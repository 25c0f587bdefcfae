from . import config
from .layers import (
    Layer, NoOp, LinTrans, Rect, Softmax, ToPyramid, MultiscaleConvMax,
    MultiscaleRect, Select, BatchNorm, MultiscaleBatchNorm,
    CrossEntropyError, Chain, Aux, nfkc_hypers,
)

__all__ = [
    "config", "Layer", "NoOp", "LinTrans", "Rect", "Softmax", "ToPyramid",
    "MultiscaleConvMax", "MultiscaleRect", "Select", "BatchNorm",
    "MultiscaleBatchNorm", "CrossEntropyError", "Chain", "Aux",
    "nfkc_hypers",
]
