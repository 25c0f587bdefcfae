from . import config
from .layers import (
    Layer, NoOp, LinTrans, Conv, Rect, Softmax, MaxPool, GlobalMaxPool,
    ToPyramid, MultiscaleLLN, MultiscaleConvMax, MultiscaleRect, Select,
    Dropout, BatchNorm, MultiscaleBatchNorm, SquaredError, CrossEntropyError,
    SuperclassCrossEntropyError, ActivityError, Chain, Aux, nfkc_hypers,
)

__all__ = [
    "config", "Layer", "NoOp", "LinTrans", "Conv", "Rect", "Softmax",
    "MaxPool", "GlobalMaxPool", "ToPyramid", "MultiscaleLLN",
    "MultiscaleConvMax", "MultiscaleRect", "Select", "Dropout", "BatchNorm",
    "MultiscaleBatchNorm", "SquaredError", "CrossEntropyError",
    "SuperclassCrossEntropyError", "ActivityError", "Chain", "Aux",
    "nfkc_hypers",
]
