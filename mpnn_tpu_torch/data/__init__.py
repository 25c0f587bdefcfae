from . import augment, synth
from .dataset import Dataset

__all__ = ["augment", "synth", "Dataset"]
