from . import augment, synth

__all__ = ["augment", "synth"]
