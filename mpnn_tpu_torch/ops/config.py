"""Compute-precision policy of the layer zoo (counterpart of
`mpnn_tpu/ops/config.py`).

Parameters are stored float32. When `compute_dtype` is `torch.bfloat16`,
convs and matmuls cast their inputs and weights to bf16 and emit bf16
outputs (products accumulate in fp32 inside the kernel or library call);
softmax and loss terms run in fp32. None means float32 throughout.

There is no kernel on/off switch: on a CUDA tensor the MultiscaleConvMax
stage is the hand-written kernel (`ops/kernels.py`)."""

import torch

compute_dtype = None  # None => float32 everywhere


def set_compute_dtype(dtype):
    """Set the global compute dtype (None, torch.float32 or torch.bfloat16)."""
    global compute_dtype
    if dtype not in (None, torch.float32, torch.bfloat16):
        raise ValueError("compute dtype must be None, float32 or bfloat16, "
                         "got %r" % (dtype,))
    compute_dtype = None if dtype is torch.float32 else dtype


def cast_compute(t):
    """Cast a tensor to the compute dtype (no-op if unset)."""
    return t if compute_dtype is None else t.to(compute_dtype)
