"""PyTorch/CUDA port of `mpnn_tpu`: routed inference of trained routing nets.

Module names mirror `mpnn_tpu` so each counterpart is easy to find. The
package imports torch, numpy and the standard library only. Activations are
NHWC and conv weights HWIO at every public function, as in `mpnn_tpu`, so
both packages take the same arrays."""

import torch

__all__ = ["resolve_device", "set_up_device", "synchronize"]


def resolve_device(device="cuda"):
    """The torch device an entry point runs on. Entry points default to
    "cuda"; asking for CUDA on a host without it raises instead of quietly
    running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device %r requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU"
            % str(device))
    return dev


def set_up_device(device, precision):
    """The entry points' device (`resolve_device`) and compute type: TF32
    off on CUDA (fp32 means fp32 in cuDNN convs and cuBLAS matmuls), bf16
    as the compute dtype for precision "bf16"."""
    from .ops import config
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    config.set_compute_dtype(torch.bfloat16 if precision == "bf16"
                             else None)
    return device


def synchronize(device):
    """Wait for the device's queued work (a no-op on the CPU), so a host
    clock read after it includes that work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
