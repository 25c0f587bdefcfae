"""PyTorch/CUDA port of `mpnn_tpu`: routed inference of trained routing nets.

Module names mirror `mpnn_tpu` so each counterpart is easy to find. The
package imports torch, numpy and the standard library only. Activations are
NHWC and conv weights HWIO at every public function, as in `mpnn_tpu`, so
both packages take the same arrays."""

import torch

__all__ = ["resolve_device", "synchronize"]


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


def synchronize(device):
    """Wait for the device's queued work (a no-op on the CPU), so a host
    clock read after it includes that work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
