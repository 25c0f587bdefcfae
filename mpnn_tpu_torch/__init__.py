"""PyTorch/CUDA port of `mpnn_tpu`: routed inference of trained routing nets.

Module names mirror `mpnn_tpu` so each counterpart is easy to find. The
package imports torch, numpy and the standard library only. Activations are
NHWC and conv weights HWIO at every public function, as in `mpnn_tpu`, so
both packages take the same arrays."""

import os

import torch

__all__ = ["resolve_device", "set_deterministic", "set_up_device",
           "synchronize"]


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


def set_deterministic(flag=True):
    """Deterministic kernels: `torch.use_deterministic_algorithms` (an op
    without a deterministic form warns, naming itself, and runs), cuDNN's
    deterministic algorithms and no autotuning; turning them on also sets
    CUBLAS_WORKSPACE_CONFIG=:4096:8 unless set, which cuBLAS needs under
    deterministic algorithms and which takes effect only before the
    process's first cuBLAS handle. On the card the training step
    otherwise does not repeat itself: cuDNN's default backward algorithms
    in the stage's VJP (`ops/kernels.py`) sum in an order that varies
    from run to run."""
    if flag:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(flag, warn_only=True)
    torch.backends.cudnn.deterministic = flag
    torch.backends.cudnn.benchmark = False


def set_up_device(device, precision, deterministic=False):
    """The entry points' device (`resolve_device`) and compute type: TF32
    off on CUDA (fp32 means fp32 in cuDNN convs and cuBLAS matmuls), bf16
    as the compute dtype for precision "bf16". With deterministic (the
    training entry points), CUDA runs `set_deterministic`, so a run, and
    a run resumed from its checkpoint, repeat themselves bit for bit, as
    `mpnn_tpu` does on the TPU; the CPU is deterministic as it is."""
    from .ops import config
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if deterministic:
            set_deterministic(True)
    config.set_compute_dtype(torch.bfloat16 if precision == "bf16"
                             else None)
    return device


def synchronize(device):
    """Wait for the device's queued work (a no-op on the CPU), so a host
    clock read after it includes that work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
