"""The fused MultiscaleConvMax stage (counterpart of
`mpnn_tpu/ops/kernels.py`).

`fused_mcm` computes one MultiscaleConvMax stage over the last L scales:

    out[0] = b0 + conv3x3(x[S-L], wh0)
    out[j] = b_j + conv3x3(x[S-L+j], wh_j) + conv3x3(pool2(out[j-1]), wv_{j-1})

with SAME padding, fp32 accumulation and outputs in the compute dtype. On
CUDA tensors it launches the hand-written kernel of `csrc/fused_mcm.cu`
(built with nvcc and bound with ctypes by `_build.py`), one launch per
output scale, coarse-ward, on the current stream. On CPU tensors it
computes the plain version `mcm_ref`. There is no fallback from the kernel
to `mcm_ref`: a CUDA tensor either takes the kernel or raises.

`fused_mcm.launches` counts kernel launches (one per output scale)."""

import torch

from . import _build, config
from .layers import _pool2, conv_same

__all__ = ["fused_mcm", "mcm_ref", "_pack_w"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _pack_w(w):
    """(kh, kw, Cin, Cout) -> (kh*kw*Cin, Cout), tap-major like im2col. The
    kernel reads HWIO weights in exactly this layout."""
    kh, kw, ci, co = w.shape
    return w.reshape(kh * kw * ci, co)


def mcm_ref(xs, whs, wvs, bs):
    """Plain PyTorch version of the stage (the counterpart of `mcm_xla`):
    cuDNN / CPU convs plus a max-pool, under the compute dtype policy."""
    L = len(whs)
    kept = xs[len(xs) - L:]
    out0 = conv_same(kept[0], whs[0])
    outs = [out0 + bs[0].to(out0.dtype)]
    for j in range(1, L):
        oj = (conv_same(kept[j], whs[j])
              + conv_same(_pool2(outs[j - 1]), wvs[j - 1]))
        outs.append(oj + bs[j].to(oj.dtype))
    return outs


def _aligned(t):
    """t, or an aligned copy: the kernel reads 16-byte vectors, so a view
    whose data does not start on a 16-byte boundary is copied."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(cond, msg):
    if not cond:
        raise ValueError("fused_mcm: " + msg)


def fused_mcm(xs, whs, wvs, bs, supp):
    """MCM stage: the CUDA kernel on CUDA tensors, `mcm_ref` on CPU tensors.

    xs: pyramid (list of NHWC tensors; the last len(whs) scales are used),
    whs / wvs: HWIO horizontal / vertical weights, bs: biases, as in
    MultiscaleConvMax params."""
    L = len(whs)
    _check(L >= 1 and len(wvs) == L - 1 and len(bs) == L
           and len(xs) >= L, "expected L horizontal weights, L-1 vertical "
           "weights, L biases and at least L input scales")
    kept = list(xs[len(xs) - L:])
    tensors = kept + list(whs) + list(wvs) + list(bs)
    if all(t.device.type == "cpu" for t in tensors):
        return mcm_ref(xs, whs, wvs, bs)
    dev = kept[0].device
    _check(dev.type == "cuda" and all(t.device == dev for t in tensors),
           "tensors must all be on the CPU or all on one CUDA device, got "
           "%s" % sorted({str(t.device) for t in tensors}))
    _check(supp == 3, "the kernel's taps are compiled for 3x3 (supp=%r)"
           % (supp,))
    cdt = config.compute_dtype or torch.float32
    _check(cdt in _DTYPE_CODE, "compute dtype %s not supported" % cdt)
    for x in kept:
        _check(x.dtype in _DTYPE_CODE, "input dtype %s not supported"
               % x.dtype)
        _check(x.is_contiguous(), "inputs must be contiguous NHWC")
    kept = [_aligned(x.to(cdt)) for x in kept]
    whs = [_aligned(w.to(cdt).contiguous()) for w in whs]
    wvs = [_aligned(w.to(cdt).contiguous()) for w in wvs]
    bs = [b.to(torch.float32).contiguous() for b in bs]

    B = kept[0].shape[0]
    outs = []
    for j in range(L):
        x = kept[j]
        _check(x.dim() == 4 and x.shape[0] == B, "scale %d: expected "
               "(B, H, W, C) with B=%d, got %s" % (j, B, tuple(x.shape)))
        _, H, W, Cin = x.shape
        Cout = whs[j].shape[-1]
        _check(tuple(whs[j].shape) == (3, 3, Cin, Cout) and Cout % 4 == 0,
               "w_horz_%d: expected (3, 3, %d, Cout) with Cout a multiple "
               "of 4, got %s" % (j, Cin, tuple(whs[j].shape)))
        _check(tuple(bs[j].shape) == (Cout,), "b_%d: expected (%d,), got %s"
               % (j, Cout, tuple(bs[j].shape)))
        if j > 0:
            prev = outs[j - 1]
            _check(prev.shape[1] == 2 * H and prev.shape[2] == 2 * W,
                   "scale %d is %dx%d but scale %d pools to %dx%d"
                   % (j, H, W, j - 1, prev.shape[1] // 2, prev.shape[2] // 2))
            Cprev = prev.shape[-1]
            _check(tuple(wvs[j - 1].shape) == (3, 3, Cprev, Cout),
                   "w_vert_%d: expected (3, 3, %d, %d), got %s"
                   % (j - 1, Cprev, Cout, tuple(wvs[j - 1].shape)))
            prev_ptr, wv_ptr = prev.data_ptr(), wvs[j - 1].data_ptr()
        else:
            Cprev, prev_ptr, wv_ptr = 0, None, None
        out = torch.empty((B, H, W, Cout), dtype=cdt, device=dev)
        _launch(dev, x.data_ptr(), whs[j].data_ptr(), prev_ptr, wv_ptr,
                bs[j].data_ptr(), out.data_ptr(), B, H, W, Cin, Cprev, Cout,
                _DTYPE_CODE[cdt])
        outs.append(out)
    return outs


fused_mcm.launches = 0


def _launch(dev, *args):
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.mcm_scale_forward(*args, stream)
    if rc != 0:
        raise RuntimeError("fused_mcm kernel launch failed: CUDA error %d "
                           "(%s)" % (rc, lib.mcm_error_string(rc).decode()))
    fused_mcm.launches += 1

