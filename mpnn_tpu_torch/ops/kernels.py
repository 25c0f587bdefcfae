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

The stage is differentiable on both devices, as JAX's custom VJP makes it:
the backward is `torch.func.vjp` of `mcm_ref` on the saved inputs (the
counterpart of `_fused_mcm_bwd`, which takes `jax.vjp` of `mcm_xla`). The
conv is linear, so this is the exact derivative of the same function.

The stage composes with `torch.func` (`vmap`, `grad`), as the vmapped
k_cpt sweep (`models.steps.make_sweep_train_loop`) and the stacked
subtrees of `Net.forward` (`ops.config.stacked_tails`) need. Under `vmap`
the CUDA kernel's net axis computes all nets in one launch per output
scale, each input either batched (a per-net stride) or shared by every
net (stride 0, no copy); on the CPU `mcm_ref` runs on each net's slice.
Nested vmaps (the stacked tails inside the sweep) fold into that one net
axis: each level's rule re-enters the Function with the nets counted so
far, and the next level out multiplies its width in, so 8 nets x 8 tails
are one launch of 64. The backward under `vmap` takes torch's conv
batching rule (a grouped conv), the counterpart of XLA's.

`fused_mcm.launches` counts kernel launches (one per output scale, of one
net or of all nets); `fused_mcm.net_launches` counts those of the net
axis alone."""

import math

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
    """MCM stage: the CUDA kernel on CUDA tensors, `mcm_ref` on CPU tensors,
    with the gradient of `mcm_ref` on both.

    xs: pyramid (list of NHWC tensors; the last len(whs) scales are used),
    whs / wvs: HWIO horizontal / vertical weights, bs: biases, as in
    MultiscaleConvMax params."""
    L = len(whs)
    _check(L >= 1 and len(wvs) == L - 1 and len(bs) == L
           and len(xs) >= L, "expected L horizontal weights, L-1 vertical "
           "weights, L biases and at least L input scales")
    kept = list(xs[len(xs) - L:])
    return list(_FusedMCM.apply(L, supp, 0, (), *kept, *whs, *wvs, *bs))


def _split(L, tensors):
    """(kept xs, whs, wvs, bs) from the flat tuple `_FusedMCM` takes."""
    return (list(tensors[:L]), list(tensors[L:2 * L]),
            list(tensors[2 * L:3 * L - 1]), list(tensors[3 * L - 1:]))


def _ref_stage(L, n_nets, batched):
    """The stage through `mcm_ref` on the flat tensors: of one net, or
    (n_nets) of every net, `torch.func.vmap` over the batched tensors."""
    def stage(*tensors):
        return tuple(mcm_ref(*_split(L, tensors)))

    if not n_nets:
        return stage
    return torch.func.vmap(stage, in_dims=tuple(0 if b else None
                                                for b in batched))


class _FusedMCM(torch.autograd.Function):
    """Forward: the kernel (CUDA) or `mcm_ref` (CPU), of one net or, with
    n_nets > 0, of n_nets nets (the tensors flagged in `batched` carry
    them on a leading axis; the others are shared). Backward:
    `torch.func.vjp` of `mcm_ref` on the saved inputs (vmapped over the
    nets). The lists go in flattened, as `apply` takes tensors only as
    positional arguments."""

    @staticmethod
    def forward(L, supp, n_nets, batched, *tensors):
        return tuple(_forward(*_split(L, tensors), supp, n_nets=n_nets,
                              batched=list(batched) or None))

    @staticmethod
    def setup_context(ctx, inputs, output):
        L, _, n_nets, batched, *tensors = inputs
        ctx.L, ctx.n_nets, ctx.batched = L, n_nets, batched
        ctx.save_for_backward(*tensors)

    @staticmethod
    def vmap(info, in_dims, L, supp, n_nets, batched, *tensors):
        """One vmap level: its width n becomes the net axis (n_nets = 0)
        or multiplies into it (n_nets > 0, the level outside a vmap that
        already made one), and the Function is re-entered on the level
        below, so every level folds into one launch. A tensor batched at
        only one of the two is expanded over the other."""
        n, dims = info.batch_size, in_dims[4:]
        moved, flags = [], []
        for t, d, b in zip(tensors, dims, batched or [False] * len(dims)):
            if d is not None:
                t = t.movedim(d, 0)
            if n_nets and (d is not None or b):
                if d is None:
                    t = t.unsqueeze(0).expand((n,) + t.shape)
                elif not b:
                    t = t.unsqueeze(1).expand((n, n_nets) + t.shape[1:])
                t = t.reshape((n * n_nets,) + t.shape[2:])
            moved.append(t)
            flags.append(d is not None or b)
        outs = _FusedMCM.apply(L, supp, n * max(n_nets, 1), tuple(flags),
                               *moved)
        if n_nets:
            outs = tuple(o.unflatten(0, (n, n_nets)) for o in outs)
        return tuple(outs), (0,) * L

    @staticmethod
    def backward(ctx, *gs):
        need = ctx.needs_input_grad[4:]
        saved = ctx.saved_tensors
        stage = _ref_stage(ctx.L, ctx.n_nets, ctx.batched)

        def wrt_needed(*wrt):
            it = iter(wrt)
            return stage(*[next(it) if n else t for t, n in zip(saved, need)])

        _, vjp = torch.func.vjp(wrt_needed, *[t for t, n in zip(saved, need)
                                              if n])
        grads = iter(vjp(gs))
        return (None,) * 4 + tuple(next(grads) if n else None for n in need)


def _padded_stride(per, esize):
    """The least multiple of 16 bytes, in elements, that holds `per`."""
    q = 16 // esize
    return -(-per // q) * q


def _net_slices(t, batched):
    """(tensor, per-net element stride, per-net shape) as the kernel reads
    them: a shared tensor 16-byte aligned with stride 0; a batched one
    (nets first) with every net's slice 16-byte aligned, copied into a
    padded (nets, stride) buffer where its size or base does not allow
    that."""
    if not batched:
        return _aligned(t), 0, tuple(t.shape)
    t = t.contiguous()
    n, shape = t.shape[0], tuple(t.shape[1:])
    per = t[0].numel()
    stride = _padded_stride(per, t.element_size())
    if stride != per or t.data_ptr() % 16:
        buf = t.new_empty((n, stride))
        buf[:, :per].copy_(t.reshape(n, per))
        t = buf
    return t, stride, shape


def _forward(kept, whs, wvs, bs, supp, n_nets=0, batched=None):
    """The stage's outputs, without autograd: `mcm_ref` if every tensor is
    on the CPU, else the kernel, one launch per output scale.

    With n_nets = N (under vmap), the tensors flagged in `batched` carry
    the nets on a leading axis and the others are shared by every net; the
    outputs carry the nets first. On CUDA each scale is one launch of the
    kernel's net axis; on the CPU `mcm_ref` runs on each net's slice."""
    L = len(whs)
    tensors = kept + whs + wvs + bs
    batched = batched or [False] * len(tensors)
    if all(t.device.type == "cpu" for t in tensors):
        if not n_nets:
            return mcm_ref(kept, whs, wvs, bs)
        per_net = [mcm_ref(*_split(L, [t[i] if b else t for t, b in
                                       zip(tensors, batched)]))
                   for i in range(n_nets)]
        return [torch.stack(o) for o in zip(*per_net)]
    dev = kept[0].device
    _check(dev.type == "cuda" and all(t.device == dev for t in tensors),
           "tensors must all be on the CPU or all on one CUDA device, got "
           "%s" % sorted({str(t.device) for t in tensors}))
    _check(supp == 3, "the kernel's taps are compiled for 3x3 (supp=%r)"
           % (supp,))
    cdt = config.compute_dtype or torch.float32
    _check(cdt in _DTYPE_CODE, "compute dtype %s not supported" % cdt)
    for x, b in zip(kept, batched):
        _check(x.dtype in _DTYPE_CODE, "input dtype %s not supported"
               % x.dtype)
        _check(b or x.is_contiguous(), "inputs must be contiguous NHWC")
    tensors = [t.to(cdt) for t in kept] + [
        t.to(cdt).contiguous() for t in whs + wvs] + [
        t.to(torch.float32).contiguous() for t in bs]
    kept, whs, wvs, bs = _split(L, [_net_slices(t, b)
                                    for t, b in zip(tensors, batched)])

    B = kept[0][2][0]
    N = max(n_nets, 1)
    outs = []
    for j in range(L):
        (x, s_x, xshape), (wh, s_wh, wshape), (b, s_b, bshape) = (
            kept[j], whs[j], bs[j])
        _check(len(xshape) == 4 and xshape[0] == B, "scale %d: expected "
               "(B, H, W, C) with B=%d, got %s" % (j, B, xshape))
        _, H, W, Cin = xshape
        Cout = wshape[-1]
        _check(wshape == (3, 3, Cin, Cout) and Cout % 4 == 0,
               "w_horz_%d: expected (3, 3, %d, Cout) with Cout a multiple "
               "of 4, got %s" % (j, Cin, wshape))
        _check(bshape == (Cout,), "b_%d: expected (%d,), got %s"
               % (j, Cout, bshape))
        if j > 0:
            prev, s_prev, pshape = outs[j - 1]
            _check(pshape[1] == 2 * H and pshape[2] == 2 * W,
                   "scale %d is %dx%d but scale %d pools to %dx%d"
                   % (j, H, W, j - 1, pshape[1] // 2, pshape[2] // 2))
            Cprev = pshape[-1]
            wv, s_wv, vshape = wvs[j - 1]
            _check(vshape == (3, 3, Cprev, Cout),
                   "w_vert_%d: expected (3, 3, %d, %d), got %s"
                   % (j - 1, Cprev, Cout, vshape))
            prev_ptr, wv_ptr = prev.data_ptr(), wv.data_ptr()
        else:
            Cprev, prev_ptr, wv_ptr, s_prev, s_wv = 0, None, None, 0, 0
        oshape = (B, H, W, Cout)
        args = (x.data_ptr(), wh.data_ptr(), prev_ptr, wv_ptr, b.data_ptr())
        tail = (B, H, W, Cin, Cprev, Cout, _DTYPE_CODE[cdt])
        if n_nets:
            s_out = _padded_stride(B * H * W * Cout, x.element_size())
            out = torch.empty((N, s_out), dtype=cdt, device=dev)
            _launch_nets(dev, *args, out.data_ptr(), N, s_x, s_wh, s_prev,
                         s_wv, s_b, s_out, *tail)
        else:
            s_out = 0
            out = torch.empty(oshape, dtype=cdt, device=dev)
            _launch(dev, *args, out.data_ptr(), *tail)
        outs.append((out, s_out, oshape))
    if not n_nets:
        return [o for o, _, _ in outs]
    return [o[:, :math.prod(s)].unflatten(1, s) for o, _, s in outs]


fused_mcm.launches = 0
fused_mcm.net_launches = 0


def _call(dev, entry, *args):
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, entry)(*args, stream)
    if rc != 0:
        raise RuntimeError("fused_mcm kernel launch failed: CUDA error %d "
                           "(%s)" % (rc, lib.mcm_error_string(rc).decode()))
    fused_mcm.launches += 1


def _launch(dev, *args):
    """One scale of one net."""
    _call(dev, "mcm_scale_forward", *args)


def _launch_nets(dev, *args):
    """One scale of every net of a sweep, through the kernel's net axis."""
    _call(dev, "mcm_scale_forward_nets", *args)
    fused_mcm.net_launches += 1
