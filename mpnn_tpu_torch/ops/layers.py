"""The layers of the routing nets, for training and serving (counterpart
of `mpnn_tpu/ops/layers.py`).

A layer object is static configuration (hypers plus tree links `router` /
`sinks` / `comps`). Parameters and BatchNorm running statistics live in
nested dicts of tensors passed to plain functions:

- `build(x_shape)` fixes `out_shape` and the analytic op count `n_ops`
  (routed inference reports realized ops from it, so the formulas are the
  reference's exactly);
- `init(gen, x_shape) -> params` draws from an explicit `torch.Generator`
  on the CPU; `Net.init` moves the tree to its device;
- `init_state(x_shape) -> state`;
- `apply(params, state, x, y, ctx) -> (x_out, new_state, Aux)`.

Activations are NHWC and conv weights HWIO, as in `mpnn_tpu`; a transpose
happens only inside a torch op that needs NCHW. Multiscale ("pyramid")
activations are Python lists of tensors. Parameter and hyper names follow
the checkpoint schema (`w_horz_i`, `w_vert_i`, `b_i`, `w`, `b`, `γ`, `β`,
`m_avg`, `v_avg`).

`y=None` asks for no loss terms: error layers and weight penalties skip
their `c_err` / `c_mod` work. Routed inference passes None, since eager
PyTorch would otherwise compute terms that nothing reads. Weight penalties
are also skipped under `config.analytic_l2`, where the train step adds
their gradient itself (`l2_specs`)."""

import math
import unicodedata
from types import SimpleNamespace as Ns

import numpy as np
import torch
import torch.nn.functional as F

from . import config

__all__ = [
    "Layer", "NoOp", "LinTrans", "Rect", "Softmax", "ToPyramid",
    "MultiscaleConvMax", "MultiscaleRect", "Select", "BatchNorm",
    "MultiscaleBatchNorm", "CrossEntropyError", "Chain", "Aux",
    "nfkc_hypers", "conv_same",
]


def nfkc_hypers(hypers):
    """NFKC-normalize hyper-dict keys (shared by Layer and Net).

    Python normalizes identifiers at parse (source kwarg `ϵ` U+03F5 becomes
    attr `ε` U+03B5), but keys arriving via **dict -- e.g. decoded from a
    checkpoint record -- do not. Two raw keys normalizing to the same name
    (a corrupt record) raise rather than letting one silently win."""
    out = {}
    for k, v in hypers.items():
        nk = unicodedata.normalize("NFKC", k)
        if nk in out:
            raise ValueError(
                "hyper keys %r and earlier one both normalize to %r" % (k, nk))
        out[nk] = v
    return out


class Aux:
    """Per-layer loss contributions (`c_err` / `c_mod` / `delta_cor`)."""

    def __init__(self, c_err=0.0, c_mod=0.0, delta_cor=None):
        self.c_err = c_err      # per-example (B,) or scalar 0
        self.c_mod = c_mod      # scalar
        self.delta_cor = delta_cor  # (B,) 0/1 correctness, or None


def _prod(shape):
    return int(np.prod(shape)) if len(shape) else 1


def _randn(gen, shape):
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32)


def conv_same(x, w):
    """Stride-1 SAME 2-D conv, NHWC input, HWIO weights, NHWC output.

    Under a bf16 compute policy inputs and weights are cast to bf16 and the
    output stays bf16. Even (clipped) kernels pad as XLA's SAME does."""
    x, w = config.cast_compute(x), config.cast_compute(w)
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   padding="same")
    return out.permute(0, 2, 3, 1).contiguous()


def _pool2(x):
    """2x2 stride-2 SAME max-pool of an NHWC tensor; odd dims pad at the
    bottom/right edge, as XLA's SAME reduce_window does."""
    b, h, w, c = x.shape
    if h % 2 == 0 and w % 2 == 0:
        return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    out = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return out.permute(0, 2, 3, 1).contiguous()


def _matmul(x, w):
    """Dense product under the compute policy; output in compute dtype."""
    return config.cast_compute(x) @ config.cast_compute(w)


def _bias_add(out, b):
    """out + b without promoting bf16 activations to fp32."""
    return out + b.to(out.dtype)


################################################################################
# Core layer class
################################################################################

class Layer:
    default_hypers = {}

    def __init__(self, name=None, router=None, sinks=None, comps=None,
                 **hypers):
        self.name = name if name is not None else type(self).__name__
        self.router = router
        self.sinks = list(sinks) if sinks else []
        self.comps = list(comps) if comps else []
        self.hypers = Ns(**{**dict(type(self).default_hypers),
                            **nfkc_hypers(hypers)})
        self.out_shape = None
        self.n_ops = 0.0

    def l2_specs(self):
        """param name -> (k_l2, w_eq) for weights whose c_mod is the L2
        penalty against w_eq (None means zero); read by the analytic-L2
        update (models/optim.py:tree_l2_decay)."""
        return {}

    def build(self, x_shape):
        self.out_shape = x_shape
        self.n_ops = 0.0

    def init(self, gen, x_shape):
        return {}

    def init_state(self, x_shape):
        return {}

    def apply(self, params, state, x, y, ctx):
        return x, state, Aux()


class NoOp(Layer):
    """Identity; the default root of a Net."""


################################################################################
# Transformation layers
################################################################################

class LinTrans(Layer):
    """Flatten -> dense, with optional identity-residual init and L2 penalty
    measured relative to identity. n_ops = n_in * n_chan."""

    default_hypers = dict(n_chan=1, k_l2=0, σ_w=1, res=False)

    def build(self, x_shape):
        h = self.hypers
        self._n_in = _prod(x_shape)
        self._w_eq = (torch.eye(self._n_in, h.n_chan) if h.res
                      else torch.tensor(0.0))
        self.out_shape = (h.n_chan,)
        self.n_ops = float(self._n_in * h.n_chan)

    def init(self, gen, x_shape):
        h = self.hypers
        w_scale = h.σ_w / math.sqrt(self._n_in)
        w = self._w_eq + w_scale * _randn(gen, (self._n_in, h.n_chan))
        return {"w": w, "b": torch.zeros(h.n_chan)}

    def apply(self, params, state, x, y, ctx):
        w = params["w"]
        out = _bias_add(_matmul(x.reshape(x.shape[0], -1), w), params["b"])
        if y is None or config.analytic_l2:
            return out, state, Aux()
        # w_eq is 0 unless res: skip the subtraction (and its host-to-device
        # copy) where it changes nothing.
        d = w - self._w_eq.to(w.device) if self.hypers.res else w
        c_mod = self.hypers.k_l2 * torch.sum(torch.square(d))
        return out, state, Aux(c_mod=c_mod)

    def l2_specs(self):
        return {"w": (float(self.hypers.k_l2),
                      self._w_eq if self.hypers.res else None)}


class Rect(Layer):
    """ReLU."""

    def apply(self, params, state, x, y, ctx):
        return torch.relu(x), state, Aux()


class Softmax(Layer):
    """Softmax over the class axis, always computed and returned in fp32
    (class probabilities feed every accuracy and routing statistic)."""

    def apply(self, params, state, x, y, ctx):
        return torch.softmax(x.float(), dim=-1), state, Aux()


################################################################################
# Multiscale transformation layers
################################################################################

class ToPyramid(Layer):
    """Image pyramid: n_scales bilinear-resized copies at (h/2^i, w/2^i).

    `jax.image.resize(..., "bilinear")` antialiases when it shrinks, so the
    port resizes with `antialias=True` (without it 32->16/8/4 differs by up
    to 0.35). The TF1 legacy grid mode of `mpnn_tpu` is not ported."""

    default_hypers = dict(n_scales=1)

    def build(self, x_shape):
        h, w, c = x_shape
        self.out_shape = [(h // 2 ** i, w // 2 ** i, c)
                          for i in range(self.hypers.n_scales)]
        self.n_ops = 0.0

    def apply(self, params, state, x, y, ctx):
        out = []
        # Resized in fp32 and rounded once to the input's dtype (the CPU
        # has no bf16 antialiased resize).
        nchw = x.permute(0, 3, 1, 2).float()
        for (h, w, c) in self.out_shape:
            if (h, w) == tuple(x.shape[1:3]):
                out.append(x)
            else:
                r = F.interpolate(nchw, size=(h, w), mode="bilinear",
                                  align_corners=False, antialias=True)
                out.append(r.permute(0, 2, 3, 1).to(x.dtype).contiguous())
        return out, state, Aux()


class MultiscaleConvMax(Layer):
    """The core CNN block. Takes a pyramid and outputs a pyramid over the
    *last* len(n_chan) input scales:

        out[0] = b[0] + conv(x[S-L],   w_horz[0])
        out[j] = b[j] + conv(x[S-L+j], w_horz[j]) + conv(pool2(out[j-1]), w_vert[j-1])

    n_ops = sum_j n_pix(out[j]) * (n_el(w_horz[j]) + n_el(w_vert[j-1]) if j>0).
    Shapes that `_kernel_eligible` accepts run through `kernels.fused_mcm`
    (the CUDA kernel on CUDA tensors, its plain version on CPU tensors);
    the others through `kernels.mcm_ref`, as `mpnn_tpu` computes them
    outside its Pallas kernel."""

    default_hypers = dict(n_chan=(), supp=1, k_l2=0, σ_w=1)

    def build(self, x_shape):
        h = self.hypers
        L = len(h.n_chan)
        S = len(x_shape)
        self._L = L
        kept = x_shape[S - L:]
        self._in_shapes = list(kept)
        self._w_horz_shapes = [
            (min(h.supp, kept[j][0]), min(h.supp, kept[j][1]),
             kept[j][2], h.n_chan[j])
            for j in range(L)]
        self._w_vert_shapes = [
            (h.supp, h.supp, h.n_chan[j], h.n_chan[j + 1])
            for j in range(L - 1)]
        self.out_shape = [tuple(kept[j][:2]) + (h.n_chan[j],)
                          for j in range(L)]
        self.n_ops = float(sum(
            _prod(self.out_shape[j][:2]) * (
                _prod(self._w_horz_shapes[j])
                + (_prod(self._w_vert_shapes[j - 1]) if j > 0 else 0))
            for j in range(L)))

    def init(self, gen, x_shape):
        h = self.hypers
        params = {}
        for j, shp in enumerate(self._w_horz_shapes):
            scale = h.σ_w / h.supp / math.sqrt(shp[2])
            params[f"w_horz_{j}"] = scale * _randn(gen, shp)
        for j, shp in enumerate(self._w_vert_shapes):
            scale = h.σ_w / h.supp / math.sqrt(h.n_chan[j])
            params[f"w_vert_{j}"] = scale * _randn(gen, shp)
        for j in range(self._L):
            params[f"b_{j}"] = torch.zeros(h.n_chan[j])
        return params

    def _kernel_eligible(self):
        """Shape rule of the fused kernel (the port's copy of
        `mpnn_tpu`'s `_pallas_eligible`): full supp x supp horizontal
        kernels (every reference arch: the smallest scale is 4x4 >= supp),
        even spatial dims for the in-kernel pool2, and each coarser scale
        exactly half the finer one. The CUDA kernel's taps are compiled
        for supp == 3, the registry's only conv support, and it writes
        output channels in groups of 4 (every registry width is a multiple
        of 16)."""
        h = self.hypers
        return (h.supp == 3 and all(c % 4 == 0 for c in h.n_chan)
                and all(s[0] == h.supp and s[1] == h.supp
                        for s in self._w_horz_shapes)
                and all(s[0] % 2 == 0 and s[1] % 2 == 0
                        for s in self.out_shape[:-1])
                and all(2 * b[0] == a[0] and 2 * b[1] == a[1]
                        for a, b in zip(self._in_shapes,
                                        self._in_shapes[1:])))

    def apply(self, params, state, x, y, ctx):
        from .kernels import fused_mcm, mcm_ref
        h = self.hypers
        L = self._L
        whs = [params[f"w_horz_{j}"] for j in range(L)]
        wvs = [params[f"w_vert_{j}"] for j in range(L - 1)]
        bs = [params[f"b_{j}"] for j in range(L)]
        if self._kernel_eligible():
            out = fused_mcm([t.contiguous() for t in x], whs, wvs, bs,
                            h.supp)
        else:
            out = mcm_ref(x, whs, wvs, bs)
        if y is None or config.analytic_l2:
            return out, state, Aux()
        c_mod = h.k_l2 * (sum(torch.sum(torch.square(w)) for w in whs)
                          + sum(torch.sum(torch.square(w)) for w in wvs))
        return out, state, Aux(c_mod=c_mod)

    def l2_specs(self):
        k2 = float(self.hypers.k_l2)
        specs = {f"w_horz_{j}": (k2, None) for j in range(self._L)}
        specs.update({f"w_vert_{j}": (k2, None) for j in range(self._L - 1)})
        return specs


class MultiscaleRect(Layer):
    """ReLU mapped over the pyramid."""

    def build(self, x_shape):
        self.out_shape = list(x_shape)
        self.n_ops = 0.0

    def apply(self, params, state, x, y, ctx):
        return [torch.relu(x_i) for x_i in x], state, Aux()


class Select(Layer):
    """Pick one scale from the pyramid."""

    default_hypers = dict(i=0)

    def build(self, x_shape):
        self.out_shape = x_shape[self.hypers.i]
        self.n_ops = 0.0

    def apply(self, params, state, x, y, ctx):
        return x[self.hypers.i], state, Aux()


################################################################################
# Regularization layers
################################################################################

class BatchNorm(Layer):
    """Batch normalization with EMA running statistics (decay d); γ/β are
    params, m_avg / v_avg state. Train mode (`ctx.train`) normalizes with
    the batch moments, taken in fp32 whatever the activation dtype, with
    the biased variance E[x²] - m² (not `nn.BatchNorm2d`'s), and updates
    the EMA from the moments without their gradient. Eval mode normalizes
    with the running statistics and leaves them as they are."""

    default_hypers = dict(d=0.9, ϵ=1e-6)

    def build(self, x_shape):
        self.out_shape = x_shape
        self._n_chan = x_shape[-1]
        self.n_ops = 0.0

    def init(self, gen, x_shape):
        n = self._n_chan
        return {"γ": torch.ones(n), "β": torch.zeros(n)}

    def init_state(self, x_shape):
        n = self._n_chan
        return {"m_avg": torch.zeros(n), "v_avg": torch.ones(n)}

    def apply(self, params, state, x, y, ctx):
        h = self.hypers
        if ctx.train:
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            m = torch.mean(xf, dims)
            v = torch.mean(torch.square(xf), dims) - torch.square(m)
            state = {
                "m_avg": h.d * state["m_avg"] + (1 - h.d) * m.detach(),
                "v_avg": h.d * state["v_avg"] + (1 - h.d) * v.detach(),
            }
        else:
            m, v = state["m_avg"], state["v_avg"]
        if x.dtype == torch.float32:
            out = params["γ"] * (x - m) / torch.sqrt(v + h.ϵ) + params["β"]
        else:
            # bf16 activations: one per-channel affine computed in fp32,
            # applied in the activation dtype.
            scale = params["γ"] / torch.sqrt(v + h.ϵ)
            shift = params["β"] - scale * m
            out = x * scale.to(x.dtype) + shift.to(x.dtype)
        return out, state, Aux()


class MultiscaleBatchNorm(Layer):
    """One BatchNorm per pyramid scale, exposed as comps."""

    default_hypers = dict(d=0.9, ϵ=1e-6)

    def build(self, x_shape):
        h = self.hypers
        self.comps = [BatchNorm(d=h.d, ϵ=h.ϵ) for _ in x_shape]
        for comp, shp in zip(self.comps, x_shape):
            comp.build(shp)
        self.out_shape = list(x_shape)
        self.n_ops = 0.0

    def init(self, gen, x_shape):
        return {"comps": [c.init(gen, s)
                          for c, s in zip(self.comps, x_shape)]}

    def init_state(self, x_shape):
        return {"comps": [c.init_state(s)
                          for c, s in zip(self.comps, x_shape)]}

    def apply(self, params, state, x, y, ctx):
        outs, new_states = [], []
        for comp, p, s, x_i in zip(self.comps, params["comps"],
                                   state["comps"], x):
            o, ns, _ = comp.apply(p, s, x_i, y, ctx)
            outs.append(o)
            new_states.append(ns)
        return outs, {"comps": new_states}, Aux()


################################################################################
# Error layers
################################################################################

class CrossEntropyError(Layer):
    """Cross-entropy on already-softmaxed probs with an eps-floor
    p_cls = eps/n_cls + (1-eps)*x, plus the correctness indicator."""

    default_hypers = dict(ϵ=1e-6)

    def apply(self, params, state, x, y, ctx):
        if y is None:
            return x, state, Aux()
        eps = self.hypers.ϵ
        p_cls = eps / y.shape[1] + (1 - eps) * x.float()
        c_err = -torch.sum(y * torch.log(p_cls), dim=1)
        delta_cor = (torch.argmax(x, dim=1)
                     == torch.argmax(y, dim=1)).float()
        return x, state, Aux(c_err=c_err, delta_cor=delta_cor)


################################################################################
# Compound layers
################################################################################

class Chain(Layer):
    """Sequential composition; sums c_err/c_mod/n_ops over comps and forwards
    the last comp's delta_cor. Chains are the unit nodes of the routing
    tree."""

    def build(self, x_shape):
        shape = x_shape
        for comp in self.comps:
            comp.build(shape)
            shape = comp.out_shape
        self.out_shape = shape
        self.n_ops = float(sum(c.n_ops for c in self.comps))

    def init(self, gen, x_shape):
        params, shape = [], x_shape
        for comp in self.comps:
            params.append(comp.init(gen, shape))
            shape = comp.out_shape
        return {"comps": params}

    def init_state(self, x_shape):
        states, shape = [], x_shape
        for comp in self.comps:
            states.append(comp.init_state(shape))
            shape = comp.out_shape
        return {"comps": states}

    def apply(self, params, state, x, y, ctx):
        new_states = []
        c_err, c_mod, last_aux = 0.0, 0.0, None
        for comp, p, s in zip(self.comps, params["comps"], state["comps"]):
            x, ns, aux = comp.apply(p, s, x, y, ctx)
            new_states.append(ns)
            c_err = c_err + aux.c_err
            c_mod = c_mod + aux.c_mod
            last_aux = aux
        delta_cor = last_aux.delta_cor if last_aux is not None else None
        return x, {"comps": new_states}, Aux(
            c_err=c_err, c_mod=c_mod, delta_cor=delta_cor)
