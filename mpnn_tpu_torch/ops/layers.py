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
    "Layer", "NoOp", "LinTrans", "Conv", "Rect", "Softmax", "MaxPool",
    "GlobalMaxPool", "ToPyramid", "MultiscaleLLN", "MultiscaleConvMax",
    "MultiscaleRect", "Select", "Dropout", "BatchNorm",
    "MultiscaleBatchNorm", "SquaredError", "CrossEntropyError",
    "SuperclassCrossEntropyError", "ActivityError", "Chain", "Aux",
    "nfkc_hypers", "conv_same", "max_pool_same", "fold_stream",
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
    return _conv_nhwc(config.cast_compute(x), config.cast_compute(w))


def max_pool_same(x, supp, stride):
    """supp x supp max-pool of an NHWC tensor at `stride`, SAME padding
    with -inf as XLA's reduce_window pads: ceil(n / stride) outputs a
    side, the padding split low / high with the odd one high (which
    `F.max_pool2d`'s symmetric padding cannot express)."""
    pads = []
    for n in (x.shape[2], x.shape[1]):  # F.pad's order: W, then H
        total = max((-(-n // stride) - 1) * stride + supp - n, 0)
        pads += [total // 2, total - total // 2]
    xp = F.pad(x.permute(0, 3, 1, 2), pads, value=-math.inf)
    return F.max_pool2d(xp, supp, stride).permute(0, 2, 3, 1).contiguous()


def _conv_nhwc(x, w):
    """`conv_same` in the dtype of its arguments (no compute policy)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                   padding="same")
    return out.permute(0, 2, 3, 1).contiguous()


def _pool2(x):
    """2x2 stride-2 SAME max-pool of an NHWC tensor; odd dims pad at the
    bottom/right edge, as XLA's SAME reduce_window does."""
    b, h, w, c = x.shape
    if h % 2 == 0 and w % 2 == 0:
        return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))
    return max_pool_same(x, 2, 2)


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
    _uid = 0  # set per instance by Net.build; keys stats and streams

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


class Conv(Layer):
    """SAME stride-1 conv plus bias, with optional identity-kernel
    residual init and L2 penalty measured relative to it.
    n_ops = n_pix * supp^2 * n_in * n_chan."""

    default_hypers = dict(n_chan=1, supp=1, k_l2=0, σ_w=1, res=False)

    def build(self, x_shape):
        h = self.hypers
        n_in = x_shape[-1]
        if h.res:
            centre = torch.arange(h.supp) == h.supp // 2
            self._w_eq = (centre[:, None, None, None]
                          * centre[:, None, None]
                          * torch.eye(n_in, h.n_chan)).float()
        else:
            self._w_eq = torch.tensor(0.0)
        self._n_in = n_in
        self.out_shape = tuple(x_shape[:2]) + (h.n_chan,)
        self.n_ops = float(_prod(x_shape[:2]) * h.supp ** 2 * n_in
                           * h.n_chan)

    def init(self, gen, x_shape):
        h = self.hypers
        w_scale = h.σ_w / h.supp / math.sqrt(self._n_in)
        w = self._w_eq + w_scale * _randn(
            gen, (h.supp, h.supp, self._n_in, h.n_chan))
        return {"w": w, "b": torch.zeros(h.n_chan)}

    def apply(self, params, state, x, y, ctx):
        w = params["w"]
        out = _bias_add(conv_same(x, w), params["b"])
        if y is None or config.analytic_l2:
            return out, state, Aux()
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


class MaxPool(Layer):
    """Strided SAME max-pool, window `supp` and stride `stride`. Under
    `config.maxpool_tf1` it computes what the reference computes, which
    passes the two transposed: window `stride`, stride `supp`."""

    default_hypers = dict(stride=1, supp=1)

    def _window_stride(self):
        if config.maxpool_tf1:
            return self.hypers.stride, self.hypers.supp
        return self.hypers.supp, self.hypers.stride

    def build(self, x_shape):
        h, w = x_shape[:2]
        _, s = self._window_stride()
        self.out_shape = (-(-h // s), -(-w // s)) + (x_shape[2],)
        self.n_ops = 0.0

    def apply(self, params, state, x, y, ctx):
        supp, stride = self._window_stride()
        return max_pool_same(x, supp, stride), state, Aux()


class GlobalMaxPool(Layer):
    """Max over all but the batch and channel axes."""

    def build(self, x_shape):
        self.out_shape = (x_shape[-1],)
        self.n_ops = 0.0

    def apply(self, params, state, x, y, ctx):
        return torch.amax(x, dim=tuple(range(1, x.dim() - 1))), state, Aux()


################################################################################
# Multiscale transformation layers
################################################################################

def _tf1_legacy_resize(x, out_h, out_w):
    """TF1's legacy bilinear resize of an NHWC tensor (align_corners
    False): src = dst * in / out with no half-pixel shift, the far
    neighbour clamped to the edge. At integer ratios the weights are 0,
    so it is a strided slice."""
    n, h, w, c = x.shape
    if h % out_h == 0 and w % out_w == 0:
        return x[:, ::h // out_h, ::w // out_w]
    ys = np.arange(out_h) * (h / out_h)
    xs = np.arange(out_w) * (w / out_w)
    y0, x0 = np.floor(ys).astype(np.int64), np.floor(xs).astype(np.int64)
    y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
    wy = torch.as_tensor((ys - y0)[None, :, None, None], dtype=x.dtype,
                         device=x.device)
    wx = torch.as_tensor((xs - x0)[None, None, :, None], dtype=x.dtype,
                         device=x.device)
    y0, y1, x0, x1 = (torch.as_tensor(i, device=x.device)
                      for i in (y0, y1, x0, x1))
    top, bot = x[:, y0], x[:, y1]
    top = top[:, :, x0] * (1 - wx) + top[:, :, x1] * wx
    bot = bot[:, :, x0] * (1 - wx) + bot[:, :, x1] * wx
    return top * (1 - wy) + bot * wy


class ToPyramid(Layer):
    """Image pyramid: n_scales bilinear-resized copies at (h/2^i, w/2^i).

    `jax.image.resize(..., "bilinear")` antialiases when it shrinks, so the
    port resizes with `antialias=True` (without it 32->16/8/4 differs by up
    to 0.35). Under `config.pyramid_tf1` it takes TF1's legacy grid instead
    (`_tf1_legacy_resize`, no antialiasing): the grid that parameters
    trained by the reference need."""

    default_hypers = dict(n_scales=1)

    def build(self, x_shape):
        h, w, c = x_shape
        self.out_shape = [(h // 2 ** i, w // 2 ** i, c)
                          for i in range(self.hypers.n_scales)]
        self.n_ops = 0.0

    def apply(self, params, state, x, y, ctx):
        if config.pyramid_tf1:
            return [x if (h, w) == tuple(x.shape[1:3])
                    else _tf1_legacy_resize(x, h, w)
                    for (h, w, c) in self.out_shape], state, Aux()
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


class MultiscaleLLN(Layer):
    """Local luminance normalization per pyramid scale: each scale divided
    by its Gaussian-weighted (σ) Rec.709 luma, corrected at the borders by
    the kernel's density (the same SAME conv of a ones image, computed once
    at build time), plus ϵ."""

    default_hypers = dict(shape0=(1, 1), σ=3, ϵ=1e-3)

    def build(self, x_shape):
        h = self.hypers
        s = int(np.ceil(2 * h.σ))
        u = np.linspace(-s, s, 2 * s + 1)[:, None, None, None]
        v = np.linspace(-s, s, 2 * s + 1)[:, None, None]
        k = (np.exp(-(u ** 2 + v ** 2) / (2 * h.σ ** 2))
             / (2 * np.pi * h.σ ** 2)
             * [[0.2126], [0.7152], [0.0722]])
        # (2s+1, 2s+1, 3, 1), HWIO
        self._k = torch.as_tensor(k, dtype=torch.float32)
        self._density = [_conv_nhwc(torch.ones((1,) + tuple(shp)),
                                         self._k) for shp in x_shape]
        self._consts = {}  # (device, dtype) -> (kernel, densities)
        self.out_shape = list(x_shape)
        self.n_ops = 0.0

    def apply(self, params, state, x, y, ctx):
        key = (x[0].device, x[0].dtype)
        if key not in self._consts:
            self._consts[key] = (
                self._k.to(*key), [d.to(*key) for d in self._density])
        k, dens = self._consts[key]
        eps = self.hypers.ϵ
        return [x_i / (_conv_nhwc(x_i, k) / d + eps)
                for x_i, d in zip(x, dens)], state, Aux()


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

_MASK64 = (1 << 64) - 1


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_stream(seed, *tags):
    """A generator seed that is a function of integers only (the
    counterpart of chaining `jax.random.fold_in`): splitmix64 over the
    sequence, cut to 63 bits."""
    h = _splitmix64(int(seed) & _MASK64)
    for tag in tags:
        h = _splitmix64(h ^ (int(tag) & _MASK64))
    return h >> 1


class Dropout(Layer):
    """Keep-probability λ dropout with 1/λ rescale. As in the reference it
    is not gated by mode: it applies in training and evaluation whenever
    the context carries a stream (`ctx.rng`), and is the identity at
    λ = 1 or without one (routed serving passes none).

    The keep mask is `ctx.masks[uid]` where the forward drew it
    (`Net.dropout_masks`: outside any vmap, since torch.func refuses random
    draws inside one), else drawn here from the stream folded with the
    layer's uid (`draw_keep`)."""

    default_hypers = dict(λ=1)

    def build(self, x_shape):
        self.out_shape = x_shape
        self.n_ops = 0.0

    def active(self):
        return self.hypers.λ < 1

    def draw_keep(self, seed, batch, device, gen=None):
        """The (batch,) + in-shape keep mask of stream `seed`: uniform
        draws below λ."""
        gen = gen or torch.Generator(device=device)
        gen.manual_seed(seed)
        u = torch.rand((batch,) + tuple(self.out_shape), generator=gen,
                       device=device)
        return u < self.hypers.λ

    def apply(self, params, state, x, y, ctx):
        lam = self.hypers.λ
        rng = getattr(ctx, "rng", None)
        if lam >= 1 or rng is None:
            return x, state, Aux()
        masks = getattr(ctx, "masks", None) or {}
        keep = masks.get(self._uid)
        if keep is None:
            keep = self.draw_keep(fold_stream(rng, self._uid), x.shape[0],
                                  x.device)
        return torch.where(keep, x / lam, 0.0), state, Aux()


class BatchNorm(Layer):
    """Batch normalization with EMA running statistics (decay d); γ/β are
    params, m_avg / v_avg state. Train mode (`ctx.train`) normalizes with
    the batch moments, taken in fp32 whatever the activation dtype, with
    the biased variance E[x²] - m² (not `nn.BatchNorm2d`'s), over the
    global batch under a mesh's data axis (`ctx.data`), and updates
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
            # Imported here: serving (eval mode, e.g. an exported
            # artifact) needs nothing of the parallel package.
            from ..parallel.mesh import batch_moments
            m, v = batch_moments(x.float(), tuple(range(x.dim() - 1)),
                                 getattr(ctx, "data", None))
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

def _delta_cor(x, y):
    return (torch.argmax(x, dim=1) == torch.argmax(y, dim=1)).float()


class SquaredError(Layer):
    """Per-example sum-of-squares error plus the correctness indicator."""

    def apply(self, params, state, x, y, ctx):
        if y is None:
            return x, state, Aux()
        c_err = torch.sum(torch.square(x.float() - y), dim=1)
        return x, state, Aux(c_err=c_err, delta_cor=_delta_cor(x, y))


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
        return x, state, Aux(c_err=c_err, delta_cor=_delta_cor(x, y))


class SuperclassCrossEntropyError(Layer):
    """Cross-entropy against the labels projected through the hyper
    `w_cls` (n_cls, n_superclasses), with CrossEntropyError's eps-floor;
    correctness against the projected labels."""

    default_hypers = dict(w_cls=None, ϵ=1e-6)

    def build(self, x_shape):
        super().build(x_shape)
        self._w_cls = torch.as_tensor(
            np.asarray(self.hypers.w_cls, np.float32))
        self._w_on = {}  # device -> w_cls there

    def apply(self, params, state, x, y, ctx):
        if y is None:
            return x, state, Aux()
        if y.device not in self._w_on:
            self._w_on[y.device] = self._w_cls.to(y.device)
        y_sup = y @ self._w_on[y.device]
        eps = self.hypers.ϵ
        p_cls = eps / y_sup.shape[1] + (1 - eps) * x.float()
        c_err = -torch.sum(y_sup * torch.log(p_cls), dim=1)
        return x, state, Aux(c_err=c_err, delta_cor=_delta_cor(x, y_sup))


class ActivityError(Layer):
    """Activity regularizer: c_mod = α * the per-example sum of squared
    activations, a (B,) term."""

    default_hypers = dict(α=0.0)

    def apply(self, params, state, x, y, ctx):
        if y is None:
            return x, state, Aux()
        c_mod = self.hypers.α * torch.sum(torch.square(x.float()),
                                          dim=tuple(range(1, x.dim())))
        return x, state, Aux(c_mod=c_mod)


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
