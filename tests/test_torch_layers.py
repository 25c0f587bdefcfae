"""Layers of the PyTorch port (mpnn_tpu_torch.ops.layers) against mpnn_tpu's,
on the CPU in fp32: the same numpy inputs and parameters go through both,
outputs agree to atol 1e-5 and n_ops exactly."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.models.net import Ctx as JCtx
from mpnn_tpu.ops import layers as J
from mpnn_tpu_torch.models.net import Ctx as TCtx
from mpnn_tpu_torch.ops import config as tconfig
from mpnn_tpu_torch.ops import layers as T
from tests.torch_threads import share_cores  # noqa: F401

ATOL = 1e-5


def _np(tree):
    """numpy view of a jax or torch tree (lists of arrays included)."""
    if isinstance(tree, (list, tuple)):
        return [_np(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().numpy()
    return np.asarray(tree, np.float32)


def _to_jax(tree):
    if isinstance(tree, (list, tuple)):
        return [_to_jax(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _to_torch(tree):
    if isinstance(tree, (list, tuple)):
        return [_to_torch(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree))


def _random_like(tree, rng):
    """Replace every array of a param/state tree by seeded random values
    (variances kept positive)."""
    if isinstance(tree, list):
        return [_random_like(t, rng) for t in tree]
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                out[k] = _random_like(v, rng)
            elif k == "v_avg":
                out[k] = rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)
            else:
                out[k] = (0.5 * rng.standard_normal(np.shape(v))
                          ).astype(np.float32)
        return out
    raise TypeError(type(tree))


def _assert_close(a, b, atol=ATOL):
    a, b = _np(a), _np(b)
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_close(x, y, atol)
        return
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, atol=atol, rtol=0)


def _run_both(make, x_shape, x_np, y_np=None, seed=0):
    """Build the layer in both packages, carry JAX's (randomized) params
    and state over, apply both in eval mode; returns both results and
    layers."""
    jl, tl = make(J), make(T)
    jl.build(x_shape)
    tl.build(x_shape)
    rng = np.random.RandomState(seed)
    p = _random_like(_np(jl.init(jax.random.PRNGKey(0), x_shape)), rng)
    s = _random_like(_np(jl.init_state(x_shape)), rng)
    jo = jl.apply(_to_jax(p), _to_jax(s), _to_jax(x_np),
                  None if y_np is None else jnp.asarray(y_np), JCtx())
    to = tl.apply(_to_torch(p), _to_torch(s), _to_torch(x_np),
                  None if y_np is None else torch.as_tensor(y_np), TCtx())
    return jo, to, jl, tl


def _pyramid(rng, b, shapes):
    return [rng.rand(b, *s).astype(np.float32) for s in shapes]


PYR = [(16, 16, 4), (8, 8, 4), (4, 4, 4)]

CASES = {
    "lintrans_on_select": (
        lambda L: L.Chain(comps=[L.Select(i=-1),
                                 L.LinTrans(n_chan=6, k_l2=1e-2)]), PYR),
    "lintrans_res": (lambda L: L.LinTrans(n_chan=64, res=True, k_l2=1e-2),
                     (4, 4, 4)),
    "rect": (lambda L: L.Rect(), (4, 4, 4)),
    "softmax": (lambda L: L.Softmax(), (10,)),
    "multiscale_rect": (lambda L: L.MultiscaleRect(), PYR),
    "select": (lambda L: L.Select(i=1), PYR),
    "batchnorm_eval": (lambda L: L.BatchNorm(), (4, 4, 4)),
    "multiscale_batchnorm_eval": (lambda L: L.MultiscaleBatchNorm(), PYR),
    "mcm_fused_shape": (
        lambda L: L.MultiscaleConvMax(n_chan=[8, 8, 8], supp=3, k_l2=1e-3),
        PYR),
    "mcm_two_of_three": (
        lambda L: L.MultiscaleConvMax(n_chan=[6, 5], supp=3, k_l2=1e-3),
        PYR),
    "mcm_clipped_kernel": (
        lambda L: L.MultiscaleConvMax(n_chan=[4, 4], supp=3),
        [(4, 4, 3), (2, 2, 3)]),
    "mcm_odd_dims": (
        lambda L: L.MultiscaleConvMax(n_chan=[4, 4], supp=3),
        [(5, 6, 3), (3, 3, 3)]),
    "router_chain": (
        lambda L: L.Chain(comps=[
            L.Select(i=-1), L.LinTrans(n_chan=16), L.BatchNorm(), L.Rect(),
            L.LinTrans(n_chan=16), L.BatchNorm(), L.Rect(),
            L.LinTrans(n_chan=2)]), PYR),
    "reconvmax_chain": (
        lambda L: L.Chain(comps=[
            L.MultiscaleConvMax(n_chan=[8, 8, 8], supp=3, k_l2=1e-3),
            L.MultiscaleBatchNorm(), L.MultiscaleRect()]), PYR),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_layer_matches_jax(name):
    make, shape = CASES[name]
    rng = np.random.RandomState(1)
    x = (_pyramid(rng, 3, shape) if isinstance(shape, list)
         else rng.randn(3, *shape).astype(np.float32))
    jo, to, jl, tl = _run_both(make, shape, x)
    _assert_close(jo[0], to[0])
    assert tl.n_ops == jl.n_ops
    assert (tl.out_shape == jl.out_shape
            or [tuple(s) for s in tl.out_shape]
            == [tuple(s) for s in jl.out_shape])


@pytest.mark.parametrize("name", ["lintrans_on_select", "lintrans_res",
                                  "mcm_fused_shape", "reconvmax_chain"])
def test_weight_penalty_matches_jax(name):
    """With a label batch given, c_mod (the L2 penalty) agrees too."""
    make, shape = CASES[name]
    rng = np.random.RandomState(2)
    x = (_pyramid(rng, 3, shape) if isinstance(shape, list)
         else rng.randn(3, *shape).astype(np.float32))
    y = np.eye(10, dtype=np.float32)[[1, 4, 7]]
    jo, to, _, _ = _run_both(make, shape, x, y)
    np.testing.assert_allclose(float(to[2].c_mod), float(jo[2].c_mod),
                               rtol=1e-5)


def test_to_pyramid_matches_jax_antialias():
    """jax.image.resize antialiases when it shrinks; 32 -> 16/8/4."""
    make = lambda L: L.ToPyramid(n_scales=4)  # noqa: E731
    x = np.random.RandomState(3).rand(2, 32, 32, 3).astype(np.float32)
    jo, to, jl, tl = _run_both(make, (32, 32, 3), x)
    assert [t.shape[1] for t in to[0]] == [32, 16, 8, 4]
    _assert_close(jo[0], to[0])
    assert tl.out_shape == jl.out_shape


def test_cross_entropy_matches_jax():
    rng = np.random.RandomState(4)
    logits = rng.randn(5, 10).astype(np.float32)
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 5)]
    jo, to, _, _ = _run_both(lambda L: L.CrossEntropyError(), (10,), p, y)
    _assert_close(jo[2].c_err, to[2].c_err)
    _assert_close(jo[2].delta_cor, to[2].delta_cor)


def test_leaf_chain_matches_jax():
    """The early-exit LogReg leaf: Select -> LinTrans -> Softmax -> CE."""
    make = lambda L: L.Chain(comps=[  # noqa: E731
        L.Select(i=-1), L.LinTrans(n_chan=10), L.Softmax(),
        L.CrossEntropyError()])
    rng = np.random.RandomState(5)
    x = _pyramid(rng, 4, PYR)
    y = np.eye(10, dtype=np.float32)[[0, 3, 3, 9]]
    jo, to, _, _ = _run_both(make, PYR, x, y)
    _assert_close(jo[0], to[0])
    _assert_close(jo[2].c_err, to[2].c_err)


@pytest.mark.parametrize("shape", [(8, 8, 3), (7, 5, 2)])
def test_pool2_matches_jax(shape):
    x = np.random.RandomState(6).randn(2, *shape).astype(np.float32)
    _assert_close(J._pool2(jnp.asarray(x)), T._pool2(torch.as_tensor(x)))


@pytest.mark.parametrize("k", [3, 2])
def test_conv_same_matches_jax(k):
    """SAME padding agrees for odd and clipped even kernels."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 6, 3).astype(np.float32)
    w = rng.randn(k, k, 3, 4).astype(np.float32)
    _assert_close(J.conv_same(jnp.asarray(x), jnp.asarray(w)),
                  T.conv_same(torch.as_tensor(x), torch.as_tensor(w)))


def test_batchnorm_bf16_matches_jax():
    """Under bf16 activations BN folds into one fp32-computed affine."""
    rng = np.random.RandomState(8)
    x = rng.randn(4, 4, 4, 8).astype(np.float32)
    jl, tl = J.BatchNorm(), T.BatchNorm()
    jl.build((4, 4, 8))
    tl.build((4, 4, 8))
    p = _random_like(_np(jl.init(jax.random.PRNGKey(0), (4, 4, 8))), rng)
    s = _random_like(_np(jl.init_state((4, 4, 8))), rng)
    jo = jl.apply(_to_jax(p), _to_jax(s), jnp.asarray(x, jnp.bfloat16),
                  None, JCtx())[0]
    to = tl.apply(_to_torch(p), _to_torch(s),
                  torch.as_tensor(x).to(torch.bfloat16), None, TCtx())[0]
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(to), _np(jo), atol=0.05, rtol=0.02)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_batchnorm_train_matches_jax(dtype):
    """Train mode: batch moments in fp32 (the biased variance E[x²] - m²),
    the EMA of the running statistics, and the output, fp32 and under bf16
    activations; the EMA carries no gradient."""
    rng = np.random.RandomState(9)
    x = (2.0 + 3.0 * rng.randn(6, 5, 4, 8)).astype(np.float32)
    jl, tl = J.BatchNorm(d=0.8), T.BatchNorm(d=0.8)
    jl.build((5, 4, 8))
    tl.build((5, 4, 8))
    p = _random_like(_np(jl.init(jax.random.PRNGKey(0), (5, 4, 8))), rng)
    s = _random_like(_np(jl.init_state((5, 4, 8))), rng)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = torch.as_tensor(x).to(torch.bfloat16 if dtype == "bf16"
                               else torch.float32).requires_grad_()
    jo, js, _ = jl.apply(_to_jax(p), _to_jax(s), jx, None,
                         JCtx(train=True))
    to, ts, _ = tl.apply(_to_torch(p), _to_torch(s), tx, None,
                         TCtx(train=True))
    assert to.dtype == tx.dtype
    for k in ("m_avg", "v_avg"):
        assert ts[k].dtype == torch.float32 and not ts[k].requires_grad
        np.testing.assert_allclose(_np(ts[k]), _np(js[k]), rtol=1e-5,
                                   atol=1e-6)
    # The biased variance: v_avg = d * v0 + (1 - d) * (E[x²] - m²).
    xf = np.asarray(jx, np.float64).reshape(-1, 8)
    np.testing.assert_allclose(
        _np(ts["v_avg"]), 0.8 * s["v_avg"] + 0.2 * xf.var(axis=0),
        rtol=1e-5)
    if dtype == "fp32":
        _assert_close(to, jo)
    else:
        np.testing.assert_allclose(_np(to), _np(jo), atol=0.05, rtol=0.02)


def test_compute_dtype_policy():
    """bf16 policy: convs and matmuls emit bf16, softmax stays fp32."""
    tconfig.set_compute_dtype(torch.bfloat16)
    try:
        x = torch.rand(2, 4, 4, 3)
        assert T.conv_same(x, torch.rand(3, 3, 3, 5)).dtype == torch.bfloat16
        assert T._matmul(x.reshape(2, -1),
                         torch.rand(48, 4)).dtype == torch.bfloat16
        out = T.Softmax().apply({}, {}, torch.rand(2, 10).to(torch.bfloat16),
                                None, TCtx())[0]
        assert out.dtype == torch.float32
    finally:
        tconfig.set_compute_dtype(None)
    with pytest.raises(ValueError):
        tconfig.set_compute_dtype(torch.float16)


def test_nfkc_hypers():
    """Raw 'ϵ' (U+03F5) record keys land on the class's 'ε' hyper."""
    bn = T.BatchNorm(**{"ϵ": 1e-3})
    assert bn.hypers.ε == 1e-3
    assert T.nfkc_hypers({"ϵ": 1}) == J.nfkc_hypers({"ϵ": 1})
    with pytest.raises(ValueError):
        T.nfkc_hypers({"ϵ": 1, "ε": 2})
