"""bf16 training of the port held against a yardstick measured in the same
run, on the CPU: one step's loss and gradients of the 3-stage actor chain
of tests/test_torch_train.py, from the same parameter arrays and batch, in
both packages, in fp32 and in bf16. The port's bf16 loss is within 1e-3
relative of JAX's bf16 loss; the distance of the port's bf16 gradients
from its own fp32 gradients (relative L2 over the whole tree, as
chip_smoke.tree_errs measures it) is at most 2x JAX's bf16-to-fp32
distance, and the worst leaf's at most 3x JAX's worst leaf. The biases
right before a train-mode BatchNorm, whose exact gradient is zero, are
left out."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.ops import config as jconfig
from mpnn_tpu_torch.models.net import Ctx as TCtx
from mpnn_tpu_torch.ops import config as tconfig
from mpnn_tpu_torch.utils.serdes import from_numpy_tree
from tests.test_torch_train import (EPS, K_CPT, TAU, _batch,
                                    _jax_loss_and_grads, _np, _pair, _paths,
                                    _port_loss_and_grads)
from tests.torch_threads import share_cores  # noqa: F401

LOSS_TOL = 1e-3  # port bf16 loss against JAX bf16 loss, relative
TREE_FACTOR = 2.0  # port's bf16-to-fp32 distance over JAX's, whole tree
LEAF_FACTOR = 3.0  # the same for the worst leaf


def _distances(a, b):
    """(whole-tree relative L2, worst leaf relative L2, its path) of
    gradient tree `a` against `b`, over the leaves whose exact gradient is
    not zero."""
    num = den = worst = 0.0
    at = None
    for (path, x, zero), (_, y, _) in zip(_paths(a), _paths(b)):
        if zero:
            continue
        d, n = np.linalg.norm(x - y), np.linalg.norm(y)
        num, den = num + d * d, den + n * n
        if n and d / n > worst:
            worst, at = d / n, path
    return (num / den) ** 0.5, worst, at


def _step(jnet, tnet, p, s, x, y, bf16):
    """(JAX's loss and gradients, the port's) of one step in one type."""
    jconfig.set_compute_dtype(jnp.bfloat16 if bf16 else None)
    tconfig.set_compute_dtype(torch.bfloat16 if bf16 else None)
    try:
        (jc, _), jg = _jax_loss_and_grads(jnet, p, s, x, y)
        tp, ts = from_numpy_tree(p, s, device="cpu")
        tc, _, _, tg = _port_loss_and_grads(
            tnet, tp, ts, torch.as_tensor(x), torch.as_tensor(y),
            TCtx(train=True, tau=TAU, eps=EPS, k_cpt=K_CPT))
    finally:
        jconfig.set_compute_dtype(None)
        tconfig.set_compute_dtype(None)
    return (float(jc), _np(jg)), (float(tc), _np(tg))


@pytest.fixture(scope="module")
def steps():
    jnet, tnet, p, s = _pair()
    x, y = _batch()
    return {dt: _step(jnet, tnet, p, s, x, y, dt == "bf16")
            for dt in ("fp32", "bf16")}


def test_bf16_loss_matches_jax_bf16(steps):
    (jc, _), (tc, _) = steps["bf16"]
    print("bf16 loss: port %r, jax %r" % (tc, jc))
    assert abs(tc - jc) <= LOSS_TOL * abs(jc)


def test_bf16_gradients_no_farther_from_fp32_than_jax(steps):
    (_, jg32), (_, tg32) = steps["fp32"]
    (_, jg16), (_, tg16) = steps["bf16"]
    port = _distances(tg16, tg32)
    jax_ = _distances(jg16, jg32)
    print("bf16 to fp32 gradients: port tree %.4g, leaf %.4g (%s); jax "
          "tree %.4g, leaf %.4g (%s)" % (port + jax_))
    assert port[0] > 0 and jax_[0] > 0  # bf16 really rounded
    assert port[0] <= TREE_FACTOR * jax_[0]
    assert port[1] <= LEAF_FACTOR * jax_[1]
