"""Whole sweep steps of the port against mpnn_tpu's on the CPU: the
actor (TALR) and critic chains, 3 members at batch 8 stacked from JAX's
init_training, one and three steps of the port's sweep step against
jax.vmap of mpnn_tpu's presampled train step on the same batches: every
member's params, state and velocity to 1e-4 per leaf, losses to 1e-5.
Nets are the 3-stage chains on 16x16 inputs of tests/test_torch_sr_cr.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.data.augment import augment_presampled as j_augment_presampled
from mpnn_tpu.models import steps as jsteps
from mpnn_tpu.ops import layers as J
from mpnn_tpu_torch.data.augment import flip_batch, shift_batch
from mpnn_tpu_torch.models import steps as tsteps
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils.serdes import from_numpy_tree
from mpnn_tpu_torch.utils.tree import unstack_tree
from tests.test_torch_sr_cr import build_chain
from tests.test_torch_sweep import (B, K_CPTS, N_NETS, N_STEPS, SCHED,
                                    _raw_batches)
from tests.test_torch_train import (LEAF_TOL, VALUE_TOL, _assert_tree_close,
                                    _dataset)


def _port_batch_from_jax_draws(rng, t, xb, yb, m_sym, r_shift=4):
    """The batch JAX's presampled step t augments, made by the port: the
    key split as `_step_pieces` and `augment_presampled` split it, its
    draws read out and handed to shift_batch / flip_batch. Checked
    against JAX's own."""
    k_aug = jax.random.split(jax.random.fold_in(rng, t), 3)[0]
    k_flip, k_shift = jax.random.split(k_aug)
    coin = np.array(jax.random.bernoulli(k_flip, 0.5, (B,)))
    duv = np.array(jax.random.randint(k_shift, (B, 2), -r_shift,
                                      r_shift + 1))
    x, y = torch.as_tensor(xb), torch.as_tensor(yb)
    do_flip = torch.as_tensor(coin) & (y @ torch.as_tensor(m_sym) != 0)
    x = shift_batch(flip_batch(x, do_flip), torch.as_tensor(duv[:, 0]),
                    torch.as_tensor(duv[:, 1]))
    jx, jy = j_augment_presampled(k_aug, jnp.asarray(xb), jnp.asarray(yb),
                                  jnp.asarray(m_sym), r_shift)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    return x, y


def _jax_sweep(kind):
    """jax.vmap of mpnn_tpu's presampled step over N_NETS members drawn
    by init_training(seed i), at K_CPTS, for N_STEPS steps: the stacked
    init, the stacked trees and losses after each step, and each step's
    augmented batch re-made by the port from JAX's draws."""
    jnet = build_chain(J, kind)
    _, _, m_sym = _dataset()
    step = jsteps._train_step_body(jnet, B, jsteps.Schedules(**SCHED),
                                   presampled=True)
    vstep = jax.jit(jax.vmap(step, in_axes=(0, 0, 0, None, None, None,
                                            None, None, 0)))
    init = jax.jit(lambda: [jsteps.stack_trees(list(t)) for t in zip(
        *(jsteps.init_training(jnet, seed=i) for i in range(N_NETS)))])()
    ps, ss, vs = init
    init = jax.tree.map(np.array, init)
    rng = jax.random.PRNGKey(7)
    k = jnp.asarray(K_CPTS, jnp.float32)
    out, batches = {}, []
    for t, (xb, yb) in enumerate(_raw_batches()):
        batches.append(_port_batch_from_jax_draws(rng, t, xb, yb, m_sym))
        ps, ss, vs, c = vstep(ps, ss, vs, t, rng, jnp.asarray(xb),
                              jnp.asarray(yb), jnp.asarray(m_sym), k)
        out[t + 1] = jax.tree.map(np.array, (ps, ss, vs, c))
    return init, out, batches


@pytest.fixture(scope="module", params=["ac", "cr"])
def jax_sweep(request):
    return (request.param,) + _jax_sweep(request.param)


@pytest.mark.parametrize("n_steps", [1, N_STEPS])
def test_sweep_steps_match_jax(jax_sweep, n_steps):
    """Whole sweep steps of the actor (TALR) and critic chains: every
    member's params, state and velocity per leaf, and the (n_nets,)
    losses, after 1 and 3 steps from JAX's stacked init, on the batches
    JAX's steps saw (fed presampled, augmentation off on the port's
    side)."""
    kind, init, out, batches = jax_sweep
    tnet = build_chain(T, kind)
    step = tsteps._sweep_step_body(tnet, B, tsteps.Schedules(**SCHED),
                                   r_shift=0)
    tp, ts, tv = from_numpy_tree(*init, device="cpu")
    gen = torch.Generator().manual_seed(0)
    k = torch.tensor(K_CPTS)
    for t in range(n_steps):
        tp, ts, tv, c = step(tp, ts, tv, t, gen, *batches[t],
                             torch.zeros(10), k)
    jp, js, jv, jc = out[n_steps]
    assert c.shape == (N_NETS,) and c.dtype == torch.float32
    assert len(set(c.tolist())) == N_NETS  # the prices tell members apart
    for i in range(N_NETS):
        assert abs(float(c[i]) - float(jc[i])) <= VALUE_TOL * abs(
            float(jc[i]))
        _assert_tree_close(unstack_tree(tp, i), unstack_tree(jp, i),
                           LEAF_TOL, zero_grad_biases=True)
        _assert_tree_close(unstack_tree(ts, i), unstack_tree(js, i),
                           LEAF_TOL)
        _assert_tree_close(unstack_tree(tv, i), unstack_tree(jv, i),
                           LEAF_TOL, zero_grad_biases=True)
