"""remat_policy under the port's k_cpt sweep step, on the CPU in fp32:
for "full" and "dots", the actor sweep's steps (3 members at batch 8,
the chain of tests/test_torch_sweep_steps.py) equal the same
steps without a policy, and equal jax.vmap of mpnn_tpu's presampled step
under the same policy (`mpnn_tpu.ops.config.set_remat`), from JAX's
stacked init on the batches JAX drew. Losses to 1e-5 relative
(`VALUE_TOL`), every member's params, state and velocity to 1e-4 per leaf
(`LEAF_TOL`). The policy's checkpoint is real: "full" runs the stage's
plain version once more per stage in the backward, "dots" does not."""

import pytest
import torch

from mpnn_tpu.ops import config as jconfig
from mpnn_tpu_torch.models import steps as tsteps
from mpnn_tpu_torch.ops import config as tconfig
from mpnn_tpu_torch.ops import kernels
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils.serdes import from_numpy_tree
from mpnn_tpu_torch.utils.tree import tree_map, unstack_tree
from tests.test_torch_sr_cr import build_chain
from tests.test_torch_sweep import K_CPTS, N_NETS, N_STEPS, SCHED, B
from tests.test_torch_sweep_steps import _jax_sweep
from tests.test_torch_train import LEAF_TOL, VALUE_TOL, _assert_tree_close
from tests.torch_threads import share_cores  # noqa: F401

POLICIES = ["full", "dots"]


@pytest.fixture
def remat():
    """Both packages' remat policy, restored after the test."""
    saved = jconfig.remat_policy, tconfig.remat_policy
    yield
    jconfig.set_remat(saved[0])
    tconfig.set_remat(saved[1])


def _port_sweep(kind, init, batches, policy, n_steps):
    """The port's sweep step under `policy` for n_steps from init: the
    stacked trees, the last losses and the stage's plain-version calls."""
    tconfig.set_remat(policy)
    step = tsteps._sweep_step_body(build_chain(T, kind), B,
                                   tsteps.Schedules(**SCHED), r_shift=0)
    tp, ts, tv = from_numpy_tree(*init, device="cpu")
    gen = torch.Generator().manual_seed(0)
    k = torch.tensor(K_CPTS)
    calls = [0]
    plain = kernels.mcm_ref

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    kernels.mcm_ref = counted
    try:
        for t in range(n_steps):
            tp, ts, tv, c = step(tp, ts, tv, t, gen, *batches[t],
                                 torch.zeros(10), k)
    finally:
        kernels.mcm_ref = plain
    return (tp, ts, tv), c, calls[0]


def _assert_members_close(got, c, want, jc):
    for i in range(N_NETS):
        assert abs(float(c[i]) - float(jc[i])) <= VALUE_TOL * abs(
            float(jc[i]))
        for a, b, zero in zip(got, want, (True, False, True)):
            _assert_tree_close(unstack_tree(a, i), unstack_tree(b, i),
                               LEAF_TOL, zero_grad_biases=zero)


@pytest.mark.parametrize("policy", POLICIES)
def test_sweep_step_under_remat_matches_plain_and_jax(remat, policy):
    """Three sweep steps under the policy against the port's without one
    and against JAX's under the same policy; "full" recomputes every
    stage in the backward (on the CPU the stage's plain version runs once
    per member in a forward), "dots" saves the stage's outputs."""
    kind = "ac"
    jconfig.set_remat(policy)
    init, out, batches = _jax_sweep(kind)
    trees, c, calls = _port_sweep(kind, init, batches, policy, N_STEPS)
    ref, rc, ref_calls = _port_sweep(kind, init, batches, None, N_STEPS)
    jp, js, jv, jc = out[N_STEPS]
    _assert_members_close(trees, c, (jp, js, jv), jc)
    _assert_members_close(trees, c, tuple(
        tree_map(lambda a: a.double().numpy(), t) for t in ref), rc)
    n_stages = 3
    assert calls == ref_calls + (N_STEPS * n_stages * N_NETS
                                 if policy == "full" else 0)
