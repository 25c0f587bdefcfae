"""The port's meshes on the CPU, over gloo ranks in processes of their own
(`tests/torch_mesh_workers.py`): data parallelism over 2 ranks against
the port's single-process step at the same global batch and against
mpnn_tpu's `make_train_step(mesh=make_mesh(n_data=2))` on 2 virtual
devices, for SR, actor and critic chains; the train loop's draws
(indices, augmentation, per-example k_cpt, Dropout masks) and the
evaluator under the mesh; stacked tails under a data mesh against the
serial step, and refused with a sweep mesh; the k_cpt sweep over 2x1 and
2x2 sweep meshes against the meshless sweep.

Tolerances: losses 1e-5 relative, BatchNorm statistics 1e-4 per leaf,
parameters and velocities 1e-4 per leaf (`LEAF_TOL`), eval sums 1e-5
relative; the sweep meshes at mpnn_tpu's rtol 2e-4, atol 1e-5
(tests/test_parallel.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mpnn_tpu.models import steps as jsteps
from mpnn_tpu.parallel import make_mesh as j_make_mesh
from mpnn_tpu.parallel import replicate_tree as j_replicate
from mpnn_tpu.parallel import shard_params as j_shard_params
from mpnn_tpu_torch.models.steps import init_training
from mpnn_tpu_torch.ops import config as tconfig
from mpnn_tpu_torch.parallel import make_mesh, make_sweep_mesh, mesh
from mpnn_tpu_torch.utils.tree import tree_map
from tests import torch_mesh_workers as W
from tests.test_torch_sr_cr import random_pair
from tests.test_torch_train import (LEAF_TOL, VALUE_TOL, _assert_tree_close,
                                    _dataset, _port_batch_from_jax_draws,
                                    _randomize)
from tests.test_torch_tree import random_tree_pair
from tests.torch_threads import share_cores  # noqa: F401

B = 32  # test_torch_train's batch: 16 rows per rank
N_STEPS = 2
KINDS = ["sr", "ac", "cr"]
K_SAMPLE = [0.0, 1e-6, 1e-5]
SWEEP_K = [0.0, 1e-9, 4e-9, 1.6e-8]


@pytest.fixture(autouse=True)
def _restore_modes():
    yield
    tconfig.set_stacked_tails(False)


def _jax_batches():
    rng = jax.random.PRNGKey(7)
    return rng, [tuple(a.numpy() for a in _port_batch_from_jax_draws(
        rng, t, _dataset())) for t in range(N_STEPS)]


def _calls():
    """The data-parallel runs: each chain kind from JAX's structure of
    random params (presampled steps and the evaluator); the actor chain
    with Dropout and per-example k_cpt, whose loop draws every kind of
    draw; the small tree with stacked tails (steps and loop)."""
    _, batches = _jax_batches()
    data = _dataset()
    calls = {}
    for kind in KINDS:
        _, _, p, s = random_pair(kind)
        calls[kind] = (("chain", kind, {}), p, s, batches, data, B, False,
                       None, False)
    spec = ("chain", "ac", {"dropout": True})
    p, s, _ = init_training(W.build(spec), seed=3, device="cpu")
    rng = np.random.RandomState(4)
    p, s = (_randomize(tree_map(lambda a: a.numpy(), t), rng)
            for t in (p, s))
    calls["ac-drop"] = (spec, p, s, batches, data, B, False, K_SAMPLE,
                        True)
    _, _, p, s = random_tree_pair("ac")
    calls["tree-stacked"] = (("tree", "ac", {}), p, s, batches, data, B,
                             True, None, True)
    return calls


@pytest.fixture(scope="module")
def dp_runs():
    """{name: (rank 0's result, rank 1's result, single-process result,
    the call's arguments)} of every data-parallel run, the two ranks of
    all of them started once."""
    calls = _calls()
    names = list(calls)
    ranks = W.run_ranks(W.many, 2, [(W.data_parallel, calls[n])
                                    for n in names])
    out = {}
    for i, n in enumerate(names):
        args = calls[n]
        if n == "tree-stacked":  # the serial step, whole, on one process
            args = args[:6] + (False,) + args[7:]
        out[n] = (ranks[0][i], ranks[1][i], W.data_parallel(0, *args),
                  calls[n])
        tconfig.set_stacked_tails(False)
    return out


def _assert_run_close(a, b, tol=LEAF_TOL):
    """Trees and losses of two runs ("steps" or "loop" records) from
    random params: the biases before a train-mode BatchNorm (zero exact
    gradient) are held as noise in the velocities only."""
    p, s, v, cs = a
    rp, rs, rv, rcs = b
    np.testing.assert_allclose(cs, rcs, rtol=VALUE_TOL)
    _assert_tree_close(p, rp, tol)
    _assert_tree_close(s, rs, 1e-4)
    _assert_tree_close(v, rv, tol, zero_grad_biases=True)


@pytest.mark.parametrize("name", KINDS + ["ac-drop"])
def test_dp_matches_single_process(dp_runs, name):
    """2 ranks at a global batch of 32 (16 rows each) take the port's
    single-process step at batch 32: the presampled steps and, for the
    actor with Dropout, the train loop (its gathers, flips, shifts,
    per-example prices and Dropout masks are the global batch's, each
    rank keeping its rows), and the ranks agree exactly with each
    other."""
    r0, r1, single, _ = dp_runs[name]
    assert (r0["rows"], r1["rows"]) == ((0, 16), (16, 32))
    assert ("loop" in r0) == (name == "ac-drop")
    for part in [k for k in ("steps", "loop") if k in r0]:
        _assert_run_close(r0[part], single[part])
        _assert_tree_close(r1[part][0], r0[part][0], 0.0)
        assert r1[part][3] == r0[part][3]


@pytest.mark.parametrize("name", KINDS)
def test_dp_eval_matches_single_process(dp_runs, name):
    """The evaluator under the data mesh (each rank's rows of every batch,
    the sums all-reduced) gives the meshless sums on every rank."""
    r0, r1, single, _ = dp_runs[name]
    assert sorted(r0["eval"]) == sorted(single["eval"])
    for k, v in single["eval"].items():
        np.testing.assert_allclose(r0["eval"][k], v, rtol=VALUE_TOL,
                                   atol=1e-6 * max(1.0, np.abs(v).max()),
                                   err_msg=k)
        np.testing.assert_array_equal(r1["eval"][k], r0["eval"][k])


def _jax_mesh_steps(kind, p, s):
    """mpnn_tpu's make_train_step over a 2-device data mesh, N_STEPS steps
    from (p, s) on its own draws: (params, state, vel, losses)."""
    from tests.test_torch_sr_cr import build_chain
    from mpnn_tpu.ops import layers as J
    jnet = build_chain(J, kind)
    m = j_make_mesh(n_data=2, n_model=1, devices=jax.devices()[:2])
    jp = j_shard_params(jax.tree.map(jnp.asarray, p), m)
    js = j_replicate(jax.tree.map(jnp.asarray, s), m)
    jv = j_shard_params(jax.tree.map(jnp.zeros_like, jp), m)
    sched = jsteps.Schedules(lr=lambda t: W.LR,
                             tau=lambda t: W.TAU0 / 2 ** (t / 2))
    step = jsteps.make_train_step(jnet, B, sched, mesh=m)
    x0, y, m_sym = (j_replicate(jnp.asarray(a), m) for a in _dataset())
    rng, _ = _jax_batches()
    cs = []
    for t in range(N_STEPS):
        jp, js, jv, c = step(jp, js, jv, t, rng, x0, y, m_sym)
        cs.append(float(c))
    return (*jax.tree.map(np.asarray, (jp, js, jv)), cs)


@pytest.mark.parametrize("name", KINDS)
def test_dp_matches_jax_mesh_step(dp_runs, name):
    """The port's 2-rank step equals mpnn_tpu's step over a 2-device data
    mesh from the same params (fed the batches JAX's steps drew)."""
    r0, _, _, call = dp_runs[name]
    _assert_run_close(r0["steps"], _jax_mesh_steps(name, call[1], call[2]))


def test_stacked_tails_under_data_mesh_match_serial(dp_runs):
    """The small tree with stacked tails over a 2-rank data mesh (its
    congruent tails vmapped, their BatchNorms reduced across ranks inside
    the vmap) equals the serial step on one process."""
    r0, r1, serial, _ = dp_runs["tree-stacked"]
    for part in ("steps", "loop"):
        _assert_run_close(r0[part], serial[part])
        _assert_tree_close(r1[part][0], r0[part][0], 0.0)


def test_stacked_tails_refused_with_sweep_mesh():
    """As mpnn_tpu's make_sweep_train_loop: refused when the loop is made,
    and when it runs after the flag was set later."""
    from mpnn_tpu_torch.models import steps
    net = W.build_tree("ac")
    smesh = make_sweep_mesh()
    assert smesh.shape == {"sweep": 1, "data": 1}
    tconfig.set_stacked_tails(True)
    with pytest.raises(ValueError, match="sweep mesh"):
        steps.make_sweep_train_loop(net, 8, W.schedules(), mesh=smesh)
    tconfig.set_stacked_tails(False)
    loop = steps.make_sweep_train_loop(net, 8, W.schedules(), mesh=smesh)
    tconfig.set_stacked_tails(True)
    with pytest.raises(ValueError, match="sweep mesh"):
        loop(None, None, None, 0, 0, None, None, None, 1, None)


def test_model_axis_not_ported():
    """n_model > 1 raises, naming the roadmap item; a process without a
    process group is a mesh of one rank."""
    with pytest.raises(NotImplementedError, match="A9"):
        make_mesh(n_data=1, n_model=2)
    m = make_mesh()
    assert m.shape == {"data": 1, "model": 1} and not m.data.reduces
    assert mesh.world() == (0, 1)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(n_data=2)


@pytest.fixture(scope="module")
def sweep_members():
    return [random_pair("ac", seed=10 + i)[2:] for i in range(4)]


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)])
def test_sweep_mesh_matches_meshless(sweep_members, shape):
    """The 4-net actor sweep over a (sweep, data) mesh: each rank trains
    its 2 members (with 2 data ranks, on its 8 of each batch's 16 rows),
    and every member ends as the meshless sweep's member does (losses and
    trees at rtol 2e-4, atol 1e-5)."""
    n_sweep, n_data = shape
    args = (("chain", "ac", {}), sweep_members, SWEEP_K)
    tail = (_dataset(), 16, 3)
    ref = W.sweep_mesh(0, *args, 1, 1, *tail)
    ranks = W.run_ranks(W.sweep_mesh, n_sweep * n_data, *args, n_sweep,
                        n_data, *tail)
    for rank, r in enumerate(ranks):
        s, d = r["coords"]
        assert (s, d) == divmod(rank, n_data)
        lo = 2 * s
        np.testing.assert_allclose(r["losses"], ref["losses"][:, lo:lo + 2],
                                   rtol=2e-4, atol=1e-5)
        for got, want in zip(r["trees"], ref["trees"]):
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(a, b[lo:lo + 2], rtol=2e-4,
                                           atol=1e-5)
