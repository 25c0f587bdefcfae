"""The mesh's 'model' axis on the CPU, over gloo ranks in processes of
their own (`tests/torch_mesh_workers.py`): params and velocity sharded by
`shard_params(model_parallel=True, min_chan=8)` on tests/test_parallel.py's
net, `pyr(rcm([8, 8, 8], reg(10), rcm([8, 8], reg(10))))`, where the
MultiscaleConvMax, router and leaf weights all shard.

- The spec rule: `shard_params` keeps the block of every leaf that
  `mpnn_tpu`'s `shard_params` places on the same model index, at
  min_chan 8 and 64; `unshard_params` gives the whole leaves back.
- 1x2 and 2x2 meshes, SR, actor and critic: 2 presampled steps against
  the port's single-process step, and (2x2) against `mpnn_tpu`'s
  `make_train_step` over a 2x2 mesh of virtual devices with the same
  sharding; the train loop on the 2x2 mesh.
- Gradients: each rank's gradient of a sharded leaf is its block of the
  single process's (a sum over the ranks in a backward would double it).
- The evaluator under 2x2; the small tree under 1x2, serial and with
  stacked tails, steps and loop; the actor's step under 1x2 with the
  analytic L2 (its value's partial sums over 'model').
- The CLI: `train synth-ac --net 4 --mesh 1x2` (params replicated along
  'model', as `scripts/train-nets`) writes the single run's files, bit
  for bit.

Tolerances are the data-mesh tests' (tests/test_torch_parallel.py):
losses 1e-5 relative (`VALUE_TOL`), parameters, velocities and gradients
1e-4 per leaf (`LEAF_TOL`), BatchNorm statistics 1e-4, eval sums 1e-5."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.models import steps as jsteps
from mpnn_tpu.parallel import make_mesh as j_make_mesh
from mpnn_tpu.parallel import replicate_tree as j_replicate
from mpnn_tpu.parallel import shard_params as j_shard_params
from mpnn_tpu_torch.data.prep import save_archive
from mpnn_tpu_torch.data.synth import make_synthetic
from mpnn_tpu_torch.parallel.mesh import Axis, Mesh, shard_params
from mpnn_tpu_torch.utils.serdes import read_net
from mpnn_tpu_torch.utils.tree import tree_leaves, tree_map
from tests import torch_mesh_workers as W
from tests.test_torch_parallel import B, _jax_batches
from tests.test_torch_parallel import _assert_run_close as _assert_chain_close
from tests.test_torch_train import (LEAF_TOL, VALUE_TOL, _assert_tree_close,
                                    _dataset, _np, _randomize)
from tests.test_torch_tree import random_tree_pair
from tests.torch_threads import share_cores  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
KINDS = ["sr", "ac", "cr"]
MIN_CHAN = 8
# The 11 sharded leaves of the net at min_chan 8: the 5 + 3
# MultiscaleConvMax weights, the router's 8-wide LinTrans, the 2 leaves'
# 10-wide LinTrans (the router's 2-wide LinTrans stays whole).
N_SHARDED = 11


def _jax_net(kind):
    from mpnn_tpu.models import ActorNet, CriticNet, SRNet
    from tests.test_train_e2e import pyr, rcm, reg
    root = pyr(rcm([8, 8, 8], reg(10), rcm([8, 8], reg(10))))
    cls = {"sr": SRNet, "ac": ActorNet, "cr": CriticNet}[kind]
    kw = {} if kind == "sr" else {"k_cpt": W.K_CPT}
    return cls(x0_shape=(16, 16, 3), y_shape=(10,), root=root, **kw)


def _random_params(kind, seed=4):
    """Seeded random (params, state) in JAX's structure of the net."""
    shapes = jax.eval_shape(_jax_net(kind).init, jax.random.PRNGKey(0))
    p, s = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    rng = np.random.RandomState(seed)
    return _randomize(p, rng), _randomize(s, rng)


def _spec(kind):
    return ("tp", kind, {})


def _leaves_zero(tree, path=""):
    """[(path, numpy leaf, exact gradient zero)] of a params-shaped tree of
    the net: the biases right before a train-mode BatchNorm, which are its
    stages' last-scale biases and its router's first (of two) dense
    bias (`tests.test_torch_train._paths` for this router's shape)."""
    tree = _np(tree)
    if isinstance(tree, dict):
        last_b = "b_%d" % (sum(k.startswith("b_") for k in tree) - 1)
        return [(p, a, z or k == last_b) for k in sorted(tree)
                for p, a, z in _leaves_zero(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [e for i, t in enumerate(tree)
                for e in _leaves_zero(t, f"{path}[{i}]")]
    return [(path, tree, path.endswith("/router/comps[1]/b"))]


def _assert_close(t, j, tol, zero_grad_biases=False):
    """`_assert_tree_close` over this net's zero-gradient biases."""
    tp, jp = _leaves_zero(t), _leaves_zero(j)
    assert [e[0] for e in tp] == [e[0] for e in jp]
    total = np.sqrt(sum(np.sum(np.square(e[1])) for e in jp))
    for (path, a, zero), (_, b, _) in zip(tp, jp):
        assert a.shape == b.shape, path
        if zero_grad_biases and zero:
            assert max(np.linalg.norm(a), np.linalg.norm(b)) <= (
                1e-6 * total), path
            continue
        err = np.linalg.norm(a - b)
        assert err <= tol * np.linalg.norm(b), (path, err,
                                                np.linalg.norm(b))


def _assert_run_close(a, b, tol=LEAF_TOL):
    """`tests.test_torch_parallel._assert_run_close` for this net."""
    p, s, v, cs = a
    rp, rs, rv, rcs = b
    np.testing.assert_allclose(cs, rcs, rtol=VALUE_TOL)
    _assert_close(p, rp, tol)
    _assert_close(s, rs, 1e-4)
    _assert_close(v, rv, tol, zero_grad_biases=True)


def _jax_block(a, min_chan, index, n_model=2):
    """The block of `a` that mpnn_tpu's shard_params puts on model index
    `index` of a 1 x n_model mesh."""
    devs = jax.devices()[:n_model]
    m = j_make_mesh(n_data=1, n_model=n_model, devices=devs)
    arr = j_shard_params({"a": jnp.asarray(a)}, m, model_parallel=True,
                         min_chan=min_chan)["a"]
    return next(np.asarray(sh.data) for sh in arr.addressable_shards
                if sh.device == devs[index])


@pytest.mark.parametrize("min_chan", [8, 64])
def test_shard_params_matches_jax_model_spec(min_chan):
    """On the net's own shapes and the flagship's (16-128 channel
    stages, 16-wide routers, 10-class leaves), with 1-D leaves, every
    rank's block equals the one mpnn_tpu places on its model index."""
    p, _ = _random_params("ac")
    rng = np.random.RandomState(0)
    extra = {"w%d" % i: rng.standard_normal(shp).astype(np.float32)
             for i, shp in enumerate([(3, 3, 32, 64), (3, 3, 64, 64),
                                      (3, 3, 64, 128), (3, 3, 16, 32),
                                      (1024, 16), (16, 10), (16, 2),
                                      (64,), (10,), (3, 3, 3, 12)])}
    tree = {"net": p, "extra": extra}
    n_sharded = 0
    for index in range(2):
        mesh = Mesh(("data", "model"), [Axis(1, 0), Axis(2, index)])
        got = shard_params(tree_map(torch.as_tensor, tree), mesh,
                           model_parallel=True, min_chan=min_chan)
        for a, b in zip(tree_leaves(got), tree_leaves(tree)):
            want = _jax_block(b, min_chan, index)
            np.testing.assert_array_equal(a.numpy(), want)
            n_sharded += a.shape != b.shape
        same = shard_params(tree_map(torch.as_tensor, tree), mesh)
        assert all(a.shape == np.shape(b) for a, b in
                   zip(tree_leaves(same), tree_leaves(tree)))
    expect = {8: N_SHARDED + 7, 64: 3}[min_chan]
    assert n_sharded == 2 * expect


@pytest.fixture(scope="module")
def tp_runs():
    """{(shape, name): (the ranks' results, the single-process result,
    (p, s))} of every run on a 2x2 mesh (one start of 4 ranks) and on a
    1x2 mesh (one start of 2 ranks)."""
    batches = _jax_batches()[1]
    data = _dataset()
    calls = {}
    for kind in KINDS:
        p, s = _random_params(kind)
        calls[((2, 2), kind)] = (_spec(kind), p, s, data, False, False)
        calls[((1, 2), kind)] = (_spec(kind), p, s, None, False, False)
    calls[((1, 2), "ac-analytic-l2")] = (_spec("ac"), p, s, None, False,
                                         True)
    _, _, tp, ts = random_tree_pair("ac")
    for stacked in (False, True):
        calls[((1, 2), "tree-stacked" if stacked else "tree")] = (
            ("tree", "ac", {}), tp, ts, data, stacked, False)
    out = {}
    for shape in ((2, 2), (1, 2)):
        names = [k for k in calls if k[0] == shape]
        ranks = W.run_ranks(W.many, shape[0] * shape[1], [
            (W.model_parallel, (spec, p, s, batches, B, shape, MIN_CHAN,
                                d, st, l2))
            for spec, p, s, d, st, l2 in (calls[k] for k in names)])
        for i, key in enumerate(names):
            spec, p, s, d, _, l2 = calls[key]
            single = W.model_parallel(0, spec, p, s, batches, B, (1, 1),
                                      MIN_CHAN, d, False, l2)
            out[key] = ([r[i] for r in ranks], single, (p, s))
    return out


@pytest.mark.parametrize("shape, kind", [
    (shape, kind) for shape in [(1, 2), (2, 2)] for kind in KINDS] + [
    ((1, 2), "ac-analytic-l2")])
def test_tp_step_matches_single_process(tp_runs, shape, kind):
    """2 steps over the mesh equal the single process's at the global
    batch of 32 (the 2x2 mesh: 16 rows a data index), and every rank
    ends with the same whole params; on the 2x2 mesh the loop too."""
    ranks, single, _ = tp_runs[(shape, kind)]
    for r in ranks:
        assert len(r["sharded"]) == N_SHARDED and all(r["roundtrip"])
    assert [r["coords"] for r in ranks] == [
        divmod(i, 2) for i in range(len(ranks))]
    parts = ("steps", "loop") if shape == (2, 2) else ("steps",)
    for part in parts:
        _assert_run_close(ranks[0][part], single[part])
        for r in ranks[1:]:
            _assert_tree_close(r[part][0], ranks[0][part][0], 0.0)
            np.testing.assert_allclose(r[part][3], ranks[0][part][3],
                                       rtol=VALUE_TOL)


def _block_of(tree, like, index):
    """`tree`'s leaves cut to the shape of `like`'s (the block of model
    index `index` of each sharded leaf)."""
    def cut(a, b):
        if a.shape == b.shape:
            return a
        k = b.shape[-1]
        return a[..., index * k:(index + 1) * k]
    return tree_map(cut, tree, like)


@pytest.mark.parametrize("kind", KINDS)
def test_tp_gradients_are_blocks_of_single_process(tp_runs, kind):
    """Each rank's gradient (after the step's all-reduce over 'data') of
    every sharded leaf equals its block of the single process's, and of
    every whole leaf the whole gradient: a sum over the 'model' ranks in
    the gather's or the penalty's backward would double the blocks, and
    a missing sum at a sharded layer's input would halve the gradient of
    every layer before it."""
    ranks, single, _ = tp_runs[((2, 2), kind)]
    for r in ranks:
        got = r["grads"]
        want = _block_of(single["grads"], got, r["coords"][1])
        _assert_close(got, want, LEAF_TOL, zero_grad_biases=True)


@pytest.mark.parametrize("kind", KINDS)
def test_tp_eval_matches_single_process(tp_runs, kind):
    """The evaluator over the 2x2 mesh (each data index's rows of every
    batch, the sharded params gathered per layer) gives the meshless
    sums on every rank."""
    ranks, single, _ = tp_runs[((2, 2), kind)]
    for k, v in single["eval"].items():
        for r in ranks:
            np.testing.assert_allclose(
                r["eval"][k], v, rtol=VALUE_TOL,
                atol=1e-6 * max(1.0, np.abs(v).max()), err_msg=k)


def _jax_tp_steps(kind, p, s):
    """mpnn_tpu's make_train_step over a 2x2 ('data', 'model') mesh of
    virtual devices with the params and velocity sharded at min_chan 8,
    N_STEPS steps from (p, s) on its own draws."""
    m = j_make_mesh(n_data=2, n_model=2, devices=jax.devices()[:4])
    jp = j_shard_params(jax.tree.map(jnp.asarray, p), m,
                        model_parallel=True, min_chan=MIN_CHAN)
    js = j_replicate(jax.tree.map(jnp.asarray, s), m)
    jv = j_shard_params(jax.tree.map(jnp.zeros_like, jp), m,
                        model_parallel=True, min_chan=MIN_CHAN)
    sched = jsteps.Schedules(lr=lambda t: W.LR,
                             tau=lambda t: W.TAU0 / 2 ** (t / 2))
    step = jsteps.make_train_step(_jax_net(kind), B, sched, mesh=m)
    x0, y, m_sym = (j_replicate(jnp.asarray(a), m) for a in _dataset())
    rng, batches = _jax_batches()
    cs = []
    for t in range(len(batches)):
        jp, js, jv, c = step(jp, js, jv, t, rng, x0, y, m_sym)
        cs.append(float(c))
    return (*jax.tree.map(np.asarray, (jp, js, jv)), cs)


@pytest.mark.parametrize("kind", KINDS)
def test_tp_step_matches_jax_dp_tp_step(tp_runs, kind):
    """The port's 2x2 step equals mpnn_tpu's dp x tp step from the same
    params (fed the batches JAX's steps drew), at the data mesh's
    tolerances (tighter than tests/test_parallel.py's rtol 1e-3 on the
    losses)."""
    ranks, _, (p, s) = tp_runs[((2, 2), kind)]
    _assert_run_close(ranks[0]["steps"], _jax_tp_steps(kind, p, s))


@pytest.mark.parametrize("name", ["tree", "tree-stacked"])
def test_tp_tree_matches_serial(tp_runs, name):
    """The small tree over a 1x2 mesh, its tails node by node or stacked
    (the sharded tails vmapped, their gathers through the gather's vmap
    rule; the loop carries the packed blocks), equals the serial step
    and loop on one process."""
    ranks, serial, _ = tp_runs[((1, 2), name)]
    assert all(all(r["roundtrip"]) for r in ranks)
    for part in ("steps", "loop"):
        _assert_chain_close(ranks[0][part], serial[part])
        _assert_tree_close(ranks[1][part][0], ranks[0][part][0], 0.0)


def test_model_axis_step_needs_deterministic_algorithms_on_cuda():
    """Each rank along 'model' computes the replicated layers' gradients
    itself, so on CUDA the step refuses to run without the deterministic
    algorithms (cuDNN's default backward algorithms would let the
    replicas drift; the card showed it); on the CPU, or without a 'model'
    axis that reduces, it runs as it is."""
    from mpnn_tpu_torch import set_deterministic
    from mpnn_tpu_torch.models.steps import _check_model_repeats
    axis = Axis(2, 0, group=object())
    cuda = torch.device("cuda")
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    try:
        set_deterministic(False)
        with pytest.raises(RuntimeError, match="deterministic"):
            _check_model_repeats(axis, cuda)
        _check_model_repeats(axis, torch.device("cpu"))
        _check_model_repeats(Axis(1, 0), cuda)
        _check_model_repeats(None, cuda)
        set_deterministic(True)
        _check_model_repeats(axis, cuda)
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=True)
        torch.backends.cudnn.deterministic = before[1]
        torch.backends.cudnn.benchmark = before[2]


def test_sharded_stage_refuses_blocks_the_kernel_cannot_write():
    """A stage that takes the kernel, its 8 output channels over 4 ranks
    (a block 2 wide), is refused on the CPU as on the card: the kernel
    writes output channels in groups of 4, and no device runs such a
    block through the plain version instead. The refusal comes before
    any collective, so the axis' group is a stand-in."""
    from mpnn_tpu_torch.models.net import Ctx
    from mpnn_tpu_torch.ops.layers import MultiscaleConvMax
    shp = [(8, 8, 3), (4, 4, 3)]
    mcm = MultiscaleConvMax(n_chan=[8, 8], supp=3)
    mcm.build(shp)
    assert mcm._kernel_eligible()
    params = mcm.init(torch.Generator().manual_seed(0), shp)
    block = {k: v[..., :2] if v.ndim >= 2 else v for k, v in params.items()}
    x = [torch.rand(2, *s) for s in shp]
    ctx = Ctx(model=Axis(4, 0, group=object()))
    with pytest.raises(ValueError, match="block of 2 output channels .8 "
                                         "over 4 ranks. is not a multiple "
                                         "of 4"):
        mcm.apply(block, {}, x, None, ctx)


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def test_cli_model_axis_writes_single_run_files(tmp_path):
    """`train synth-ac --net 4 --mesh 1x2` (the flagship chain at full
    width, 2 steps and an evaluation on a small synthetic archive): its 2
    ranks replicate the params and each trains the whole batch, so the
    files rank 0 writes are the single run's bit for bit (both runs on
    one thread: the CPU's reductions split by thread)."""
    save_archive(str(tmp_path / "data" / "synth.npz"),
                 make_synthetic(n_tr=48, n_ts=16, seed=2))
    args = ("synth-ac", "--net", "4", "--n-iter", "2", "--t-log", "2",
            "--batch-size", "8", "--device", "cpu", "--data-root",
            str(tmp_path))
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs, logs = {}, {}
    for run, extra in (("single", ()), ("mesh", ("--mesh", "1x2"))):
        logs[run] = open(tmp_path / (run + ".out"), "w")
        procs[run] = subprocess.Popen(
            [sys.executable, "-m", "mpnn_tpu_torch.train", *args,
             "--out-root", str(tmp_path / run), *extra], cwd=REPO, env=env,
            stdout=logs[run], stderr=subprocess.STDOUT)
    try:
        rcs = {run: p.wait(timeout=300) for run, p in procs.items()}
    finally:
        for run, p in procs.items():
            if p.poll() is None:
                p.kill()
            logs[run].close()
    texts = {run: (tmp_path / (run + ".out")).read_text() for run in procs}
    assert rcs == {"single": 0, "mesh": 0}, texts
    assert texts["mesh"].count('"mesh": {"data": 1, "model": 2}') == 2
    want, got = (str(tmp_path / run / "synth-ac") for run in procs)
    assert _files(got) == _files(want)
    for f in _files(want):
        if f.endswith("-log.txt"):
            continue  # the log's lines carry wall-clock times
        with open(os.path.join(got, f), "rb") as a, \
                open(os.path.join(want, f), "rb") as b:
            assert a.read() == b.read(), f
    _, gp, gs, gx = read_net(os.path.join(got, "0004.npy"), "cpu")
    assert gx["t"] == 2
