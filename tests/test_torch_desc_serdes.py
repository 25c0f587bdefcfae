"""Full-split evaluation, descriptors, their rendering and checkpoint
writing in the port against mpnn_tpu on the CPU: the eval sums and
`net_desc` agree to 1e-5 (relative) per stat; the renderers give the same
bytes; a checkpoint the port writes has JAX's record schema (keys, types,
hypers), JAX's `read_net` reads it bit for bit and its forward matches
the port's; a checkpoint JAX writes resumes in the port. Nets are the
3-stage chains of tests/test_torch_sr_cr.py over a 16x16 synthetic split
padded to the eval batch."""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.data import synth as jsynth
from mpnn_tpu.data.dataset import Dataset as JDataset
from mpnn_tpu.models import steps as jsteps
from mpnn_tpu.utils import desc as jdesc
from mpnn_tpu.utils import serdes as jserdes
from mpnn_tpu_torch.data.dataset import Dataset as TDataset
from mpnn_tpu_torch.models import steps as tsteps
from mpnn_tpu_torch.models.net import Ctx as TCtx
from mpnn_tpu_torch.train import train_one_net
from mpnn_tpu_torch.utils import desc as tdesc
from mpnn_tpu_torch.utils import serdes as tserdes
from mpnn_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_torch_sr_cr import build_chain, random_pair
from tests.test_torch_train import EPS, K_CPT, TAU, _jax_run
from mpnn_tpu.ops import layers as J
from mpnn_tpu_torch.ops import layers as T
from tests.torch_threads import share_cores  # noqa: F401

EB = 16  # eval batch: both splits below need padding
VALUE_TOL = 1e-5


@pytest.fixture(scope="module")
def archive():
    return jsynth.make_synthetic(n_tr=40, n_ts=24, h=16, w=16, c=3,
                                 n_cls=10, seed=5)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("kind", ["ac", "sr", "cr"])
def test_eval_split_sums_match_jax(archive, kind):
    """make_eval_split_fn: the same keys and the masked sums over a padded
    split, per key within 1e-5."""
    jnet, tnet, p, s = random_pair(kind)
    jx, jy, jm, jn = JDataset(archive).padded_split("tr", EB)
    tx, ty, tm, tn = TDataset(archive, device="cpu").padded_split("tr", EB)
    assert tn == jn == 40 and tx.shape[0] == 3
    j = jax.jit(jsteps.make_eval_split_fn(jnet, EB))(
        *jax.tree.map(jnp.asarray, (p, s)), jx, jy, jm, TAU, K_CPT)
    tp, ts = tserdes.from_numpy_tree(p, s, device="cpu")
    t = tsteps.make_eval_split_fn(tnet, EB)(tp, ts, tx, ty, tm, TAU, K_CPT,
                                            eval_key=(1, 2))
    assert sorted(t) == sorted(j)
    for k in j:
        assert _rel(t[k].numpy(), np.asarray(j[k])) <= VALUE_TOL, k


def _assert_desc_close(t, j, path="desc"):
    assert type(t) is type(j), path
    if isinstance(j, dict):
        assert list(t) == list(j), path
        for k in j:
            _assert_desc_close(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, list) and j and isinstance(j[0], dict):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_desc_close(a, b, f"{path}[{i}]")
    elif isinstance(j, str):
        assert t == j, path
    else:
        assert np.shape(t) == np.shape(j), path
        assert _rel(t, j) <= VALUE_TOL or np.allclose(t, j, rtol=0,
                                                      atol=1e-7), path


@pytest.mark.parametrize("kind", ["ac", "sr"])
def test_net_desc_matches_jax_and_renders_alike(archive, kind):
    """net_desc: JAX's schema (the same keys in the same order, floats and
    lists) with values within 1e-5; render_net_desc of a desc dict gives
    the same bytes in both packages."""
    jnet, tnet, p, s = random_pair(kind)
    j = jdesc.net_desc(jnet, JDataset(archive), p, s, batch_size=EB,
                       tau=TAU)
    tp, ts = tserdes.from_numpy_tree(p, s, device="cpu")
    t = tdesc.net_desc(tnet, TDataset(archive, device="cpu"), tp, ts,
                       batch_size=EB, tau=TAU)
    _assert_desc_close(t, j)
    assert isinstance(t["stats_tr"]["acc"], float)
    for d in (j, t):
        for name in ("Network", "nets/x/0004.npy — Epoch 20"):
            assert (tdesc.render_net_desc(d, name)
                    == jdesc.render_net_desc(d, name))
    assert "ReConvMax" in tdesc.render_net_desc(t)


def _no_torch(obj, path="record"):
    """No torch object anywhere in a decoded record."""
    assert not type(obj).__module__.startswith("torch"), path
    if isinstance(obj, dict):
        for k, v in obj.items():
            _no_torch(v, f"{path}/{k}")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _no_torch(v, f"{path}[{i}]")


def _assert_record_equal(t, j, path="record"):
    """Two encoded records: the same keys in the same order, the same
    types, equal hypers and bitwise-equal float32 arrays."""
    assert type(t) is type(j), (path, type(t), type(j))
    if isinstance(j, dict):
        assert list(t) == list(j), path
        for k in j:
            _assert_record_equal(t[k], j[k], f"{path}/{k}")
    elif isinstance(j, (list, tuple)):
        assert len(t) == len(j), path
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_record_equal(a, b, f"{path}[{i}]")
    elif isinstance(j, np.ndarray):
        assert t.dtype == j.dtype and t.shape == j.shape, path
        np.testing.assert_array_equal(t, j, err_msg=path)
    else:
        assert t == j, path


@pytest.fixture(scope="module")
def port_checkpoint(tmp_path_factory):
    """A checkpoint the port wrote for an actor chain from the port's own
    init (its trees in the port's key order), with a random momentum and
    t = 7, and numpy copies of the arrays behind it."""
    jnet, tnet = build_chain(J, "ac"), build_chain(T, "ac")
    tp, ts, tv = tsteps.init_training(tnet, seed=1, device="cpu")
    gen = torch.Generator().manual_seed(9)
    for leaf in tree_leaves(tv):
        leaf.normal_(generator=gen)
    p, s, v = (tree_map(lambda t: t.numpy().copy(), tree)
               for tree in (tp, ts, tv))
    path = str(tmp_path_factory.mktemp("ckpt") / "0004.npy")
    tserdes.write_net(path, tnet, tp, ts, extra={"vel": tv, "t": 7})
    return path, jnet, tnet, (p, s, v), (tp, ts, tv)


def test_port_checkpoint_has_jax_schema(port_checkpoint):
    """The record the port writes equals JAX's encode_net of the same
    arrays in keys, types and hypers; it holds no torch object."""
    path, jnet, tnet, (p, s, v), _ = port_checkpoint
    rec = np.load(path, allow_pickle=True)[()]
    _no_torch(rec)
    jrec = jserdes.encode_net(jnet, *jax.tree.map(jnp.asarray, (p, s)),
                              extra={"vel": jax.tree.map(jnp.asarray, v),
                                     "t": 7})
    _assert_record_equal(rec, jrec)
    assert rec["extra"]["t"].dtype == np.int64


def test_jax_reads_port_checkpoint(port_checkpoint):
    """JAX's read_net gives back params, state and vel bit for bit and
    t = 7; JAX's eval forward on them matches the port's within 1e-5."""
    path, _, tnet, (p, s, v), (tp, ts, _) = port_checkpoint
    jnet, jp, js, extra = jserdes.read_net(path)
    for a, b in zip(jax.tree.leaves((jp, js, extra["vel"])),
                    jax.tree.leaves((p, s, v))):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert int(extra["t"]) == 7
    rng = np.random.RandomState(3)
    x = rng.rand(32, 16, 16, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 32)]
    jrecs, _, _ = _jax_run(jnet, jax.tree.map(np.asarray, jp),
                           jax.tree.map(np.asarray, js), x, y, False)
    trecs, _ = tnet.forward(tp, ts, torch.as_tensor(x), torch.as_tensor(y),
                            TCtx(train=False, tau=TAU, eps=EPS,
                                 k_cpt=K_CPT))
    n = 0
    for jl, tl in zip(jnet.layers, tnet.layers):
        if not tl.sinks:
            assert _rel(trecs[tl].x.numpy(), np.asarray(jrecs[jl].x)) <= (
                VALUE_TOL)
            n += 1
    assert n == 3


def test_port_read_net_returns_training_state(port_checkpoint):
    """The port's read_net: extra["vel"] as tensors on the device, in the
    params' structure and key order, extra["t"] an int."""
    path, _, _, _, (tp, ts, tv) = port_checkpoint
    net, p, s, extra = tserdes.read_net(path, "cpu")
    assert type(extra["t"]) is int and extra["t"] == 7
    same = []
    tree_map(lambda a, b: same.append(isinstance(a, torch.Tensor)
                                      and torch.equal(a, b)),
             (p, s, extra["vel"]), (tp, ts, tv))
    assert len(same) == len(tree_leaves(tp)) * 2 + len(tree_leaves(ts))
    assert all(same)
    assert ([a.shape for a in tree_leaves(p)]
            == [a.shape for a in tree_leaves(extra["vel"])])


def test_jax_checkpoint_resumes_in_port(archive, tmp_path):
    """A checkpoint that JAX's write_net wrote, with its momentum and
    t = 2, resumes in the port's train_one_net from t = 2 to 4."""
    jnet = build_chain(J, "ac")
    # Under jit: JAX's eager first calls cost seconds a primitive here.
    jp, js, jv = jax.jit(lambda: jsteps.init_training(jnet, seed=0))()
    out_dir = str(tmp_path / "tiny")
    os.makedirs(out_dir)
    jserdes.write_net(os.path.join(out_dir, "0000.npy"), jnet, jp, js,
                      extra={"vel": jv, "t": 2})
    tnet = build_chain(T, "ac")
    rec, buf = {}, io.StringIO()
    with redirect_stdout(buf):
        params, _, _, desc = train_one_net(
            tnet, TDataset(archive, device="cpu"),
            schedules=tsteps.Schedules(lr=lambda t: 0.01), tau_fn=None,
            n_iter=4, t_log=2, batch_size=8, out_dir=out_dir, net_index=0,
            resume=True, timings=rec)
    assert "[resuming %s/0000.npy at t=2]" % out_dir in buf.getvalue()
    assert rec["t_start"] == 2 and rec["steps"] == 2 and rec["evals"] == 1
    _, p4, _, extra = tserdes.read_net(os.path.join(out_dir, "0000.npy"),
                                       "cpu")
    assert extra["t"] == 4
    for a, b in zip(tree_leaves(p4), tree_leaves(params)):
        assert torch.equal(a, b)
    # The JAX checkpoint's params were the start: training moved them.
    moved = [not np.array_equal(a, np.asarray(b)) for a, b in
             zip(jax.tree.leaves(tree_map(lambda t: t.numpy(), p4)),
                 jax.tree.leaves(jp))]
    assert any(moved)
    assert os.path.exists(os.path.join(out_dir, "0000-stats", "00000004.npy"))
    assert desc["type"] == "ActorNet"
