"""Trees through the port's training CLI and routed inference, against
mpnn_tpu on the CPU. With both registries monkeypatched to the small
actor tree of tests/test_torch_tree.py, `python -m mpnn_tpu_torch.train`
writes the files JAX's `train_experiment` writes, in the same schema,
serially and with --vmap-sweep. Routed inference of a small dyn_k_cpt
tree (randomized so its routers reach 4 of its 5 leaves, and route
differently at the two prices) equals JAX's at two
prices, at capacity 1 and below it with forced exits through the 3-way
and 2-way switches' leaves: the same exits, ops and forced counts, probs
within 1e-5; calibrate_capacities gives JAX's fractions."""

import json
import os
from types import SimpleNamespace as Ns

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu import experiments as jcfg
from mpnn_tpu.data.prep import save_archive
from mpnn_tpu.data.synth import make_synthetic
from mpnn_tpu.models.infer import calibrate_capacities as j_calibrate
from mpnn_tpu.models.infer import make_routed_infer_fn as j_infer
from mpnn_tpu.ops import layers as J
from mpnn_tpu.train import train_experiment as j_train_experiment
from mpnn_tpu_torch import experiments as tcfg
from mpnn_tpu_torch import train as ttrain
from mpnn_tpu_torch.models.infer import calibrate_capacities as t_calibrate
from mpnn_tpu_torch.models.infer import make_routed_infer_fn as t_infer
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils.serdes import from_numpy_tree
from tests.test_torch_cli import _files, _schema
from tests.test_torch_tree import build_tree
from tests.test_torch_train import _randomize
from tests.torch_threads import share_cores  # noqa: F401

B = 48


def _tiny_registry(mod, L):
    def ctor(**hypers):
        return lambda x0_shape, y_shape: build_tree(
            L, "ac", tuple(x0_shape), y_shape[0], **hypers)
    return lambda: {"tiny-ac-tree": Ns(
        dataset="data/tiny.npz", tau=mod.AC_TAU, sweep_k_cpts=[0.0, 1e-9],
        nets=[ctor(k_cpt=0.0), ctor(k_cpt=1e-9)])}


def test_tree_cli_writes_jax_files(tmp_path, monkeypatch):
    """The port's `main()` and JAX's train_experiment on the small tree
    (net 1, 3 iterations, t_log 2, batch 8): the same file names,
    MANIFEST.json, stats of the same schema, logs of the same shape and
    checkpoints of the same structure; then the port's --vmap-sweep
    writes every net's files in the same schema."""
    arch = make_synthetic(n_tr=40, n_ts=24, h=16, w=16, c=3, n_cls=10,
                          seed=1)
    save_archive(str(tmp_path / "data" / "tiny.npz"), arch)
    monkeypatch.setattr(jcfg, "make_experiments", _tiny_registry(jcfg, J))
    monkeypatch.setattr(tcfg, "make_experiments", _tiny_registry(tcfg, T))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    j_train_experiment("tiny-ac-tree", n_iter=3, t_log=2, batch_size=8,
                       net_indices=[1], data_root=str(tmp_path),
                       out_root=jout, verbose=False)
    args = ["tiny-ac-tree", "--n-iter", "3", "--t-log", "2",
            "--batch-size", "8", "--device", "cpu", "--data-root",
            str(tmp_path)]
    ttrain.main(args + ["--net", "1", "--out-root", tout])
    files = _files(jout)
    assert _files(tout) == files == [
        "tiny-ac-tree/0001-log.txt", "tiny-ac-tree/0001-stats.npy",
        "tiny-ac-tree/0001-stats/00000002.npy",
        "tiny-ac-tree/0001-stats/00000003.npy", "tiny-ac-tree/0001.npy",
        "tiny-ac-tree/MANIFEST.json"]
    with open(os.path.join(jout, "tiny-ac-tree/MANIFEST.json")) as f:
        jman = json.load(f)
    with open(os.path.join(tout, "tiny-ac-tree/MANIFEST.json")) as f:
        assert json.load(f) == jman
    jrec = {}
    for name in files:
        if not name.endswith(".npy"):
            continue
        j = np.load(os.path.join(jout, name), allow_pickle=True)[()]
        t = np.load(os.path.join(tout, name), allow_pickle=True)[()]
        if name.endswith("0001.npy"):
            assert int(t["extra"]["t"]) == int(j["extra"]["t"]) == 3
            j, t = (jax.tree.map(lambda a: (a.dtype.str, a.shape)
                                 if isinstance(a, np.ndarray) else a, r)
                    for r in (j, t))
            assert t == j
        assert _schema(t) == _schema(j), name
        jrec[name] = _schema(j)
    logs = []
    for root in (jout, tout):
        with open(os.path.join(root, "tiny-ac-tree/0001-log.txt"),
                  encoding="utf-8") as f:
            logs.append([line.split(" ")[0] for line in f])
    assert logs[0] == logs[1] and len(logs[0]) > 40

    sout = str(tmp_path / "sweep")
    ttrain.main(args + ["--vmap-sweep", "--out-root", sout])
    assert _files(sout) == sorted(
        [f.replace("0001", "%.4i" % i) for i in (0, 1) for f in files
         if "0001" in f] + ["tiny-ac-tree/MANIFEST.json"])
    for i in (0, 1):
        d = np.load(os.path.join(sout, "tiny-ac-tree/%.4i-stats.npy" % i),
                    allow_pickle=True)[()]
        assert _schema(d) == jrec["tiny-ac-tree/0001-stats.npy"]


@pytest.fixture(scope="module")
def trees():
    """(jnet, JAX's (params, state), tnet, the port's) of the small actor
    tree with dyn_k_cpt routers (α_cpt large enough for the price to
    move them), seeded random params (a seed whose routers spread the
    batch)."""
    hypers = dict(dyn_k_cpt=True, α_cpt=1e9)
    jnet = build_tree(J, "ac", **hypers)
    tnet = build_tree(T, "ac", **hypers)
    jp, js = jnet.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(25)
    p = _randomize(jax.tree.map(np.asarray, jp), rng)
    s = _randomize(jax.tree.map(np.asarray, js), rng)
    return (jnet, jax.tree.map(jnp.asarray, (p, s)), tnet,
            from_numpy_tree(p, s, device="cpu"))


@pytest.fixture(scope="module")
def batch():
    return np.random.RandomState(1).rand(B, 16, 16, 3).astype(np.float32)


@pytest.mark.parametrize("k_cpt", [0.0, 4e-9])
@pytest.mark.parametrize("cap,forces", [(1.0, False),
                                        ([0.25, 0.0625, 0.0625], True)],
                         ids=["cap1", "per_switch"])
def test_routed_tree_infer_matches_jax(trees, batch, k_cpt, cap, forces):
    jnet, (jp, js), tnet, (tp, ts) = trees
    jo = j_infer(jnet, B, cap)(jp, js, jnp.asarray(batch), k_cpt)
    to = t_infer(tnet, B, cap)(tp, ts, torch.as_tensor(batch), k_cpt)
    jo = {k: np.asarray(v) for k, v in jo.items()}
    to = {k: v.numpy() for k, v in to.items()}
    np.testing.assert_array_equal(to["exit_idx"], jo["exit_idx"])
    np.testing.assert_array_equal(to["ops"], jo["ops"])
    np.testing.assert_array_equal(to["forced"], jo["forced"])
    np.testing.assert_allclose(to["probs"], jo["probs"], atol=1e-5, rtol=0)
    assert to["forced"].shape == (3,)
    if forces:  # the 3-way switch and a tail's switch force exits
        assert to["forced"][0] > 0 and to["forced"][1:].sum() > 0
    else:
        assert len(np.unique(to["exit_idx"])) >= 3
        assert not to["forced"].any()


def test_tree_prices_move_routing(trees, batch):
    """The dyn_k_cpt tree routes differently at the two prices."""
    _, _, tnet, (tp, ts) = trees
    infer = t_infer(tnet, B, 1.0)
    a, b = (infer(tp, ts, torch.as_tensor(batch), k)["exit_idx"]
            for k in (0.0, 4e-9))
    assert (a != b).any()


def test_calibrate_tree_capacities_matches_jax(trees, batch):
    jnet, (jp, js), tnet, (tp, ts) = trees
    jf = j_calibrate(jnet, jp, js, jnp.asarray(batch), margin=1.2,
                     k_cpt=4e-9)
    tf = t_calibrate(tnet, tp, ts, torch.as_tensor(batch), margin=1.2,
                     k_cpt=4e-9)
    assert tf == jf and len(tf) == 3
