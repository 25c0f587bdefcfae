"""The adaptive registry and trainer of the port against mpnn_tpu on the
CPU. Both registries hold the same ten entries; with both monkeypatched to
a small dyn_k_cpt actor chain and tree (the nets of
tests/test_torch_sr_cr.py and tests/test_torch_tree.py), the port's
`train_adaptive_experiment` writes the files JAX's writes (stats_log,
n_iter 4, t_log 2, batch 8), in the same schema, and JAX's read_net reads
its net.npy. Evaluated from the same net.npy (JAX's, resumed at its last
step), the port's per-k_cpt descriptors equal JAX's within
1e-4 x max(1, |stat|). A run resumed from net.npy at t=4 to 6 ends bit for
bit where an uninterrupted run to 6 ends, with the same stats_log
snapshots; the CLI `mpnn_tpu_torch.train_adaptive` takes every registry
name and refuses others."""

import os
import re
import shutil
from types import SimpleNamespace as Ns

import numpy as np
import jax
import pytest

from mpnn_tpu import experiments as jcfg
from mpnn_tpu.data.prep import save_archive
from mpnn_tpu.data.synth import make_synthetic
from mpnn_tpu.ops import layers as J
from mpnn_tpu.train import train_adaptive_experiment as j_train_adaptive
from mpnn_tpu.utils.serdes import read_net as j_read_net
from mpnn_tpu_torch import experiments as tcfg
from mpnn_tpu_torch import train_adaptive as tcli
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.train import train_adaptive_experiment
from tests.test_torch_cli import _files, _schema
from tests.test_torch_sr_cr import build_chain
from tests.test_torch_tree import build_tree
from tests.torch_threads import share_cores  # noqa: F401

DESC_TOL = 1e-4  # per scalar stat, times max(1, |stat|)


def test_adaptive_registry_matches_jax():
    """The same ten names, datasets and τ schedules; per entry the same
    net type, hypers and op counts at the registry's input shape."""
    jreg = jcfg.make_adaptive_experiments()
    treg = tcfg.make_adaptive_experiments()
    assert list(treg) == list(jreg) and len(treg) == 10
    assert sum("-tree-" in name for name in treg) == 3
    for name, te in treg.items():
        je = jreg[name]
        assert te.dataset == je.dataset, name
        assert te.tau(12345) == je.tau(12345), name
        tn, jn = te.net((32, 32, 3), (10,)), je.net((32, 32, 3), (10,))
        assert type(tn).__name__ == type(jn).__name__, name
        assert vars(tn.hypers) == vars(jn.hypers), name
        assert tn.hypers.dyn_k_cpt, name
        assert [l.n_ops for l in tn.layers] == [
            l.n_ops for l in jn.layers], name


def _registry(mod, L):
    def net(build):
        return lambda x0_shape, y_shape: build(
            L, "ac", tuple(x0_shape), y_shape[0], dyn_k_cpt=True)
    return lambda: {
        "tiny-ac-dynkcpt": Ns(dataset="data/tiny.npz",
                              net=net(build_chain), tau=mod.AC_TAU),
        "tiny-ac-tree-dynkcpt": Ns(dataset="data/tiny.npz",
                                   net=net(build_tree), tau=mod.AC_TAU)}


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    arch = make_synthetic(n_tr=40, n_ts=24, h=16, w=16, c=3, n_cls=10,
                          seed=1)
    save_archive(str(tmp_path / "data" / "tiny.npz"), arch)
    monkeypatch.setattr(jcfg, "make_adaptive_experiments",
                        _registry(jcfg, J))
    monkeypatch.setattr(tcfg, "make_adaptive_experiments",
                        _registry(tcfg, T))
    return str(tmp_path)


def _run(data_root, out, expt, **kw):
    train_adaptive_experiment(expt, batch_size=8, data_root=data_root,
                              out_root=out, verbose=False, device="cpu",
                              **kw)


def _scalars(desc, path=""):
    """[(path, value)] of every scalar stat of a descriptor."""
    out = [(path + "/" + k, v) for key in ("stats_tr", "stats_ts")
           for k, v in sorted(desc.get(key, {}).items())
           if np.ndim(v) == 0]
    sinks = desc.get("sinks", [desc["root"]] if "root" in desc else [])
    for i, s in enumerate(sinks):
        out += _scalars(s, "%s/%d" % (path, i))
    return out


@pytest.mark.parametrize("expt", ["tiny-ac-dynkcpt", "tiny-ac-tree-dynkcpt"])
def test_adaptive_trainer_writes_jax_files(data_root, expt):
    jout = os.path.join(data_root, "jax")
    j_train_adaptive(expt, n_iter=4, t_log=2, batch_size=8,
                     data_root=data_root, out_root=jout, verbose=False,
                     stats_log=True)
    tout = os.path.join(data_root, "port")
    _run(data_root, tout, expt, n_iter=4, t_log=2, stats_log=True)
    files = _files(jout)
    assert _files(tout) == files
    assert len(files) == 2 + 8 + 8 * 2  # MANIFEST, net, latest, snapshots
    for name in files:
        if not name.endswith("-stats.npy") and "-stats/" not in name:
            continue
        j = np.load(os.path.join(jout, name), allow_pickle=True)[()]
        t = np.load(os.path.join(tout, name), allow_pickle=True)[()]
        assert _schema(t) == _schema(j), name
    j = np.load(os.path.join(jout, expt, "net.npy"), allow_pickle=True)[()]
    t = np.load(os.path.join(tout, expt, "net.npy"), allow_pickle=True)[()]
    assert jax.tree.structure(t) == jax.tree.structure(j)
    assert [(np.asarray(a).dtype, np.shape(a)) for a in jax.tree.leaves(t)] \
        == [(np.asarray(a).dtype, np.shape(a)) for a in jax.tree.leaves(j)]
    net, _, _, extra = j_read_net(os.path.join(tout, expt, "net.npy"))
    assert int(extra["t"]) == 4 and net.hypers.dyn_k_cpt

    # The port's evaluation of JAX's trained net: resumed at its last step,
    # nothing is trained, and every k_cpt's descriptor is written.
    eout = os.path.join(data_root, "eval")
    os.makedirs(os.path.join(eout, expt))
    shutil.copy(os.path.join(jout, expt, "net.npy"),
                os.path.join(eout, expt, "net.npy"))
    _run(data_root, eout, expt, n_iter=4, t_log=2, resume=True)
    worst = 0.0
    for i in range(len(tcfg.k_cpts)):
        name = os.path.join(expt, "%.4i-stats.npy" % i)
        j = np.load(os.path.join(jout, name), allow_pickle=True)[()]
        t = np.load(os.path.join(eout, name), allow_pickle=True)[()]
        jp, tp = _scalars(j), _scalars(t)
        assert [p for p, _ in tp] == [p for p, _ in jp]
        for (p, a), (_, b) in zip(tp, jp):
            err = abs(a - b) / max(1.0, abs(b))
            assert err <= DESC_TOL, (i, p, a, b)
            worst = max(worst, err)
    print("%s: worst descriptor difference %.3g" % (expt, worst))


def test_adaptive_resume_equals_uninterrupted_run(data_root):
    expt = "tiny-ac-tree-dynkcpt"
    a, b = (os.path.join(data_root, d) for d in ("a", "b"))
    _run(data_root, a, expt, n_iter=4, t_log=4, stats_log=True)
    _, _, _, extra = j_read_net(os.path.join(a, expt, "net.npy"))
    assert int(extra["t"]) == 4
    timings = {}
    _run(data_root, a, expt, n_iter=6, t_log=4, stats_log=True, resume=True,
         timings=timings)
    assert timings["t_start"] == 4 and timings["steps"] == 2
    assert timings["evals"] == 8
    _run(data_root, b, expt, n_iter=6, t_log=4, stats_log=True)
    assert _files(a) == _files(b)
    assert "%s/0007-stats/00000004.npy" % expt in _files(a)
    assert "%s/0007-stats/00000006.npy" % expt in _files(a)
    for name in _files(a):
        if name.endswith(".npy"):
            ra = np.load(os.path.join(a, name), allow_pickle=True)[()]
            rb = np.load(os.path.join(b, name), allow_pickle=True)[()]
            la, lb = jax.tree.leaves(ra), jax.tree.leaves(rb)
            assert jax.tree.structure(ra) == jax.tree.structure(rb), name
            assert all(np.array_equal(x, y) for x, y in zip(la, lb)), name


def test_adaptive_cli_takes_registry_names(capsys):
    with pytest.raises(SystemExit):
        tcli.main(["--help"])
    # argparse may wrap the list of names after a hyphen or a comma.
    out = re.sub(r"([-,])\s+", r"\1", capsys.readouterr().out)
    assert all(name in out for name in tcfg.make_adaptive_experiments())
    with pytest.raises(SystemExit):
        tcli.main(["synth-ac", "--device", "cpu"])
    assert "invalid choice" in capsys.readouterr().err

