"""The port's training CLI against mpnn_tpu's on the CPU: both registries
(train-nets and adaptive) hold JAX's experiments, name for name, with the
same datasets, schedules and nets; for one tiny experiment (the registry
monkeypatched to a 3-stage chain on 16x16 inputs) `python -m
mpnn_tpu_torch.train` writes the files JAX's `train_experiment` writes,
in the same schema; tree experiments are accepted and unknown names
refused."""

import json
import os
import re
from types import SimpleNamespace as Ns

import numpy as np
import jax
import pytest

from mpnn_tpu import experiments as jcfg
from mpnn_tpu.data.prep import save_archive
from mpnn_tpu.data.synth import make_synthetic
from mpnn_tpu.ops import layers as J
from mpnn_tpu.train import train_experiment as j_train_experiment
from mpnn_tpu_torch import experiments as tcfg
from mpnn_tpu_torch import train as ttrain
from mpnn_tpu_torch.ops import layers as T
from tests.test_torch_sr_cr import build_chain
from tests.torch_threads import share_cores  # noqa: F401


def test_registry_matches_jax_chain_entries():
    """Every entry of JAX's train-nets registry, chains and trees, in JAX's
    order: the same dataset, tau schedule, sweep prices and, per net, the
    same type, hypers and op count at the registry's input shape; and the
    adaptive registry's names in JAX's order."""
    jreg, treg = jcfg.make_experiments(), tcfg.make_experiments()
    assert list(treg) == list(jreg)
    assert sum(k.endswith("-tree") for k in treg) == 3
    assert len(treg) == 28
    assert list(tcfg.make_adaptive_experiments()) == list(
        jcfg.make_adaptive_experiments())
    assert tcfg.batch_size == jcfg.batch_size == 128
    for name, te in treg.items():
        je = jreg[name]
        assert te.dataset == je.dataset, name
        assert getattr(te, "sweep_k_cpts", None) == getattr(
            je, "sweep_k_cpts", None), name
        assert (te.tau is None) == (je.tau is None), name
        if te.tau is not None:
            assert te.tau(12345) == je.tau(12345), name
        assert len(te.nets) == len(je.nets) == 8, name
        n_cls = {"cifar-2": 2, "cifar-5": 5}.get(
            os.path.basename(te.dataset)[:-4], 10)
        for tn, jn in ((ctor((32, 32, 3), (n_cls,)), jctor((32, 32, 3),
                                                          (n_cls,)))
                       for ctor, jctor in zip(te.nets, je.nets)):
            assert type(tn).__name__ == type(jn).__name__, name
            assert vars(tn.hypers) == vars(jn.hypers), name
            assert [l.n_ops for l in tn.layers] == [
                l.n_ops for l in jn.layers], name


def _tiny_registry(mod, L):
    def ctor(kind, **hypers):
        return lambda x0_shape, y_shape: build_chain(
            L, kind, tuple(x0_shape), y_shape[0], **hypers)
    return lambda: {"tiny-ac": Ns(
        dataset="data/tiny.npz", tau=mod.AC_TAU, sweep_k_cpts=[0.0, 1e-9],
        nets=[ctor("ac", k_cpt=0.0), ctor("ac", k_cpt=1e-9)])}


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _schema(obj):
    """A descriptor's structure: dict keys, list lengths, leaf kinds."""
    if isinstance(obj, dict):
        return {k: _schema(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_schema(v) for v in obj]
    return type(obj).__name__


def test_cli_writes_jax_files(tmp_path, monkeypatch):
    """`main()` of the port and JAX's train_experiment, same arguments
    (net 1, 3 iterations, t_log 2, batch 8): the same file names, the same
    MANIFEST.json, stats files of the same schema, logs of the same
    shape, and checkpoints whose records have the same structure."""
    arch = make_synthetic(n_tr=40, n_ts=24, h=16, w=16, c=3, n_cls=10,
                          seed=1)
    save_archive(str(tmp_path / "data" / "tiny.npz"), arch)
    monkeypatch.setattr(jcfg, "make_experiments", _tiny_registry(jcfg, J))
    monkeypatch.setattr(tcfg, "make_experiments", _tiny_registry(tcfg, T))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    j_train_experiment("tiny-ac", n_iter=3, t_log=2, batch_size=8,
                       net_indices=[1], data_root=str(tmp_path),
                       out_root=jout, verbose=False)
    ttrain.main(["tiny-ac", "--n-iter", "3", "--t-log", "2",
                 "--batch-size", "8", "--net", "1", "--device", "cpu",
                 "--data-root", str(tmp_path), "--out-root", tout])
    files = _files(jout)
    assert _files(tout) == files == [
        "tiny-ac/0001-log.txt", "tiny-ac/0001-stats.npy",
        "tiny-ac/0001-stats/00000002.npy", "tiny-ac/0001-stats/00000003.npy",
        "tiny-ac/0001.npy", "tiny-ac/MANIFEST.json"]
    with open(os.path.join(jout, "tiny-ac/MANIFEST.json")) as f:
        jman = json.load(f)
    with open(os.path.join(tout, "tiny-ac/MANIFEST.json")) as f:
        assert json.load(f) == jman
    for name in files:
        if not name.endswith(".npy"):
            continue
        j = np.load(os.path.join(jout, name), allow_pickle=True)[()]
        t = np.load(os.path.join(tout, name), allow_pickle=True)[()]
        if name.endswith("0001.npy"):
            assert int(t["extra"]["t"]) == int(j["extra"]["t"]) == 3
            # Same structure, hypers, dtypes and shapes; values differ
            # (the two packages draw different inits).
            j, t = (jax.tree.map(lambda a: (a.dtype.str, a.shape)
                                 if isinstance(a, np.ndarray) else a, r)
                    for r in (j, t))
            assert t == j
        assert _schema(t) == _schema(j), name
    logs = []
    for root in (jout, tout):
        with open(os.path.join(root, "tiny-ac/0001-log.txt"),
                  encoding="utf-8") as f:
            logs.append([line.split(" ")[0] for line in f])
    assert logs[0] == logs[1] and len(logs[0]) > 20


def test_cli_refuses_trees_and_unknown_names(capsys, monkeypatch):
    """Unknown names are refused; the tree names are listed and reach the
    trainer."""
    with pytest.raises(SystemExit):
        ttrain.main(["no-such-expt", "--device", "cpu"])
    assert "unknown experiment" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        ttrain.main(["--help"])
    # argparse may wrap the list of names after a hyphen.
    out = re.sub(r"-\s+", "-", capsys.readouterr().out)
    assert all(name in out for name in ("synth-ac", "synth-ac-tree",
                                        "synth-cr-tree", "hybrid-ac-tree"))
    with pytest.raises(KeyError):
        ttrain.train_experiment("no-such-expt", device="cpu")
    called = []
    monkeypatch.setattr(ttrain, "train_experiment",
                        lambda name, **kw: called.append((name, kw)))
    ttrain.main(["synth-ac-tree", "--vmap-sweep", "--device", "cpu"])
    assert called[0][0] == "synth-ac-tree" and called[0][1]["vmap_sweep"]
