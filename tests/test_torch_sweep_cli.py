"""The port's --vmap-sweep training CLI against mpnn_tpu's on the CPU (the
registry monkeypatched to tiny 3-stage chains on 16x16 inputs, as in
tests/test_torch_cli.py): the same files in the same schema, checkpoints
that mpnn_tpu's read_net reads; 6 iterations equal 4 and a resumed 2,
files included; --net, and an experiment without sweep_k_cpts, take the
serial path, as in mpnn_tpu."""

import io
import os
from contextlib import redirect_stdout
from types import SimpleNamespace as Ns

import numpy as np
import jax
import pytest
import torch

from mpnn_tpu import experiments as jcfg
from mpnn_tpu.data.prep import save_archive
from mpnn_tpu.data.synth import make_synthetic
from mpnn_tpu.ops import layers as J
from mpnn_tpu.train import train_experiment as j_train_experiment
from mpnn_tpu.utils.serdes import read_net as j_read_net
from mpnn_tpu_torch import experiments as tcfg
from mpnn_tpu_torch import train as ttrain
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils.serdes import read_net
from mpnn_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_cli import _files, _schema
from tests.test_torch_sr_cr import build_chain
from tests.torch_threads import share_cores  # noqa: F401

K_CPTS = [0.0, 1e-6, 4e-6]


def _registry(mod, L):
    """tiny-ac: a 3-net actor sweep; tiny-sr: 2 SR nets, no sweep_k_cpts."""
    def ctor(kind, **hypers):
        return lambda x0_shape, y_shape: build_chain(
            L, kind, tuple(x0_shape), y_shape[0], **hypers)
    return lambda: {
        "tiny-ac": Ns(dataset="data/tiny.npz", tau=mod.AC_TAU,
                      sweep_k_cpts=list(K_CPTS),
                      nets=[ctor("ac", k_cpt=k) for k in K_CPTS]),
        "tiny-sr": Ns(dataset="data/tiny.npz", tau=None,
                      nets=[ctor("sr"), ctor("sr")])}


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    arch = make_synthetic(n_tr=40, n_ts=24, h=16, w=16, c=3, n_cls=10,
                          seed=1)
    save_archive(str(tmp_path / "data" / "tiny.npz"), arch)
    monkeypatch.setattr(jcfg, "make_experiments", _registry(jcfg, J))
    monkeypatch.setattr(tcfg, "make_experiments", _registry(tcfg, T))
    return str(tmp_path)


def _main(data_root, out_root, *args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        ttrain.main(["--batch-size", "8", "--t-log", "2", "--device", "cpu",
                     "--data-root", data_root, "--out-root", out_root,
                     *args])
    return buf.getvalue()


def test_vmap_sweep_cli_writes_jax_files(data_root):
    """`main()` with --vmap-sweep and mpnn_tpu's train_experiment with
    vmap_sweep=True, same arguments (3 iterations, t_log 2, batch 8):
    every net's files under the same names, stats files of the same
    schema, logs of the same shape, checkpoints of the same structure
    that mpnn_tpu's read_net reads, each with its own net's k_cpt."""
    jout = os.path.join(data_root, "jax")
    tout = os.path.join(data_root, "port")
    j_train_experiment("tiny-ac", n_iter=3, t_log=2, batch_size=8,
                       data_root=data_root, out_root=jout, verbose=False,
                       vmap_sweep=True)
    text = _main(data_root, tout, "tiny-ac", "--n-iter", "3",
                 "--vmap-sweep")
    assert "[sweep of 3 nets x 3 iters in" in text
    files = _files(jout)
    assert _files(tout) == files
    assert files == ["tiny-ac/%.4i%s" % (i, suffix) for i in range(3)
                     for suffix in ("-log.txt", "-stats.npy",
                                    "-stats/00000002.npy",
                                    "-stats/00000003.npy", ".npy")
                     ] + ["tiny-ac/MANIFEST.json"]
    for name in files:
        if not name.endswith(".npy"):
            continue
        j = np.load(os.path.join(jout, name), allow_pickle=True)[()]
        t = np.load(os.path.join(tout, name), allow_pickle=True)[()]
        if name[-8:-4].isdigit() and "stats" not in name:
            assert int(t["extra"]["t"]) == int(j["extra"]["t"]) == 3
            i = int(name[-8:-4])
            assert t["hypers"]["k_cpt"] == K_CPTS[i]
            # mpnn_tpu's sweep writes net 0's hypers into every member's
            # checkpoint; the port writes each net's own, as the serial
            # path does.
            t["hypers"]["k_cpt"] = j["hypers"]["k_cpt"]
            j, t = (jax.tree.map(lambda a: (a.dtype.str, a.shape)
                                 if isinstance(a, np.ndarray) else a, r)
                    for r in (j, t))
            assert t == j
            _, _, _, extra = j_read_net(os.path.join(tout, name))
            assert int(extra["t"]) == 3
        assert _schema(t) == _schema(j), name
    for i in range(3):
        logs = []
        for root in (jout, tout):
            with open(os.path.join(root, "tiny-ac/%.4i-log.txt" % i),
                      encoding="utf-8") as f:
                logs.append([line.split(" ")[0] for line in f])
        assert logs[0] == logs[1] and len(logs[0]) > 20


def _state(out_dir, i):
    _, params, state, extra = read_net(
        os.path.join(out_dir, "tiny-ac", "%.4i.npy" % i), "cpu")
    return extra["t"], tree_leaves((params, state, extra["vel"]))


def test_vmap_sweep_resume_equals_uninterrupted_run(data_root):
    """6 iterations in one sweep run against 4 and then --resume for 2:
    every net's checkpoint, stats files and rendered log are the same."""
    one = os.path.join(data_root, "one")
    two = os.path.join(data_root, "two")
    _main(data_root, one, "tiny-ac", "--n-iter", "6", "--vmap-sweep")
    _main(data_root, two, "tiny-ac", "--n-iter", "4", "--vmap-sweep")
    text = _main(data_root, two, "tiny-ac", "--n-iter", "6", "--vmap-sweep",
                 "--resume")
    assert "[resuming tiny-ac sweep at t=4]" in text
    assert _files(one) == _files(two)
    for i in range(3):
        (t1, leaves1), (t2, leaves2) = _state(one, i), _state(two, i)
        assert t1 == t2 == 6
        assert all(torch.equal(a, b) for a, b in zip(leaves1, leaves2))
        for t in (2, 4, 6):
            name = "tiny-ac/%.4i-stats/%.8i.npy" % (i, t)
            a = np.load(os.path.join(one, name), allow_pickle=True)[()]
            b = np.load(os.path.join(two, name), allow_pickle=True)[()]
            assert a == b, name
        logs = []
        for root in (one, two):
            with open(os.path.join(root, "tiny-ac/%.4i-log.txt" % i),
                      encoding="utf-8") as f:
                logs.append(f.read().replace(root, "OUT"))
        assert logs[0] == logs[1] and logs[0].count("Epoch") == 3


@pytest.mark.parametrize("expt,args,written", [
    ("tiny-ac", ["--net", "1"], [1]), ("tiny-sr", [], [0, 1])],
    ids=["with_net", "no_sweep_k_cpts"])
def test_vmap_sweep_falls_back_to_serial_path(data_root, monkeypatch, expt,
                                              args, written):
    """--vmap-sweep with --net, or for an experiment without sweep_k_cpts,
    trains serially (train_one_net per net), as mpnn_tpu does."""
    def no_sweep(*a, **k):
        raise AssertionError("the sweep path ran")

    monkeypatch.setattr(ttrain, "_train_sweep", no_sweep)
    out = os.path.join(data_root, "out")
    _main(data_root, out, expt, "--n-iter", "1", "--vmap-sweep", *args)
    assert [f for f in _files(out) if f.endswith(".npy")
            and "stats" not in f] == ["%s/%.4i.npy" % (expt, i)
                                      for i in written]
