"""--stacked-tails through the port's CLIs on the CPU. With the registries
monkeypatched to the small actor tree of tests/test_torch_tree.py (its
two tails congruent), `python -m mpnn_tpu_torch.train --stacked-tails`
(one net, and --vmap-sweep) and `python -m mpnn_tpu_torch.train_adaptive
--stacked-tails` write the serial run's files, with descriptors within
1e-4 x max(1, |stat|) of the serial run's and checkpoints of the same
structure; `train_bench --arch tree --stacked-tails` times the stacked
step alone and as a sweep."""

import json
import os

import numpy as np
import jax
import pytest

from mpnn_tpu.data.prep import save_archive
from mpnn_tpu.data.synth import make_synthetic
from mpnn_tpu_torch import experiments as tcfg
from mpnn_tpu_torch import train as ttrain
from mpnn_tpu_torch import train_adaptive as tadaptive
from mpnn_tpu_torch.ops import config as tconfig
from mpnn_tpu_torch.ops import layers as T
from tests.test_torch_adaptive import _registry as _adaptive_registry
from tests.test_torch_adaptive import _scalars
from tests.test_torch_cli import _files
from tests.test_torch_tree_cli import _tiny_registry

DESC_TOL = 1e-4  # per scalar stat, times max(1, |stat|)


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    """The tiny archive, both port registries on the small tree, and the
    flag restored after the CLIs set it."""
    arch = make_synthetic(n_tr=40, n_ts=24, h=16, w=16, c=3, n_cls=10,
                          seed=1)
    save_archive(str(tmp_path / "data" / "tiny.npz"), arch)
    monkeypatch.setattr(tcfg, "make_experiments", _tiny_registry(tcfg, T))
    monkeypatch.setattr(tcfg, "make_adaptive_experiments",
                        _adaptive_registry(tcfg, T))
    monkeypatch.setattr(tconfig, "stacked_tails", False)
    return str(tmp_path)


def _same_outputs(serial, stacked):
    """The same files; every descriptor within DESC_TOL of the serial
    run's; checkpoints of the same structure, dtypes and shapes."""
    files = _files(serial)
    assert _files(stacked) == files
    for name in files:
        if not name.endswith(".npy"):
            continue
        a = np.load(os.path.join(stacked, name), allow_pickle=True)[()]
        b = np.load(os.path.join(serial, name), allow_pickle=True)[()]
        if "stats" in name:
            sa, sb = _scalars(a), _scalars(b)
            assert [p for p, _ in sa] == [p for p, _ in sb], name
            for (p, x), (_, y) in zip(sa, sb):
                assert abs(x - y) <= DESC_TOL * max(1.0, abs(y)), (name, p)
        else:
            assert jax.tree.structure(a) == jax.tree.structure(b), name
            assert [(np.asarray(x).dtype, np.shape(x))
                    for x in jax.tree.leaves(a)] == [
                (np.asarray(x).dtype, np.shape(x))
                for x in jax.tree.leaves(b)], name
    return files


@pytest.mark.parametrize("mode", [["--net", "1"], ["--vmap-sweep"]],
                         ids=["net", "vmap_sweep"])
def test_train_cli_stacked_writes_serial_files(data_root, mode):
    args = ["tiny-ac-tree", "--n-iter", "3", "--t-log", "2",
            "--batch-size", "8", "--device", "cpu", "--data-root",
            data_root] + mode
    ttrain.main(args + ["--out-root", os.path.join(data_root, "serial")])
    assert not tconfig.stacked_tails
    ttrain.main(args + ["--out-root", os.path.join(data_root, "stacked"),
                        "--stacked-tails"])
    assert tconfig.stacked_tails
    files = _same_outputs(os.path.join(data_root, "serial"),
                          os.path.join(data_root, "stacked"))
    assert "tiny-ac-tree/0001.npy" in files


def test_train_adaptive_cli_stacked_writes_serial_files(data_root, capsys):
    args = ["tiny-ac-tree-dynkcpt", "--n-iter", "4", "--t-log", "2",
            "--batch-size", "8", "--stats-log", "--device", "cpu",
            "--data-root", data_root]
    lines = {}
    for name, extra in (("serial", []), ("stacked", ["--stacked-tails"])):
        tadaptive.main(args + ["--out-root", os.path.join(data_root, name)]
                       + extra)
        lines[name] = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert not lines["serial"]["stacked_tails"]
    assert lines["stacked"]["stacked_tails"]
    assert lines["stacked"]["steps"] == lines["serial"]["steps"] == 4
    files = _same_outputs(os.path.join(data_root, "serial"),
                          os.path.join(data_root, "stacked"))
    assert len(files) == 2 + 8 + 8 * 2  # MANIFEST, net, latest, snapshots


def test_train_bench_times_the_stacked_tree(capsys, monkeypatch):
    """train_bench --arch tree --stacked-tails, alone and as a sweep of 2,
    on the small tree in the registry tree's place."""
    from mpnn_tpu_torch import train_bench
    from tests.test_torch_tree import build_tree
    monkeypatch.setattr(tconfig, "stacked_tails", False)
    monkeypatch.setattr(train_bench, "_ctor", lambda arch: lambda **h: (
        lambda x0_shape, y_shape: build_tree(T, "ac", x0_shape, y_shape[0],
                                             **h)))
    for extra, metric in (
            ([], "train-step (tree, stacked tails, fp32, batch 2)"),
            (["--sweep", "2"],
             "train-sweep (tree, stacked tails, fp32, 2 nets x batch 2)")):
        train_bench.main(["--device", "cpu", "--batch-size", "2",
                          "--n-steps", "2", "--n-windows", "1", "--arch",
                          "tree", "--stacked-tails"] + extra)
        rec = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert rec["metric"] == metric and rec["value"] > 0
        assert rec["stacked_tails"] and np.isfinite(rec["loss_last"]).all()
