"""`train --profile-dir` and `--debug-nans` on the CPU, through the CLI's
`main` on a tiny registry (a 3-stage actor chain on 16x16 inputs, as in
tests/test_torch_cli.py): the trace is written, the run's files and final
checkpoint equal a run without the flag, and the snapshots follow
`mpnn_tpu`'s rule; runs of 10 steps or fewer and --vmap-sweep are refused;
--debug-nans names the step of a NaN forced into a param and changes
nothing where there is none."""

import json
import os
from types import SimpleNamespace as Ns

import numpy as np
import pytest
import torch

from mpnn_tpu_torch import experiments as tcfg
from mpnn_tpu_torch import train as ttrain
from mpnn_tpu_torch.data.prep import save_archive
from mpnn_tpu_torch.data.synth import make_synthetic
from mpnn_tpu_torch.models.steps import check_nans
from mpnn_tpu_torch.ops import config as tconfig
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils.serdes import read_net, write_net
from tests.test_torch_sr_cr import build_chain
from tests.torch_threads import share_cores  # noqa: F401

NET = 1


def _registry():
    def ctor(k_cpt):
        return lambda x0_shape, y_shape: build_chain(
            T, "ac", tuple(x0_shape), y_shape[0], k_cpt=k_cpt)
    return {"tiny-ac": Ns(dataset="data/tiny.npz", tau=tcfg.AC_TAU,
                          sweep_k_cpts=[0.0, 1e-9],
                          nets=[ctor(0.0), ctor(1e-9)])}


@pytest.fixture
def root(tmp_path, monkeypatch):
    arch = make_synthetic(n_tr=40, n_ts=24, h=16, w=16, c=3, n_cls=10,
                          seed=1)
    save_archive(str(tmp_path / "data" / "tiny.npz"), arch)
    monkeypatch.setattr(tcfg, "make_experiments", _registry)
    yield tmp_path
    tconfig.set_debug_nans(False)


def _main(root, out, n_iter, *flags):
    ttrain.main(["tiny-ac", "--n-iter", str(n_iter), "--t-log", "5",
                 "--batch-size", "8", "--net", str(NET), "--device", "cpu",
                 "--data-root", str(root), "--out-root", str(root / out),
                 *flags])
    return root / out / "tiny-ac"


def _files(d):
    return sorted(os.path.relpath(os.path.join(p, f), d)
                  for p, _, fs in os.walk(d) for f in fs)


def _same_checkpoints(a, b):
    _, pa, sa, ea = read_net(str(a / ("%.4i.npy" % NET)), "cpu")
    _, pb, sb, eb = read_net(str(b / ("%.4i.npy" % NET)), "cpu")
    assert ea["t"] == eb["t"]
    la = [np.asarray(x) for x in _leaves((pa, sa, ea["vel"]))]
    lb = [np.asarray(x) for x in _leaves((pb, sb, eb["vel"]))]
    assert len(la) == len(lb) > 0
    assert all(np.array_equal(x, y) for x, y in zip(la, lb))
    return ea["t"]


def _leaves(tree):
    from mpnn_tpu_torch.utils.tree import tree_leaves
    return tree_leaves(tree)


def test_profile_dir_traces_and_keeps_the_run(root, capsys):
    """--n-iter 20 --t-log 5 with --profile-dir: steps 0-1 warm up, 2-9
    are traced, and the boundaries 5 and 10 inside them write nothing
    (`mpnn_tpu/train.py:200`: last_written = t_start after the trace), so
    the snapshots are 15 and 20 only; the trace file is a Chrome trace of
    8 steps; the final checkpoint equals the run without the flag bit for
    bit."""
    prof = root / "prof"
    got = _main(root, "profiled", 20, "--profile-dir", str(prof))
    out = capsys.readouterr().out
    assert "[profiler trace written to %s]" % (prof / "trace.json") in out
    with open(prof / "trace.json", encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    # Each step's update is one "optimizer" range: 8 traced steps.
    assert sum(e.get("name") == "optimizer"
               and e.get("cat") == "user_annotation" for e in events) == 8
    want = _main(root, "plain", 20)
    assert [f for f in _files(got) if "-stats/" in f] == [
        "%.4i-stats/00000015.npy" % NET, "%.4i-stats/00000020.npy" % NET]
    assert set(_files(got)) < set(_files(want))
    assert _same_checkpoints(got, want) == 20
    for name in ("%.4i-stats.npy" % NET, "%.4i-stats/00000020.npy" % NET):
        a = np.load(str(got / name), allow_pickle=True)[()]
        b = np.load(str(want / name), allow_pickle=True)[()]
        assert a == b, name


@pytest.mark.parametrize("n_iter", [4, 10])
def test_profile_dir_refuses_runs_of_ten_steps_or_fewer(root, n_iter):
    """`mpnn_tpu` would train the 10 steps anyway and then label the
    checkpoint n_iter (or, at 10, write none); the port refuses."""
    with pytest.raises(ValueError, match="more than 10 steps"):
        _main(root, "short", n_iter, "--profile-dir", str(root / "p"))
    assert not (root / "p").exists()


def test_profile_dir_refused_with_vmap_sweep(root):
    with pytest.raises(ValueError, match="--vmap-sweep does not support "
                                         "profile_dir; run serially"):
        ttrain.main(["tiny-ac", "--vmap-sweep", "--n-iter", "20",
                     "--device", "cpu", "--data-root", str(root),
                     "--out-root", str(root / "s"),
                     "--profile-dir", str(root / "p")])


def test_debug_nans_silent_without_nans(root, capsys):
    """--debug-nans on a healthy run: no error, the same files and
    checkpoint as the run without it."""
    got = _main(root, "checked", 7, "--debug-nans")
    want = _main(root, "plain", 7)
    assert _files(got) == _files(want)
    assert _same_checkpoints(got, want) == 7
    assert "NaN" not in capsys.readouterr().out


def test_debug_nans_names_the_step_of_a_forced_nan(root):
    """A NaN written into one param of the step-5 checkpoint: the resumed
    run under --debug-nans raises FloatingPointError at step 5, and the
    run without the flag trains through it."""
    d = _main(root, "nan", 5)
    path = str(d / ("%.4i.npy" % NET))
    net, params, state, extra = read_net(path, "cpu")
    leaf = _leaves(params)[0]
    leaf.view(-1)[0] = float("nan")
    write_net(path, net, params, state, extra)
    with pytest.raises(FloatingPointError, match=r"NaN at step 5 in "):
        _main(root, "nan", 7, "--resume", "--debug-nans")
    tconfig.set_debug_nans(False)
    _main(root, "nan", 7, "--resume")


def test_check_nans_finds_the_first_nan_leaf():
    """Inf passes, a NaN is named by its tree and path, the loss first."""
    ok = {"layer": {"w": torch.tensor([1.0, float("inf")])}}
    check_nans(3, loss=torch.tensor(2.0), params=ok)
    bad = {"layer": {"w": torch.ones(2), "b": torch.tensor([float("nan")])},
           "sinks": [{"w": torch.tensor([float("nan")])}]}
    with pytest.raises(FloatingPointError,
                       match=r"NaN at step 7 in params/layer/b \(2 of 5 "):
        check_nans(7, loss=torch.tensor(1.0), gradients=ok, params=bad)
    with pytest.raises(FloatingPointError, match=r"step 0 in loss \("):
        check_nans(0, loss=torch.tensor(float("nan")), params=bad)
