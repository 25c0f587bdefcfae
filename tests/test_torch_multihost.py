"""The port's multi-process runs on the CPU: ranks in processes of their
own, joined over gloo from torchrun's environment variables
(`tests/torch_mesh_workers.py`), and the CLI's own ranks.

- `multihost`'s helpers on 2 ranks: the primary, the all-gather through
  an all-reduce, rank 0's state broadcast, the resume desync check, a
  barrier.
- `train_experiment` over a 2-rank data mesh (`train_one_net`): rank 0
  alone writes, and its files equal the single-process run's; a resume
  that only rank 0's checkpoint could serve fails loud on both ranks.
- The vmapped sweep over a 2x1 sweep mesh: each rank writes its members'
  files, each file once, equal to the meshless sweep's.
- The CLI: `--mesh 2x1 --device cpu` starts its own 2 ranks, and
  `python -m torch.distributed.run --nproc-per-node 2 ... --multihost
  --mesh auto` runs under torchrun; their files equal the single-process
  run's.

Files are compared within the training gates: checkpoints of the small
nets per leaf to 1e-4 in ||mesh - single|| / ||single|| (`LEAF_TOL`; the
biases before a train-mode BatchNorm held as noise), the full-width
flagship's within chip_smoke.py's fp32 gates (`GATES`), BatchNorm
statistics to 1e-4 per leaf, descriptor stats to 1e-4 x
max(1, |stat|)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from mpnn_tpu_torch import experiments as tcfg
from mpnn_tpu_torch import train as ttrain
from mpnn_tpu_torch.data.prep import save_archive
from mpnn_tpu_torch.data.synth import make_synthetic
from mpnn_tpu_torch.parallel.multihost import free_port
from mpnn_tpu_torch.utils.serdes import read_net
from tests import torch_mesh_workers as W
from tests.test_torch_train import LEAF_TOL, _assert_tree_close, _paths
from tests.torch_threads import share_cores  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DESC_TOL = 1e-4
# The fp32 training gates of chip_smoke.py (TRAIN_TOL), for one step of
# the full-width flagship.
GATES = {"tree": 1e-3, "leaf": 5e-2, "zero_grad": 1e-6}


def test_multihost_helpers_on_two_ranks():
    r = W.run_ranks(W.collectives, 2)
    assert [x["primary"] for x in r] == [True, False]
    for x in r:
        np.testing.assert_array_equal(x["rows"], [[0, 10], [1, 11]])
        np.testing.assert_array_equal(x["tree"]["w"], np.zeros(3))
        np.testing.assert_array_equal(x["tree"]["v"][0], [0.0, 1.0])
        assert "resume desync" in x["desync"]
        assert x["device"] == "cpu"
    assert [x["mesh"] for x in r] == [({"data": 2, "model": 1}, 0),
                                      ({"data": 2, "model": 1}, 1)]
    # A 2x1 sweep mesh's one-rank 'data' axis reduces nothing.
    assert [x["reduces"] for x in r] == [(True, False), (True, False)]


@pytest.fixture
def data_root(tmp_path, monkeypatch):
    save_archive(str(tmp_path / "data" / "tiny.npz"),
                 make_synthetic(n_tr=40, n_ts=24, h=16, w=16, c=3,
                                n_cls=10, seed=1))
    monkeypatch.setattr(tcfg, "make_experiments", W.tiny_registry)
    return str(tmp_path)


def _single(data_root, expt, n_iter, vmap_sweep):
    out = os.path.join(data_root, "single")
    ttrain.train_experiment(expt, n_iter=n_iter, t_log=2, batch_size=8,
                            data_root=data_root, out_root=out,
                            verbose=False, device="cpu",
                            vmap_sweep=vmap_sweep)
    return os.path.join(out, expt)


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _scalars(desc, path=""):
    if isinstance(desc, dict):
        return {k: v for key in sorted(desc) for k, v in
                _scalars(desc[key], "%s/%s" % (path, key)).items()}
    if isinstance(desc, list):
        return {k: v for i, d in enumerate(desc)
                for k, v in _scalars(d, "%s[%d]" % (path, i)).items()}
    if isinstance(desc, str):
        return {}
    return {path: np.asarray(desc, np.float64)}


def _assert_gates(got, want):
    """`got` within GATES of `want`: over the whole tree and per leaf, the
    biases before a train-mode BatchNorm (`_paths`) held as noise."""
    a, b = _paths(got), _paths(want)
    assert [e[0] for e in a] == [e[0] for e in b]
    total = np.sqrt(sum(np.sum(np.square(e[1])) for e in b))
    num = den = 0.0
    for (path, x, zero), (_, y, _) in zip(a, b):
        if zero:
            assert max(np.linalg.norm(x), np.linalg.norm(y)) <= (
                GATES["zero_grad"] * total), path
            continue
        d, n = np.linalg.norm(x - y), np.linalg.norm(y)
        assert d <= GATES["leaf"] * n, (path, d, n)
        num, den = num + d * d, den + n * n
    assert np.sqrt(num / den) <= GATES["tree"]


def _assert_net_files_close(got_dir, want_dir, i, n_evals, gates=False):
    """Net i's checkpoint, latest stats and log in got_dir against
    want_dir's: per leaf within LEAF_TOL, or within GATES."""
    _, gp, gs, gx = read_net(os.path.join(got_dir, "%.4i.npy" % i), "cpu")
    _, wp, ws, wx = read_net(os.path.join(want_dir, "%.4i.npy" % i), "cpu")
    assert gx["t"] == wx["t"]
    _assert_tree_close(W.to_np(gs), W.to_np(ws), LEAF_TOL)
    for g, w in ((gp, wp), (gx["vel"], wx["vel"])):
        if gates:
            _assert_gates(W.to_np(g), W.to_np(w))
        else:
            _assert_tree_close(W.to_np(g), W.to_np(w), LEAF_TOL,
                               zero_grad_biases=True)
    load = lambda d: np.load(os.path.join(d, "%.4i-stats.npy" % i),  # noqa
                             allow_pickle=True)[()]
    got, want = _scalars(load(got_dir)), _scalars(load(want_dir))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert np.all(np.abs(got[k] - v) <= DESC_TOL * np.maximum(
            1.0, np.abs(v))), k
    with open(os.path.join(got_dir, "%.4i-log.txt" % i)) as f:
        assert f.read().count("Epoch") == n_evals  # written once each


def test_data_parallel_train_single_writer(data_root):
    """tiny-sr over 2 ranks: rank 0 writes every file, rank 1 none, and
    they equal the single-process run's; resuming where only rank 0's
    directory has the checkpoint fails loud on both ranks."""
    want = _single(data_root, "tiny-sr", 4, False)
    out = os.path.join(data_root, "mesh")
    r = W.run_ranks(W.train_rank, 2, data_root, out, "tiny-sr", None, 4)
    got = os.path.join(out, "rank0", "tiny-sr")
    assert not os.path.exists(os.path.join(out, "rank1"))
    assert _files(got) == _files(want)
    _assert_net_files_close(got, want, 0, 2)
    for x in r:
        assert x["timings"][0]["steps"] == 4
        assert "resume desync" in x["resumed"]


def test_sweep_mesh_train_writes_each_member_once(data_root):
    """tiny-ac's 4-net sweep over a 2x1 sweep mesh: rank 0 writes members
    0 and 1 and the manifest, rank 1 members 2 and 3, and every member's
    files equal the meshless sweep's."""
    want = _single(data_root, "tiny-ac", 3, True)
    out = os.path.join(data_root, "mesh")
    W.run_ranks(W.train_rank, 2, data_root, out, "tiny-ac", (2, 1), 3)
    got = [os.path.join(out, "rank%d" % r, "tiny-ac") for r in range(2)]
    files = [_files(d) for d in got]
    assert sorted(files[0] + files[1]) == _files(want)
    assert "MANIFEST.json" in files[0]
    assert {f[:4] for f in files[0] if f[0] == "0"} == {"0000", "0001"}
    assert {f[:4] for f in files[1]} == {"0002", "0003"}
    for i in range(4):
        _assert_net_files_close(got[i // 2], want, i, 2)


def _cli(out, *argv, launcher=()):
    """The training CLI in a process of its own, output to the file out."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    with open(out, "w") as f:
        return subprocess.Popen([sys.executable, *launcher, "-m",
                                 "mpnn_tpu_torch.train", *argv], cwd=REPO,
                                env=env, stdout=f, stderr=subprocess.STDOUT,
                                text=True)


def _done(proc, out):
    try:
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    with open(out) as f:
        text = f.read()
    assert rc == 0, text[-3000:]
    return text


def test_cli_mesh_and_torchrun(tmp_path):
    """synth-ac net 4 (the flagship chain at full width, on a small
    synthetic archive) for one step: `--mesh 2x1` starts 2 ranks itself,
    torchrun starts 2 with `--multihost --mesh auto`; both write the
    single-process run's files once. (One step: the CPU's fp32 step at
    batch 16 is itself 1.3e-4 off float64 over the velocity tree, the
    2-rank step 2.2e-6, and a second step at lr 0.1 grows the gap to
    4e-3, past the one-step gates.)"""
    save_archive(str(tmp_path / "data" / "synth.npz"),
                 make_synthetic(n_tr=48, n_ts=16, seed=2))
    args = ("synth-ac", "--net", "4", "--n-iter", "1", "--t-log", "2",
            "--batch-size", "16", "--device", "cpu", "--data-root",
            str(tmp_path))
    out = {k: str(tmp_path / (k + ".out")) for k in ("spawn", "torchrun")}
    procs = {"spawn": _cli(out["spawn"], *args, "--out-root",
                           str(tmp_path / "spawn"), "--mesh", "2x1"),
             "torchrun": _cli(out["torchrun"], *args, "--out-root",
                              str(tmp_path / "torchrun"), "--multihost",
                              "--mesh", "auto",
                              launcher=("-m", "torch.distributed.run",
                                        "--nproc-per-node", "2",
                                        "--master-port",
                                        str(free_port())))}
    try:
        ttrain.main([*args, "--out-root", str(tmp_path / "single")])
        texts = {k: _done(p, out[k]) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    assert "[multihost: rank 0 of 2]" in texts["torchrun"]
    want = str(tmp_path / "single" / "synth-ac")
    for run in ("spawn", "torchrun"):
        got = str(tmp_path / run / "synth-ac")
        assert _files(got) == _files(want)
        _assert_net_files_close(got, want, 4, 1, gates=True)
