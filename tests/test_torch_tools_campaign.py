"""The port's campaign tools (`mpnn_tpu_torch.tools.retrain_diverged`,
`.summarize_campaign`, `.archive_results`) against the repo's tools on the
CPU: every case of tests/test_retrain_diverged.py, tests/test_summarize.py,
tests/test_archive.py and the archive cases of tests/test_compact_ckpt.py,
against the port's module; then both packages on the same directories,
whose outputs and file trees are equal, byte for byte."""

import contextlib
import importlib.util
import io
import os
import shutil
import sys
from glob import glob
from unittest import mock

import numpy as np
import pytest
import torch

from mpnn_tpu_torch import train as ttrain
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.tools import archive_results as ar
from mpnn_tpu_torch.tools import retrain_diverged as rd
from mpnn_tpu_torch.tools import summarize_campaign as sc
from mpnn_tpu_torch.utils.serdes import read_net, write_net
from mpnn_tpu_torch.utils.tree import tree_leaves
from tests.test_torch_sr_cr import build_chain
from tests.torch_threads import share_cores  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        "jax_" + name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jrd, jsc, jar = (_jax_tool(n) for n in (
    "retrain_diverged", "summarize_campaign", "archive_results"))


def _files(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _stdout(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args, **kwargs)
    return buf.getvalue()


# --- retrain_diverged ------------------------------------------------------

def _desc(acc, n_cls=10):
    """Minimal descriptor with the fields the scanner reads."""
    return {"stats_ts": {"acc": acc},
            "root": {"sinks": [{"stats_ts": {"p_cor_by_cls": [0.0] * n_cls},
                                "sinks": []}]}}


def _expt(d):
    d.mkdir(parents=True)
    for i, acc in enumerate([0.104, 0.95, 0.61]):
        np.save(d / ("%.4i-stats.npy" % i), _desc(acc))
        (d / ("%.4i-log.txt" % i)).write_text("trajectory\n")
        (d / ("%.4i.npy" % i)).write_bytes(b"ckpt")
        snap = d / ("%.4i-stats" % i)
        snap.mkdir()
        (snap / "00002500.npy").write_bytes(b"snap")
    return d


@pytest.fixture
def expt_dir(tmp_path):
    return _expt(tmp_path / "cifar10-x")


def test_diverged_detection_uses_descriptor_chance_level(expt_dir):
    dead = rd.diverged_members(str(expt_dir))
    assert [(i, n) for i, _, n in dead] == [(0, 10)]


def test_diverged_detection_5class(tmp_path):
    d = tmp_path / "cifar5-x"
    d.mkdir()
    np.save(d / "0000-stats.npy", _desc(0.194, n_cls=5))
    np.save(d / "0001-stats.npy", _desc(0.35, n_cls=5))
    assert [i for i, _, _ in rd.diverged_members(str(d))] == [0]


def test_low_class_count_uses_additive_threshold(tmp_path):
    d = tmp_path / "cifar2-x"
    d.mkdir()
    np.save(d / "0000-stats.npy", _desc(0.70, n_cls=2))
    np.save(d / "0001-stats.npy", _desc(0.52, n_cls=2))
    assert [i for i, _, _ in rd.diverged_members(str(d))] == [1]


def test_interrupted_retry_hole_is_redetected(expt_dir):
    rd.preserve_diverged(str(expt_dir), 0, seed=0)
    np.save(expt_dir / "0002-stats.npy", _desc(0.102))
    assert [i for i, _, _ in rd.diverged_members(str(expt_dir))] == [0, 2]


def _mirrored(tmp_path):
    (tmp_path / "nets" / "cifar10-x").mkdir(parents=True)
    mirror = tmp_path / "results" / "nets" / "cifar10-x"
    mirror.mkdir(parents=True)
    live = tmp_path / "nets" / "cifar10-x"
    for d in (live, mirror):
        np.save(d / "0000-stats.npy", _desc(0.104))
        (d / "0000-log.txt").write_text("trajectory\n")
        (d / "0000.npy").write_bytes(b"ckpt")
    return live, mirror


def test_preserve_diverged_mirrors_results_archive(tmp_path):
    live, mirror = _mirrored(tmp_path)
    rd.preserve_diverged(str(live), 0, seed=0)
    for d in (live, mirror):
        assert not (d / "0000-stats.npy").exists()
        assert (d / "0000-stats-diverged-seed0.npy").exists()
        assert not (d / "0000.npy").exists()


def test_preserve_diverged_renames_and_drops_ckpt(expt_dir):
    rd.preserve_diverged(str(expt_dir), 0, seed=0)
    names = sorted(os.path.basename(p) for p in glob(str(expt_dir / "0000*")))
    assert names == ["0000-log-diverged-seed0.txt",
                     "0000-stats-diverged-seed0",
                     "0000-stats-diverged-seed0.npy"]
    hits = glob(str(expt_dir / "*-stats.npy"))
    assert sorted(os.path.basename(p) for p in hits) == [
        "0001-stats.npy", "0002-stats.npy"]
    assert not os.path.exists(expt_dir / "0000.npy")


def test_retrain_functions_match_jax(tmp_path):
    """Both packages' scans agree on the same directories, and their
    preserve_diverged leave equal trees (the results/ mirror too)."""
    for pkg in ("port", "jax"):
        _expt(tmp_path / pkg / "cifar10-x")
        _mirrored(tmp_path / pkg / "m")
        np.save(tmp_path / pkg / "cifar10-x" / "0002-stats.npy",
                _desc(0.30, n_cls=5))
    for pkg, mod in (("port", rd), ("jax", jrd)):
        d = str(tmp_path / pkg / "cifar10-x")
        assert mod.diverged_members(d) == rd.diverged_members(
            str(tmp_path / "jax" / "cifar10-x"))
        mod.preserve_diverged(d, 0, seed=100)
        mod.preserve_diverged(str(tmp_path / pkg / "m" / "nets" /
                                  "cifar10-x"), 0, seed=7)
        assert [i for i, _, _ in mod.diverged_members(d)] == [0]
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_retrain_command_parses_under_the_training_cli(tmp_path):
    with mock.patch("subprocess.run") as run:
        rd.retrain("synth-ac", [0, 5], 100, str(tmp_path), n_iter=40,
                   train_args=["--precision", "bf16", "--analytic-l2",
                               "--device", "cpu"])
    (cmd,), kwargs = run.call_args
    assert kwargs == {"check": True}
    assert cmd[:3] == [sys.executable, "-m", "mpnn_tpu_torch.train"]
    args, _ = ttrain._parse(cmd[3:])
    assert (args.expt, args.seed, args.out_root, args.net, args.n_iter,
            args.precision, args.analytic_l2, args.device) == (
        "synth-ac", 100, str(tmp_path), [0, 5], 40, "bf16", True, "cpu")


def test_retrain_main_preserves_then_retrains(tmp_path):
    """main with a dead member: its evidence kept under seed 0 + i, one
    retrain at seed 100 with the campaign's flags, on the training CLI's
    own default device, then a clean scan ends the attempts; a dry run
    prints as JAX's does."""
    d = tmp_path / "synth-ac"
    d.mkdir()
    np.save(d / "0003-stats.npy", _desc(0.09))
    np.save(d / "0004-stats.npy", _desc(0.90))
    jd = tmp_path / "jax" / "synth-ac"
    shutil.copytree(d, jd)
    argv = ["synth-ac", "--out-root", str(tmp_path), "--dry-run"]
    with mock.patch.object(sys, "argv", ["retrain_diverged"] + [
            "synth-ac", "--out-root", str(tmp_path / "jax"), "--dry-run"]):
        want = _stdout(jrd.main)
    assert _stdout(rd.main, argv) == want
    assert "would retry with seed 103" in want

    def fake_train(cmd, check):
        args, _ = ttrain._parse(cmd[3:])
        assert (args.seed, args.net, args.precision, args.analytic_l2,
                args.device) == (100, [3], "bf16", True, "cuda")
        np.save(d / "0003-stats.npy", _desc(0.88))

    with mock.patch("subprocess.run", side_effect=fake_train) as run:
        assert rd.main(argv[:-1]) == 0
    assert run.call_count == 1
    assert (d / "0003-stats-diverged-seed3.npy").exists()
    assert rd.diverged_members(str(d)) == []


def test_retrain_main_passes_the_users_train_args(tmp_path):
    """--train-arg flags replace the campaign's and reach the training
    CLI as given, its --device too; nothing is appended after them."""
    d = tmp_path / "synth-ac"
    d.mkdir()
    np.save(d / "0001-stats.npy", _desc(0.09))
    cmds = []

    def fake_train(cmd, check):
        cmds.append(cmd)
        np.save(d / "0001-stats.npy", _desc(0.88))

    with mock.patch("subprocess.run", side_effect=fake_train):
        assert rd.main(["synth-ac", "--out-root", str(tmp_path),
                        "--train-arg=--device=cpu",
                        "--train-arg=--precision=fp32"]) == 0
    (cmd,) = cmds
    assert cmd[-2:] == ["--device=cpu", "--precision=fp32"]
    args, _ = ttrain._parse(cmd[3:])
    assert (args.seed, args.net, args.device, args.precision,
            args.analytic_l2) == (100, [1], "cpu", "fp32", False)


# --- summarize_campaign ----------------------------------------------------

def _write_sweep(root, expt, errs):
    d = root / expt
    d.mkdir(parents=True)
    for i, err in enumerate(errs):
        np.save(d / f"{i:04d}-stats.npy",
                {"stats_ts": {"acc": 1.0 - err, "moc": 1e6 * (i + 1)}})


def test_outlier_flags_aggressive_price_vs_unexplained(tmp_path):
    errs = [0.05] * 8
    errs[7] = 0.40
    errs[2] = 0.30
    _write_sweep(tmp_path, "hybrid-ac", errs)
    rows = dict(sc.sweep_rows(str(tmp_path)))
    flags = sc.outliers("hybrid-ac", rows["hybrid-ac"])
    assert len(flags) == 2
    joined = " ".join(flags)
    assert "k_cpt=6.4e-08" in joined and "aggressive price" in joined
    assert "UNEXPLAINED" in joined
    by_member = {f.split()[0]: f for f in flags}
    assert "aggressive price" in by_member["0007"]
    assert "UNEXPLAINED" in by_member["0002"]


def test_outlier_sr_depth_sweep_shallow_expected(tmp_path):
    errs = [0.20, 0.05, 0.05, 0.05, 0.05, 0.05, 0.05, 0.18]
    _write_sweep(tmp_path, "hybrid-sr", errs)
    rows = dict(sc.sweep_rows(str(tmp_path)))
    flags = sc.outliers("hybrid-sr", rows["hybrid-sr"])
    assert len(flags) == 2
    by_member = {f.split()[0]: f for f in flags}
    assert "capacity-limited" in by_member["0000"]
    assert "depth=1" in by_member["0000"]
    assert "UNEXPLAINED" in by_member["0007"]
    assert "depth=8" in by_member["0007"]


def test_no_flags_within_bar(tmp_path):
    _write_sweep(tmp_path, "hybrid-ac", [0.05, 0.06, 0.07, 0.05,
                                         0.06, 0.08, 0.10, 0.14])
    rows = dict(sc.sweep_rows(str(tmp_path)))
    assert sc.outliers("hybrid-ac", rows["hybrid-ac"]) == []


def test_outlier_probe_retrain_explains(tmp_path):
    errs = [0.05] * 8
    errs[7] = 0.18
    _write_sweep(tmp_path / "nets", "hybrid-sr", errs)
    probe = tmp_path / "nets-probe" / "hybrid-sr"
    probe.mkdir(parents=True)
    np.save(probe / "0007-stats.npy",
            {"stats_ts": {"acc": 0.93, "moc": 1e6}})
    rows = dict(sc.sweep_rows(str(tmp_path / "nets")))
    flags = sc.outliers("hybrid-sr", rows["hybrid-sr"],
                        probe_dir=str(tmp_path / "nets-probe"))
    assert len(flags) == 1 and "seed instability" in flags[0]
    np.save(probe / "0007-stats.npy",
            {"stats_ts": {"acc": 0.80, "moc": 1e6}})
    flags = sc.outliers("hybrid-sr", rows["hybrid-sr"],
                        probe_dir=str(tmp_path / "nets-probe"))
    assert len(flags) == 1 and "systematic" in flags[0]


def test_summary_table_matches_jax_byte_for_byte(tmp_path, monkeypatch):
    """Every labelling route (cost sweep, SR depths, an adaptive
    directory of 8 price snapshots, an unknown experiment, a probe
    retrain) through both mains, with --full."""
    nets = tmp_path / "nets"
    errs = [0.05] * 8
    errs[7], errs[2] = 0.40, 0.30
    _write_sweep(nets, "hybrid-ac", errs)
    _write_sweep(nets, "hybrid-sr", [0.20] + [0.05] * 6 + [0.18])
    _write_sweep(nets, "hybrid-ac-dynkcpt", [0.05] * 6 + [0.20, 0.30])
    _write_sweep(nets, "my-probe-expt", [0.1, 0.1, 0.5])
    (nets / "empty").mkdir()
    probe = tmp_path / "nets-probe" / "hybrid-sr"
    probe.mkdir(parents=True)
    np.save(probe / "0007-stats.npy",
            {"stats_ts": {"acc": 0.93, "moc": 1e6}})
    monkeypatch.chdir(tmp_path)
    argv = ["--nets-dir", "nets", "--full"]
    with mock.patch.object(sys, "argv", ["summarize_campaign"] + argv):
        want = _stdout(jsc.main)
    got = _stdout(sc.main, argv)
    assert got == want
    assert "UNEXPLAINED" in got and "seed instability" in got
    assert got.count("\n| ") == 4  # the rows of 4 experiments


# --- archive_results -------------------------------------------------------

def _repo(tmp_path):
    nets = tmp_path / "nets" / "synth-sr"
    nets.mkdir(parents=True)
    (nets / "0000-stats.npy").write_bytes(b"stats0")
    (nets / "0000-log.txt").write_text("log line\n")
    (nets / "MANIFEST.json").write_text('{"dataset": "synthetic"}')
    (nets / "0000.npy").write_bytes(b"x" * 100)
    (nets / "net.npy").write_bytes(b"x" * 100)
    (nets / "huge.npy").write_bytes(b"x" * 2 * 1024 * 1024)
    hist = nets / "0000-stats"
    hist.mkdir()
    (hist / "00000030.npy").write_bytes(b"snap")
    logs = tmp_path / "nets" / "campaign-logs"
    logs.mkdir()
    (logs / "campaign.log").write_text("=== start\n")
    (logs / "synth-sr.log").write_text("per-run stdout (excluded)\n")
    figs = tmp_path / "figures"
    figs.mkdir()
    (figs / "acc-eff.svg").write_text("<svg/>")
    return tmp_path


@pytest.fixture
def repo(tmp_path):
    return _repo(tmp_path)


def test_archive_selects_compact_artifacts(repo):
    out = repo / "results"
    n_copied, n_kept = ar.archive(["nets", "figures"], str(out), 512,
                                  repo=str(repo))
    got = sorted(_files(out))
    assert got == [
        "figures/acc-eff.svg",
        "nets/campaign-logs/campaign.log",
        "nets/synth-sr/0000-log.txt",
        "nets/synth-sr/0000-stats.npy",
        "nets/synth-sr/0000-stats/00000030.npy",
        "nets/synth-sr/MANIFEST.json",
    ]
    assert n_copied == len(got)
    n_copied, n_kept = ar.archive(["nets", "figures"], str(out), 512,
                                  repo=str(repo))
    assert n_copied == 0 and n_kept == len(got) - 1


def test_archive_recopies_on_change(repo):
    out = repo / "results"
    ar.archive(["nets"], str(out), 512, repo=str(repo))
    stats = repo / "nets" / "synth-sr" / "0000-stats.npy"
    stats.write_bytes(b"stats0+updated")
    os.utime(stats, None)
    n_copied, _ = ar.archive(["nets"], str(out), 512, repo=str(repo))
    assert n_copied == 1
    assert (out / "nets" / "synth-sr" /
            "0000-stats.npy").read_bytes() == b"stats0+updated"


def test_archive_checkpoints_opt_in_with_cap(repo, capsys):
    out = repo / "results"
    big = repo / "nets" / "synth-sr" / "0001.npy"
    big.write_bytes(b"x" * 2 * 1024 * 1024)
    ar.archive(["nets"], str(out), 512, repo=str(repo), ckpt_max_kb=1024)
    assert (out / "nets" / "synth-sr" / "0000.npy").exists()
    assert (out / "nets" / "synth-sr" / "net.npy").exists()
    assert not (out / "nets" / "synth-sr" / "0001.npy").exists()
    assert "skip checkpoint over --ckpt-max-kb" in capsys.readouterr().out
    fresh = repo / "fresh-vm"
    fresh.mkdir()
    ar.restore(str(out), repo=str(fresh))
    assert (fresh / "nets" / "synth-sr" /
            "0000.npy").read_bytes() == b"x" * 100
    (fresh / "nets" / "synth-sr" / "0000.npy").write_bytes(b"live")
    ar.restore(str(out), repo=str(fresh))
    assert (fresh / "nets" / "synth-sr" /
            "0000.npy").read_bytes() == b"live"


def test_restore_never_overwrites_live_files(repo, tmp_path):
    out = repo / "results"
    ar.archive(["nets", "figures"], str(out), 512, repo=str(repo))
    fresh = tmp_path / "fresh-vm"
    fresh.mkdir()
    assert ar.restore(str(out), repo=str(fresh)) == 6
    assert (fresh / "nets" / "synth-sr" /
            "0000-stats.npy").read_bytes() == b"stats0"
    assert not (fresh / "nets" / "synth-sr" / "0000.npy").exists()
    live = fresh / "nets" / "synth-sr" / "0000-stats.npy"
    live.write_bytes(b"live-training-output")
    assert ar.restore(str(out), repo=str(fresh)) == 0
    assert live.read_bytes() == b"live-training-output"


def test_restore_skips_direct_results_artifacts(repo, tmp_path):
    out = repo / "results"
    ar.archive(["nets", "figures"], str(out), 512, repo=str(repo))
    (out / "bench-r5-warmcheck.json").write_text('{"v": 1}')
    sf = out / "serving-frontier"
    sf.mkdir()
    (sf / "chain-frontier.json").write_text("{}")
    fresh = tmp_path / "fresh-vm"
    fresh.mkdir()
    ar.restore(str(out), repo=str(fresh))
    assert (fresh / "nets" / "synth-sr" / "0000-stats.npy").exists()
    assert (fresh / "figures" / "acc-eff.svg").exists()
    assert not (fresh / "bench-r5-warmcheck.json").exists()
    assert not (fresh / "serving-frontier").exists()


def _small_ckpt(path):
    """A 3-stage actor chain's checkpoint, params from a seed, written by
    the port."""
    net = build_chain(T, "ac")
    write_net(str(path), net, *net.init(torch.Generator().manual_seed(0),
                                        "cpu"))


def _bf16(a):
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    r = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        >> np.uint32(16)
    return (r << np.uint32(16)).view(np.float32)


def test_archive_restore_prune_compact(tmp_path):
    expdir = tmp_path / "nets" / "synth-ac-fat"
    expdir.mkdir(parents=True)
    ckpt = expdir / "0000.npy"
    _small_ckpt(ckpt)
    _, params, state, _ = read_net(str(ckpt), "cpu")
    cap_kb = max(1, int(os.path.getsize(ckpt) / 1024 // 3))
    out = tmp_path / "results"

    ar.archive(["nets"], str(out), 512, repo=str(tmp_path),
               ckpt_max_kb=cap_kb)
    czdir = out / "nets" / "synth-ac-fat" / "0000.npy.cz"
    assert czdir.is_dir() and (czdir / "MANIFEST.json").exists()
    parts = [n for n in os.listdir(czdir) if n.startswith("part-")]
    assert len(parts) >= 2
    assert all(os.path.getsize(czdir / p) <= cap_kb * 1024 for p in parts)
    _, kept = ar.archive(["nets"], str(out), 512, repo=str(tmp_path),
                         ckpt_max_kb=cap_kb)
    assert kept >= 1 and (czdir / "MANIFEST.json").exists()

    ckpt.unlink()
    assert ar.restore(str(out), repo=str(tmp_path)) >= 1 and ckpt.exists()
    _, params3, state3, _ = read_net(str(ckpt), "cpu")
    for a, b in zip(tree_leaves((params, state)),
                    tree_leaves((params3, state3))):
        np.testing.assert_array_equal(_bf16(a.numpy()), b.numpy())
    assert not (expdir / "0000.npy.cz").exists()

    assert ar.prune(["nets"], str(out), repo=str(tmp_path)) == 0
    assert czdir.is_dir()
    ckpt.unlink()
    assert ar.prune(["nets"], str(out), repo=str(tmp_path)) >= 1
    assert not czdir.exists()


def test_archive_size_class_change_never_leaves_both(tmp_path):
    expdir = tmp_path / "nets" / "synth-ac"
    expdir.mkdir(parents=True)
    ckpt = expdir / "0000.npy"
    _small_ckpt(ckpt)
    size_kb = os.path.getsize(ckpt) / 1024
    out = tmp_path / "results"
    ar.archive(["nets"], str(out), 512, repo=str(tmp_path),
               ckpt_max_kb=max(1, int(size_kb // 3)))
    dst = out / "nets" / "synth-ac" / "0000.npy"
    assert (dst.parent / "0000.npy.cz").is_dir() and not dst.exists()
    ar.archive(["nets"], str(out), 512, repo=str(tmp_path),
               ckpt_max_kb=int(size_kb) + 64)
    assert dst.exists() and not (dst.parent / "0000.npy.cz").exists()
    ar.archive(["nets"], str(out), 512, repo=str(tmp_path),
               ckpt_max_kb=max(1, int(size_kb // 3)))
    assert (dst.parent / "0000.npy.cz").is_dir() and not dst.exists()


def test_archive_and_restore_match_jax_byte_for_byte(tmp_path):
    """archive (checkpoints, a compact one, a torn one), prune, then
    restore on a fresh tree through each package: the same files with
    the same bytes, and the same printed lines."""
    trees = {}
    for pkg, mod in (("port", ar), ("jax", jar)):
        root = _repo(tmp_path / pkg)
        ck = root / "nets" / "synth-ac"
        ck.mkdir()
        _small_ckpt(ck / "0000.npy")
        shutil.copy(ck / "0000.npy", ck / "0001.npy")
        (ck / "0002.npy").write_bytes(b"x" * 40 * 1024)  # torn
        out = root / "results"
        (out / "nets" / "gone").mkdir(parents=True)
        (out / "nets" / "gone" / "0000-stats.npy").write_bytes(b"old")
        cap = max(1, int(os.path.getsize(ck / "0000.npy") / 1024 // 2))
        (ck / "0001.npy").write_bytes((ck / "0001.npy").read_bytes()[:100])
        printed = _stdout(lambda: (
            mod.prune(["nets"], str(out), repo=str(root)),
            mod.archive(["nets", "figures"], str(out), 512, repo=str(root),
                        ckpt_max_kb=cap)))
        fresh = root / "fresh"
        fresh.mkdir()
        restored = mod.restore(str(out), repo=str(fresh))
        trees[pkg] = (_files(out), _files(fresh), restored,
                      printed.replace(str(root), "ROOT"))
    assert trees["port"] == trees["jax"]
    results, fresh, restored, printed = trees["port"]
    assert "nets/synth-ac/0000.npy.cz/MANIFEST.json" in results
    assert "nets/synth-ac/0000.npy" in fresh and restored >= 7
    assert "compact encode failed" in printed
    assert not any(k.startswith("nets/gone") for k in results)


def test_write_compact_files_equal_jax_byte_for_byte(tmp_path):
    """The flagship checkpoint's record, with a Fortran-ordered float
    array added: the port's write_compact writes mpnn_tpu's files, byte
    for byte, and reads the array back in its order."""
    from mpnn_tpu.utils import serdes as jserdes
    from mpnn_tpu_torch.utils import serdes as tserdes
    rec = np.load(os.path.join(REPO, "results", "nets", "hybrid-ac",
                               "0004.npy"), allow_pickle=True)[()]
    rec["f_order"] = np.asfortranarray(
        np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4))
    for mod, name in ((tserdes, "t"), (jserdes, "j")):
        mod.write_compact(str(tmp_path / name), rec, part_bytes=1 << 20,
                          src_sha="ab12")
    port = _files(tmp_path / "t")
    assert len(port) == 4 and port == _files(tmp_path / "j")
    back = tserdes.read_compact(str(tmp_path / "t"))["f_order"]
    assert back.flags.f_contiguous
    np.testing.assert_array_equal(back, _bf16(rec["f_order"]))
