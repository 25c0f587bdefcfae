"""The PyTorch port stands alone: no module of mpnn_tpu_torch, and not
chip_smoke.py, imports jax or mpnn_tpu; the package and its entry point run
with jax blocked, and all but the figures without matplotlib; the entry
point refuses to run on the CPU unless asked."""

import ast
import json
import math
import os
import statistics
import subprocess
import sys

import pytest
import torch

from tests.torch_threads import share_cores  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PKG = os.path.join(REPO, "mpnn_tpu_torch")
# The port's counterparts of the repo's tools (mpnn_tpu_torch/tools/).
TOOLS = ("serving_frontier", "dense_crossover", "retrain_diverged",
         "summarize_campaign", "archive_results")
_TOOL_MODULES = ", ".join("mpnn_tpu_torch.tools." + t for t in TOOLS)


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def test_no_jax_or_mpnn_tpu_imports():
    files = _port_files()
    assert len(files) >= 21
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {"mpnn_tpu_torch/parallel/mesh.py",
            "mpnn_tpu_torch/parallel/multihost.py",
            "mpnn_tpu_torch/dryrun.py"} <= rel
    assert {"mpnn_tpu_torch/tools/%s.py" % t for t in TOOLS} <= rel
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "mpnn_tpu", "flax",
                                  "optax", "bench")]
    assert bad == []


_BLOCK_JAX = ("import sys; sys.modules['jax'] = None; "
              "sys.modules['mpnn_tpu'] = None; ")


def _run(code, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", _BLOCK_JAX + code, *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)


def test_import_with_jax_blocked():
    r = _run("import mpnn_tpu_torch, mpnn_tpu_torch.ops.kernels, "
             "mpnn_tpu_torch.models.infer, mpnn_tpu_torch.utils.serdes, "
             "mpnn_tpu_torch.experiments, mpnn_tpu_torch.infer_bench, "
             "mpnn_tpu_torch.data.synth, mpnn_tpu_torch.data.augment, "
             "mpnn_tpu_torch.models.routing, mpnn_tpu_torch.models.stats, "
             "mpnn_tpu_torch.models.optim, mpnn_tpu_torch.models.steps, "
             "mpnn_tpu_torch.utils.tree, mpnn_tpu_torch.train_bench, "
             "mpnn_tpu_torch.train, mpnn_tpu_torch.data.dataset, "
             "mpnn_tpu_torch.data.prep, mpnn_tpu_torch.models.sr, "
             "mpnn_tpu_torch.models.critic, mpnn_tpu_torch.utils.desc, "
             "mpnn_tpu_torch.ops.layers, mpnn_tpu_torch.ops.config, "
             "mpnn_tpu_torch.train_adaptive, mpnn_tpu_torch.models.net, "
             "mpnn_tpu_torch.export, mpnn_tpu_torch.export_net, "
             "mpnn_tpu_torch.oracle, mpnn_tpu_torch.paritycheck, "
             "mpnn_tpu_torch.check_parity, mpnn_tpu_torch.parallel, "
             "mpnn_tpu_torch.parallel.mesh, "
             "mpnn_tpu_torch.parallel.multihost, mpnn_tpu_torch.dryrun, "
             "mpnn_tpu_torch.figures, mpnn_tpu_torch.viz, "
             "mpnn_tpu_torch.viz.loading, mpnn_tpu_torch.viz.acc_eff, "
             "mpnn_tpu_torch.viz.nld, mpnn_tpu_torch.viz.routing, "
             "mpnn_tpu_torch.viz.pres, " + _TOOL_MODULES + "; "
             "from mpnn_tpu_torch.ops import (Conv, MaxPool, GlobalMaxPool, "
             "MultiscaleLLN, Dropout, SquaredError, ActivityError, "
             "SuperclassCrossEntropyError); "
             "from mpnn_tpu_torch.data.prep import (prepare_from_files, "
             "download_and_prepare); "
             "print('ok')")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_entry_points_import_without_matplotlib():
    """The card's machine has no matplotlib: the package and every
    training, serving, export, tool and smoke entry point import without
    it, and none of them pulls in the figures (the serving frontier
    imports them only to draw)."""
    r = _run("sys.modules['matplotlib'] = None; "
             "import mpnn_tpu_torch, mpnn_tpu_torch.train, "
             "mpnn_tpu_torch.train_adaptive, mpnn_tpu_torch.train_bench, "
             "mpnn_tpu_torch.infer_bench, mpnn_tpu_torch.kernel_bench, "
             "mpnn_tpu_torch.export, mpnn_tpu_torch.export_net, "
             "mpnn_tpu_torch.check_parity, mpnn_tpu_torch.dryrun, "
             "mpnn_tpu_torch.data.prep, mpnn_tpu_torch.figures, chip_smoke, "
             + _TOOL_MODULES + "; "
             "print(sorted(m for m in sys.modules "
             "if m.startswith('mpnn_tpu_torch.viz')))")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_infer_bench_cpu_with_jax_blocked():
    r = _run("import runpy, sys; sys.argv[0] = 'infer_bench'; "
             "runpy.run_module('mpnn_tpu_torch.infer_bench', "
             "run_name='__main__')",
             "--device", "cpu", "--batch-size", "8", "--n-batches", "1",
             "--precision", "fp32")
    assert r.returncode == 0, r.stderr
    recs = [json.loads(line) for line in r.stdout.splitlines()]
    assert [r["metric"].split()[1] for r in recs] == ["(dense,", "(routed,"]
    assert all(r["value"] > 0 and r["mean_ops_per_example"] > 0
               and r["device"] == "cpu" for r in recs)


def test_train_bench_cpu_with_jax_blocked(tmp_path):
    """It also reports the median of its windows, each window and the
    first and last loss; --profile adds the step's split (no device time
    on the CPU) and writes a Chrome trace."""
    r = _run("import runpy, sys; sys.argv[0] = 'train_bench'; "
             "runpy.run_module('mpnn_tpu_torch.train_bench', "
             "run_name='__main__')",
             "--device", "cpu", "--batch-size", "4", "--n-steps", "1",
             "--n-windows", "2", "--profile", str(tmp_path))
    assert r.returncode == 0, r.stderr
    rec, prof = [json.loads(line) for line in r.stdout.splitlines()
                 if line.startswith("{")]
    assert rec["metric"] == "train-step (fp32, batch 4)"
    assert rec["device"] == "cpu" and rec["window_steps"] == 1
    assert len(rec["window_values"]) == 2
    assert rec["value"] == statistics.median(rec["window_values"]) > 0
    assert all(map(math.isfinite, (rec["loss_first"], rec["loss_last"])))
    assert rec["fused_mcm_launches_per_step"] == 0  # no kernel on the CPU
    assert prof["steps"] == 1 and prof["device_ms_per_step"] == 0
    assert prof["device_idle_share"] is None
    assert (tmp_path / "train_fp32.json").exists()


@pytest.mark.parametrize("entry,args", [
    ("infer_bench", ["--batch-size", "8", "--n-batches", "1"]),
    ("train_bench", ["--batch-size", "8", "--n-steps", "1"]),
    ("train", ["synth-ac", "--n-iter", "1", "--data-root", "/nonexistent"]),
    ("train", ["synth-ac", "--n-iter", "20", "--profile-dir",
               "/nonexistent/trace", "--data-root", "/nonexistent"]),
    ("export_net", ["/nonexistent/net.npy", "/nonexistent/net.pt2"]),
    ("check_parity", ["/nonexistent/net.npy"]),
    ("tools.serving_frontier", ["--checkpoint", "/nonexistent/net.npy",
                                "--data", "/nonexistent/data.npz"]),
    ("tools.dense_crossover", ["--json", "/nonexistent/crossover.json"])])
def test_entry_point_refuses_cpu_unless_asked(entry, args):
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    import importlib
    main = importlib.import_module("mpnn_tpu_torch." + entry).main
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(args)


def test_chip_smoke_refuses_without_gpu():
    """No CUDA: the smoke test exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_ignore_lists_keep_served_checkpoint():
    """.gitignore's results/ block and .chiprunignore list the same paths,
    and neither drops the checkpoints that chip_smoke.py serves: the
    flagship chain, the adaptive chain, and the adaptive tree's compact
    archive with the descriptor files of its training."""
    def results_entries(name):
        with open(os.path.join(REPO, name), encoding="utf-8") as f:
            return [ln.strip() for ln in f
                    if ln.strip().startswith("results/")]

    git, chip = results_entries(".gitignore"), results_entries(".chiprunignore")
    assert git and git == chip
    tree = "results/nets/hybrid-ac-tree-dynkcpt/"
    for served in ["results/nets/hybrid-ac/0004.npy",
                   "results/nets/hybrid-ac-dynkcpt/net.npy",
                   tree + "net.npy.cz/MANIFEST.json",
                   tree + "net.npy.cz/part-00", tree + "net.npy.cz/part-01"
                   ] + [tree + "%.4i-stats.npy" % i for i in range(8)]:
        assert os.path.exists(os.path.join(REPO, served))
        assert not [e for e in chip
                    if served == e or served.startswith(e.rstrip("/") + "/")]
