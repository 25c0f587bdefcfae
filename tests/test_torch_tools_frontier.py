"""The port's serving frontier and dense/routed crossover
(`mpnn_tpu_torch.tools.serving_frontier`, `.dense_crossover`) against
`tools/serving_frontier.py` and `mpnn_tpu`'s engine on the CPU.

- Frontier parity: on test_infer.py's small dyn_k_cpt tree and a 3-stage
  adaptive chain at 16x16 inputs (JAX's init from a seed, the routers
  perturbed with numpy as that test does, the same arrays in both
  packages), at 3 prices the port's deterministic columns equal those of
  JAX's calibrate_capacities / make_routed_infer_fn and the JAX tool's
  leaf_breakdown: capacities, exits, forced exits and per-leaf counts
  exactly, accuracy and ops within 1e-6; and routed equals dense per
  price where no exit is forced.
- The CLI on a checkpoint the port writes and a small archive: 8 records
  and a summary with the keys of the committed
  results/serving-frontier/chain-frontier-r5.json, every engine call
  counted.
- The figure: the port's render and JAX's, byte for byte.
- The crossover: JAX's row keys, the routed accuracy of JAX's engine at
  the same schedule, the skip row of a missing rung."""

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.models import ActorNet as JActorNet
from mpnn_tpu.models.infer import calibrate_capacities as j_calibrate
from mpnn_tpu.models.infer import make_routed_infer_fn as j_infer
from mpnn_tpu.ops import layers as J
from mpnn_tpu_torch.data.prep import save_archive
from mpnn_tpu_torch.data.synth import make_synthetic
from mpnn_tpu_torch.models import ActorNet as TActorNet
from mpnn_tpu_torch.models import infer as tinfer
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.tools import dense_crossover as dc
from mpnn_tpu_torch.tools import serving_frontier as sf
from mpnn_tpu_torch.utils.serdes import from_numpy_tree, write_net
from tests.test_torch_sr_cr import build_chain
from tests.test_torch_train import _randomize
from tests.torch_threads import child_env, share_cores  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_spec = importlib.util.spec_from_file_location(
    "serving_frontier", os.path.join(REPO, "tools", "serving_frontier.py"))
jsf = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jsf)

B = 64
PRICES = (0.0, 1e-8, 6.4e-8)
COMMITTED = os.path.join(REPO, "results", "serving-frontier",
                         "chain-frontier-r5.json")
# The keys of the JAX tool's records and summary (tools/serving_frontier.py
# :181-205, :228, :269-279), as in the committed file.
RECORD_KEYS = [
    "k_cpt", "capacities", "images_per_sec", "images_per_sec_passes",
    "mean_ops_per_example", "accuracy", "dense_accuracy",
    "dense_mean_ops_per_example", "forced_exits", "per_leaf_routed",
    "per_leaf_dense", "routed_matches_dense_exits",
    "images_per_sec_warmup_windows"]
SUMMARY_KEYS = ["checkpoint", "batch_size", "margin", "measure_passes",
                "estimator", "n_programs", "n_prices", "ops_span"]
# tools/dense_crossover.py:79-91.
CROSSOVER_KEYS = [
    "net", "checkpoint", "dense_images_per_sec", "dense_ops",
    "routed_calibrated_images_per_sec", "routed_ops", "routed_accuracy",
    "flops_savings", "wallclock_speedup_routed_vs_dense"]


def _tree(L, Net):
    """tests/test_infer.py's small tree: a 3-way switch (leaf, a 2-way
    switch, a pass-through stage), dyn_k_cpt."""
    def router(n):
        if n < 2:
            return None
        return L.Chain(name="Router", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=8, k_l2=1e-4), L.BatchNorm(),
            L.Rect(), L.LinTrans(n_chan=n, k_l2=1e-4, σ_w=0)])

    def reg():
        return L.Chain(name="LogReg", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=10, k_l2=1e-4), L.Softmax(),
            L.CrossEntropyError()])

    def rcm(n_chan, *sinks):
        return L.Chain(name="ReConvMax", sinks=sinks,
                       router=router(len(sinks)),
                       comps=[L.MultiscaleConvMax(n_chan=n_chan, supp=3,
                                                  k_l2=1e-4),
                              L.MultiscaleBatchNorm(), L.MultiscaleRect()])

    root = L.Chain(name="ToPyramid", sinks=[
        rcm([8, 8], reg(), rcm([8], reg(), rcm([8], reg())),
            rcm([8], reg()))], comps=[L.ToPyramid(n_scales=3)])
    return Net(x0_shape=(16, 16, 3), y_shape=(10,), root=root,
               dyn_k_cpt=True)


def _perturb_routers(tree, rng):
    """JAX's params as numpy, every router's arrays redrawn from
    N(0, 0.5), as tests/test_infer.py does."""
    if isinstance(tree, list):
        return [_perturb_routers(t, rng) for t in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k == "router" and v:
            out[k] = jax.tree.map(lambda a: rng.normal(0, 0.5, np.shape(a))
                                  .astype(np.float32), v)
        else:
            out[k] = _perturb_routers(v, rng)
    return out


def _pair(arch, dyn_k_cpt=True):
    if arch == "tree":
        jnet, tnet = _tree(J, JActorNet), _tree(T, TActorNet)
    else:
        jnet = build_chain(J, "ac", dyn_k_cpt=dyn_k_cpt)
        tnet = build_chain(T, "ac", dyn_k_cpt=dyn_k_cpt)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    p, s = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    rng = np.random.RandomState(4)
    p, s = _randomize(p, rng), _randomize(s, rng)
    return jnet, tnet, _perturb_routers(p, rng), s


def _data(n_tr, n_ts, seed=0):
    return make_synthetic(n_tr=n_tr, n_ts=n_ts, h=16, w=16, c=3, n_cls=10,
                          seed=seed)


def _jax_columns(jnet, p, s, x0, y_cls, x0_cal, margin):
    """tools/serving_frontier.py's columns (:164-205) at PRICES, through
    mpnn_tpu's engine and the JAX tool's leaf_breakdown."""
    jp, js = jax.tree.map(jnp.asarray, (p, s))
    n_leaves = sum(1 for l in jnet.layers if len(l.sinks) == 0)
    dense = j_infer(jnet, B, capacities=1.0)
    cols = []
    for price in PRICES:
        fracs = j_calibrate(jnet, jp, js, jnp.asarray(x0_cal), margin=margin,
                            k_cpt=price)
        r = {k: np.asarray(v) for k, v in j_infer(
            jnet, B, capacities=fracs)(jp, js, jnp.asarray(x0), price).items()}
        rd = {k: np.asarray(v) for k, v in
              dense(jp, js, jnp.asarray(x0), price).items()}
        pred, pred_d = (np.argmax(o["probs"], axis=1) for o in (r, rd))
        cols.append({
            "capacities": [round(f, 4) for f in fracs],
            "exit_idx": r["exit_idx"], "dense_exit_idx": rd["exit_idx"],
            "mean_ops_per_example": float(r["ops"].mean()),
            "dense_mean_ops_per_example": float(rd["ops"].mean()),
            "accuracy": round(float(np.mean(pred == y_cls)), 4),
            "dense_accuracy": round(float(np.mean(pred_d == y_cls)), 4),
            "forced_exits": int(r["forced"].sum()),
            "per_leaf_routed": jsf.leaf_breakdown(r["exit_idx"],
                                                  pred == y_cls, n_leaves),
            "per_leaf_dense": jsf.leaf_breakdown(rd["exit_idx"],
                                                 pred_d == y_cls, n_leaves)})
    return cols


@contextlib.contextmanager
def counting_engine_calls():
    """Counts the calls of every routed engine built inside the block,
    calibration's included: [n]."""
    calls = [0]
    real = tinfer.make_routed_infer_fn

    def counted(*args, **kwargs):
        fn = real(*args, **kwargs)

        def call(*a):
            calls[0] += 1
            return fn(*a)
        return call

    with mock.patch.object(tinfer, "make_routed_infer_fn", counted), \
            mock.patch.object(sf, "make_routed_infer_fn", counted):
        yield calls


@pytest.mark.parametrize("arch", ["tree", "chain"])
def test_frontier_columns_match_jax(arch):
    jnet, tnet, p, s = _pair(arch)
    d = _data(B, B)
    x0, x0_cal = d["x0_ts"][:B], d["x0_tr"][:B]
    y_cls = np.argmax(d["y_ts"][:B], axis=1)
    tp, ts = from_numpy_tree(p, s, device="cpu")
    engines = sf.Engines(tnet, tp, ts)
    with counting_engine_calls() as calls:
        recs, fracs, outs = sf.frontier_columns(
            engines, torch.as_tensor(x0), y_cls, torch.as_tensor(x0_cal),
            margin=1.5, prices=PRICES)
    # One engine call for each calibration, routed and dense serving.
    assert calls[0] == 3 * len(PRICES)
    want = _jax_columns(jnet, p, s, x0, y_cls, x0_cal, margin=1.5)
    for price, rec, w in zip(PRICES, recs, want):
        r, rd = outs[price]
        assert rec["k_cpt"] == price
        assert rec["capacities"] == w["capacities"]
        assert [round(f, 4) for f in fracs[price]] == w["capacities"]
        np.testing.assert_array_equal(r["exit_idx"], w["exit_idx"])
        np.testing.assert_array_equal(rd["exit_idx"], w["dense_exit_idx"])
        for k in ("forced_exits", "per_leaf_routed", "per_leaf_dense"):
            assert rec[k] == w[k], k
        for k in ("accuracy", "dense_accuracy", "mean_ops_per_example",
                  "dense_mean_ops_per_example"):
            assert abs(rec[k] - w[k]) <= 1e-6 * max(1.0, abs(w[k])), k
        assert rec["routed_matches_dense_exits"] == bool(
            (w["exit_idx"] == w["dense_exit_idx"]).all())
    # The routers split the batch, and the prices move the routing.
    assert len({tuple(r[0]["exit_idx"]) for r in outs.values()}) > 1
    assert max(len(np.unique(r[0]["exit_idx"])) for r in outs.values()) > 2


@pytest.mark.parametrize("arch", ["tree", "chain"])
def test_routed_equals_dense_without_forced_exits(arch):
    """Calibrated on the served batch itself at margin 1.0, no exit is
    forced, so the routed engine's exits, probs and per-leaf breakdown
    are dense hard routing's at every price."""
    _, tnet, p, s = _pair(arch)
    d = _data(B, B)
    x0 = torch.as_tensor(d["x0_ts"][:B])
    y_cls = np.argmax(d["y_ts"][:B], axis=1)
    engines = sf.Engines(tnet, *from_numpy_tree(p, s, device="cpu"))
    recs, _, outs = sf.frontier_columns(engines, x0, y_cls, x0, margin=1.0,
                                        prices=PRICES)
    for price, rec in zip(PRICES, recs):
        r, rd = outs[price]
        assert rec["forced_exits"] == 0
        assert rec["routed_matches_dense_exits"]
        np.testing.assert_allclose(r["probs"], rd["probs"], atol=1e-5)
        assert rec["per_leaf_routed"] == rec["per_leaf_dense"]
        assert rec["accuracy"] == rec["dense_accuracy"]
        assert sum(row["n"] for row in rec["per_leaf_routed"]) == B


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The frontier CLI on the CPU: a small adaptive chain the port wrote,
    a small archive, every engine call counted at the engine."""
    d = tmp_path_factory.mktemp("frontier")
    _, tnet, p, s = _pair("chain")
    ckpt, data = str(d / "net.npy"), str(d / "synth.npz")
    write_net(ckpt, tnet, *from_numpy_tree(p, s, device="cpu"))
    save_archive(data, _data(24, 12, seed=3))
    out = str(d / "frontier.json")
    with counting_engine_calls() as calls:
        res = sf.main(["--checkpoint", ckpt, "--data", data,
                       "--batch-size", "16", "--n-batches", "1",
                       "--measure-passes", "2", "--device", "cpu",
                       "--no-figure", "--json", out,
                       "--latency-prices", "min,max",
                       "--latency-batches", "1,2", "--latency-calls", "2"])
    with open(out) as f:
        lines = [json.loads(line) for line in f]
    return res, lines, calls[0], d


def test_frontier_cli_writes_jax_records(cli_run):
    res, lines, calls, _ = cli_run
    from mpnn_tpu_torch.experiments import k_cpts
    assert len(lines) == 9
    recs, summary = lines[:8], lines[8]["serving_frontier_summary"]
    assert [r["k_cpt"] for r in recs] == list(k_cpts)
    for i, r in enumerate(recs):
        keys = RECORD_KEYS + (["latency_ms"] if i in (0, 7) else [])
        assert list(r) == keys
        assert r["images_per_sec"] > 0 and len(
            r["images_per_sec_passes"]) == 2
        assert sum(row["n"] for row in r["per_leaf_routed"]) == 16
    assert set(recs[0]["latency_ms"]) == {"b1", "b2"}
    assert list(summary) == SUMMARY_KEYS
    assert summary["n_prices"] == 8 and summary["batch_size"] == 16
    assert summary["checkpoint"] == "net.npy"
    if os.path.exists(COMMITTED):  # .gitignore lists it; tracked
        with open(COMMITTED) as f:
            committed = [json.loads(line) for line in f]
        assert [sorted(set(r) - {"latency_ms"}) for r in committed[:-1]] \
            == [sorted(RECORD_KEYS)] * 8
        assert list(committed[-1]["serving_frontier_summary"]) \
            == SUMMARY_KEYS
    # Each price calibrates and serves routed and dense, then is timed.
    assert calls > 8 * 3
    assert res["records"] == recs and res["summary"] == summary


def _start_render(module_code, records_path, out):
    """A process that draws the records with `render` of module_code."""
    code = ("import json\n%s\n"
            "lines = [json.loads(l) for l in open(%r)]\n"
            "render(lines[:-1], lines[-1]['serving_frontier_summary'], %r)\n"
            % (module_code, records_path, out))
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            env=child_env(PYTHONPATH=REPO),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def test_frontier_figure_matches_jax(cli_run):
    """Each package draws in a process of its own, the two at once."""
    _, _, _, d = cli_run
    records = str(d / "frontier.json")
    procs = [_start_render("from mpnn_tpu_torch.tools.serving_frontier "
                           "import render", records, str(d / "port.svg")),
             _start_render("import importlib.util\n"
                           "s = importlib.util.spec_from_file_location("
                           "'sf', 'tools/serving_frontier.py')\n"
                           "m = importlib.util.module_from_spec(s)\n"
                           "s.loader.exec_module(m)\nrender = m.render",
                           records, str(d / "jax.svg"))]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
    port, ref = ((d / name).read_bytes() for name in ("port.svg", "jax.svg"))
    assert port.startswith(b"<?xml") and port == ref


def test_crossover_rows_match_jax(tmp_path, capsys):
    jnet, tnet, p, s = _pair("chain", dyn_k_cpt=False)
    (tmp_path / "nets").mkdir()
    write_net(str(tmp_path / "nets" / "0004.npy"), tnet,
              *from_numpy_tree(p, s, device="cpu"))
    data = _data(32, 20, seed=5)
    save_archive(str(tmp_path / "data.npz"), data)
    ladder = [("base", "nets/0004.npy", "data.npz"),
              ("fat-x2", "nets/missing/0004.npy", "data.npz")]
    out = str(tmp_path / "crossover.json")
    rows = dc.run_ladder(ladder, str(tmp_path), out, batch_size=32,
                         n_batches=2, device="cpu")
    printed = [json.loads(line) for line in
               capsys.readouterr().out.splitlines()]
    assert printed == rows[:1] + [{"skip": "fat-x2",
                                   "missing": "nets/missing/0004.npy"}]
    with open(out) as f:
        assert json.load(f) == {"batch_size": 32, "rows": rows}
    (row,) = rows
    assert list(row) == CROSSOVER_KEYS
    assert row["dense_images_per_sec"] > 0
    assert row["routed_calibrated_images_per_sec"] > 0

    # mpnn_tpu's engine at the schedule mpnn_tpu calibrates.
    jp, js = jax.tree.map(jnp.asarray, (p, s))
    x0 = jnp.asarray(np.resize(data["x0_ts"], (32, 16, 16, 3)))
    y_cls = np.argmax(np.resize(data["y_ts"], (32, 10)), axis=1)
    fracs = j_calibrate(jnet, jp, js, jnp.asarray(data["x0_tr"][:32]))
    r = j_infer(jnet, 32, capacities=fracs)(jp, js, x0, None)
    acc = round(float(np.mean(np.argmax(np.asarray(r["probs"]), 1)
                              == y_cls)), 4)
    assert row["routed_accuracy"] == acc
    assert row["routed_ops"] == pytest.approx(
        float(np.asarray(r["ops"]).mean()), rel=1e-6)
    assert row["dense_ops"] == float(sum(
        n.n_ops + (n.router.n_ops if n.router is not None else 0.0)
        for n in jnet.layers))
    full = j_infer(jnet, 32, capacities=1.0)(jp, js, x0, None)
    assert row["flops_savings"] == round(
        1.0 - float(np.asarray(full["ops"]).mean()) / row["dense_ops"], 4)
