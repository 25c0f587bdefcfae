"""Measured serving frontier of an adaptive (dyn_k_cpt) net (counterpart of
`tools/serving_frontier.py`).

One adaptive net's routers take the cost-of-compute price per call, so one
trained net spans the whole accuracy/efficiency frontier. This tool
measures that frontier as deployed. For each price of
`experiments.k_cpts` it

  1. calibrates the per-switch capacity schedule to the routing at that
     price (`models.infer.calibrate_capacities`, on a train-split batch);
  2. serves the test split through the routed engine with those buffers
     (prices whose 1/32-grid schedules coincide share one engine);
  3. reports accuracy, realized ops per example, forced exits and
     measured img/s on the wall clock.

Each record also carries the dense cross-check: accuracy and per-leaf
exit occupancy and accuracy from exact hard routing (capacity 1.0, the
reference's eval rule) at the same price, beside the routed engine's own
per-leaf breakdown, and `routed_matches_dense_exits`. With no forced exit
the two agree exactly.

Timing: every engine is warmed first (its windows repeated until two in
a row agree within 1.6x, at most 4, all kept in
`images_per_sec_warmup_windows`), then --measure-passes passes run one
window per engine in rotated order; `images_per_sec` is the median across
passes. A window is one call, a synchronise, then --n-batches calls and a
synchronise. --latency-prices measures the per-call latency (median and
p90 ms) at small batches, each call closed by a synchronise.

Output: one JSON line per price and a summary line (--json also writes
them to a file, truncated per run), and an accuracy-vs-ops figure
(--out; --no-figure skips it). `main` computes in fp32, a fresh
process's default; `run` computes in the caller's compute type
(`ops.config`). It runs on the card unless --device cpu is given.

    python -m mpnn_tpu_torch.tools.serving_frontier \\
        [--checkpoint nets/hybrid-ac-dynkcpt/net.npy] \\
        [--data data/hybrid.npz] [--batch-size 1024] [--n-batches 20] \\
        [--margin 1.5] [--json path] [--latency-prices min,max] \\
        [--latency-batches 1,8] [--out figures/serving-frontier.svg]
"""

import json
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from .. import set_up_device, synchronize
from ..experiments import k_cpts
from ..models.infer import calibrate_capacities, make_routed_infer_fn

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def leaf_breakdown(exit_idx, correct, n_leaves):
    """Per-exit-leaf occupancy and accuracy (preorder leaf index), from
    measured routed exits."""
    rows = []
    for li in range(n_leaves):
        at = exit_idx == li
        n = int(at.sum())
        rows.append({"leaf": li, "n": n,
                     "acc": round(float(correct[at].mean()), 4)
                            if n else None})
    return rows


class Engines:
    """The routed engines of one net, one per (capacity schedule, batch
    size), built on first use."""

    def __init__(self, net, params, state):
        self.net, self.params, self.state = net, params, state
        self.n_switches = sum(1 for l in net.layers if len(l.sinks) > 1)
        self.dense_key = (1.0,) * self.n_switches
        self._fns = {}

    def calibrate(self, x0_cal, margin, price):
        """The capacity schedule fitted at `price` (one engine call)."""
        return calibrate_capacities(self.net, self.params, self.state,
                                    x0_cal, margin=margin, k_cpt=price)

    def serve(self, key, x0, price):
        """x0 served at `price` by the engine of schedule `key`."""
        fn = self._fns.get((key, len(x0)))
        if fn is None:
            fn = self._fns[key, len(x0)] = make_routed_infer_fn(
                self.net, len(x0), capacities=list(key))
        return fn(self.params, self.state, x0, price)


def _np(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def frontier_columns(engines, x0, y_cls, x0_cal, margin=1.5, prices=k_cpts):
    """The deterministic columns at each price: capacities, accuracy, ops,
    forced exits, the dense cross-check and both per-leaf breakdowns.
    Returns (records, unrounded schedules by price, {price: (routed,
    dense)} engine outputs as numpy); each record's `_program` is its
    schedule, dropped by `run`."""
    n_leaves = sum(1 for l in engines.net.layers if len(l.sinks) == 0)
    records, fracs_by_price, outs = [], {}, {}
    for price in prices:
        fracs = engines.calibrate(x0_cal, margin, price)
        fracs_by_price[price] = fracs
        key = tuple(fracs)
        r = _np(engines.serve(key, x0, price))
        rd = _np(engines.serve(engines.dense_key, x0, price))
        outs[price] = (r, rd)
        pred = np.argmax(r["probs"], axis=1)
        pred_d = np.argmax(rd["probs"], axis=1)
        records.append({
            "k_cpt": price,
            "capacities": [round(f, 4) for f in fracs],
            "images_per_sec": None,
            "images_per_sec_passes": [],
            "mean_ops_per_example": float(r["ops"].mean()),
            "accuracy": round(float(np.mean(pred == y_cls)), 4),
            "dense_accuracy": round(float(np.mean(pred_d == y_cls)), 4),
            "dense_mean_ops_per_example": float(rd["ops"].mean()),
            "forced_exits": int(r["forced"].sum()),
            "per_leaf_routed": leaf_breakdown(r["exit_idx"], pred == y_cls,
                                              n_leaves),
            "per_leaf_dense": leaf_breakdown(rd["exit_idx"],
                                             pred_d == y_cls, n_leaves),
            "routed_matches_dense_exits":
                bool((r["exit_idx"] == rd["exit_idx"]).all()),
            "_program": key,
        })
    return records, fracs_by_price, outs


def _window(engines, key, x0, price, n_batches, device):
    """img/s of one window: a call and a synchronise, then n_batches calls
    and a synchronise on the clock."""
    engines.serve(key, x0, price)
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        engines.serve(key, x0, price)
    synchronize(device)
    return round(n_batches * len(x0) / (time.perf_counter() - t0), 1)


def time_frontier(engines, records, x0, n_batches, measure_passes, device):
    """Warm every engine the records use, then time --measure-passes
    passes in rotated order; fills each record's img/s columns and returns
    the engines' keys, in the records' order."""
    keys = []
    for rec in records:
        if rec["_program"] not in keys:
            keys.append(rec["_program"])
    price_of = {key: next(r["k_cpt"] for r in records
                          if r["_program"] == key) for key in keys}
    warmup = {}
    for key in keys:
        wins = [_window(engines, key, x0, price_of[key], n_batches, device)]
        while len(wins) < 4:
            wins.append(_window(engines, key, x0, price_of[key], n_batches,
                                device))
            hi, lo = max(wins[-2:]), min(wins[-2:])
            if lo > 0 and hi / lo < 1.6:
                break
        warmup[key] = wins
    for p in range(max(1, measure_passes)):
        for key in keys[p % len(keys):] + keys[:p % len(keys)]:
            ips = _window(engines, key, x0, price_of[key], n_batches, device)
            for rec in records:
                if rec["_program"] == key:
                    rec["images_per_sec_passes"].append(ips)
    for rec in records:
        rec["images_per_sec_warmup_windows"] = warmup[rec["_program"]]
        rec["images_per_sec"] = round(
            float(np.median(rec["images_per_sec_passes"])), 1)
    return keys


def measure_latency(engines, records, fracs_by_price, x0, prices, batches,
                    n_calls, device):
    """Per-call latency at the small batches for the records nearest each
    price, at the price's unrounded schedule: median and p90 ms of n_calls
    calls after one untimed call, each closed by a synchronise. Adds
    `latency_ms` to those records and prints one line each."""
    for price in prices:
        rec = min(records, key=lambda r: abs(r["k_cpt"] - price))
        rec.setdefault("latency_ms", {})
        key = tuple(fracs_by_price[rec["k_cpt"]])
        for lb in batches:
            xs = x0[:lb]
            engines.serve(key, xs, price)
            synchronize(device)
            ts = []
            for _ in range(n_calls):
                t0 = time.perf_counter()
                engines.serve(key, xs, price)
                synchronize(device)
                ts.append((time.perf_counter() - t0) * 1e3)
            rec["latency_ms"]["b%d" % lb] = {
                "median": round(float(np.median(ts)), 2),
                "p90": round(float(np.percentile(ts, 90)), 2)}
        print(json.dumps({"k_cpt": rec["k_cpt"],
                          "latency_ms": rec["latency_ms"]}), flush=True)


def parse_args(argv=None):
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--checkpoint", default=os.path.join(
        REPO, "nets", "hybrid-ac-dynkcpt", "net.npy"))
    ap.add_argument("--data", default=os.path.join(REPO, "data",
                                                   "hybrid.npz"))
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--n-batches", type=int, default=20)
    ap.add_argument("--margin", type=float, default=1.5)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request)")
    ap.add_argument("--json", default=None,
                    help="also write the records to this file (truncated "
                         "per run)")
    ap.add_argument("--out", default=os.path.join(REPO, "figures",
                                                  "serving-frontier.svg"))
    ap.add_argument("--no-figure", action="store_true")
    ap.add_argument("--measure-passes", type=int, default=3,
                    help="timed passes per engine (after its warm "
                         "windows); img/s is the median across passes")
    ap.add_argument("--latency-prices", default=None,
                    help="comma list of k_cpt prices (or 'min,max') to "
                         "measure small-batch latency for")
    ap.add_argument("--latency-batches", default="1,8",
                    help="comma list of batch sizes for --latency-prices")
    ap.add_argument("--latency-calls", type=int, default=30,
                    help="timed calls per latency point (median and p90 "
                         "reported; each call synchronised)")
    return ap.parse_args(argv)


def serving_batches(ds, batch_size):
    """(x0, y_cls, x0_cal) as numpy: the test split tiled to batch_size
    with its class indices, and a train-split calibration batch."""
    B = batch_size
    reps = -(-B // len(ds.x0_ts))
    x0 = np.tile(ds.x0_ts, (reps, 1, 1, 1))[:B]
    y_cls = np.argmax(np.tile(np.asarray(ds.y_ts), (reps, 1))[:B], axis=1)
    x0_cal = (ds.x0_tr[:B] if len(ds.x0_tr) >= B
              else np.tile(ds.x0_tr, (-(-B // len(ds.x0_tr)), 1, 1, 1))[:B])
    return x0, y_cls, x0_cal


def run(args, net, params, state, ds, device):
    """The frontier of the net (params on `device`) on the dataset `ds`
    (a `data.Dataset`): prints and writes what `main` does. Returns
    {"records", "summary"}."""
    as_t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=device)
    x0, y_cls, x0_cal = serving_batches(ds, args.batch_size)
    x0, x0_cal = as_t(x0), as_t(x0_cal)
    engines = Engines(net, params, state)
    records, fracs_by_price, _ = frontier_columns(
        engines, x0, y_cls, x0_cal, margin=args.margin)
    keys = time_frontier(engines, records, x0, args.n_batches,
                         args.measure_passes, device)
    for rec in records:
        del rec["_program"]
        print(json.dumps(rec), flush=True)

    if args.latency_prices:
        if args.latency_prices == "min,max":
            lat_prices = [min(k_cpts), max(k_cpts)]
        else:
            lat_prices = [float(s) for s in args.latency_prices.split(",")]
        measure_latency(engines, records, fracs_by_price, x0, lat_prices,
                        [int(s) for s in args.latency_batches.split(",")],
                        args.latency_calls, device)

    ckpt = os.path.abspath(args.checkpoint)
    summary = {
        "checkpoint": (os.path.relpath(args.checkpoint, REPO)
                       if ckpt.startswith(REPO)
                       else os.path.basename(args.checkpoint)),
        "batch_size": args.batch_size, "margin": args.margin,
        "measure_passes": args.measure_passes,
        "estimator": "median of timed passes (warm window discarded)",
        "n_programs": len(keys),
        "n_prices": len(k_cpts),
        "ops_span": round(max(r["mean_ops_per_example"] for r in records)
                          / min(r["mean_ops_per_example"] for r in records),
                          2),
    }
    print(json.dumps({"serving_frontier_summary": summary}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            for rec in records + [{"serving_frontier_summary": summary}]:
                f.write(json.dumps(rec) + "\n")
    if not args.no_figure:
        render(records, summary, args.out)
        print("wrote %s" % args.out)
    return {"records": records, "summary": summary}


def main(argv=None):
    from ..data import Dataset
    from ..utils.serdes import read_net

    args = parse_args(argv)
    device = set_up_device(args.device, "fp32")
    net, params, state, _ = read_net(args.checkpoint, device)
    ds = Dataset(args.data, device_put=False)
    return run(args, net, params, state, ds, device)


def render(records, summary, out):
    """The accuracy-vs-ops figure, annotated with img/s (the same bytes as
    `tools/serving_frontier.py:render` draws)."""
    from .. import viz  # noqa: F401  (deterministic figure bytes)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    INK, BLUE = "#333333", "#2a6ccc"
    ops = [r["mean_ops_per_example"] for r in records]
    err = [1.0 - r["accuracy"] for r in records]
    fig, ax = plt.subplots(figsize=(5.6, 4.2))
    ax.grid(True, color="#dddddd", lw=0.6, zorder=0)
    for s in ("top", "right"):
        ax.spines[s].set_visible(False)
    ax.plot(ops, err, "-o", color=BLUE, lw=2, ms=6, zorder=3)
    ax.margins(y=0.18)
    # Label a point unless its x sits within 4% of the last labelled one.
    last_x = None
    for i, (r, o, e) in enumerate(zip(records, ops, err)):
        if last_x is not None and abs(o - last_x) < 0.04 * max(ops) \
                and i != len(records) - 1:
            continue
        last_x = o
        lab = (f"k_cpt={r['k_cpt']:g}"
               f"\n{r['images_per_sec']/1e3:.0f}k img/s")
        at_right = o > 0.9 * max(ops)
        ax.annotate(lab, (o, e),
                    xytext=(-6 if at_right else 6, 10),
                    textcoords="offset points",
                    ha="right" if at_right else "left",
                    fontsize=7.5, color=INK)
    ax.set_xscale("log")
    ax.set_xlabel("realized ops / example (measured, routed)",
                  fontsize=10, color=INK)
    ax.set_ylabel("test error", fontsize=10, color=INK)
    ips = [r["images_per_sec"] for r in records]
    ax.set_title("One deployed adaptive net, every operating point\n"
                 f"(b{summary['batch_size']}, {summary['n_programs']} "
                 f"programs / {summary['n_prices']} prices, "
                 f"{min(ips)/1e3:.0f}–{max(ips)/1e3:.0f}k img/s)",
                 fontsize=10, color=INK)
    ax.tick_params(colors=INK, labelsize=9)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out), exist_ok=True)
    fig.savefig(out)


if __name__ == "__main__":
    main()
