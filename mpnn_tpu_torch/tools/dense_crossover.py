"""Where does routed sparse inference beat the dense forward on the wall
clock? (counterpart of `tools/dense_crossover.py`)

Per rung of the width ladder (base, fat x2, fatter x4) it measures, at
batch 1024 in bf16 with the analytic L2 penalty (no layer computes its
penalty in the forward, as in `tools/dense_crossover.py`): img/s of the
all-branches dense forward (the eval `Net.forward`, every branch for
every example, as the reference pays at eval) against the routed engine
at capacities calibrated on a train-split batch. Each is warmed (one
call, then a window of max(2, n/2) calls), then timed over --n-batches
calls with one synchronise at the end. As width
grows the FLOPs routing saves grow quadratically while the engine's
compaction stays about constant, so routing should win somewhere up the
ladder. A rung whose checkpoint is missing prints a skip row; a rung that
fails prints an error row; each finished row is written to --json at once
(by default results/dense-crossover-cuda.json, beside and not over the
TPU's record). It runs on the card unless --device cpu is given.

    python -m mpnn_tpu_torch.tools.dense_crossover \\
        [--json results/dense-crossover-cuda.json]
"""

import json
import os
import pickle
import time
from argparse import ArgumentParser

import numpy as np
import torch

from .. import set_up_device, synchronize
from ..ops import config

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

LADDER = [
    ("base", "nets/hybrid-ac/0004.npy", "data/hybrid.npz"),
    ("fat-x2", "nets/cifar10-ac-fat/0004.npy", "data/cifar-10.npz"),
    ("fatter-x4", "nets/cifar10-ac-fatter/0004.npy", "data/cifar-10.npz"),
]


def _warm_calls(n_batches):
    return 1 + max(2, n_batches // 2)


def _rate(call, n_batches, batch_size, device):
    """img/s of n_batches calls after a warm call and a warm window
    (`_warm_calls` in all)."""
    for _ in range(_warm_calls(n_batches)):
        call()
    synchronize(device)
    t0 = time.perf_counter()
    for _ in range(n_batches):
        call()
    synchronize(device)
    return round(n_batches * batch_size / (time.perf_counter() - t0), 1)


def measure(checkpoint, data, batch_size=1024, n_batches=10,
            device="cuda"):
    """Dense against calibrated routed serving of one checkpoint on the
    test split of `data` (an archive path, or its dict), tiled to
    batch_size. Returns {"dense": {images_per_sec, mean_ops_per_example},
    "routed": {mean_ops_per_example} at capacity 1.0, "calibrated":
    {capacity, images_per_sec, mean_ops_per_example, forced_exits,
    accuracy} or None where the train split is smaller than the batch,
    "flops_savings_vs_dense", "forward_calls": the forwards of the dense
    net and of the engine it made}. Without the archive the inputs are
    noise and nothing is calibrated. It computes in the process's compute
    type and L2 mode (`ops.config`), which `main` sets to bf16 and
    analytic."""
    from ..data import Dataset
    from ..models.infer import calibrate_capacities, make_routed_infer_fn
    from ..models.net import Ctx
    from ..utils.serdes import read_net

    device = torch.device(device)
    net, params, state, _ = read_net(checkpoint, device)
    B = batch_size
    as_t = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=device)
    y_cls = x0_cal = None
    if isinstance(data, dict) or os.path.exists(data):
        ds = Dataset(data, device_put=False)
        reps = -(-B // len(ds.x0_ts))
        x0 = as_t(np.tile(ds.x0_ts, (reps, 1, 1, 1))[:B])
        y_cls = np.argmax(np.tile(ds.y_ts, (reps, 1))[:B], axis=1)
        if len(ds.x0_tr) >= B:
            x0_cal = as_t(ds.x0_tr[:B])
    else:
        x0 = as_t(np.random.RandomState(0).rand(B, *net.hypers.x0_shape))

    y = torch.zeros((B,) + tuple(net.hypers.y_shape), device=device)
    ctx = Ctx(train=False, tau=1.0, eps=1e-6,
              k_cpt=getattr(net.hypers, "k_cpt", 0.0))

    @torch.inference_mode()
    def dense():
        net.forward(params, state, x0, y, ctx)

    dense_ops = float(sum(
        node.n_ops + (node.router.n_ops if node.router is not None else 0.0)
        for node in net.layers))
    out = {"dense": {"images_per_sec": _rate(dense, n_batches, B, device),
                     "mean_ops_per_example": dense_ops}}
    full = make_routed_infer_fn(net, B, capacities=1.0)(params, state, x0)
    out["routed"] = {"mean_ops_per_example":
                     float(full["ops"].cpu().numpy().mean())}
    out["flops_savings_vs_dense"] = round(
        1.0 - out["routed"]["mean_ops_per_example"] / dense_ops, 4)
    out["calibrated"] = None
    out["forward_calls"] = _warm_calls(n_batches) + n_batches + 1
    if x0_cal is not None:
        caps = calibrate_capacities(net, params, state, x0_cal)
        infer = make_routed_infer_fn(net, B, capacities=caps)
        r = {}
        rate = _rate(lambda: r.update(infer(params, state, x0)), n_batches,
                     B, device)
        cal = {"capacity": [round(f, 4) for f in caps],
               "images_per_sec": rate,
               "mean_ops_per_example": float(r["ops"].cpu().numpy().mean()),
               "forced_exits": int(r["forced"].sum())}
        if y_cls is not None:
            pred = np.argmax(r["probs"].cpu().numpy(), axis=1)
            cal["accuracy"] = round(float(np.mean(pred == y_cls)), 4)
        out["calibrated"] = cal
        out["forward_calls"] += 1 + _warm_calls(n_batches) + n_batches
    return out


def row(name, ckpt, r):
    """The ladder's row of a rung from its `measure` result."""
    cal = r["calibrated"]
    return {
        "net": name, "checkpoint": ckpt,
        "dense_images_per_sec": r["dense"]["images_per_sec"],
        "dense_ops": r["dense"]["mean_ops_per_example"],
        "routed_calibrated_images_per_sec":
            cal["images_per_sec"] if cal else None,
        "routed_ops": cal["mean_ops_per_example"] if cal else None,
        "routed_accuracy": cal.get("accuracy") if cal else None,
        "flops_savings": r["flops_savings_vs_dense"],
        "wallclock_speedup_routed_vs_dense":
            (round(cal["images_per_sec"] / r["dense"]["images_per_sec"], 3)
             if cal else None),
    }


def _write(path, batch_size, rows):
    with open(path, "w") as f:
        json.dump({"batch_size": batch_size, "rows": rows}, f, indent=1)


def run_ladder(ladder, root, json_path, batch_size=1024, n_batches=10,
               device="cuda"):
    """Measure each rung (name, checkpoint, archive) of `ladder`, its
    paths under `root`; prints a row per rung and rewrites json_path after
    each. Returns the rows."""
    rows = []
    for name, ckpt, data in ladder:
        if not os.path.exists(os.path.join(root, ckpt)):
            print(json.dumps({"skip": name, "missing": ckpt}), flush=True)
            continue
        try:
            r = measure(os.path.join(root, ckpt), os.path.join(root, data),
                        batch_size=batch_size, n_batches=n_batches,
                        device=device)
        except (OSError, EOFError, ValueError, KeyError,
                pickle.UnpicklingError) as e:
            # A torn checkpoint or archive must not discard the rungs
            # already measured; a failed launch (RuntimeError) stops the
            # run.
            rows.append({"net": name, "checkpoint": ckpt,
                         "error": "%s: %s" % (type(e).__name__, e)})
            print(json.dumps(rows[-1]), flush=True)
            _write(json_path, batch_size, rows)
            continue
        rows.append(row(name, ckpt, r))
        print(json.dumps(rows[-1]), flush=True)
        _write(json_path, batch_size, rows)
    return rows


def main(argv=None):
    ap = ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--json", default=os.path.join(
        REPO, "results", "dense-crossover-cuda.json"))
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--n-batches", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on request)")
    args = ap.parse_args(argv)
    device = set_up_device(args.device, "bf16")
    config.set_analytic_l2(True)
    run_ladder(LADDER, REPO, args.json, batch_size=args.batch_size,
               n_batches=args.n_batches, device=device)
    print("wrote %s" % args.json)


if __name__ == "__main__":
    main()
