"""Routed-inference benchmark: images/sec and mean realized ops per example
(counterpart of `scripts/infer-bench`).

Loads a trained checkpoint, chain or tree (a `.npy` file, or a compact
archive directory such as results/nets/hybrid-ac-tree-dynkcpt/net.npy.cz),
or builds the flagship actor chain fresh from a seed, and measures dense
evaluation (capacity 1.0: every example runs until its router exits it,
with batch-wide buffers) and routed inference at the given or calibrated
capacities. Each mode is timed over
--n-windows windows of --n-batches batches; `value` is the median of the
windows' rates and `window_values` holds each. Prints one JSON line per
mode. A dyn_k_cpt net (the adaptive registry's) is served at the price
--k-cpt. Runs on CUDA unless --device cpu is given.

    python -m mpnn_tpu_torch.infer_bench --checkpoint results/nets/hybrid-ac/0004.npy
    python -m mpnn_tpu_torch.infer_bench \
        --checkpoint results/nets/hybrid-ac-tree-dynkcpt/net.npy.cz \
        --k-cpt 1.6e-8
"""

import json
import statistics
import time
from argparse import ArgumentParser

import numpy as np
import torch


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", default=None,
                        help="nets/<expt>/<i>.npy or net.npy checkpoint "
                             "of a chain or tree, or a compact archive "
                             "directory")
    parser.add_argument("--batch-size", type=int, default=1024)
    parser.add_argument("--capacity", type=float, default=1.0)
    parser.add_argument("--calibrate", action="store_true",
                        help="fit per-switch capacities to the trained "
                             "routing distribution on a train-split "
                             "calibration batch (needs --data)")
    parser.add_argument("--margin", type=float, default=1.5,
                        help="calibration safety factor over measured "
                             "arrival rates")
    parser.add_argument("--data", default=None,
                        help="dataset .npz: bench on its test split "
                             "instead of noise")
    parser.add_argument("--k-cpt", type=float, default=None,
                        help="cost-of-compute price for dyn_k_cpt "
                             "checkpoints")
    parser.add_argument("--n-batches", type=int, default=20,
                        help="batches per timed window")
    parser.add_argument("--n-windows", type=int, default=5,
                        help="timed windows per mode; the median is "
                             "reported")
    parser.add_argument("--precision", choices=["fp32", "bf16"],
                        default="bf16")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    args = parser.parse_args(argv)

    from . import set_up_device, synchronize
    from .models.infer import calibrate_capacities, make_routed_infer_fn

    device = set_up_device(args.device, args.precision)

    if args.checkpoint:
        from .utils.serdes import read_net
        net, params, state, _ = read_net(args.checkpoint, device)
    else:
        from .experiments import ac_chain
        net = ac_chain(k_cpt=1e-9)((32, 32, 3), (10,))
        params, state = net.init(torch.Generator().manual_seed(0), device)

    B = args.batch_size
    y_cls = None
    if args.data:
        ds = np.load(args.data, allow_pickle=True)["arr_0"][()]
        reps = -(-B // len(ds["x0_ts"]))
        x0_np = np.tile(ds["x0_ts"], (reps, 1, 1, 1))[:B]
        y_cls = np.argmax(np.tile(ds["y_ts"], (reps, 1))[:B], axis=1)
    else:
        rng = np.random.RandomState(0)
        x0_np = rng.rand(B, *net.hypers.x0_shape)
    x0 = torch.as_tensor(np.asarray(x0_np, np.float32), device=device)

    routed_cap = args.capacity
    if args.calibrate:
        if not args.data:
            parser.error("--calibrate needs --data (a train split to "
                         "measure routing arrival rates on)")
        x_tr = ds["x0_tr"]
        x0_cal = np.tile(x_tr, (-(-B // len(x_tr)), 1, 1, 1))[:B]
        routed_cap = calibrate_capacities(
            net, params, state,
            torch.as_tensor(np.asarray(x0_cal, np.float32), device=device),
            margin=args.margin, k_cpt=args.k_cpt)
        print(json.dumps({"calibrated_capacities":
                          [round(f, 4) for f in routed_cap],
                          "margin": args.margin}), flush=True)

    device_name = (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu")
    for mode, cap in (("dense", 1.0), ("routed", routed_cap)):
        infer = make_routed_infer_fn(net, B, capacities=cap)
        out = infer(params, state, x0, args.k_cpt)  # warm-up
        synchronize(device)
        rates = []
        for _ in range(args.n_windows):
            t0 = time.perf_counter()
            for _ in range(args.n_batches):
                out = infer(params, state, x0, args.k_cpt)
            synchronize(device)
            rates.append(args.n_batches * B / (time.perf_counter() - t0))
        ops = out["ops"].cpu().numpy()
        forced = out["forced"].cpu().numpy()
        rec = {
            "metric": "routed-inference (%s, capacity=%s)" % (
                mode, "calibrated" if isinstance(cap, list) else cap),
            "value": statistics.median(rates),
            "unit": "images/sec/chip",
            "window_values": rates,
            "window_batches": args.n_batches,
            "mean_ops_per_example": float(ops.mean()),
            "forced_exits": int(forced.sum()),
            "forced_per_switch": forced.tolist(),
            "device": device_name,
        }
        if y_cls is not None:
            pred = np.argmax(out["probs"].cpu().numpy(), axis=1)
            rec["accuracy"] = round(float(np.mean(pred == y_cls)), 4)
        if args.k_cpt is not None:
            rec["k_cpt"] = args.k_cpt
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
