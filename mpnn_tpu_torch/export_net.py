"""Export a trained checkpoint as a serving artifact (counterpart of
`scripts/export-net`).

Traces the routed sparse inference path (`models/infer.py`) with the
trained parameters baked in as constants (`mpnn_tpu_torch/export.py`)
and writes it with `torch.export.save`: the file serves batches with
torch and this package's `mcm_stage` operator, and needs no checkpoint
and no model code. It is traced on --device (the kernel on CUDA) and
`load_artifact(path, device)` moves it to another.

For adaptive (dyn_k_cpt) checkpoints pass --dyn-kcpt: the artifact keeps
the cost-of-compute price as a 0-d input, so one file serves every
accuracy/compute operating point.

Prints one JSON record; with --check it reloads the artifact and holds it
against the direct inference path on random input, and exits 1 on a
mismatch. Runs on CUDA unless --device cpu is given.

    python -m mpnn_tpu_torch.export_net results/nets/hybrid-ac/0004.npy \\
        /tmp/net.pt2 --batch-size 1024 --check
"""

import json
import os
import sys
from argparse import ArgumentParser

import numpy as np
import torch


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint", help="nets/<expt>/<i>.npy, net.npy or "
                        "a compact archive directory")
    parser.add_argument("out", help="output artifact path (.pt2)")
    parser.add_argument("--batch-size", type=int, default=1024)
    parser.add_argument("--capacity", type=float, default=1.0,
                        help="per-switch capacity fraction; 1.0 = exact "
                             "dense-hard-routing parity")
    parser.add_argument("--calibrate", metavar="DATA_NPZ", default=None,
                        help="fit per-switch capacities to the trained "
                             "routing distribution on DATA_NPZ's train "
                             "split (models/infer.calibrate_capacities); "
                             "the artifact bakes in the calibrated buffer "
                             "schedule")
    parser.add_argument("--margin", type=float, default=1.5,
                        help="calibration safety factor")
    parser.add_argument("--dyn-kcpt", action="store_true",
                        help="keep k_cpt a run-time input (adaptive nets)")
    parser.add_argument("--precision", choices=["fp32", "bf16"],
                        default="bf16")
    parser.add_argument("--device", default="cuda",
                        help="torch device to trace on (default cuda; cpu "
                             "for tests)")
    parser.add_argument("--check", action="store_true",
                        help="reload the artifact and verify it matches "
                             "the direct inference path on random input")
    args = parser.parse_args(argv)

    from . import set_up_device
    from . import export as ex
    from .models.infer import calibrate_capacities, make_routed_infer_fn
    from .utils.serdes import read_net

    device = set_up_device(args.device, args.precision)
    net, params, state, _ = read_net(args.checkpoint, device)
    B = args.batch_size

    def price():
        return torch.tensor(float(getattr(net.hypers, "k_cpt", 0.0)
                                  or 1e-9), device=device)

    capacities = args.capacity
    if args.calibrate:
        from .data.dataset import Dataset
        ds = Dataset(args.calibrate, device_put=False)
        reps = -(-B // len(ds.x0_tr))
        x0_cal = torch.as_tensor(np.tile(ds.x0_tr, (reps, 1, 1, 1))[:B],
                                 device=device)
        capacities = calibrate_capacities(
            net, params, state, x0_cal, margin=args.margin,
            k_cpt=price() if args.dyn_kcpt else None)
    exported = ex.export_infer(net, params, state, batch_size=B,
                               capacities=capacities,
                               dyn_k_cpt=args.dyn_kcpt)
    ex.save_artifact(exported, args.out)

    rec = {
        "artifact": args.out,
        "bytes": os.path.getsize(args.out),
        "batch_size": B,
        "capacity": (capacities if isinstance(capacities, float)
                     else [round(f, 4) for f in capacities]),
        "dyn_k_cpt": args.dyn_kcpt,
        "device": str(device),
    }

    if args.check:
        rng = np.random.RandomState(0)
        x0 = torch.as_tensor(rng.rand(B, *net.hypers.x0_shape)
                             .astype(np.float32), device=device)
        fn = ex.serve_fn(args.out)
        direct = make_routed_infer_fn(net, B, capacities=capacities)
        if args.dyn_kcpt:
            k = price()
            got, want = fn(x0, k), direct(params, state, x0, k)
        else:
            got, want = fn(x0), direct(params, state, x0)
        ok = all(np.allclose(got[key].cpu().numpy(), want[key].cpu().numpy())
                 for key in ("probs", "exit_idx", "ops"))
        rec["check"] = "ok" if ok else "MISMATCH"
        if not ok:
            print(json.dumps(rec))
            return 1

    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
