"""Validate a checkpoint against the independent float64 oracle
(counterpart of `scripts/check-parity`).

Loads a net checkpoint (a `.npy` file or a compact archive directory), or
initializes a registry experiment's net fresh, runs the port's fp32
forward and loss (on CUDA the kernel path, TF32 off) and
`mpnn_tpu_torch.oracle`'s float64 re-derivation of the reference's
semantics on the same batch, and reports per-quantity deviations: p_tr /
p_ev routing probabilities, router logits, per-leaf error costs, the root
output and the total loss (tolerances: `mpnn_tpu_torch.paritycheck.TOLS`).
Prints each report as JSON, then `PARITY OK` or `PARITY FAILED`; the exit
code is 0 iff every check passes. Runs on CUDA unless --device cpu is
given.

    python -m mpnn_tpu_torch.check_parity results/nets/hybrid-ac/0004.npy \\
        --data data/hybrid.npz --grads
"""

import json
import sys
from argparse import ArgumentParser

import numpy as np


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint", nargs="?", default=None,
                        help="nets/<expt>/<i>.npy (or net.npy, or a compact "
                        "archive directory) checkpoint; omit with --expt to "
                        "check a freshly initialized registry net")
    parser.add_argument("--expt", default=None,
                        help="registry experiment name; with a checkpoint "
                        "omitted, checks net 0 of this experiment at init")
    parser.add_argument("--net", type=int, default=0,
                        help="net index within --expt (fresh-init mode)")
    parser.add_argument("--data", default=None,
                        help="dataset .npz: draw the batch from its test "
                        "split instead of synthetic noise")
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--eval", action="store_true",
                        help="eval-mode forward (EMA BatchNorm stats) "
                        "instead of train-mode")
    parser.add_argument("--tau", type=float, default=None)
    parser.add_argument("--eps", type=float, default=None)
    parser.add_argument("--k-cpt", type=float, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--grads", action="store_true",
                        help="also check the training gradient against a "
                        "float64 finite difference of the oracle's "
                        "stop-gradient-explicit loss (train mode)")
    parser.add_argument("--pyramid-tf1", action="store_true",
                        help="run ToPyramid on TF1's legacy resize grid "
                        "(ops.config.set_pyramid_tf1), as a "
                        "reference-trained checkpoint needs (PARITY.md)")
    parser.add_argument("--maxpool-tf1", action="store_true",
                        help="MaxPool with the reference's transposed "
                        "max_pool args (window=stride, stride=supp; "
                        "ops.config.set_maxpool_tf1, PARITY.md)")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    args = parser.parse_args(argv)

    from . import set_up_device
    from .ops import config as ops_config
    device = set_up_device(args.device, "fp32")
    if args.pyramid_tf1:
        ops_config.set_pyramid_tf1(True)
    if args.maxpool_tf1:
        ops_config.set_maxpool_tf1(True)

    from .data.dataset import Dataset
    from .paritycheck import check_grad_parity, check_parity

    ds = Dataset(args.data, device_put=False) if args.data else None
    if args.checkpoint:
        from .utils.serdes import read_net
        net, params, state, _ = read_net(args.checkpoint, device)
    elif args.expt:
        from . import experiments as cfg
        from .models.steps import init_training
        regs = cfg.make_experiments()
        if args.expt in regs:
            make = regs[args.expt].nets[args.net]
        else:
            make = cfg.make_adaptive_experiments()[args.expt].net
        shapes = ((32, 32, 3), (10,))
        if ds is not None:
            shapes = (ds.x0_tr.shape[1:], ds.y_tr.shape[1:])
        net = make(*shapes)
        params, state, _ = init_training(net, seed=args.seed, device=device)
    else:
        parser.error("give a checkpoint path or --expt")

    b = args.batch_size
    if ds is not None:
        x0, y = ds.x0_ts[:b], ds.y_ts[:b]
    else:
        r = np.random.RandomState(args.seed)
        h, w, c = net.hypers.x0_shape
        n_cls = net.hypers.y_shape[0]
        x0 = r.rand(b, h, w, c).astype(np.float32)
        y = np.eye(n_cls, dtype=np.float32)[r.randint(0, n_cls, b)]

    report = check_parity(net, params, state, x0, y,
                          train=not args.eval, tau=args.tau, eps=args.eps,
                          k_cpt=args.k_cpt)
    print(json.dumps(report, indent=2))
    ok = report["ok"]
    if args.grads:
        grad_report = check_grad_parity(net, params, state, x0, y,
                                        tau=args.tau, eps=args.eps,
                                        k_cpt=args.k_cpt, seed=args.seed)
        print(json.dumps(grad_report, indent=2))
        ok = ok and grad_report["ok"]
    print("PARITY %s" % ("OK" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
