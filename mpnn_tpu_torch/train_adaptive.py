"""Adaptive-net trainer CLI (counterpart of `scripts/train-adaptive-nets`).

Trains one net of the adaptive registry
(`experiments.make_adaptive_experiments`: dyn_k_cpt chains and trees)
with k_cpt sampled per example from the sweep's eight prices each batch,
then evaluates it once per price: `net.npy` (with the momentum and the
step, written at every --t-log boundary too, so --resume continues from
it), one `%.4i-stats.npy` per price and `MANIFEST.json` under
<out-root>/<expt>/, in `mpnn_tpu`'s formats
(`train.train_adaptive_experiment`).

    python -m mpnn_tpu_torch.data.prep --synthetic --small --data-dir D/data
    python -m mpnn_tpu_torch.train_adaptive synth-ac-tree-dynkcpt \\
        --n-iter 40 --t-log 20 --data-root D --out-root D/nets

With --stacked-tails the tree's eight congruent 5-stage tails run as one
vmapped template (`ops.config.stacked_tails`), each tail stage one launch
of fused_mcm's net axis, and the training loop carries them pre-stacked;
the files are those of the serial path.

Runs on CUDA unless --device cpu is given; fp32 runs with TF32 off, and
with deterministic algorithms (`set_up_device`), so a resumed run repeats
the uninterrupted one. The
last line is one JSON object: the run's steps, evaluations (one per
price) and host seconds (`train.train_adaptive_experiment`'s timings),
and the fused_mcm kernel launches it made (`fused_mcm_launches`, of which
`fused_mcm_net_launches` on the net axis).

--pyramid-tf1 and --maxpool-tf1 set the TF1 parity modes before the net
is built. `--platform` is JAX's and the port has `--device`."""

import json
import os
from argparse import ArgumentParser

from . import experiments as cfg
from .train import STACKED_TAILS_HELP, add_tf1_flags, set_tf1_modes


def main(argv=None):
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    names = sorted(cfg.make_adaptive_experiments())
    parser.add_argument("expt", choices=names,
                        help="the experiment to perform")
    parser.add_argument("--n-iter", type=int, default=None)
    parser.add_argument("--t-log", type=int, default=None,
                        help="checkpoint cadence (default 2500)")
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--precision", choices=["fp32", "bf16"],
                        default="fp32")
    parser.add_argument("--data-root", default=".")
    parser.add_argument(
        "--out-root", default=os.environ.get("MPNN_OUT_ROOT", "nets"),
        help="output root for <expt>/ trees (env: MPNN_OUT_ROOT); point "
             "smoke runs away from campaign outputs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resume", action="store_true",
                        help="continue from the periodic net.npy checkpoint")
    parser.add_argument("--stats-log", action="store_true",
                        help="also write the per-k_cpt descriptor snapshots "
                             "at every t_log boundary")
    parser.add_argument("--stacked-tails", action="store_true",
                        help=STACKED_TAILS_HELP)
    add_tf1_flags(parser)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)

    from . import set_up_device
    from .ops import config
    from .ops.kernels import fused_mcm
    from .train import train_adaptive_experiment
    device = set_up_device(args.device, args.precision,
                           deterministic=True)
    config.set_stacked_tails(args.stacked_tails)
    set_tf1_modes(args)
    n0, m0, timings = fused_mcm.launches, fused_mcm.net_launches, {}
    train_adaptive_experiment(
        args.expt, n_iter=args.n_iter, batch_size=args.batch_size,
        t_log=args.t_log, data_root=args.data_root, out_root=args.out_root,
        seed=args.seed, resume=args.resume, stats_log=args.stats_log,
        device=device, timings=timings)
    print(json.dumps(dict(
        timings, expt=args.expt, stacked_tails=args.stacked_tails,
        fused_mcm_launches=fused_mcm.launches - n0,
        fused_mcm_net_launches=fused_mcm.net_launches - m0)), flush=True)


if __name__ == "__main__":
    main()
