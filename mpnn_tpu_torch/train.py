"""Experiment trainer (counterpart of `mpnn_tpu/train.py` and
`scripts/train-nets`, serial path).

For each net of a registry experiment: train n_iter steps in spans of
t_log (`make_train_loop`); at every t_log boundary evaluate both splits
(`net_desc`) and write `<out>/<expt>/%.4i-stats/%.8i.npy`,
`%.4i-stats.npy`, the rendered tree appended to `%.4i-log.txt` and the
checkpoint `%.4i.npy` with the momentum and the step for resume; when
n_iter is off a boundary, evaluate and write once more at the end.
`MANIFEST.json` records the dataset's provenance. The files are the ones
`mpnn_tpu`'s CLI writes, in its formats: its `read_net` reads the
checkpoints and its figure scripts the stats.

    python -m mpnn_tpu_torch.data.prep --synthetic --small --data-dir D/data
    python -m mpnn_tpu_torch.train synth-ac --net 4 --n-iter 40 --t-log 20 \\
        --data-root D --out-root D/nets

Runs on CUDA unless --device cpu is given. Not ported: the `*-tree`
experiments, the vmapped sweep (--vmap-sweep), meshes and multi-host
runs, the adaptive registry, --profile-dir and the TF1 parity modes."""

import json
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from . import experiments as cfg
from . import resolve_device, synchronize
from .data.dataset import Dataset
from .models.steps import (Schedules, init_training, make_eval_split_fn,
                           make_train_loop)
from .utils.desc import net_desc, render_net_desc
from .utils.serdes import atomic_save, read_net, write_net

__all__ = ["train_one_net", "train_experiment", "main"]


def _write_manifest(out_dir, dataset):
    """<out>/<expt>/MANIFEST.json: the dataset's provenance, so results on
    synthetic stand-ins are never taken for real-dataset results."""
    os.makedirs(out_dir, exist_ok=True)
    prov = dataset.provenance
    if prov is None:
        prov = {"synthetic": None,
                "note": "archive carries no provenance record"}
    with open(os.path.join(out_dir, "MANIFEST.json"), "w") as f:
        json.dump({"dataset": dataset.path, "provenance": prov}, f,
                  indent=2, default=str)
        f.write("\n")


def _fresh_log(out_dir, i):
    """Remove a net's rendered log before a run that does not resume (the
    log is appended to; a resumed run keeps one continuous log)."""
    path = os.path.join(out_dir, "%.4i-log.txt" % i)
    if os.path.exists(path):
        os.remove(path)


def _tau_at(tau_fn, t, net):
    if tau_fn is None:
        return float(getattr(net.hypers, "τ", 1.0))
    return float(tau_fn(t))


def _write_epoch_outputs(out_dir, i, t, desc, net, params, state, vel, *,
                         verbose=True):
    """The per-t_log files: `%.4i-stats/%.8i.npy` snapshot,
    `%.4i-stats.npy` latest, the rendered tree appended to `%.4i-log.txt`,
    and the `%.4i.npy` checkpoint with the momentum and the step."""
    text = render_net_desc(desc, "%s/%.4i.npy — Epoch %i" % (out_dir, i, t))
    snap_dir = os.path.join(out_dir, "%.4i-stats" % i)
    os.makedirs(snap_dir, exist_ok=True)
    atomic_save(os.path.join(snap_dir, "%.8i.npy" % t), desc)
    atomic_save(os.path.join(out_dir, "%.4i-stats.npy" % i), desc)
    with open(os.path.join(out_dir, "%.4i-log.txt" % i), "a+") as f:
        f.write(text + "\n")
    write_net(os.path.join(out_dir, "%.4i.npy" % i), net, params, state,
              extra={"vel": vel, "t": t})
    if verbose:
        print(text)


def train_one_net(net, dataset, *, schedules, tau_fn, n_iter, t_log,
                  batch_size, out_dir=None, net_index=0, seed=0,
                  verbose=True, resume=False, timings=None):
    """Train one net on `dataset` (on the dataset's device); returns
    (params, state, vel, final_desc).

    Checkpoints are written at every t_log boundary; with resume=True a
    checkpoint that carries the momentum continues from its step. With a
    `timings` dict, it is filled with the run's steps and evaluations and
    the host seconds spent training (to the device's end of each span),
    evaluating and writing."""
    device = dataset.device
    t_start = 0
    params = None
    ckpt_path = (os.path.join(out_dir, "%.4i.npy" % net_index)
                 if out_dir is not None else None)
    if resume and ckpt_path is not None and os.path.exists(ckpt_path):
        _, params, state, extra = read_net(ckpt_path, device)
        if extra is not None and "vel" in extra:
            vel, t_start = extra["vel"], extra["t"]
            if verbose:
                print("  [resuming %s at t=%i]" % (ckpt_path, t_start))
        else:
            params = None
    if params is None:
        params, state, vel = init_training(net, seed, device)
        if out_dir is not None:
            _fresh_log(out_dir, net_index)
    loop = make_train_loop(net, batch_size, schedules)
    # The net's static price, rounded to fp32 as `mpnn_tpu` passes it.
    k_cpt = (None if schedules.k_cpt_sample is not None
             else float(np.float32(getattr(net.hypers, "k_cpt", 0.0))))
    eval_split = make_eval_split_fn(net, batch_size)
    x0_tr, y_tr, m_sym = dataset.train_arrays
    clock = {"train_s": 0.0, "eval_s": 0.0, "write_s": 0.0, "evals": 0}
    desc = None

    def eval_and_write(t):
        t0 = time.perf_counter()
        desc = net_desc(net, dataset, params, state, batch_size=batch_size,
                        tau=_tau_at(tau_fn, t - 1, net),
                        eval_split=eval_split)
        t1 = time.perf_counter()
        if out_dir is not None:
            _write_epoch_outputs(out_dir, net_index, t, desc, net,
                                 params, state, vel, verbose=verbose)
        clock["eval_s"] += t1 - t0
        clock["write_s"] += time.perf_counter() - t1
        clock["evals"] += 1
        return desc

    t0_wall = time.perf_counter()
    t = t_start
    last_written = t_start if t_start else -1
    while t < n_iter:
        # One span per t_log window: no host round trip inside it.
        n_chunk = min(t_log - (t % t_log), n_iter - t)
        ts = time.perf_counter()
        params, state, vel, cs = loop(params, state, vel, t, seed + 1,
                                      x0_tr, y_tr, m_sym, n_chunk, k_cpt)
        synchronize(device)
        clock["train_s"] += time.perf_counter() - ts
        t += n_chunk
        if verbose:
            print("  --- Iteration %i ---\r" % t, end="", flush=True)
        if t % t_log == 0:
            desc = eval_and_write(t)
            last_written = t
    if last_written != n_iter:
        # n_iter off a t_log boundary: evaluate and write the final state.
        desc = eval_and_write(n_iter)
    dt = time.perf_counter() - t0_wall
    n_run = n_iter - t_start
    if verbose:
        print("\n  [%i iters in %.1fs — %.0f img/s]"
              % (n_run, dt, n_run * batch_size / max(dt, 1e-9)))
        print("  [training %.1fs — %.0f img/s; %i evals in %.1fs; writes "
              "%.1fs]" % (clock["train_s"], n_run * batch_size
                          / max(clock["train_s"], 1e-9), clock["evals"],
                          clock["eval_s"], clock["write_s"]))
    if timings is not None:
        timings.update(clock, t_start=t_start, n_iter=n_iter, steps=n_run,
                       batch_size=batch_size, total_s=dt)
    return params, state, vel, desc


def train_experiment(expt_name, *, n_iter=None, t_log=None, batch_size=None,
                     net_indices=None, data_root=".", out_root="nets",
                     seed=0, verbose=True, resume=False, device="cuda",
                     timings=None):
    """Train the nets of a registry experiment one after another (all, or
    `net_indices`) on `device`. With a `timings` list, one dict per net is
    appended (see `train_one_net`)."""
    if expt_name in cfg.TREE_EXPERIMENTS:
        raise ValueError(
            "%r trains dr_tree nets, which are not ported to mpnn_tpu_torch "
            "yet" % expt_name)
    expt = cfg.make_experiments()[expt_name]
    device = resolve_device(device)
    dataset = Dataset(os.path.join(data_root, expt.dataset), device=device)
    n_iter = n_iter or cfg.n_iter
    t_log = t_log or cfg.t_log
    batch_size = batch_size or cfg.batch_size
    out_dir = os.path.join(out_root, expt_name)
    indices = (net_indices if net_indices is not None
               else range(len(expt.nets)))
    _write_manifest(out_dir, dataset)
    for i in indices:
        net = expt.nets[i](dataset.x0_shape, dataset.y_shape)
        schedules = Schedules(lr=cfg.λ_lrn, tau=expt.tau)
        rec = {} if timings is not None else None
        train_one_net(
            net, dataset, schedules=schedules, tau_fn=expt.tau,
            n_iter=n_iter, t_log=t_log, batch_size=batch_size,
            out_dir=out_dir, net_index=i, seed=seed + i, verbose=verbose,
            resume=resume, timings=rec)
        if timings is not None:
            timings.append(dict(rec, expt=expt_name, net_index=i))


def main(argv=None):
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    names = sorted(cfg.make_experiments())
    parser.add_argument("expt", help="the experiment to perform, one of: "
                        + ", ".join(names))
    parser.add_argument("--n-iter", type=int, default=None)
    parser.add_argument("--t-log", type=int, default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--net", type=int, action="append", default=None,
                        help="train only these net indices of the sweep")
    parser.add_argument("--precision", choices=["fp32", "bf16"],
                        default="fp32")
    parser.add_argument("--data-root", default=".")
    parser.add_argument(
        "--out-root", default=os.environ.get("MPNN_OUT_ROOT", "nets"),
        help="output root for <expt>/ trees (env: MPNN_OUT_ROOT); point "
             "smoke runs away from campaign outputs")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--resume", action="store_true",
                        help="continue from the latest periodic checkpoint")
    parser.add_argument("--analytic-l2", action="store_true",
                        help="weight L2 as a closed-form decay gradient "
                             "instead of in-graph reductions")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    if args.expt in cfg.TREE_EXPERIMENTS:
        parser.error("%r trains dr_tree nets, which are not ported to "
                     "mpnn_tpu_torch yet" % args.expt)
    if args.expt not in names:
        parser.error("unknown experiment %r (choose from %s)"
                     % (args.expt, ", ".join(names)))

    from .ops import config
    device = resolve_device(args.device)
    if device.type == "cuda":
        # fp32 means fp32: no TF32 in cuDNN convs or cuBLAS matmuls.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    config.set_compute_dtype(torch.bfloat16 if args.precision == "bf16"
                             else None)
    config.set_analytic_l2(args.analytic_l2)
    train_experiment(
        args.expt, n_iter=args.n_iter, t_log=args.t_log,
        batch_size=args.batch_size, net_indices=args.net,
        data_root=args.data_root, out_root=args.out_root, seed=args.seed,
        resume=args.resume, device=device)


if __name__ == "__main__":
    main()
