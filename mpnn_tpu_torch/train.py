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

With --vmap-sweep, an experiment that sweeps k_cpt (`sweep_k_cpts`: the
actor and critic sweeps) trains all its nets at once, one vmapped step
per iteration (`make_sweep_train_loop`) and one vmapped evaluation pass
per split, and writes every net's files as the serial path does. With
--net, or for an experiment without `sweep_k_cpts` (the SR sweeps), it
runs serially, as `mpnn_tpu` does.

    python -m mpnn_tpu_torch.data.prep --synthetic --small --data-dir D/data
    python -m mpnn_tpu_torch.train synth-ac --net 4 --n-iter 40 --t-log 20 \\
        --data-root D --out-root D/nets
    python -m mpnn_tpu_torch.train synth-ac --vmap-sweep --n-iter 40 \\
        --t-log 20 --data-root D --out-root D/nets

Chains and trees (`*-tree`) train the same way, serially and with
--vmap-sweep. `train_adaptive_experiment` trains one net of the adaptive
registry (its CLI is `mpnn_tpu_torch.train_adaptive`).

With --stacked-tails each group of congruent subtrees (a tree's eight
5-stage tails, a chain's congruent leaves) runs as one vmapped template
(`ops.config.stacked_tails`, off by default as in `mpnn_tpu`); the files
are those of the serial path.

Runs on CUDA unless --device cpu is given. Not ported: meshes (the sweep
mesh included) and multi-host runs, --profile-dir and the TF1 parity
modes."""

import json
import os
import time
from argparse import ArgumentParser

import numpy as np
import torch

from . import experiments as cfg
from . import resolve_device, set_up_device, synchronize
from .data.dataset import Dataset
from .models.steps import (Schedules, init_training, make_eval_split_fn,
                           make_sweep_eval_split_fn, make_sweep_train_loop,
                           make_train_loop)
from .utils.desc import net_desc, render_net_desc, sweep_net_descs
from .utils.serdes import atomic_save, read_net, write_net
from .utils.tree import stack_trees, tree_to_host, unstack_tree

__all__ = ["train_one_net", "train_experiment", "train_adaptive_experiment",
           "main"]

STACKED_TAILS_HELP = ("run each group of congruent subtrees (a tree's "
                      "tails) as one vmapped template, its stages one "
                      "launch of fused_mcm's net axis")


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
    `%.4i-stats.npy` latest, the rendered tree appended to
    `%.4i-log.txt`, and the `%.4i.npy` checkpoint with the momentum and
    the step."""
    text = render_net_desc(desc, "%s/%.4i.npy — Epoch %i" % (out_dir, i, t))
    os.makedirs(out_dir, exist_ok=True)
    _save_snapshot(out_dir, i, t, desc)
    atomic_save(os.path.join(out_dir, "%.4i-stats.npy" % i), desc)
    with open(os.path.join(out_dir, "%.4i-log.txt" % i), "a+") as f:
        f.write(text + "\n")
    write_net(os.path.join(out_dir, "%.4i.npy" % i), net, params, state,
              extra={"vel": vel, "t": t})
    if verbose:
        print(text)


def _save_snapshot(out_dir, i, t, desc):
    snap_dir = os.path.join(out_dir, "%.4i-stats" % i)
    os.makedirs(snap_dir, exist_ok=True)
    atomic_save(os.path.join(snap_dir, "%.8i.npy" % t), desc)


def _train_in_spans(trees, train_span, evaluate, write, *, t_start, n_iter,
                    t_log, device, verbose, tag="", start_evaluated=True):
    """Train from t_start to n_iter in spans that end on t_log boundaries
    (`trees = train_span(trees, t, n)`, one call a span, no host round
    trip inside it); at every boundary, and at n_iter off one, `desc =
    evaluate(t, trees)` and `write(t, desc, trees)`. A run resumed at
    t_start = n_iter is evaluated again unless start_evaluated (its
    checkpoint was written with its evaluation). Returns (trees, the
    last desc, clock): the host seconds spent training (to the device's
    end of each span), evaluating and writing, the evaluations, and the
    whole run's seconds."""
    clock = {"train_s": 0.0, "eval_s": 0.0, "write_s": 0.0, "evals": 0}
    desc = None

    def eval_and_write(t):
        t0 = time.perf_counter()
        desc = evaluate(t, trees)
        t1 = time.perf_counter()
        write(t, desc, trees)
        clock["eval_s"] += t1 - t0
        clock["write_s"] += time.perf_counter() - t1
        clock["evals"] += 1
        return desc

    t0_wall = time.perf_counter()
    t = t_start
    last_written = t_start if t_start and start_evaluated else -1
    while t < n_iter:
        n_chunk = min(t_log - (t % t_log), n_iter - t)
        ts = time.perf_counter()
        trees = train_span(trees, t, n_chunk)
        synchronize(device)
        clock["train_s"] += time.perf_counter() - ts
        t += n_chunk
        if verbose:
            print("  --- Iteration %i%s ---\r" % (t, tag), end="",
                  flush=True)
        if t % t_log == 0:
            desc = eval_and_write(t)
            last_written = t
    if last_written != n_iter:
        # n_iter off a t_log boundary: evaluate and write the final state.
        desc = eval_and_write(n_iter)
    clock["total_s"] = time.perf_counter() - t0_wall
    return trees, desc, clock


def _resume_from(ckpt_path, device, verbose):
    """(params, state, vel, t) of a checkpoint that carries the momentum
    and the step, or None."""
    if ckpt_path is None or not os.path.exists(ckpt_path):
        return None
    _, params, state, extra = read_net(ckpt_path, device)
    if extra is None or "vel" not in extra or "t" not in extra:
        return None
    if verbose:
        print("  [resuming %s at t=%i]" % (ckpt_path, extra["t"]))
    return params, state, extra["vel"], extra["t"]


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
    ckpt_path = (os.path.join(out_dir, "%.4i.npy" % net_index)
                 if out_dir is not None else None)
    found = _resume_from(ckpt_path, device, verbose) if resume else None
    if found is not None:
        params, state, vel, t_start = found
    else:
        params, state, vel = init_training(net, seed, device)
        if out_dir is not None:
            _fresh_log(out_dir, net_index)
    loop = make_train_loop(net, batch_size, schedules)
    # The net's static price, rounded to fp32 as `mpnn_tpu` passes it.
    k_cpt = (None if schedules.k_cpt_sample is not None
             else float(np.float32(getattr(net.hypers, "k_cpt", 0.0))))
    eval_split = make_eval_split_fn(net, batch_size)
    x0_tr, y_tr, m_sym = dataset.train_arrays

    def train_span(trees, t, n):
        return loop(*trees, t, seed + 1, x0_tr, y_tr, m_sym, n, k_cpt)[:3]

    def evaluate(t, trees):
        return net_desc(net, dataset, trees[0], trees[1],
                        batch_size=batch_size,
                        tau=_tau_at(tau_fn, t - 1, net),
                        eval_split=eval_split)

    def write(t, desc, trees):
        if out_dir is not None:
            _write_epoch_outputs(out_dir, net_index, t, desc, net, *trees,
                                 verbose=verbose)

    (params, state, vel), desc, clock = _train_in_spans(
        (params, state, vel), train_span, evaluate, write, t_start=t_start,
        n_iter=n_iter, t_log=t_log, device=device, verbose=verbose)
    _report(clock, t_start, n_iter, batch_size, 1, verbose, timings)
    return params, state, vel, desc


def _report(clock, t_start, n_iter, batch_size, n_nets, verbose, timings):
    """Print a run's rates (over all nets for a sweep) and fill `timings`
    with the clock, the steps and the batch size (and n_nets for a
    sweep)."""
    n_run = n_iter - t_start
    imgs = n_nets * n_run * batch_size
    dt, train_s = clock["total_s"], clock["train_s"]
    if verbose:
        if n_nets == 1:
            print("\n  [%i iters in %.1fs — %.0f img/s]"
                  % (n_run, dt, imgs / max(dt, 1e-9)))
        else:
            print("\n  [sweep of %i nets x %i iters in %.1fs — %.0f img/s "
                  "aggregate]" % (n_nets, n_run, dt, imgs / max(dt, 1e-9)))
        print("  [training %.1fs — %.0f img/s%s; %i evals in %.1fs; writes "
              "%.1fs]" % (train_s, imgs / max(train_s, 1e-9),
                          " aggregate" if n_nets > 1 else "",
                          clock["evals"], clock["eval_s"], clock["write_s"]))
    if timings is not None:
        timings.update(clock, t_start=t_start, n_iter=n_iter, steps=n_run,
                       batch_size=batch_size)
        if n_nets > 1:
            timings["n_nets"] = n_nets


def _read_sweep(out_dir, n_nets, device):
    """[(params, state, vel)] and t of every member's checkpoint, or None
    unless each one exists, carries the momentum and the step, and they
    agree on the step (a reference-schema checkpoint cannot seed the
    sweep)."""
    paths = [os.path.join(out_dir, "%.4i.npy" % i) for i in range(n_nets)]
    if not all(os.path.exists(p) for p in paths):
        return None
    loaded = [read_net(p, device) for p in paths]
    extras = [ex for _, _, _, ex in loaded]
    if not all(ex is not None and "vel" in ex and "t" in ex
               for ex in extras):
        return None
    ts = {int(ex["t"]) for ex in extras}
    if len(ts) != 1:
        return None
    return [(p, s, ex["vel"]) for _, p, s, ex in loaded], ts.pop()


def _train_sweep(expt, expt_name, dataset, *, n_iter, t_log, batch_size,
                 out_dir, seed, verbose=True, resume=False, timings=None):
    """Train a k_cpt sweep's nets at once (`make_sweep_train_loop`),
    member i drawn as the serial path draws net i (`init_training(net,
    seed + i)`), the shared batch stream from seed + 1. At every t_log
    boundary (and at n_iter off one) it evaluates every member in one
    vmapped pass per split and writes each net's files as
    `train_one_net` does; with resume=True it continues from the
    members' checkpoints when `_read_sweep` accepts them. Returns
    (params_s, state_s, vel_s, descs) of the stacked trees; with a
    `timings` dict, fills it as `train_one_net` does, plus n_nets."""
    k_cpts = np.asarray(expt.sweep_k_cpts, np.float32)
    n_nets = len(k_cpts)
    device = dataset.device
    nets = [expt.nets[i](dataset.x0_shape, dataset.y_shape)
            for i in range(n_nets)]
    net = nets[0]  # the architecture every member shares
    schedules = Schedules(lr=cfg.λ_lrn, tau=expt.tau)
    loop = make_sweep_train_loop(net, batch_size, schedules)
    eval_split = make_sweep_eval_split_fn(net, batch_size)
    x0_tr, y_tr, m_sym = dataset.train_arrays
    k_arr = torch.as_tensor(k_cpts, device=device)

    t_start = 0
    found = _read_sweep(out_dir, n_nets, device) if resume else None
    if found is not None:
        members, t_start = found
        if verbose:
            print("  [resuming %s sweep at t=%i]" % (expt_name, t_start))
    else:
        members = [init_training(net, seed + i, device)
                   for i in range(n_nets)]
        for i in range(n_nets):
            _fresh_log(out_dir, i)
    trees = tuple(stack_trees([m[j] for m in members]) for j in range(3))
    del members

    def train_span(trees, t, n):
        return loop(*trees, t, seed + 1, x0_tr, y_tr, m_sym, n, k_arr)[:3]

    def evaluate(t, trees):
        return sweep_net_descs(net, dataset, trees[0], trees[1], k_cpts,
                               batch_size=batch_size,
                               tau=_tau_at(expt.tau, t - 1, net),
                               eval_split=eval_split)

    def write(t, descs, trees):
        # One device-to-host copy of the stacked trees, then per-net views.
        host = tree_to_host(trees)
        for i in range(n_nets):
            _write_epoch_outputs(out_dir, i, t, descs[i], nets[i],
                                 *(unstack_tree(h, i) for h in host),
                                 verbose=verbose)

    trees, descs, clock = _train_in_spans(
        trees, train_span, evaluate, write, t_start=t_start, n_iter=n_iter,
        t_log=t_log, device=device, verbose=verbose,
        tag=" (sweep of %i)" % n_nets)
    _report(clock, t_start, n_iter, batch_size, n_nets, verbose, timings)
    return (*trees, descs)


def train_experiment(expt_name, *, n_iter=None, t_log=None, batch_size=None,
                     net_indices=None, data_root=".", out_root="nets",
                     seed=0, verbose=True, resume=False, device="cuda",
                     timings=None, vmap_sweep=False):
    """Train the nets of a registry experiment one after another (all, or
    `net_indices`) on `device`; with vmap_sweep, an experiment with
    `sweep_k_cpts` and no `net_indices` trains all its nets at once
    (`_train_sweep`). With a `timings` list, one dict per net (one for the
    whole sweep) is appended (see `train_one_net`)."""
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
    if (vmap_sweep and getattr(expt, "sweep_k_cpts", None) is not None
            and net_indices is None):
        rec = {} if timings is not None else None
        _train_sweep(expt, expt_name, dataset, n_iter=n_iter, t_log=t_log,
                     batch_size=batch_size, out_dir=out_dir, seed=seed,
                     verbose=verbose, resume=resume, timings=rec)
        if timings is not None:
            timings.append(dict(rec, expt=expt_name, net_index=None))
        return
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


def train_adaptive_experiment(expt_name, *, n_iter=None, batch_size=None,
                              t_log=None, data_root=".", out_root="nets",
                              seed=0, verbose=True, resume=False,
                              stats_log=False, device="cuda", timings=None):
    """Train one net of the adaptive registry on `device`, with k_cpt
    sampled per example from `experiments.k_cpts` each batch, then
    evaluate it once per k_cpt (counterpart of `mpnn_tpu`'s
    `train_adaptive_experiment`). Writes to <out_root>/<expt>/:

    - `net.npy` with the momentum and the step at every t_log boundary
      before n_iter (resume continues from it), and at n_iter before the
      evaluations, so a run stopped during them resumes there;
    - `%.4i-stats.npy` per k_cpt index, at the τ of step n_iter - 1;
    - with stats_log, the per-k_cpt descriptors at every boundary as well,
      into `%.4i-stats/%.8i.npy` snapshots (and the latest);
    - `MANIFEST.json`.

    The draws are `make_train_loop`'s, functions of (seed + 1, t), so a
    resumed run draws what an uninterrupted run draws. With a `timings`
    dict, it is filled as `train_one_net` fills it; `evals` counts the
    per-k_cpt evaluations."""
    expt = cfg.make_adaptive_experiments()[expt_name]
    device = resolve_device(device)
    dataset = Dataset(os.path.join(data_root, expt.dataset), device=device)
    n_iter = n_iter or cfg.n_iter
    batch_size = batch_size or cfg.batch_size
    out_dir = os.path.join(out_root, expt_name)
    _write_manifest(out_dir, dataset)
    ckpt_path = os.path.join(out_dir, "net.npy")

    net = expt.net(dataset.x0_shape, dataset.y_shape)
    schedules = Schedules(lr=cfg.λ_lrn, tau=expt.tau,
                          k_cpt_sample=cfg.k_cpts)
    found = _resume_from(ckpt_path, device, verbose) if resume else None
    if found is not None:
        params, state, vel, t_start = found
    else:
        params, state, vel = init_training(net, seed, device)
        t_start = 0
    loop = make_train_loop(net, batch_size, schedules)
    eval_split = make_eval_split_fn(net, batch_size)
    x0_tr, y_tr, m_sym = dataset.train_arrays
    done = {"evals": 0, "ckpt_s": 0.0}

    def train_span(trees, t, n):
        return loop(*trees, t, seed + 1, x0_tr, y_tr, m_sym, n)[:3]

    def evaluate(t, trees):
        # _train_in_spans evaluates before it writes, and net.npy has to
        # come first: a run stopped during the evaluations resumes at t.
        ts = time.perf_counter()
        write_net(ckpt_path, net, trees[0], trees[1],
                  extra={"vel": trees[2], "t": t})
        done["ckpt_s"] += time.perf_counter() - ts
        if t < n_iter and not stats_log:
            return []
        done["evals"] += len(cfg.k_cpts)
        tau = _tau_at(expt.tau, t - 1, net)
        return [net_desc(net, dataset, trees[0], trees[1],
                         batch_size=batch_size, tau=tau, k_cpt=k_cpt,
                         eval_split=eval_split) for k_cpt in cfg.k_cpts]

    def write(t, descs, trees):
        for i, desc in enumerate(descs):
            if stats_log:
                _save_snapshot(out_dir, i, t, desc)
            atomic_save(os.path.join(out_dir, "%.4i-stats.npy" % i), desc)

    (params, state, vel), _, clock = _train_in_spans(
        (params, state, vel), train_span, evaluate, write, t_start=t_start,
        n_iter=n_iter, t_log=t_log or cfg.t_log, device=device,
        verbose=verbose, start_evaluated=False)
    # Count the per-k_cpt evaluations, and net.npy's writes as writing.
    clock.update(evals=done["evals"],
                 eval_s=clock["eval_s"] - done["ckpt_s"],
                 write_s=clock["write_s"] + done["ckpt_s"])
    _report(clock, t_start, n_iter, batch_size, 1, verbose, timings)
    return params, state, vel


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
    parser.add_argument("--vmap-sweep", action="store_true",
                        help="train a whole k_cpt sweep (the actor and "
                             "critic experiments) at once, one vmapped "
                             "step per iteration")
    parser.add_argument("--analytic-l2", action="store_true",
                        help="weight L2 as a closed-form decay gradient "
                             "instead of in-graph reductions")
    parser.add_argument("--stacked-tails", action="store_true",
                        help=STACKED_TAILS_HELP)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    args = parser.parse_args(argv)
    if args.expt not in names:
        parser.error("unknown experiment %r (choose from %s)"
                     % (args.expt, ", ".join(names)))
    device = set_up_device(args.device, args.precision)
    from .ops import config
    config.set_analytic_l2(args.analytic_l2)
    config.set_stacked_tails(args.stacked_tails)
    train_experiment(
        args.expt, n_iter=args.n_iter, t_log=args.t_log,
        batch_size=args.batch_size, net_indices=args.net,
        data_root=args.data_root, out_root=args.out_root, seed=args.seed,
        resume=args.resume, device=device, vmap_sweep=args.vmap_sweep)


if __name__ == "__main__":
    main()
