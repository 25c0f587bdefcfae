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

--pyramid-tf1 and --maxpool-tf1 set the TF1 parity modes
(`ops.config.pyramid_tf1`, `maxpool_tf1`) before any net is built, as
`scripts/train-nets` does.

Meshes (`parallel`), one process per rank: --mesh auto|DxM trains
data-parallel over D ranks (M, the 'model' axis, must be 1), or with
--vmap-sweep over a (sweep x data) mesh, each rank training its
n_nets / S members. In a process that no launcher started, --mesh DxM
starts the D x M ranks itself (`torch.multiprocessing`, spawn), on one
card if there is one (over gloo) or on the CPU; --multihost joins the
ranks a launcher started from its environment (`multihost.initialize`),
over NCCL where each rank has a card of its own:

    python -m mpnn_tpu_torch.train synth-ac --net 4 --mesh 2x1 ...
    python -m torch.distributed.run --nproc-per-node 2 \
        -m mpnn_tpu_torch.train synth-ac --net 4 --multihost --mesh auto ...

One rank writes each file: rank 0 the manifest and a data-parallel net's
files, and under a sweep mesh the rank of 'data' index 0 that holds a
member writes that member's. A rank that fails, or a collective that
fails, fails the run.

--profile-dir DIR traces the serial loop as `mpnn_tpu` does: 2 warm-up
steps, then 8 steps under torch.profiler (CPU and CUDA activities), the
Chrome trace written to DIR/trace.json (DIR/rank<r>/ under a mesh of
several ranks); those 10 steps are training steps, and a t_log boundary
inside them writes nothing. The loop's spans, and so its draws, are
those of a run without the flag. A run of 10 steps or fewer is refused
(`mpnn_tpu` would write a checkpoint labelled n_iter after 10 steps), as
is --vmap-sweep. --debug-nans, the counterpart of jax_debug_nans, checks
the loss, the gradients and the updated params, state and velocity after
every step (`models.steps.check_nans`) and raises FloatingPointError at
the first NaN, naming the step and the leaf.

Runs on CUDA unless --device cpu is given; there with deterministic
algorithms (`set_up_device(..., deterministic=True)`, as the other
training entry points), so a resumed run repeats the uninterrupted one
bit for bit. Not ported: the 'model' axis."""

import json
import os
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

from . import experiments as cfg
from . import resolve_device, set_up_device, synchronize
from .data.dataset import Dataset
from .ops.layers import fold_stream
from .models.steps import (Schedules, init_training, make_eval_split_fn,
                           make_sweep_eval_split_fn, make_sweep_train_loop,
                           make_train_loop)
from .parallel import make_mesh, make_sweep_mesh, multihost, shard_sweep_tree
from .parallel.mesh import world
from .utils.desc import net_desc, render_net_desc, sweep_net_descs
from .utils.serdes import atomic_save, read_net, write_net
from .utils.tree import stack_trees, tree_to_host, unstack_tree

__all__ = ["train_one_net", "train_experiment", "train_adaptive_experiment",
           "main"]

STACKED_TAILS_HELP = ("run each group of congruent subtrees (a tree's "
                      "tails) as one vmapped template, its stages one "
                      "launch of fused_mcm's net axis")


def add_tf1_flags(parser):
    """--pyramid-tf1 and --maxpool-tf1, the TF1 parity modes."""
    parser.add_argument("--pyramid-tf1", action="store_true",
                        help="ToPyramid on TF1's legacy resize grid (for "
                             "records trained by the reference; "
                             "ops.config.set_pyramid_tf1)")
    parser.add_argument("--maxpool-tf1", action="store_true",
                        help="MaxPool with the reference's transposed "
                             "arguments (window=stride, stride=supp; "
                             "ops.config.set_maxpool_tf1)")


def set_tf1_modes(args):
    """Set the TF1 parity modes of parsed `add_tf1_flags` arguments, before
    any net is built."""
    from .ops import config
    config.set_pyramid_tf1(args.pyramid_tf1)
    config.set_maxpool_tf1(args.maxpool_tf1)


def _eval_key(seed, t):
    """The evaluation's Dropout key at step t, a function of (seed, t) as
    `mpnn_tpu`'s fold_in(PRNGKey(seed + 2), t) is; ignored by nets without
    an active Dropout."""
    return fold_stream(seed + 2, t)


def _write_manifest(out_dir, dataset):
    """<out>/<expt>/MANIFEST.json: the dataset's provenance, so results on
    synthetic stand-ins are never taken for real-dataset results. Written
    by rank 0 only."""
    if not multihost.is_primary():
        return
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
                    t_log, device, verbose, tag="", start_evaluated=True,
                    quiet_until=None):
    """Train from t_start to n_iter in spans that end on t_log boundaries
    (`trees = train_span(trees, t, n)`, one call a span, no host round
    trip inside it); at every boundary after quiet_until (if given), and
    at n_iter off one, `desc = evaluate(t, trees)` and `write(t, desc,
    trees)`. A run resumed at t_start = n_iter is evaluated again unless
    start_evaluated (its checkpoint was written with its evaluation).
    Returns (trees, the last desc, clock): the host seconds spent
    training (to the device's end of each span), evaluating and writing,
    the evaluations, and the whole run's seconds."""
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
        if t % t_log == 0 and (quiet_until is None or t > quiet_until):
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
                  verbose=True, resume=False, timings=None, mesh=None,
                  profile_dir=None):
    """Train one net on `dataset` (on the dataset's device); returns
    (params, state, vel, final_desc).

    Checkpoints are written at every t_log boundary; with resume=True a
    checkpoint that carries the momentum continues from its step. With a
    `timings` dict, it is filled with the run's steps and evaluations and
    the host seconds spent training (to the device's end of each span),
    evaluating and writing.

    With a mesh (`parallel.make_mesh`) the net trains data-parallel over
    its 'data' axis, batch_size being the global batch: every rank starts
    from the same state (the ranks' (t_start, params) are checked to
    agree, then rank 0's are broadcast: a checkpoint that only some ranks
    see fails loud), evaluates its rows of each batch, and rank 0 alone
    writes and prints.

    With profile_dir, the first PROFILE_WARMUP steps run untraced and the
    next PROFILE_STEPS under torch.profiler (`_step_profiler`); a t_log
    boundary among them writes nothing, as in `mpnn_tpu`."""
    device = dataset.device
    writer = multihost.is_primary()
    verbose = verbose and writer
    t_start = 0
    ckpt_path = (os.path.join(out_dir, "%.4i.npy" % net_index)
                 if out_dir is not None else None)
    found = _resume_from(ckpt_path, device, verbose) if resume else None
    if found is not None:
        params, state, vel, t_start = found
    else:
        params, state, vel = init_training(net, seed, device)
        if out_dir is not None and writer:
            _fresh_log(out_dir, net_index)
    if mesh is not None:
        multihost.replicate_to_global(mesh, (params, state, vel), t_start,
                                      ckpt_path)
    loop = make_train_loop(net, batch_size, schedules, mesh=mesh)
    # The net's static price, rounded to fp32 as `mpnn_tpu` passes it.
    k_cpt = (None if schedules.k_cpt_sample is not None
             else float(np.float32(getattr(net.hypers, "k_cpt", 0.0))))
    eval_split = make_eval_split_fn(net, batch_size, mesh=mesh)
    x0_tr, y_tr, m_sym = dataset.train_arrays

    on_step, quiet_until = None, None
    if profile_dir is not None:
        on_step = _step_profiler(profile_dir, t_start, n_iter, device,
                                 verbose)
        quiet_until = t_start + PROFILE_WARMUP + PROFILE_STEPS

    def train_span(trees, t, n):
        return loop(*trees, t, seed + 1, x0_tr, y_tr, m_sym, n, k_cpt,
                    on_step=on_step)[:3]

    def evaluate(t, trees):
        return net_desc(net, dataset, trees[0], trees[1],
                        batch_size=batch_size,
                        tau=_tau_at(tau_fn, t - 1, net),
                        eval_split=eval_split, eval_key=_eval_key(seed, t))

    def write(t, desc, trees):
        if out_dir is not None and writer:
            _write_epoch_outputs(out_dir, net_index, t, desc, net, *trees,
                                 verbose=verbose)

    (params, state, vel), desc, clock = _train_in_spans(
        (params, state, vel), train_span, evaluate, write, t_start=t_start,
        n_iter=n_iter, t_log=t_log, device=device, verbose=verbose,
        quiet_until=quiet_until)
    _report(clock, t_start, n_iter, batch_size, 1, verbose, timings)
    return params, state, vel, desc


# --profile-dir: untraced warm-up steps, then traced steps (`mpnn_tpu/
# train.py:183-196`).
PROFILE_WARMUP = 2
PROFILE_STEPS = 8


def _step_profiler(profile_dir, t_start, n_iter, device, verbose):
    """on_step(t), the train loop's hook for --profile-dir: after step
    t_start + PROFILE_WARMUP - 1 it starts torch.profiler (CPU activity,
    and CUDA's on a card), after PROFILE_STEPS more it stops it and writes
    the Chrome trace to profile_dir/trace.json (profile_dir/rank<r>/
    where the run has several ranks), the device synchronized at both
    ends. The loop's spans and draws are those of a run without it. A
    run with no step left after the traced ones is refused: `mpnn_tpu`
    trains those steps anyway and then writes a checkpoint labelled
    n_iter (or, at exactly 10 steps, none)."""
    from torch.profiler import ProfilerActivity, profile
    n = PROFILE_WARMUP + PROFILE_STEPS
    if n_iter - t_start <= n:
        raise ValueError(
            "--profile-dir trains %d steps (%d warm-up, %d traced) before "
            "the first write: it needs more than %d steps to run, got %d "
            "(t=%d to n_iter=%d)" % (n, PROFILE_WARMUP, PROFILE_STEPS, n,
                                     n_iter - t_start, t_start, n_iter))
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    first = t_start + PROFILE_WARMUP

    def on_step(t):
        if t == first - 1:
            synchronize(device)
            prof.start()
        elif t == first + PROFILE_STEPS - 1:
            synchronize(device)
            prof.stop()
            rank, n_ranks = world()
            out = (profile_dir if n_ranks == 1
                   else os.path.join(profile_dir, "rank%d" % rank))
            os.makedirs(out, exist_ok=True)
            path = os.path.join(out, "trace.json")
            prof.export_chrome_trace(path)
            if verbose or n_ranks > 1:
                print("  [profiler trace written to %s]" % path, flush=True)

    return on_step


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
                 out_dir, seed, verbose=True, resume=False, timings=None,
                 mesh=None):
    """Train a k_cpt sweep's nets at once (`make_sweep_train_loop`),
    member i drawn as the serial path draws net i (`init_training(net,
    seed + i)`), the shared batch stream from seed + 1. At every t_log
    boundary (and at n_iter off one) it evaluates every member in one
    vmapped pass per split and writes each net's files as
    `train_one_net` does; with resume=True it continues from the
    members' checkpoints when `_read_sweep` accepts them. Returns
    (params_s, state_s, vel_s, descs) of the stacked trees; with a
    `timings` dict, fills it as `train_one_net` does, plus n_nets.

    With a ('sweep', 'data') mesh (`parallel.make_sweep_mesh`; n_nets
    must tile 'sweep') every rank reads or draws all members, checks that
    the ranks agree and takes rank 0's, then keeps its own
    (`shard_sweep_tree`); it trains and evaluates them, and the rank of
    'data' index 0 writes their files, so each file is written once. The
    trees and descs returned are this rank's members'."""
    k_cpts = np.asarray(expt.sweep_k_cpts, np.float32)
    n_nets = len(k_cpts)
    if mesh is not None and n_nets % mesh.shape["sweep"] != 0:
        raise ValueError(
            "sweep of %d nets does not tile the %d-way 'sweep' mesh axis"
            % (n_nets, mesh.shape["sweep"]))
    device = dataset.device
    nets = [expt.nets[i](dataset.x0_shape, dataset.y_shape)
            for i in range(n_nets)]
    net = nets[0]  # the architecture every member shares
    schedules = Schedules(lr=cfg.λ_lrn, tau=expt.tau)
    loop = make_sweep_train_loop(net, batch_size, schedules, mesh=mesh)
    eval_split = make_sweep_eval_split_fn(net, batch_size, mesh=mesh)
    x0_tr, y_tr, m_sym = dataset.train_arrays
    mine = (range(n_nets) if mesh is None else
            range(*mesh.axes["sweep"].rows(n_nets)))
    writer = mesh is None or mesh.data.index == 0
    verbose = verbose and multihost.is_primary()
    k_arr = torch.as_tensor(k_cpts[mine.start:mine.stop], device=device)

    t_start = 0
    found = _read_sweep(out_dir, n_nets, device) if resume else None
    if found is not None:
        members, t_start = found
        if verbose:
            print("  [resuming %s sweep at t=%i]" % (expt_name, t_start))
    else:
        members = [init_training(net, seed + i, device)
                   for i in range(n_nets)]
        for i in mine:
            if writer:
                _fresh_log(out_dir, i)
    trees = tuple(stack_trees([m[j] for m in members]) for j in range(3))
    del members
    if mesh is not None:
        multihost.replicate_to_global(mesh, trees, t_start,
                                      "every member's checkpoint")
        trees = tuple(shard_sweep_tree(t, mesh) for t in trees)

    def train_span(trees, t, n):
        return loop(*trees, t, seed + 1, x0_tr, y_tr, m_sym, n, k_arr)[:3]

    def evaluate(t, trees):
        return sweep_net_descs(net, dataset, trees[0], trees[1],
                               k_cpts[mine.start:mine.stop],
                               batch_size=batch_size,
                               tau=_tau_at(expt.tau, t - 1, net),
                               eval_split=eval_split,
                               eval_key=_eval_key(seed, t))

    def write(t, descs, trees):
        if not writer:
            return
        # One device-to-host copy of the stacked trees, then per-net views.
        host = tree_to_host(trees)
        for j, i in enumerate(mine):
            _write_epoch_outputs(out_dir, i, t, descs[j], nets[i],
                                 *(unstack_tree(h, j) for h in host),
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
                     timings=None, vmap_sweep=False, mesh=None,
                     profile_dir=None):
    """Train the nets of a registry experiment one after another (all, or
    `net_indices`) on `device`; with vmap_sweep, an experiment with
    `sweep_k_cpts` and no `net_indices` trains all its nets at once
    (`_train_sweep`). With a `timings` list, one dict per net (one for the
    whole sweep) is appended (see `train_one_net`). With a mesh, each net
    trains data-parallel over its 'data' axis (`train_one_net`), and the
    vmapped sweep needs a ('sweep', 'data') mesh (`_train_sweep`).
    profile_dir traces each net's loop (`train_one_net`); the vmapped
    sweep refuses it, as `mpnn_tpu` does."""
    expt = cfg.make_experiments()[expt_name]
    device = resolve_device(device)
    dataset = Dataset(os.path.join(data_root, expt.dataset), device=device)
    n_iter = n_iter or cfg.n_iter
    t_log = t_log or cfg.t_log
    batch_size = batch_size or cfg.batch_size
    out_dir = os.path.join(out_root, expt_name)
    indices = (net_indices if net_indices is not None
               else range(len(expt.nets)))
    if (vmap_sweep and getattr(expt, "sweep_k_cpts", None) is not None
            and net_indices is None):
        if profile_dir is not None:
            raise ValueError(
                "--vmap-sweep does not support profile_dir; run serially")
        _write_manifest(out_dir, dataset)
        if mesh is not None and "sweep" not in mesh.axis_names:
            raise ValueError(
                "--vmap-sweep needs a ('sweep', 'data') mesh "
                "(parallel.make_sweep_mesh), got axes %r"
                % (mesh.axis_names,))
        rec = {} if timings is not None else None
        _train_sweep(expt, expt_name, dataset, n_iter=n_iter, t_log=t_log,
                     batch_size=batch_size, out_dir=out_dir, seed=seed,
                     verbose=verbose, resume=resume, timings=rec, mesh=mesh)
        if timings is not None:
            timings.append(dict(rec, expt=expt_name, net_index=None))
        return
    _write_manifest(out_dir, dataset)
    for i in indices:
        net = expt.nets[i](dataset.x0_shape, dataset.y_shape)
        schedules = Schedules(lr=cfg.λ_lrn, tau=expt.tau)
        rec = {} if timings is not None else None
        train_one_net(
            net, dataset, schedules=schedules, tau_fn=expt.tau,
            n_iter=n_iter, t_log=t_log, batch_size=batch_size,
            out_dir=out_dir, net_index=i, seed=seed + i, verbose=verbose,
            resume=resume, timings=rec, mesh=mesh, profile_dir=profile_dir)
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
                         eval_split=eval_split, eval_key=_eval_key(seed, t))
                for k_cpt in cfg.k_cpts]

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


def _parse_mesh(parser, spec):
    """(D, M) of a --mesh 'DxM' (M defaults to 1), or None for 'auto'."""
    if spec == "auto":
        return None
    d, sep, m = spec.partition("x")
    if not sep or not d.isdigit() or not (m.isdigit() or not m):
        parser.error("--mesh expects 'auto' or 'DxM' (e.g. 2x1), got %r"
                     % (spec,))
    return int(d), int(m or 1)


def _make_mesh(dims, vmap_sweep):
    """The mesh of --mesh over the ranks of this run: ('sweep', 'data')
    with --vmap-sweep, else ('data', 'model'); dims None ('auto') puts
    every rank on the first axis."""
    if vmap_sweep:
        return (make_sweep_mesh() if dims is None
                else make_sweep_mesh(n_sweep=dims[0], n_data=dims[1]))
    return (make_mesh() if dims is None
            else make_mesh(n_data=dims[0], n_model=dims[1]))


def _rank_main(rank, argv, port, n_ranks):
    """A rank that --mesh started: join the others, then train."""
    args, parser = _parse(argv)
    if torch.device(args.device).type == "cpu":
        torch.set_num_threads(max(1, torch.get_num_threads() // n_ranks))
    multihost.initialize("127.0.0.1:%d" % port, n_ranks, rank,
                         device=args.device)
    try:
        _train(args, parser)
    finally:
        multihost.shutdown()


def _parse(argv):
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
    add_tf1_flags(parser)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu on request)")
    parser.add_argument("--profile-dir", default=None,
                        help="trace %d steps of the loop after %d warm-up "
                             "steps with torch.profiler and write the "
                             "Chrome trace to DIR/trace.json (serial "
                             "path only)" % (PROFILE_STEPS, PROFILE_WARMUP))
    parser.add_argument("--debug-nans", action="store_true",
                        help="check the loss, gradients, params, state and "
                             "velocity for NaN after every step and raise "
                             "FloatingPointError at the first, naming the "
                             "step (the counterpart of jax_debug_nans)")
    parser.add_argument("--mesh", default=None,
                        help="train over a mesh of ranks, one process "
                             "each: 'auto' (every rank on the data axis) "
                             "or 'DxM' (data x model; M must be 1, the "
                             "batch must divide by D). With --vmap-sweep "
                             "the axes are (sweep x data): 'auto' puts "
                             "every rank on 'sweep', 'SxD' e.g. 2x1; the "
                             "sweep's nets must divide by S. Without "
                             "--multihost, DxM starts the D x M ranks "
                             "here and 'auto' one per card")
    parser.add_argument("--multihost", action="store_true",
                        help="join the ranks a launcher started (torchrun's "
                             "RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, "
                             "MASTER_PORT) before building the mesh; only "
                             "rank 0 writes the files of a data-parallel "
                             "net. Combine with --mesh auto")
    args = parser.parse_args(argv)
    if args.expt not in names:
        parser.error("unknown experiment %r (choose from %s)"
                     % (args.expt, ", ".join(names)))
    return args, parser


def _train(args, parser):
    """Set the modes, build the mesh and train, in this process."""
    device = set_up_device(args.device, args.precision,
                           deterministic=True)
    if args.multihost or args.mesh:
        device = multihost.local_device(device)
    from .ops import config
    config.set_analytic_l2(args.analytic_l2)
    config.set_stacked_tails(args.stacked_tails)
    config.set_debug_nans(args.debug_nans)
    set_tf1_modes(args)
    mesh = None
    if args.mesh:
        mesh = _make_mesh(_parse_mesh(parser, args.mesh), args.vmap_sweep)
    train_experiment(
        args.expt, n_iter=args.n_iter, t_log=args.t_log,
        batch_size=args.batch_size, net_indices=args.net,
        data_root=args.data_root, out_root=args.out_root, seed=args.seed,
        resume=args.resume, device=device, vmap_sweep=args.vmap_sweep,
        mesh=mesh, profile_dir=args.profile_dir)
    rank, n_ranks = world()
    if n_ranks > 1:
        # Each rank's own count of the kernel's launches (a rank's
        # process counts only its own).
        from .ops.kernels import fused_mcm
        print(json.dumps({"rank": rank, "ranks": n_ranks,
                          "mesh": None if mesh is None else mesh.shape,
                          "device": str(device),
                          "fused_mcm_launches": fused_mcm.launches,
                          "fused_mcm_net_launches": fused_mcm.net_launches}),
              flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args, parser = _parse(argv)
    if args.multihost:
        rank, n = multihost.initialize(device=args.device)
        print("  [multihost: rank %i of %i]" % (rank, n), flush=True)
        try:
            _train(args, parser)
        finally:
            multihost.shutdown()
        return
    n_ranks = 1
    if args.mesh:
        dims = _parse_mesh(parser, args.mesh)
        if dims is not None:
            n_ranks = dims[0] * dims[1]
        elif resolve_device(args.device).type == "cuda":
            n_ranks = torch.cuda.device_count()
    if n_ranks == 1:
        _train(args, parser)
        return
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main,
                       args=(argv, multihost.free_port(), n_ranks),
                       nprocs=n_ranks, join=True, start_method="spawn")


if __name__ == "__main__":
    main()
