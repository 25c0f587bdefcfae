#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mpnn_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported as one JSON line {"phase", "ok", "elapsed_s", ...}:

1. device  -- needs torch.cuda; prints the nvidia-smi name/power-limit line.
2. build   -- builds the fused_mcm CUDA kernel with nvcc (ctypes-bound).
3. grad    -- one stage (stage 1: four scales, 16 channels) at batch 64 in
              fp32 through fused_mcm on the card: its outputs carry a
              grad_fn, and its gradients for xs, whs, wvs and bs match
              autograd through mcm_ref (max abs error <= 1e-4 * max|ref|).
4. kernel  -- for each of the flagship's eight MultiscaleConvMax stage
              shapes at the serving batch, holds the kernel against its
              plain version mcm_ref in fp32 (TF32 off; max abs error <=
              1e-4 * max|ref|) and bf16 (<= 2e-2 * max|ref|), and times the
              kernel, mcm_ref and the cuDNN conv sequence mcm_ref makes,
              per call from Python (`ms`) and on the device alone (CUDA
              graph replay, `device_ms`);
              four shapes off the flagship's path are checked too (widths
              12/6/3 at batch 7; output widths 12, 20 and 160; input
              channels 3, 4 and 24; printed as `kernel_off_path`), and
              stages 4-7 at batch 32 (the routed engine's deep buffers) are
              checked and timed in bf16. Each bf16 stage's error against
              mcm_ref run in fp32 on the same bf16-valued inputs is printed
              (not a gate). The fp32 kernel (3xTF32 on the tensor cores)
              is also held against mcm_ref in float64 on the same inputs
              at batch 128 and on the off-path shapes: max abs error <=
              1e-5 * max|ref| (F64_TOL), printed beside fp32 mcm_ref's own
              error against float64. Each line has the stages' summed
              device times and the kernel's ratios to cuDNN (`vs_cudnn`)
              and to its bound (`vs_bound`; fp32 at the 3xTF32 rate).
   kernel_nets -- the kernel's net axis (mcm_scale_forward_nets): the
              eight stages for the sweep's 8 nets at batch 128, fp32 and
              bf16, stage 0's input shared, through torch.func.vmap of
              fused_mcm (one launch per output scale for all nets),
              against mcm_ref on each net's slice at the kernel phase's
              tolerances; in fp32 every net's outputs must equal a
              single-net launch on its tensors bit for bit, and be within
              F64_TOL of mcm_ref in float64 on each net's slice. Times: the
              vmapped call (`ms`, `device_ms`), mcm_ref net after net
              (`plain_*`) and mcm_ref under the same vmap (`library_*`,
              cuDNN's grouped convs), beside the bound of 8 nets' work.
   kernel_tails -- the same for the tree's tail stages 3-7, every input
              batched, at 8 x batch 128 (the stacked tails of one tree)
              (fp32 and bf16) and 64 x batch 128 (8 trees x 8 tails of
              the sweep with stacked tails; fp32).
5. serve   -- reads the trained flagship checkpoint onto the GPU and runs
              routed inference (the port's main path) at capacity 1.0 and at
              calibrated capacities: first in fp32, kernel path against the
              same net through mcm_ref, then in bf16 (the main path) over
              5 timed windows of 20 batches per capacity, with img/s (median
              and spread of the windows) and mean realized ops per example.
              The kernel's launch count is set to 0 just before the bf16
              serving and read just after; it must have risen. Before it,
              bf16 dense serving through the kernel is compared with the
              mcm_ref path: the exits that differ, and how many of them
              have a deciding router margin below 1e-2, are printed (not a
              gate).
6. train   -- the training step of the flagship actor chain, built fresh
              from seed 0, at batch 128 (`make_train_step`: augmentation,
              forward, routing, actor loss, gradients, TALR, momentum):
              train_fp32_vs_plain takes one step from the same sampled and
              augmented batch through the kernel and through mcm_ref
              (patched in as serve() does) in fp32 and holds the loss (1e-5
              relative), the BatchNorm running statistics (1e-4 in
              ||kernel - plain|| / ||plain|| per leaf), the gradients and
              the parameters after the step (1e-3 in the same norm over
              the whole tree, 5e-2 per leaf: see TRAIN_TOL; the biases
              right before a train-mode BatchNorm, whose exact gradient is
              zero, must be below 1e-6 of the tree's norm on both paths)
              against each other, with exactly 20 kernel launches per
              forward (the stages' L sum to 20; the backward launches
              none); the same comparison for a float64 stage rounded to
              fp32 is printed as the yardstick of rounding alone.
              train_bf16_vs_fp32 takes one step four ways from the same
              params and batch (kernel and mcm_ref, bf16 and fp32): the
              kernel path's bf16 gradients may be at most 2x as far from
              its fp32 gradients, over the whole tree, as mcm_ref's bf16
              gradients are from mcm_ref's fp32 ones (every distance is
              printed). train_fp32 and train_bf16 then each take 3 timed
              windows of 20 steps (img/s, median and every window; the
              loss finite at each window's end); the kernel's count is set
              to 0 before each and must read 20 per step after it; then 5
              steps under torch.profiler give the device's time,
              operations and idle share per step. bf16 also prints the
              kernel path's first-step loss against the mcm_ref path's
              (not a gate).
              The kernel phase holds and times the eight stages at the
              training batch 128 too, fp32 and bf16.
7. sweep   -- the vmapped k_cpt sweep (make_sweep_train_loop) of 8
              flagship actor chains at batch 128 per net:
              sweep_fp32_vs_plain takes one fp32 sweep step through the
              net axis and through mcm_ref and holds it to
              train_fp32_vs_plain's gates over the stacked trees (the
              losses per member; the worst member's errors and a float64
              stage's are printed), with
              exactly 20 launches per sweep forward and none in the
              backward; sweep_train_fp32 and sweep_train_bf16 take 5 timed
              windows of 20 steps each (aggregate img/s of all nets,
              median and every window, beside the single-net rate of the
              train phase of the same run), the counts from 0 and 20
              net-axis launches a step; sweep_train_bf16 also holds one
              sweep step to train_bf16_vs_fp32's gate.
7b. trees  -- the 47-stage actor tree (`ac_tree(k_cpt=k_cpts[4])`, fresh
              from seed 0, batch 128): tree_train_fp32_vs_plain holds one
              fp32 step at train_fp32_vs_plain's gates with 96 launches
              per forward; tree_train_fp32 / tree_train_bf16 take 3
              windows of 5 steps (img/s beside the chain's of this run; 1
              profiled step); tree_sweep_train_fp32 holds one step of
              synth-ac-tree's 8 trees at the sweep gates (96 net-axis
              launches per sweep forward) and, with tree_sweep_train_bf16,
              times 3 windows of 2 steps (aggregate img/s).
7c. stacked tails -- ops.config.stacked_tails (`--stacked-tails`): the
              tree's eight congruent tails as one vmapped template, the
              trees packed as the loops carry them. tree_stacked_vs_serial
              holds one fp32 step of the fresh actor tree at batch 128
              against the serial step, both through the kernel, and
              against the stacked step through mcm_ref, at
              train_fp32_vs_plain's gates, with 33 launches per forward
              (24 of one net, 9 on the net axis); tree_stacked_train_fp32
              / _bf16 time it as tree_train_* does, beside the serial
              tree's img/s, operations and idle share of 7b;
              tree_sweep_stacked holds one step of the 8 trees (each
              tree's tails a vmap inside the sweep's: 33 net-axis
              launches per sweep forward, the tails 64 wide) at the sweep
              gates against mcm_ref, then times 3 windows of 2 steps
              beside the serial sweep of 7b.
7d. tree serving -- the trained adaptive tree
              (results/nets/hybrid-ac-tree-dynkcpt/net.npy.cz, its
              committed compact form: bfloat16 weights) serves the test
              split of hybrid.npz, rebuilt at full size (50,000 / 2,000) by
              the port's prep, at batch 1024 and each of the 8 k_cpts,
              dense and at capacities calibrated on the train split: fp32
              through the kernel against mcm_ref (probs within 1e-4, the
              same exits, ops and forced counts outside router near-ties
              on the example's path), then bf16 timed (5 windows of 2
              passes over the padded test split, dense and routed in
              turns; the kernel's count from 0), with the bf16 exits that
              differ from fp32's. tree_desc_vs_jax_files prints, per
              k_cpt, net_desc of that tree through the kernel (fp32, eval
              batch 1024) beside the descriptor files its training wrote
              (accuracy, moc, the largest difference of a scalar stat;
              not a gate), and, where the fp32 net.npy is in the
              checkout, net_desc of that beside both.
8. train_cli -- the training CLI's path (`train.train_experiment`, as
              `python -m mpnn_tpu_torch.train` runs it) in a temporary
              directory, fp32, batch 128, t_log 20, on the small synthetic
              archives of the port's prep: synth-ac net 4 for 40
              iterations, then resumed to 60; synth-sr net 7 (the 8-stage
              SR chain) and synth-cr net 4 for 20 each. The kernel's count
              starts from 0 before the first run; each run must launch it
              exactly per_forward x (steps + evaluations x eval batches),
              with per_forward summed over the net's MultiscaleConvMax
              layers. Checks: every file of the output contract exists;
              each final checkpoint, read back, equals the live params,
              state and momentum bit for bit, with t = n_iter; the resumed
              run starts at 40; the final synth-ac checkpoint's net_desc
              through the kernel agrees with it through mcm_ref within
              1e-4 * max(1, |stat|) on every scalar stat (the worst stat
              is printed). Then synth-ac --vmap-sweep to 40 and resumed to
              60 (all 8 nets at once, another output root), held the same
              way for every net, with 20 launches per sweep forward, and
              net 4's final descriptor from the sweep's vmapped
              evaluation through the kernel against net_desc of its
              checkpoint through mcm_ref. synth-ac-tree net 4 and
              synth-ac-tree --vmap-sweep run to 20 under the same checks
              (96 launches per forward). Prints each run's seconds and
              img/s over training alone and over training, evaluation and
              writes.
9. adaptive_cli -- `python -m mpnn_tpu_torch.train_adaptive` in processes
              of its own (ADAPTIVE_RUNS: synth-ac-tree-dynkcpt to 20 with
              t_log 10 and --stats-log, resumed to 30, and
              synth-cr-dynkcpt to 20; then the first run again with
              --stacked-tails into another output root): the files (the
              stacked run's file set the serial run's), net.npy read back
              bit for bit with its step, the resume's start, each
              process's launches and net-axis launches (its last line)
              against per_forward x (steps + evaluations x eval batches),
              and the tree's descriptor files, serial and stacked, against
              net_desc through mcm_ref (1e-4 x max(1, |stat|)).

Then one {"kernels": [...]} line, the kernel (bf16), its fp32 branch
(launches on the fp32 training main path) and its net axis (with the
training main paths' launches in `train_launches`, `sweep_launches` and
the CLI path's in `train_cli_launches`, `train_cli_sweep_launches`; the
tree paths' in `tree_launches` and `tree_sweep_launches`; the stacked
tails' in `tree_stacked_launches` and `tree_sweep_stacked_launches`, the
tail stages' times in `tail_stages`), and last the device record. Any failed
phase raises and the script exits non-zero; it also exits non-zero, with no
result, where CUDA is absent or the port's package is not beside it."""

import json
import os
import statistics
import sys
import time
from unittest import mock

import numpy as np
import torch

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))

TOL = {"fp32": 1e-4, "bf16": 2e-2}  # max abs error / max|ref|
# The fp32 kernel (3xTF32) against mcm_ref in float64 on the same inputs:
# fp32's own error is ~4e-7 of max|ref|, plain TF32's ~3e-4.
F64_TOL = 1e-5
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
CHECKPOINT = os.path.join(HERE, "results", "nets", "hybrid-ac", "0004.npy")
BATCH = 1024  # the serving batch, also the kernel check's batch
ROUTED_BATCH = 32  # rows of the routed engine's deep buffers
TRAIN_BATCH = 128  # the per-net training batch of bench.py
GRAD_BATCH = 64
N_TRAIN_STEPS = 20  # steps per timed training window
# One fp32 train step, kernel path against mcm_ref path. The loss and the
# BatchNorm statistics are continuous in the forward's rounding and are
# held per leaf. The gradients (and the parameters they move) are not: a
# few ReLU and 2x2 max-pool decisions flip between two fp32 forwards that
# round differently, and each flip moves deep-stage gradient leaves by up
# to ~1e-3. The phase prints the same comparison for a float64 stage
# rounded to fp32 (more exact, not wrong) as the yardstick. So gradients
# and parameters are held as a whole tree and, per leaf, to a bound that a
# wrong leaf exceeds; the count of leaves past 1e-4 is printed.
TRAIN_TOL = {"loss": 1e-5, "state": 1e-4, "tree": 1e-3, "leaf": 5e-2,
             "zero_grad": 1e-6}
DISCRETE_TOL = 1e-4
CLI_T_LOG = 20
# (experiment, net index, n_iter, resume) of the train_cli phase.
CLI_RUNS = [("synth-ac", 4, 40, False), ("synth-ac", 4, 60, True),
            ("synth-sr", 7, 20, False), ("synth-cr", 4, 20, False),
            ("synth-ac-tree", 4, 20, False)]
DESC_TOL = 1e-4  # kernel vs mcm_ref net_desc, per scalar stat
N_SERVE = 20  # batches per timed serving window
N_WINDOWS = 5  # timed serving windows per capacity
N_TRAIN_WINDOWS = 3  # timed windows of N_TRAIN_STEPS single-net steps
N_NETS = 8  # nets of the flagship sweep (experiments.k_cpts)
N_SWEEP_WINDOWS = 5  # timed windows of N_TRAIN_STEPS sweep steps
# (experiment, n_iter, resume) of the train_cli phase's --vmap-sweep runs,
# and the synth-ac member whose final descriptor is held against mcm_ref.
SWEEP_CLI_RUNS = [("synth-ac", 40, False), ("synth-ac", 60, True),
                  ("synth-ac-tree", 20, False)]
SWEEP_DESC_NET = 4
MARGIN_TIE = 1e-3  # router top-2 logit margin below which exits may differ
MARGIN_BF16 = 1e-2  # the margin reported for bf16 kernel vs plain exits
# fused_mcm launches per forward of the flagship chain (the eight stages'
# scales) and of the 47-stage tree (fans 1x4 + 2x4 + 4x3, 8 tails x 9).
PER_FORWARD = {"chain": 20, "tree": 96}
# The same under ops.config.stacked_tails: (launches, of which net-axis)
# per forward of one net. The tree's eight tails are one group whose five
# stages (L = 3, 2, 2, 1, 1) take 9 net-axis launches beside the fans' 24
# (a chain's groups are leaves only: its 20 stay 20). Under the sweep every
# launch is on the net axis (8 nets x 8 tails = 64 for the tails).
STACKED_PER_FORWARD = {"tree": (33, 9)}
# Tail stages of the tree (experiments.arch[3:]) on the net axis, in the
# widths and types the stacked paths run them: 8 tails of one tree (fp32
# and bf16 training), 8 trees x 8 tails of the sweep (fp32).
TAIL_FIRST_STAGE = 3
TAIL_NETS = {8: ("fp32", "bf16"), 64: ("fp32",)}
# Timed windows x steps of the training phases, per architecture: the tree's
# host-bound step is ~5x the chain's.
TRAIN_WINDOWS = {"chain": (N_TRAIN_WINDOWS, N_TRAIN_STEPS), "tree": (3, 5)}
SWEEP_WINDOWS = {"chain": (N_SWEEP_WINDOWS, N_TRAIN_STEPS), "tree": (3, 2)}
# Steps traced by torch.profiler after the windows: reading a trace back
# takes ~0.1 ms an event, and a tree step has ~10,000-28,000 device
# operations (stacked, serial, the sweep), so the seven tree phases that
# profile trace one step each.
PROFILE_STEPS = {"chain": 5, "tree": 1}
# bf16 training against fp32 (one step, gradients over the whole tree):
# the kernel path's distance may be at most this multiple of mcm_ref's.
BF16_VS_FP32_FACTOR = 2.0


def phase(name, ok=True, **fields):
    print(json.dumps({"phase": name, "ok": ok,
                      "elapsed_s": round(time.perf_counter() - T0, 3),
                      **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def rel_err(outs, refs):
    """max |out - ref| over max |ref|, over lists of tensors."""
    err = max(float((o.float() - r.float()).abs().max())
              for o, r in zip(outs, refs))
    return err / max(float(r.float().abs().max()) for r in refs)


def f64_errs(out, xs, whs, wvs, bs):
    """(max abs error, max|ref|) of the fp32 outputs `out` and of fp32
    mcm_ref on the same inputs, against mcm_ref in float64: ((err, plain
    err), scale). Call with the fp32 compute policy."""
    from mpnn_tpu_torch.ops.kernels import mcm_ref
    ref = mcm_ref([x.double() for x in xs], [w.double() for w in whs],
                  [w.double() for w in wvs], [b.double() for b in bs])
    plain = mcm_ref(xs, whs, wvs, bs)

    def err(outs):
        return max(float((o.double() - r).abs().max())
                   for o, r in zip(outs, ref))
    return (err(out), err(plain)), max(float(r.abs().max()) for r in ref)


def check_f64(label, out, xs, whs, wvs, bs):
    """The fp32 kernel's outputs within F64_TOL of float64 mcm_ref; returns
    the kernel's and fp32 mcm_ref's errors over max|ref|."""
    (err, plain), scale = f64_errs(out, xs, whs, wvs, bs)
    check(err <= F64_TOL * scale, "%s fp32: max abs err %g against float64 "
          "> %g * max|ref| %g" % (label, err, F64_TOL, scale))
    return {"rel_err_vs_f64": err / scale,
            "plain_rel_err_vs_f64": plain / scale}


def grad_phase(device):
    """fused_mcm's gradient on the card against autograd through mcm_ref,
    fp32, one four-scale stage."""
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.kernel_bench import stage_inputs
    from mpnn_tpu_torch.ops.kernels import fused_mcm, mcm_ref

    xs, whs, wvs, bs, _ = stage_inputs(arch, GRAD_BATCH, 32, seed=3,
                                       device=device)[1]
    leaves = [t.requires_grad_() for t in xs + whs + wvs + bs]
    n0 = fused_mcm.launches
    out = fused_mcm(xs, whs, wvs, bs, 3)
    check(fused_mcm.launches - n0 == len(whs),
          "grad: the kernel did not take the forward")
    check(all(o.grad_fn is not None for o in out),
          "grad: fused_mcm's outputs carry no grad_fn")
    rng = np.random.RandomState(4)
    cot = [torch.as_tensor(rng.standard_normal(tuple(o.shape))
                           .astype(np.float32), device=device) for o in out]
    grads = torch.autograd.grad(out, leaves, cot)
    ref = torch.autograd.grad(mcm_ref(xs, whs, wvs, bs), leaves, cot)
    errs = [rel_err([g], [r]) for g, r in zip(grads, ref)]
    check(max(errs) <= TOL["fp32"], "grad: max relative error %g > %g"
          % (max(errs), TOL["fp32"]))
    return {"stage": 1, "batch": GRAD_BATCH, "n_grads": len(leaves),
            "max_rel_err": max(errs)}


def kernel_phase(device):
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.kernel_bench import (bound, stage_cost, stage_inputs,
                                             stage_times)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm, mcm_ref

    def compare(label, xin, whs, wvs, bs, dt):
        out = fused_mcm(xin, whs, wvs, bs, 3)
        ref = mcm_ref(xin, whs, wvs, bs)
        torch.cuda.synchronize()
        err = max(float((o.float() - r.float()).abs().max())
                  for o, r in zip(out, ref))
        scale = max(float(r.float().abs().max()) for r in ref)
        check(all(o.dtype == DTYPES[dt] and o.shape == r.shape
                  for o, r in zip(out, ref)),
              "%s %s: output dtype/shape differs" % (label, dt))
        check(err <= TOL[dt] * scale, "%s %s: max abs err %g > %g * "
              "max|ref| %g" % (label, dt, err, TOL[dt], scale))
        return out, err, scale

    def fp32_ref_err(out, xin, whs, wvs, bs):
        """The bf16 kernel against mcm_ref in fp32 on the same bf16-valued
        inputs and weights: the error of bf16 serving itself."""
        config.set_compute_dtype(None)
        try:
            ref = mcm_ref([x.float() for x in xin],
                          [w.to(torch.bfloat16).float() for w in whs],
                          [w.to(torch.bfloat16).float() for w in wvs], bs)
        finally:
            config.set_compute_dtype(torch.bfloat16)
        return rel_err(out, ref)

    # Shapes off the flagship's path, checked only: small ragged widths
    # (6, 3) with an odd batch, so blocks run past the last pixel; output
    # widths that are not a multiple of the kernels' 8-wide mma tiles (12,
    # 20) or wider than one 128-channel block (160); input channel counts
    # read one value at a time (3) or as 16-byte vectors (4, 8, 24).
    odd = [("ragged 12/6/3 stage", [[8, 8, 8]], 7, 12, 8),
           ("c_out 12, c_in 4", [[12, 12]], 5, 8, 4),
           ("c_out 160, c_in 24", [[160, 160]], 3, 8, 24),
           ("c_out 20, c_in 3, 6/3", [[20, 20]], 9, 6, 3)]
    odd = [(label, stage_inputs(a, b, hw, seed=2 + i, device=device,
                                c_in=c)[0])
           for i, (label, a, b, hw, c) in enumerate(odd)]
    stages = list(enumerate(stage_inputs(arch, BATCH, 32, seed=1,
                                         device=device)))
    train = list(enumerate(stage_inputs(arch, TRAIN_BATCH, 32, seed=1,
                                        device=device)))
    deep = list(enumerate(stage_inputs(arch, ROUTED_BATCH, 32, seed=1,
                                       device=device)))[4:]
    runs = ([(dt, BATCH, i, st) for dt in DTYPES for i, st in stages]
            + [(dt, TRAIN_BATCH, i, st) for dt in DTYPES for i, st in train]
            + [("bf16", ROUTED_BATCH, i, st) for i, st in deep])
    rows, off_path = [], []
    for dt, torch_dt in DTYPES.items():
        config.set_compute_dtype(torch_dt)
        try:
            for label, (xs, whs, wvs, bs, _) in odd:
                xin = [x.to(torch_dt) for x in xs]
                out, err, scale = compare(label, xin, whs, wvs, bs, dt)
                rec = {"shape": label, "dtype": dt,
                       "max_abs_err": err, "max_abs_ref": scale}
                if dt == "fp32":
                    rec.update(check_f64(label, out, xin, whs, wvs, bs))
                off_path.append(rec)
            for _, B, i, (xs, whs, wvs, bs, n_ops) in [
                    r for r in runs if r[0] == dt]:
                xin = [x.to(torch_dt) for x in xs]
                out, err, scale = compare("stage %d batch %d" % (i, B), xin,
                                          whs, wvs, bs, dt)
                n_bytes, flops = stage_cost(xin, whs, wvs, bs, n_ops, B, dt)
                row = {"stage": i, "dtype": dt, "batch": B,
                       "shape": [list(x.shape[1:]) for x in xs],
                       "c_out": [int(w.shape[-1]) for w in whs],
                       "max_abs_err": err, "max_abs_ref": scale,
                       "bytes": n_bytes, "flops": flops}
                if dt == "bf16":
                    row["rel_err_vs_fp32_ref"] = fp32_ref_err(out, xin, whs,
                                                              wvs, bs)
                elif B != BATCH:  # float64 kept off batch 1024
                    row.update(check_f64("stage %d batch %d" % (i, B), out,
                                         xin, whs, wvs, bs))
                # Timed on weights already in the compute dtype, so the
                # times hold compute only (the casts are then no-ops).
                row.update(stage_times(xin, whs, wvs, bs))
                row["bound_ms"], row["bound_by"] = bound(n_bytes, flops, dt)
                row["vs_cudnn"] = (row["device_ms"]
                                   / row["cudnn_conv_sequence_device_ms"])
                row["vs_bound"] = row["device_ms"] / row["bound_ms"]
                rows.append(row)
        finally:
            config.set_compute_dtype(None)
    for dt, B in (("fp32", BATCH), ("bf16", BATCH), ("fp32", TRAIN_BATCH),
                  ("bf16", TRAIN_BATCH), ("bf16", ROUTED_BATCH)):
        sel = [r for r in rows if r["dtype"] == dt and r["batch"] == B]
        phase("kernel", dtype=dt, batch=B, totals=stage_totals(sel), stages=[
            {k: r[k] for k in ("stage", "shape", "c_out", "max_abs_err",
                               "rel_err_vs_fp32_ref", "rel_err_vs_f64",
                               "plain_rel_err_vs_f64", "ms", "plain_ms",
                               "cudnn_conv_sequence_ms", "device_ms",
                               "plain_device_ms",
                               "cudnn_conv_sequence_device_ms", "bound_ms",
                               "bound_by", "vs_cudnn", "vs_bound") if k in r}
            for r in sel])
    phase("kernel_off_path", shapes=off_path)
    return rows


def stage_totals(rows, library="cudnn_conv_sequence_"):
    """The stages' summed device times (kernel, mcm_ref, the library call),
    their bound, and the kernel's ratios to the library and the bound."""
    from mpnn_tpu_torch.kernel_bench import bound
    dt = rows[0]["dtype"]
    t = {k: sum(r[k] for r in rows)
         for k in ("device_ms", "plain_device_ms", library + "device_ms")}
    t["bound_ms"], t["bound_by"] = bound(sum(r["bytes"] for r in rows),
                                         sum(r["flops"] for r in rows), dt)
    t["vs_library"] = t["device_ms"] / t[library + "device_ms"]
    t["vs_bound"] = t["device_ms"] / t["bound_ms"]
    return t


def kernel_nets_phase(device):
    """fused_mcm's net axis: the flagship's eight stages for N_NETS nets at
    the training batch, fp32 and bf16, stage 0's input shared, through
    torch.func.vmap of fused_mcm (one launch per output scale for every
    net), against mcm_ref on each net's slice; in fp32 each net's outputs
    must equal a single-net launch on its tensors bit for bit."""
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.kernel_bench import sweep_stage_inputs
    stages = sweep_stage_inputs(arch, N_NETS, TRAIN_BATCH, 32, seed=1,
                                device=device)
    rows = net_axis_rows("kernel_nets", stages, N_NETS, DTYPES)
    for dt in DTYPES:
        sel = [r for r in rows if r["dtype"] == dt]
        phase("kernel_nets", dtype=dt, nets=N_NETS, batch=TRAIN_BATCH,
              totals=stage_totals(sel, "library_"),
              stages=[{k: v for k, v in r.items()
                       if k not in ("dtype", "nets", "batch", "bytes",
                                    "flops", "max_abs_ref")}
                      for r in sel])
    return rows


def kernel_tails_phase(device):
    """The tree's tail stages (experiments.arch[3:]) on the net axis, every
    input batched, at the training batch: 8 tails of one tree (the
    stacked tails' launches; fp32 and bf16) and 64 (8 trees x 8 tails,
    the sweep with stacked tails; fp32), held and timed as kernel_nets
    holds and times the flagship stages."""
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.kernel_bench import sweep_stage_inputs
    rows = []
    for n, dtypes in TAIL_NETS.items():
        stages = sweep_stage_inputs(arch, n, TRAIN_BATCH, 32, seed=1,
                                    device=device, first=TAIL_FIRST_STAGE)
        rows += net_axis_rows("kernel_tails", stages, n, dtypes,
                              TAIL_FIRST_STAGE)
        del stages
    for n, dtypes in TAIL_NETS.items():
        for dt in dtypes:
            sel = [r for r in rows if r["dtype"] == dt and r["nets"] == n]
            phase("kernel_tails", dtype=dt, nets=n, batch=TRAIN_BATCH,
                  totals=stage_totals(sel, "library_"),
                  stages=[{k: v for k, v in r.items()
                           if k not in ("dtype", "nets", "batch", "bytes",
                                        "flops", "max_abs_ref")}
                          for r in sel])
    return rows


def tail_summary(rows, n_nets, dt):
    """kernel_tails' stages of one width and dtype, summed: call and
    device times of the kernel, mcm_ref net after net and mcm_ref under
    vmap (grouped cuDNN), the bound, the largest error."""
    sel = [r for r in rows if r["nets"] == n_nets and r["dtype"] == dt]
    return dict(nets=n_nets, dtype=dt, batch=TRAIN_BATCH,
                stages=[r["stage"] for r in sel],
                max_abs_err=max(r["max_abs_err"] for r in sel),
                **{k: sum(r[k] for r in sel)
                   for k in ("ms", "plain_ms", "library_ms")},
                **stage_totals(sel, "library_"))


def net_axis_rows(label, stages, n_nets, dtypes, first=0):
    """Per dtype and stage of `stages` (kernel_bench.sweep_stage_inputs,
    the first one stage `first`): the stage for n_nets nets through
    torch.func.vmap of fused_mcm, one net-axis launch per output scale,
    held against mcm_ref on each net's slice at the kernel phase's
    tolerances (in fp32 also against float64, and bit for bit against a
    single-net launch per net), timed (kernel_bench.stage_times of
    sweep_stage_fns) beside the bound of the n_nets nets' work."""
    from mpnn_tpu_torch.kernel_bench import (bound, stage_cost, stage_times,
                                             sweep_stage_fns)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm, mcm_ref
    rows = []
    for dt in dtypes:
        torch_dt = DTYPES[dt]
        config.set_compute_dtype(torch_dt)
        try:
            for i, (xs, whs, wvs, bs, n_ops) in enumerate(stages, first):
                xin = [x.to(torch_dt) for x in xs]
                shared = xin[0].dim() == 4
                n0, m0 = fused_mcm.launches, fused_mcm.net_launches
                out = sweep_stage_fns(xin, whs, wvs, bs)[""]()
                torch.cuda.synchronize()
                check(fused_mcm.launches - n0 == fused_mcm.net_launches - m0
                      == len(whs), "%s stage %d %s x%d: %d launches, "
                      "expected one net-axis launch per scale (%d)"
                      % (label, i, dt, n_nets, fused_mcm.launches - n0,
                         len(whs)))
                err = scale = single_err = 0.0
                err64 = plain64 = scale64 = 0.0
                bit_equal = True
                for n in range(n_nets):
                    xi = xin if shared else [x[n] for x in xin]
                    args = (xi, [w[n] for w in whs], [w[n] for w in wvs],
                            [b[n] for b in bs])
                    ref = mcm_ref(*args)
                    check(all(o.dtype == DTYPES[dt] and o[n].shape == r.shape
                              for o, r in zip(out, ref)),
                          "%s stage %d %s: output dtype/shape differs"
                          % (label, i, dt))
                    err = max([err] + [float((o[n].float() - r.float())
                                             .abs().max())
                                       for o, r in zip(out, ref)])
                    scale = max([scale] + [float(r.float().abs().max())
                                           for r in ref])
                    single = fused_mcm(*args, 3)
                    bit_equal &= all(torch.equal(o[n], s_)
                                     for o, s_ in zip(out, single))
                    single_err = max([single_err] + [
                        float((s_.float() - r.float()).abs().max())
                        for s_, r in zip(single, ref)])
                    if dt == "fp32":
                        (e64, p64), s64 = f64_errs([o[n] for o in out],
                                                   *args)
                        err64, plain64 = max(err64, e64), max(plain64, p64)
                        scale64 = max(scale64, s64)
                check(err <= TOL[dt] * scale, "%s stage %d %s x%d: max abs "
                      "err %g > %g * max|ref| %g"
                      % (label, i, dt, n_nets, err, TOL[dt], scale))
                check(bit_equal or dt != "fp32", "%s stage %d fp32 x%d: a "
                      "net's outputs differ from its single-net launch"
                      % (label, i, n_nets))
                check(err64 <= F64_TOL * scale64, "%s stage %d fp32 x%d: "
                      "max abs err %g against float64 > %g * max|ref| %g"
                      % (label, i, n_nets, err64, F64_TOL, scale64))
                n_bytes, flops = stage_cost(xin, whs, wvs, bs, n_ops,
                                            TRAIN_BATCH, dt, n_nets)
                row = {"stage": i, "dtype": dt, "nets": n_nets,
                       "batch": TRAIN_BATCH, "input_shared": shared,
                       "c_out": [int(w.shape[-1]) for w in whs],
                       "max_abs_err": err, "max_abs_ref": scale,
                       "single_net_max_abs_err": single_err,
                       "bit_equal_to_single_net": bit_equal,
                       "bytes": n_bytes, "flops": flops}
                if dt == "fp32":
                    row["rel_err_vs_f64"] = err64 / scale64
                    row["plain_rel_err_vs_f64"] = plain64 / scale64
                row.update(stage_times(xin, whs, wvs, bs, sweep_stage_fns))
                row["bound_ms"], row["bound_by"] = bound(n_bytes, flops, dt)
                row["vs_library"] = row["device_ms"] / row["library_device_ms"]
                row["vs_bound"] = row["device_ms"] / row["bound_ms"]
                rows.append(row)
        finally:
            config.set_compute_dtype(None)
    return rows


def serve(net, params, state, x0, cap, reference=False, k_cpt=None):
    from mpnn_tpu_torch.models.infer import make_routed_infer_fn
    from mpnn_tpu_torch.ops import kernels
    infer = make_routed_infer_fn(net, x0.shape[0], capacities=cap)
    if not reference:
        out = infer(params, state, x0, k_cpt)
    else:
        with mock.patch.object(kernels, "fused_mcm", _plain_stage):
            out = infer(params, state, x0, k_cpt)
    return {k: v.cpu().numpy() for k, v in out.items()}


def tree_paths(net):
    """For each leaf (preorder), the preorder indices of the switches on
    its path from the root."""
    pos = {id(sw): i for i, sw in enumerate(net.switches)}
    paths = []

    def walk(node, path):
        if not node.sinks:
            paths.append(path)
            return
        if len(node.sinks) > 1:
            path = path + [pos[id(node)]]
        for snk in node.sinks:
            walk(snk, path)

    walk(net.root, [])
    return paths


def router_margins(net, params, state, xs, k_cpt):
    """Top-2 router logit margin at every switch, per example, from a dense
    eval pass over the batches xs at price k_cpt: (rows, n_switches)."""
    from mpnn_tpu_torch.models.net import Ctx
    out = []
    for x0 in xs:
        ctx = Ctx(train=False, k_cpt=torch.tensor(k_cpt, device=x0.device))
        with torch.inference_mode():
            recs, _ = net.forward(params, state, x0, None, ctx)
            top2 = [torch.topk(recs[sw].router_x, 2, dim=1).values
                    for sw in net.switches]
            out.append(torch.stack([m[:, 0] - m[:, 1] for m in top2], 1)
                       .cpu().numpy())
    return np.concatenate(out)


def serve_split(net, params, state, xs, cap, k_cpt, reference=False):
    """Routed inference over the batches `xs`, outputs concatenated (the
    forced counts summed)."""
    outs = [serve(net, params, state, x, cap, reference, k_cpt) for x in xs]
    cat = {k: np.concatenate([o[k] for o in outs])
           for k in ("probs", "exit_idx", "ops")}
    cat["forced"] = sum(o["forced"] for o in outs)
    return cat


def compare_fp32(label, net, params, state, xs, n, cap, k_cpt, margins):
    """The kernel path against the mcm_ref path, both on the GPU in fp32,
    over the first n rows of the batches xs: probs within 1e-4 where the
    exits agree, and the same exits, ops and forced counts outside router
    near-ties (a top-2 margin below MARGIN_TIE at any switch on the
    example's path)."""
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    launches0 = fused_mcm.launches
    k = serve_split(net, params, state, xs, cap, k_cpt)
    check(fused_mcm.launches > launches0,
          "%s: kernel path did not launch" % label)
    r = serve_split(net, params, state, xs, cap, k_cpt, reference=True)
    paths = tree_paths(net)
    near_tie = np.array([(margins[e, paths[r["exit_idx"][e]]]
                          < MARGIN_TIE).any() for e in range(n)])
    same_exit = k["exit_idx"][:n] == r["exit_idx"][:n]
    prob_err = float(np.abs(k["probs"][:n] - r["probs"][:n])[same_exit]
                     .max())
    mismatch = ~(same_exit & (k["ops"][:n] == r["ops"][:n]))
    check(not (mismatch & ~near_tie).any(),
          "%s: exit_idx/ops differ on %d examples with router margin >= %g"
          % (label, int((mismatch & ~near_tie).sum()), MARGIN_TIE))
    check(prob_err <= 1e-4, "%s: probs differ by %g > 1e-4"
          % (label, prob_err))
    forced_diff = int(np.abs(k["forced"] - r["forced"]).sum())
    check(forced_diff <= int(near_tie.sum()),
          "%s: forced differs by %d" % (label, forced_diff))
    return k, {"capacity": cap, "max_prob_err": prob_err,
               "near_tie_examples": int(near_tie.sum()),
               "exit_mismatches": int(mismatch.sum()),
               "forced": k["forced"].tolist(),
               "forced_ref": r["forced"].tolist(),
               "mean_ops": float(k["ops"][:n].mean()),
               "exit_hist": np.bincount(k["exit_idx"][:n], minlength=len(
                   list(net.leaves))).tolist()}


def serve_phase(device):
    from mpnn_tpu_torch.data import synth
    from mpnn_tpu_torch.models.infer import (calibrate_capacities,
                                             make_routed_infer_fn)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    from mpnn_tpu_torch.utils.serdes import read_net

    B = BATCH
    net, params, state, _ = read_net(CHECKPOINT, device)
    h, w, c = net.hypers.x0_shape
    data = synth.make_synthetic(n_tr=B, n_ts=B, h=h, w=w, c=c,
                                n_cls=int(net.hypers.y_shape[0]), seed=0)
    x0 = torch.as_tensor(data["x0_ts"], device=device)
    x_cal = torch.as_tensor(data["x0_tr"], device=device)

    config.set_compute_dtype(None)
    caps = calibrate_capacities(net, params, state, x_cal)
    k_cpt = net.hypers.k_cpt
    margins = router_margins(net, params, state, [x0], k_cpt)
    fp32 = [compare_fp32("fp32 capacity %s" % cap, net, params, state, [x0],
                         B, cap, k_cpt, margins)[1]
            for cap in (1.0, caps)]
    phase("serve_fp32_vs_plain", checkpoint=os.path.relpath(CHECKPOINT, HERE),
          batch=B, calibrated_capacities=caps, results=fp32)

    config.set_compute_dtype(torch.bfloat16)
    try:
        drift = bf16_drift(net, params, state, x0)
        caps_bf16 = calibrate_capacities(net, params, state, x_cal)
        modes = [(mode, cap, make_routed_infer_fn(net, B, capacities=cap))
                 for mode, cap in (("dense", 1.0), ("routed", caps_bf16))]
        records = []
        # The main path: the kernel's count starts from 0 here and is read
        # just after the last served batch.
        fused_mcm.launches = 0
        for mode, cap, infer in modes:
            n0 = fused_mcm.launches
            out = infer(params, state, x0)  # warm-up
            torch.cuda.synchronize()
            per_batch = fused_mcm.launches - n0
            rates = []
            for _ in range(N_WINDOWS):
                t = time.perf_counter()
                for _ in range(N_SERVE):
                    out = infer(params, state, x0)
                torch.cuda.synchronize()
                rates.append(N_SERVE * B / (time.perf_counter() - t))
            check(fused_mcm.launches - n0
                  == per_batch * (1 + N_WINDOWS * N_SERVE),
                  "bf16 %s: kernel launches per batch vary" % mode)
            probs = out["probs"].float().cpu().numpy()
            ops = out["ops"].cpu().numpy()
            exit_idx = out["exit_idx"].cpu().numpy()
            check(probs.shape == (B, net.hypers.y_shape[0])
                  and np.isfinite(probs).all()
                  and np.allclose(probs.sum(axis=1), 1.0, atol=1e-3),
                  "bf16 %s: probs are not finite distributions" % mode)
            check(((exit_idx >= 0) & (exit_idx < len(list(net.leaves)))).all()
                  and (ops > 0).all(), "bf16 %s: bad exits/ops" % mode)
            forced = out["forced"].cpu().numpy()
            records.append({
                "metric": "routed-inference (%s, capacity=%s)" % (
                    mode, "calibrated" if isinstance(cap, list) else cap),
                "value": statistics.median(rates),
                "unit": "images/sec/chip",
                "window_values": rates,
                "window_batches": N_SERVE,
                "mean_ops_per_example": float(ops.mean()),
                "forced_exits": int(forced.sum()),
                "forced_per_switch": forced.tolist(),
                "kernel_launches_per_batch": per_batch,
            })
        launches = fused_mcm.launches
    finally:
        config.set_compute_dtype(None)
    return caps_bf16, records, launches, drift


def bf16_drift(net, params, state, x0):
    """bf16 dense serving through the kernel against the same through
    mcm_ref: the exits that differ, and how many of those have a deciding
    router (any switch up to the first where the two paths part) whose
    top-2 margin on the kernel path is below MARGIN_BF16. Printed, not a
    gate: the two paths round at different places."""
    margins = router_margins(net, params, state, [x0], net.hypers.k_cpt)
    k = serve(net, params, state, x0, 1.0)
    r = serve(net, params, state, x0, 1.0, reference=True)
    paths = tree_paths(net)
    # The switches both paths visit: up to the one where they part.
    near_tie = np.array([
        (margins[e, sorted(set(paths[a]) & set(paths[b]))] < MARGIN_BF16)
        .any() for e, (a, b) in enumerate(zip(k["exit_idx"],
                                              r["exit_idx"]))])
    differ = k["exit_idx"] != r["exit_idx"]
    same = ~differ
    return {"capacity": 1.0, "examples": int(len(differ)),
            "exit_mismatches": int(differ.sum()),
            "exit_mismatches_margin_below": MARGIN_BF16,
            "exit_mismatches_near_tie": int((differ & near_tie).sum()),
            "near_tie_examples": int(near_tie.sum()),
            "max_prob_err_same_exit": float(np.abs(
                k["probs"].astype(np.float32)
                - r["probs"].astype(np.float32))[same].max())
            if same.any() else None}


TREE_DIR = os.path.join(HERE, "results", "nets", "hybrid-ac-tree-dynkcpt")
# The trained adaptive tree in its committed compact form (bfloat16
# weights, 16 MB). The 40 MB fp32 net.npy beside it is listed in
# .gitignore, to keep a checkout small, so a checkout that leaves out
# ignored files lacks it; where it is present, tree_desc_phase also
# evaluates it, to measure what the rounding of the weights changes.
TREE_CHECKPOINT = os.path.join(TREE_DIR, "net.npy.cz")
TREE_FP32 = os.path.join(TREE_DIR, "net.npy")
N_TREE_PASSES = 2  # passes over the test split per timed serving window
N_TREE_WINDOWS = 5  # timed serving windows per capacity and k_cpt
EVAL_BATCH = 1024  # the batch of the trained tree's full-split evaluation


def tree_serve_phase(device):
    """Routed serving of the trained 47-stage adaptive tree on the test
    split of the rebuilt hybrid.npz, at every k_cpt, dense and at
    capacities calibrated on the train split: fp32 through the kernel
    against mcm_ref (compare_fp32), then bf16 (the main path, the
    kernel's count from 0) timed, with its exits against fp32's."""
    from mpnn_tpu_torch.data.prep import synthetic_archive
    from mpnn_tpu_torch.experiments import k_cpts
    from mpnn_tpu_torch.models.infer import (calibrate_capacities,
                                             make_routed_infer_fn)
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    from mpnn_tpu_torch.utils.serdes import read_net

    t = time.perf_counter()
    net, params, state, extra = read_net(TREE_CHECKPOINT, device)
    read_s = time.perf_counter() - t
    t = time.perf_counter()
    data = synthetic_archive("hybrid.npz")
    prep_s = time.perf_counter() - t
    check(len(list(net.layers)) == 95 and len(list(net.switches)) == 39,
          "tree_serve: the checkpoint is not the 47-stage tree")
    B, n = BATCH, len(data["x0_ts"])
    n_pad = -(-n // B) * B
    x_ts = np.resize(data["x0_ts"], (n_pad,) + data["x0_ts"].shape[1:])
    xs = [torch.as_tensor(x_ts[i:i + B], device=device)
          for i in range(0, n_pad, B)]
    x_cal = torch.as_tensor(data["x0_tr"][:B], device=device)
    y_ts = np.argmax(data["y_ts"], axis=1)
    config.set_compute_dtype(None)
    per_k, fp32_out = [], {}
    for k_cpt in k_cpts:
        margins = router_margins(net, params, state, xs, k_cpt)
        caps = calibrate_capacities(net, params, state, x_cal, k_cpt=k_cpt)
        rec = {"k_cpt": k_cpt, "calibrated_capacities": caps}
        for mode, cap in (("dense", 1.0), ("routed", caps)):
            out, rec[mode] = compare_fp32(
                "tree_serve k_cpt %g %s" % (k_cpt, mode), net, params, state,
                xs, n, cap, k_cpt, margins)
            rec[mode]["accuracy"] = float(np.mean(
                np.argmax(out["probs"][:n], axis=1) == y_ts))
            fp32_out[k_cpt, mode] = out["exit_idx"][:n]
        per_k.append(rec)

    config.set_compute_dtype(torch.bfloat16)
    try:
        # The main path: the kernel's count starts from 0 here and is read
        # just after the last served batch.
        fused_mcm.launches = 0
        for rec in per_k:
            k_cpt, infers = rec["k_cpt"], {}
            for mode, cap in (("dense", 1.0),
                              ("routed", rec["calibrated_capacities"])):
                infer = make_routed_infer_fn(net, B, capacities=cap)
                outs = [infer(params, state, x, k_cpt) for x in xs]
                exits = torch.cat([o["exit_idx"] for o in outs])[:n]
                ops = torch.cat([o["ops"] for o in outs])[:n].cpu().numpy()
                probs = torch.cat([o["probs"] for o in outs])[:n].float()
                check(bool(torch.isfinite(probs).all()) and (ops > 0).all(),
                      "tree_serve bf16 k_cpt %g %s: bad probs or ops"
                      % (k_cpt, mode))
                n0 = fused_mcm.launches
                infer(params, state, xs[0], k_cpt)
                torch.cuda.synchronize()
                per_batch = fused_mcm.launches - n0
                infers[mode] = infer
                rec[mode]["bf16"] = {
                    "mean_ops": float(ops.mean()),
                    "forced": int(sum(o["forced"].sum() for o in outs)),
                    "exit_mismatches_vs_fp32": int(
                        (exits.cpu().numpy() != fp32_out[k_cpt, mode])
                        .sum()),
                    "launches_per_batch": per_batch,
                    "accuracy": float(np.mean(
                        probs.argmax(1).cpu().numpy() == y_ts))}
            # Timed windows of whole passes over the (padded) test split,
            # dense and routed in turns, so both modes meet the same host.
            rates = {mode: [] for mode in infers}
            for _ in range(N_TREE_WINDOWS):
                for mode, infer in infers.items():
                    t = time.perf_counter()
                    for _ in range(N_TREE_PASSES):
                        for x in xs:
                            infer(params, state, x, k_cpt)
                    torch.cuda.synchronize()
                    rates[mode].append(N_TREE_PASSES * n_pad
                                       / (time.perf_counter() - t))
            for mode, r in rates.items():
                rec[mode]["bf16"].update(img_s=statistics.median(r),
                                         window_values=r)
        launches = fused_mcm.launches
    finally:
        config.set_compute_dtype(None)
    check(launches > 0, "tree_serve: fused_mcm was not launched")
    return {"checkpoint": os.path.relpath(TREE_CHECKPOINT, HERE),
            "checkpoint_t": extra["t"], "read_s": read_s,
            "dataset": "hybrid.npz rebuilt (50,000 / 2,000)",
            "prep_s": prep_s, "batch": B, "test_examples": n,
            "window_batches": N_TREE_PASSES * len(xs),
            "windows": N_TREE_WINDOWS,
            "per_k_cpt": per_k, "fused_mcm_launches": launches}, (
        net, params, state, extra["t"], data)


def tree_desc_phase(device, tree):
    """net_desc of the trained tree at every k_cpt through the kernel, fp32,
    on the rebuilt hybrid.npz, at the τ of its last training step, beside
    the committed descriptor files of its training: accuracy, moc and the
    largest difference of any scalar stat (printed, not gated). Where the
    fp32 net.npy is present (TREE_FP32), it is evaluated the same way and
    set beside both, which separates the compact archive's rounding from
    the rest."""
    from mpnn_tpu_torch.data.dataset import Dataset
    from mpnn_tpu_torch.experiments import k_cpts, τ_ds
    from mpnn_tpu_torch.models.steps import make_eval_split_fn
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.utils.desc import net_desc
    from mpnn_tpu_torch.utils.serdes import read_net
    net, params, state, n_iter, data = tree
    config.set_compute_dtype(None)
    ds = Dataset(data, device=device)
    eval_split = make_eval_split_fn(net, EVAL_BATCH)
    fp32 = (read_net(TREE_FP32, device)[1:3] if os.path.exists(TREE_FP32)
            else None)

    def desc_at(k_cpt, p, s):
        return net_desc(net, ds, p, s, batch_size=EVAL_BATCH,
                        tau=τ_ds(n_iter - 1), k_cpt=k_cpt,
                        eval_split=eval_split)

    def beside(ours, theirs):
        """The largest difference of a scalar stat and where it is, or
        (None, None) if the schemas differ."""
        ours, theirs = _scalar_stats(ours), _scalar_stats(theirs)
        if [p for p, _ in ours] != [p for p, _ in theirs]:
            return None, None
        return max((abs(a - b), p) for (p, a), (_, b) in zip(ours, theirs))

    rows = []
    t = time.perf_counter()
    for i, k_cpt in enumerate(k_cpts):
        desc = desc_at(k_cpt, params, state)
        jax_desc = np.load(os.path.join(TREE_DIR, "%.4i-stats.npy" % i),
                           allow_pickle=True)[()]
        diff, at = beside(desc, jax_desc)
        row = {"k_cpt": k_cpt, "same_schema": diff is not None,
               "acc_ts": desc["stats_ts"]["acc"],
               "acc_ts_files": jax_desc["stats_ts"]["acc"],
               "acc_tr": desc["stats_tr"]["acc"],
               "acc_tr_files": jax_desc["stats_tr"]["acc"],
               "moc_ts": desc["stats_ts"]["moc"],
               "moc_ts_files": jax_desc["stats_ts"]["moc"],
               "max_abs_stat_diff": diff, "at": at}
        if fp32 is not None:
            full = desc_at(k_cpt, *fp32)
            row["fp32_weights"] = {
                "acc_ts": full["stats_ts"]["acc"],
                "acc_tr": full["stats_tr"]["acc"],
                "moc_ts": full["stats_ts"]["moc"],
                "vs_compact": beside(desc, full),
                "vs_files": beside(full, jax_desc)}
        rows.append(row)
    return {"eval_batch": EVAL_BATCH, "tau": τ_ds(n_iter - 1),
            "seconds": time.perf_counter() - t,
            "weights": "bfloat16-rounded (the compact archive)",
            "fp32_weights": (os.path.relpath(TREE_FP32, HERE)
                             if fp32 is not None else "absent"),
            "max_acc_ts_diff": max(abs(r["acc_ts"] - r["acc_ts_files"])
                                   for r in rows), "per_k_cpt": rows}


def _leaves(tree, path=()):
    """[(path, tensor)] of a params-shaped tree."""
    if isinstance(tree, dict):
        return [e for k, v in tree.items() for e in _leaves(v, path + (k,))]
    if isinstance(tree, list):
        return [e for i, v in enumerate(tree) for e in _leaves(v, path + (i,))]
    return [(path, tree)]


def zero_grad_paths(net):
    """Paths of the biases right before a train-mode BatchNorm: a dense
    layer's bias, and a MultiscaleConvMax's last-scale bias (its coarser
    scales' biases also reach the next scale through a zero-padded vertical
    conv). BN subtracts the batch mean, so their exact gradient is zero."""
    from mpnn_tpu_torch.ops import layers as L
    out = set()

    def chain(layer, path):
        nxt = layer.comps[1:] + [None]
        for i, (c, n) in enumerate(zip(layer.comps, nxt)):
            if isinstance(n, (L.BatchNorm, L.MultiscaleBatchNorm)):
                if isinstance(c, L.LinTrans):
                    out.add(path + ("comps", i, "b"))
                elif isinstance(c, L.MultiscaleConvMax):
                    out.add(path + ("comps", i, "b_%d" % (c._L - 1)))

    def node(n, path):
        chain(n, path + ("layer",))
        if n.router is not None:
            chain(n.router, path + ("router",))
        for i, snk in enumerate(n.sinks):
            node(snk, path + ("sinks", i))

    node(net.root, ())
    return out


def tree_errs(tree, ref, zero_paths=frozenset()):
    """Errors of `tree` against `ref` over the leaves outside zero_paths:
    ||tree - ref|| / ||ref|| of the whole tree, and per leaf the largest
    such ratio, its path and how many leaves exceed DISCRETE_TOL; over
    the leaves in zero_paths, the largest max(||tree||, ||ref||) / ||ref
    tree||."""
    a, b = _leaves(tree), _leaves(ref)
    check([p for p, _ in a] == [p for p, _ in b], "trees differ in shape")
    total = float(torch.sqrt(sum(torch.sum(r.double() ** 2) for _, r in b)))
    num = den = 0.0
    worst, worst_path, n_over, zero = 0.0, None, 0, 0.0
    for (path, t), (_, r) in zip(a, b):
        t, r = t.double(), r.double()
        if path in zero_paths:
            zero = max(zero, max(float(t.norm()), float(r.norm())) / total)
            continue
        d, n = float((t - r).norm()), float(r.norm())
        num, den = num + d * d, den + n * n
        # A structurally zero gradient (an unused scale, a router behind
        # a zero-initialized layer) must be zero on both paths.
        e = d / n if n else (0.0 if d == 0 else float("inf"))
        n_over += e > DISCRETE_TOL
        if e > worst:
            worst, worst_path = e, path
    return {"tree": (num / den) ** 0.5, "leaf": worst,
            "worst_leaf": "/".join(map(str, worst_path or ())),
            "leaves_over_%g" % DISCRETE_TOL: n_over, "zero_grad": zero}


def _plain_stage(xs, whs, wvs, bs, supp):
    from mpnn_tpu_torch.ops.kernels import mcm_ref
    return mcm_ref(xs, whs, wvs, bs)


def _float64_stage(xs, whs, wvs, bs, supp):
    """mcm_ref in float64, rounded to fp32 at the stage's outputs: another,
    more exact implementation of the stage."""
    from mpnn_tpu_torch.ops.kernels import mcm_ref
    outs = mcm_ref(*([t.double() for t in ts] for ts in (xs, whs, wvs, bs)))
    return [o.float() for o in outs]


def train_once(net, params, state, vel, data, stage=None):
    """One training step of the flagship from the generator seed 0, through
    the kernel, or through `stage` patched in for fused_mcm: the loss,
    gradients and launches of `loss_and_grads`, then the whole step's
    params, state and launches."""
    from mpnn_tpu_torch.experiments import λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import (Schedules, _step_pieces,
                                             make_train_step)
    from mpnn_tpu_torch.ops import kernels
    from mpnn_tpu_torch.utils.tree import tree_map
    counter = kernels.fused_mcm
    sched = Schedules(lr=λ_lrn, tau=τ_ds)
    batch_ctx, loss_and_grads = _step_pieces(net, TRAIN_BATCH, sched, 4,
                                             False)
    step = make_train_step(net, TRAIN_BATCH, sched)
    params, vel = (tree_map(torch.clone, t) for t in (params, vel))
    # Under stacked_tails, packed as the training loop carries them.
    (params, state, vel), unpack = _packing(net, (params, state, vel))
    with mock.patch.object(kernels, "fused_mcm", stage or counter):
        n0, m0 = counter.launches, counter.net_launches
        gen = torch.Generator(device=data[0].device).manual_seed(0)
        xb, yb, ctx = batch_ctx(0, gen, *data, None)
        loss, _, _, grads = loss_and_grads(params, state, xb, yb, ctx)
        n1, m1 = counter.launches, counter.net_launches
        gen = torch.Generator(device=data[0].device).manual_seed(0)
        params, state, vel, _ = step(params, state, vel, 0, gen, *data)
        torch.cuda.synchronize()
        n2, m2 = counter.launches, counter.net_launches
    return {"loss": float(loss), "grads": unpack(grads),
            "params": unpack(params), "state": unpack(state),
            "launches": (n1 - n0, n2 - n1),
            "net_launches": (m1 - m0, m2 - m1)}


def train_vs_plain_phase(device, arch="chain"):
    """One fp32 step through the kernel against the same through mcm_ref,
    of the flagship actor chain or (arch="tree") the actor tree."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.ops import config
    config.set_compute_dtype(None)
    net, params, state, vel = train_bench.build(0, device, arch=arch)
    data = train_bench.train_data(net, device)
    k = train_once(net, params, state, vel, data)
    r = train_once(net, params, state, vel, data, _plain_stage)
    f64 = train_once(net, params, state, vel, data, _float64_stage)
    per_fwd = mcm_launches_per_forward(net)
    check(per_fwd == PER_FORWARD[arch] and k["launches"] == (per_fwd, per_fwd)
          and r["launches"] == (0, 0),
          "train %s: kernel launches per forward %s, expected %d (plain "
          "path %s)" % (arch, k["launches"], PER_FORWARD[arch],
                        r["launches"]))
    zero = zero_grad_paths(net)
    loss_err, errs = step_gates("train", k, r, zero)
    # Not a gate: the same comparison for a float64 stage, which rounds
    # differently from the plain path without being wrong.
    baseline = {"loss_rel_err": abs(f64["loss"] - r["loss"]) / abs(r["loss"]),
                "gradient": tree_errs(f64["grads"], r["grads"], zero),
                "parameter": tree_errs(f64["params"], r["params"], zero)}
    return {"arch": arch, "batch": TRAIN_BATCH, "loss": k["loss"],
            "loss_plain": r["loss"],
            "loss_rel_err": loss_err, "errors": errs, "tolerances": TRAIN_TOL,
            "float64_stage_vs_plain": baseline,
            "n_leaves": len(_leaves(k["grads"])),
            "launches_per_forward": per_fwd}


def step_gates(label, k, r, zero):
    """One step `k` held against the same step `r` (train_once records):
    the loss within TRAIN_TOL["loss"], the BatchNorm statistics per leaf,
    the gradients and parameters over the tree, per leaf and at the
    zero-gradient biases. Returns (loss error, errors)."""
    loss_err = abs(k["loss"] - r["loss"]) / abs(r["loss"])
    errs = {"gradient": tree_errs(k["grads"], r["grads"], zero),
            "parameter": tree_errs(k["params"], r["params"], zero),
            "BatchNorm statistic": tree_errs(k["state"], r["state"])}
    check(loss_err <= TRAIN_TOL["loss"], "%s: loss %g vs %g"
          % (label, k["loss"], r["loss"]))
    check(errs["BatchNorm statistic"]["leaf"] <= TRAIN_TOL["state"],
          "%s: BatchNorm statistic error %g > %g"
          % (label, errs["BatchNorm statistic"]["leaf"], TRAIN_TOL["state"]))
    for name in ("gradient", "parameter"):
        for key in ("tree", "leaf", "zero_grad"):
            check(errs[name][key] <= TRAIN_TOL[key], "%s: %s %s error "
                  "%g > %g (worst leaf %s)" % (label, name, key,
                                               errs[name][key],
                                               TRAIN_TOL[key],
                                               errs[name]["worst_leaf"]))
    return loss_err, errs


def tree_stacked_vs_serial_phase(device):
    """One fp32 step of the fresh actor tree at the training batch with
    stacked tails (packed, as the loop carries them) through the kernel,
    against the serial step through the kernel and against the stacked
    step through mcm_ref, at train_fp32_vs_plain's gates; 33 launches per
    stacked forward, 9 of them on the net axis."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.ops import config
    config.set_compute_dtype(None)
    net, params, state, vel = train_bench.build(0, device, arch="tree")
    data = train_bench.train_data(net, device)
    serial = train_once(net, params, state, vel, data)
    config.set_stacked_tails(True)
    try:
        k = train_once(net, params, state, vel, data)
        r = train_once(net, params, state, vel, data, _plain_stage)
        per_fwd = (mcm_launches_per_forward(net),
                   mcm_launches_per_forward(net, net_axis_only=True))
    finally:
        config.set_stacked_tails(False)
    n, m = STACKED_PER_FORWARD["tree"]
    check(per_fwd == (n, m) and k["launches"] == (n, n)
          and k["net_launches"] == (m, m) and r["launches"] == (0, 0)
          and serial["launches"] == (PER_FORWARD["tree"],) * 2
          and serial["net_launches"] == (0, 0),
          "tree stacked: launches per forward %s (net axis %s), expected "
          "%d (%d); plain %s; serial %s" % (
              k["launches"], k["net_launches"], n, m, r["launches"],
              serial["launches"]))
    zero = zero_grad_paths(net)
    loss_err, errs = step_gates("tree stacked vs serial", k, serial, zero)
    plain_err, plain_errs = step_gates("tree stacked kernel vs plain", k, r,
                                       zero)
    return {"arch": "tree", "batch": TRAIN_BATCH, "loss": k["loss"],
            "loss_serial": serial["loss"], "loss_plain": r["loss"],
            "loss_rel_err": loss_err, "errors": errs,
            "vs_plain": {"loss_rel_err": plain_err, "errors": plain_errs},
            "tolerances": TRAIN_TOL, "groups": [
                [len(g["members"]), len(g["preorders"][0])]
                for g in net._stack_plan],
            "launches_per_forward": n, "net_launches_per_forward": m}


def train_phase(device, precision, arch="chain", stacked=False):
    """The training main path in one precision, of the flagship actor chain
    or (arch="tree") the actor tree: a warm-up step and timed windows
    (TRAIN_WINDOWS), the kernel's count from 0; then PROFILE_STEPS steps
    under torch.profiler for the device's time, operations and idle share
    per step. With stacked, under stacked_tails, the trees packed once
    before the warm-up as the training loop carries them."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.experiments import λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import Schedules, make_train_step
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    n_windows, n_window_steps = TRAIN_WINDOWS[arch]
    config.set_compute_dtype(DTYPES[precision])
    config.set_stacked_tails(stacked)
    try:
        net, params, state, vel = train_bench.build(0, device, arch=arch)
        data = train_bench.train_data(net, device)
        extra = {}
        if precision == "bf16":
            r = train_once(net, params, state, vel, data, _plain_stage)
            extra["bf16_first_loss_plain"] = r["loss"]
        (params, state, vel), _ = _packing(net, (params, state, vel))
        step = make_train_step(net, TRAIN_BATCH,
                               Schedules(lr=λ_lrn, tau=τ_ds))
        gen = torch.Generator(device=device).manual_seed(0)
        per_fwd = (mcm_launches_per_forward(net),
                   mcm_launches_per_forward(net, net_axis_only=True))
        # The main path: the kernel's counts start from 0 here and are
        # read just after the last step.
        fused_mcm.launches = fused_mcm.net_launches = 0
        params, state, vel, c = step(params, state, vel, 0, gen, *data)
        loss_first, t = float(c), 0
        rates, losses = [], []
        for _ in range(n_windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n_window_steps):
                t += 1
                params, state, vel, c = step(params, state, vel, t, gen,
                                             *data)
            torch.cuda.synchronize()
            rates.append(n_window_steps * TRAIN_BATCH
                         / (time.perf_counter() - t0))
            losses.append(float(c))
        launches, net_launches = fused_mcm.launches, fused_mcm.net_launches

        def more(params, state, vel, t):
            for _ in range(PROFILE_STEPS[arch]):
                t += 1
                params, state, vel, _ = step(params, state, vel, t, gen,
                                             *data)
        profile = profile_steps(more, (params, state, vel, t),
                                PROFILE_STEPS[arch])
    finally:
        config.set_compute_dtype(None)
        config.set_stacked_tails(False)
    check(all(np.isfinite(losses)) and np.isfinite(loss_first),
          "train %s %s: loss not finite: %s" % (arch, precision, losses))
    n_steps = 1 + n_windows * n_window_steps
    expect = (STACKED_PER_FORWARD[arch] if stacked
              else (PER_FORWARD[arch], 0))
    check(per_fwd == expect and (launches, net_launches) == (
        expect[0] * n_steps, expect[1] * n_steps),
          "train %s %s%s: %d launches (%d of the net axis) in %d steps, "
          "expected %s a step" % (arch, precision,
                                  " stacked" if stacked else "", launches,
                                  net_launches, n_steps, expect))
    if precision == "bf16":
        extra["bf16_first_loss_kernel"] = loss_first
    if stacked:
        extra.update(stacked_tails=True, fused_mcm_net_launches=net_launches)
    label = ("" if arch == "chain" else "tree, ") + (
        "stacked tails, " if stacked else "")
    return {"arch": arch, "batch": TRAIN_BATCH,
            "metric": "train-step (%s%s, batch %d)"
            % (label, precision, TRAIN_BATCH),
            "value": statistics.median(rates),
            "unit": "images/sec", "window_values": rates,
            "window_steps": n_window_steps, "loss_first": loss_first,
            "loss_window_ends": losses, "fused_mcm_launches": launches,
            "steps": n_steps, "profile": profile, **extra}


def profile_steps(run, args, n_steps):
    """`run(*args)` (n_steps steps) under torch.profiler: the device time
    per step, its operations per step and its idle share
    (train_bench.step_split), without the list of operations."""
    from mpnn_tpu_torch.train_bench import step_split
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(*args)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    split = step_split(prof, n_steps)
    split.pop("top_device_ops")
    return dict(split, steps=n_steps,
                profiled_ms_per_step=host_s * 1e3 / n_steps)


def sweep_once(net, trees, k_cpts, data, stage=None):
    """One step of the flagship sweep, its batch sampled from the generator
    seed 0 and augmented from seed 1, through the kernel's net axis or
    through `stage` patched in for fused_mcm: the members' losses,
    gradients and launches of the vmapped loss and gradient, then the
    whole step's params, state and launches."""
    from mpnn_tpu_torch.data.augment import augment_presampled, sampled_batch
    from mpnn_tpu_torch.experiments import λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import (Schedules, _sweep_members,
                                             _sweep_step_body)
    from mpnn_tpu_torch.ops import kernels
    from mpnn_tpu_torch.utils.tree import tree_map
    counter = kernels.fused_mcm
    loss_and_grads, _ = _sweep_members(net, TRAIN_BATCH)
    step = _sweep_step_body(net, TRAIN_BATCH, Schedules(lr=λ_lrn, tau=τ_ds))
    params, state, vel = trees
    params, vel = (tree_map(torch.clone, t) for t in (params, vel))
    # Under stacked_tails, packed after the nets' axis as the loop does.
    (params, state, vel), unpack = _packing(net, (params, state, vel), 1)
    x0, y, m_sym = data
    dev = x0.device
    with mock.patch.object(kernels, "fused_mcm", stage or counter):
        xb, yb = sampled_batch(torch.Generator(dev).manual_seed(0), x0, y,
                               TRAIN_BATCH)
        n0, m0 = counter.launches, counter.net_launches
        xa, ya = augment_presampled(torch.Generator(dev).manual_seed(1), xb,
                                    yb, m_sym)
        grads, (loss, _) = loss_and_grads(params, state, k_cpts, xa, ya,
                                          τ_ds(0))
        n1, m1 = counter.launches, counter.net_launches
        params, state, vel, _ = step(params, state, vel, 0,
                                     torch.Generator(dev).manual_seed(1), xb,
                                     yb, m_sym, k_cpts)
        torch.cuda.synchronize()
        n2, m2 = counter.launches, counter.net_launches
    return {"loss": loss.tolist(), "grads": unpack(grads),
            "params": unpack(params), "state": unpack(state),
            "launches": (n1 - n0, n2 - n1),
            "net_launches": (m1 - m0, m2 - m1)}


def sweep_vs_plain_phase(device, arch="chain", stacked=False):
    """One fp32 step of the 8-net sweep of flagship actor chains (or trees)
    through the kernel's net axis against the same step through mcm_ref,
    at the gates of train_fp32_vs_plain over the sweep's stacked trees
    (the losses per member); the worst member's errors and, for the chain,
    the same comparison for a float64 stage are printed beside them. With
    stacked, under stacked_tails (each tree's tails a vmap inside the
    sweep's, every launch on the net axis)."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.utils.tree import unstack_tree
    config.set_compute_dtype(None)
    config.set_stacked_tails(stacked)
    try:
        net, params, state, vel, k_cpts = train_bench.build_sweep(
            N_NETS, 0, device, arch)
        data = train_bench.train_data(net, device)
        k = sweep_once(net, (params, state, vel), k_cpts, data)
        r = sweep_once(net, (params, state, vel), k_cpts, data, _plain_stage)
        f64 = (sweep_once(net, (params, state, vel), k_cpts, data,
                          _float64_stage) if arch == "chain" else None)
        per_fwd = mcm_launches_per_forward(net)
    finally:
        config.set_stacked_tails(False)
    expect = (STACKED_PER_FORWARD if stacked else PER_FORWARD)[arch]
    expect = expect[0] if stacked else expect
    check(per_fwd == expect and k["launches"] == (per_fwd, per_fwd)
          and k["net_launches"] == k["launches"]
          and r["launches"] == (0, 0),
          "sweep %s%s: kernel launches per sweep forward %s (net axis %s), "
          "expected %d (plain path %s)" % (
              arch, " stacked" if stacked else "", k["launches"],
              k["net_launches"], expect, r["launches"]))
    zero = zero_grad_paths(net)
    names = {"gradient": "grads", "parameter": "params",
             "BatchNorm statistic": "state"}

    def errs(a, b, i=None):
        pick = (lambda t: t) if i is None else (lambda t: unstack_tree(t, i))
        return {name: tree_errs(pick(a[key]), pick(b[key]),
                                frozenset() if key == "state" else zero)
                for name, key in names.items()}

    def worst_member(a, b):
        worst = {}
        for i in range(N_NETS):
            for name, e in errs(a, b, i).items():
                if e["tree"] >= worst.get(name, {}).get("tree", -1.0):
                    worst[name] = dict(e, net=i)
        return worst

    loss_errs = [abs(a - b) / abs(b) for a, b in zip(k["loss"], r["loss"])]
    all_errs = errs(k, r)
    check(max(loss_errs) <= TRAIN_TOL["loss"], "sweep: losses %s vs %s"
          % (k["loss"], r["loss"]))
    check(all_errs["BatchNorm statistic"]["leaf"] <= TRAIN_TOL["state"],
          "sweep: BatchNorm statistic error %g > %g"
          % (all_errs["BatchNorm statistic"]["leaf"], TRAIN_TOL["state"]))
    for name in ("gradient", "parameter"):
        for key in ("tree", "leaf", "zero_grad"):
            check(all_errs[name][key] <= TRAIN_TOL[key], "sweep: %s %s "
                  "error %g > %g (worst leaf %s)" % (
                      name, key, all_errs[name][key], TRAIN_TOL[key],
                      all_errs[name]["worst_leaf"]))
    # Not gates: the member the flips move most, and the same comparisons
    # for a float64 stage, which rounds differently without being wrong.
    out = {"arch": arch, "nets": N_NETS, "batch": TRAIN_BATCH,
           "k_cpts": k_cpts.tolist(), "loss": k["loss"],
           "loss_plain": r["loss"], "loss_rel_err": max(loss_errs),
           "errors": all_errs, "tolerances": TRAIN_TOL,
           "worst_member": worst_member(k, r),
           "launches_per_sweep_forward": per_fwd, "stacked_tails": stacked}
    if f64 is not None:
        out["float64_stage_vs_plain"] = {"errors": errs(f64, r),
                                         "worst_member": worst_member(f64, r)}
    return out


def sweep_train_phase(device, precision, single, arch="chain",
                      stacked=False):
    """The sweep's training main path in one precision: N_NETS flagship
    chains (or trees) trained at once by make_sweep_train_loop, a warm-up
    step, then timed windows (SWEEP_WINDOWS) of one call each, the
    kernel's counts from 0; `single` is the same call's single-net
    record of train_phase. With stacked, under stacked_tails (the loop
    packs each call's trees)."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.experiments import λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import Schedules, make_sweep_train_loop
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    n_windows, n_window_steps = SWEEP_WINDOWS[arch]
    config.set_compute_dtype(DTYPES[precision])
    config.set_stacked_tails(stacked)
    try:
        net, params, state, vel, k_cpts = train_bench.build_sweep(
            N_NETS, 0, device, arch)
        per_fwd = mcm_launches_per_forward(net)
        data = train_bench.train_data(net, device)
        loop = make_sweep_train_loop(net, TRAIN_BATCH,
                                     Schedules(lr=λ_lrn, tau=τ_ds))
        # The main path: the kernel's counts start from 0 here and are read
        # just after the last step.
        fused_mcm.launches = fused_mcm.net_launches = 0
        params, state, vel, cs = loop(params, state, vel, 0, 0, *data, 1,
                                      k_cpts)
        loss_first, t = cs[-1].tolist(), 1
        rates, losses = [], []
        for _ in range(n_windows):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, vel, cs = loop(params, state, vel, t, 0, *data,
                                          n_window_steps, k_cpts)
            t += n_window_steps
            torch.cuda.synchronize()
            rates.append(N_NETS * n_window_steps * TRAIN_BATCH
                         / (time.perf_counter() - t0))
            losses.append(cs[-1].tolist())
        launches, net_launches = fused_mcm.launches, fused_mcm.net_launches
        profile = None
        if arch == "tree":
            n = PROFILE_STEPS[arch]
            profile = profile_steps(
                lambda *a: loop(*a, 0, *data, n, k_cpts),
                (params, state, vel, t), n)
    finally:
        config.set_compute_dtype(None)
        config.set_stacked_tails(False)
    check(all(np.isfinite(v).all() for v in losses + [loss_first]),
          "sweep %s %s: loss not finite: %s" % (arch, precision, losses))
    n_steps = 1 + n_windows * n_window_steps
    expect = (STACKED_PER_FORWARD[arch][0] if stacked
              else PER_FORWARD[arch])
    check(per_fwd == expect
          and launches == net_launches == per_fwd * n_steps,
          "sweep %s %s%s: %d launches (%d of the net axis) in %d steps, "
          "expected %d a step" % (arch, precision,
                                  " stacked" if stacked else "", launches,
                                  net_launches, n_steps, expect))
    value = statistics.median(rates)
    label = ("" if arch == "chain" else "tree, ") + (
        "stacked tails, " if stacked else "")
    return {"arch": arch, "nets": N_NETS, "batch_per_net": TRAIN_BATCH,
            "metric": "train-sweep (%s%s, %d nets x batch %d)"
            % (label, precision, N_NETS, TRAIN_BATCH), "value": value,
            "unit": "images/sec (all nets)", "window_values": rates,
            "window_steps": n_window_steps, "profile": profile,
            "single_net_value": single["value"],
            "single_net_window_values": single["window_values"],
            "vs_single_net": value / single["value"],
            "loss_first": loss_first, "loss_window_ends": losses,
            "fused_mcm_launches": launches,
            "fused_mcm_net_launches": net_launches, "steps": n_steps,
            "stacked_tails": stacked}


def bf16_vs_fp32(run, zero):
    """The C1 gate of bf16 training: `run(stage)` (one step of the same
    params and batch, through the kernel for stage None or through
    mcm_ref) in bf16 and in fp32; the kernel path's bf16 gradients may be
    at most BF16_VS_FP32_FACTOR times as far from its fp32 gradients, over
    the whole tree, as mcm_ref's bf16 gradients are from mcm_ref's fp32
    ones. The worst leaf's distances are printed beside them."""
    from mpnn_tpu_torch.ops import config
    grads = {}
    for dt in ("bf16", "fp32"):
        config.set_compute_dtype(DTYPES[dt] if dt == "bf16" else None)
        try:
            for name, stage in (("kernel", None), ("plain", _plain_stage)):
                grads[name, dt] = run(stage)["grads"]
        finally:
            config.set_compute_dtype(None)
    dist = {name: tree_errs(grads[name, "bf16"], grads[name, "fp32"], zero)
            for name in ("kernel", "plain")}
    check(dist["kernel"]["tree"]
          <= BF16_VS_FP32_FACTOR * dist["plain"]["tree"],
          "bf16 vs fp32: the kernel path's gradient distance %g > %g x "
          "mcm_ref's %g" % (dist["kernel"]["tree"], BF16_VS_FP32_FACTOR,
                            dist["plain"]["tree"]))
    return {"kernel_bf16_vs_kernel_fp32": dist["kernel"],
            "plain_bf16_vs_plain_fp32": dist["plain"],
            "tree_ratio": dist["kernel"]["tree"] / dist["plain"]["tree"],
            "leaf_ratio": dist["kernel"]["leaf"] / dist["plain"]["leaf"],
            "gate": "tree distance ratio <= %g" % BF16_VS_FP32_FACTOR}


def train_bf16_vs_fp32_phase(device):
    """One step of the fresh flagship chain at the training batch, four
    ways from the same params and batch (kernel and mcm_ref, bf16 and
    fp32), held to the bf16_vs_fp32 gate."""
    from mpnn_tpu_torch import train_bench
    net, params, state, vel = train_bench.build(0, device)
    data = train_bench.train_data(net, device)
    return dict(batch=TRAIN_BATCH, **bf16_vs_fp32(
        lambda stage: train_once(net, params, state, vel, data, stage),
        zero_grad_paths(net)))


def sweep_bf16_vs_fp32(device):
    """bf16_vs_fp32 of one step of the 8-net flagship sweep (the stacked
    gradients of all members)."""
    from mpnn_tpu_torch import train_bench
    net, params, state, vel, k_cpts = train_bench.build_sweep(N_NETS, 0,
                                                              device)
    data = train_bench.train_data(net, device)
    return bf16_vs_fp32(
        lambda stage: sweep_once(net, (params, state, vel), k_cpts, data,
                                 stage), zero_grad_paths(net))


def mcm_launches_per_forward(net, net_axis_only=False):
    """fused_mcm launches of one forward of `net`: one per output scale of
    every MultiscaleConvMax that takes the kernel; under stacked_tails a
    stack-plan group's template counts once (one net-axis launch for all
    its members). With net_axis_only, the groups' launches alone."""
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.layers import MultiscaleConvMax

    def launches(nodes):
        return sum(c._L for node in nodes for c in node.comps
                   if isinstance(c, MultiscaleConvMax)
                   and c._kernel_eligible())

    plan = net._stack_plan if config.stacked_tails else []
    grouped = {id(n) for g in plan for pre in g["preorders"] for n in pre}
    net_axis = sum(launches(g["preorders"][0]) for g in plan)
    if net_axis_only:
        return net_axis
    return net_axis + launches(n for n in net.layers
                               if id(n) not in grouped)


def _packing(net, trees, axis=0):
    """`trees` in the packed layout the loops carry when stacked_tails is
    on (and the net has a plan), else as they are; with the function that
    brings a tree back to the node layout."""
    from mpnn_tpu_torch.ops import config
    if not (config.stacked_tails and net._stack_plan):
        return trees, lambda t: t
    return ([net.pack_tree(t, axis) for t in trees],
            lambda t: net.unpack_tree(t, axis))


def _scalar_stats(desc, path=""):
    """[(path, value)] of every scalar stat of a descriptor."""
    out = [(path + "/" + k, v) for key in ("stats_tr", "stats_ts")
           for k, v in sorted(desc.get(key, {}).items())
           if isinstance(v, float)]
    for i, s in enumerate(desc.get("sinks", [desc["root"]] if "root" in desc
                                   else [])):
        out += _scalar_stats(s, "%s/%d" % (path, i))
    return out


def train_cli_phase(device):
    """The training CLI's path: four runs of train_experiment in a
    temporary directory, their launches counted from 0."""
    import contextlib
    import io
    import tempfile
    from mpnn_tpu_torch import train as cli
    from mpnn_tpu_torch.data.dataset import Dataset
    from mpnn_tpu_torch.data.prep import make_synthetic_archives
    from mpnn_tpu_torch.experiments import make_experiments, τ_ds
    from mpnn_tpu_torch.ops import config, kernels
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    from mpnn_tpu_torch.utils.desc import net_desc
    from mpnn_tpu_torch.utils.serdes import read_net
    from mpnn_tpu_torch.utils.tree import tree_map, unstack_tree

    config.set_compute_dtype(None)
    registry = make_experiments()
    live = []
    original, original_sweep = cli.train_one_net, cli._train_sweep

    def keep(*args, **kwargs):
        out = original(*args, **kwargs)
        live.append(out)
        return out

    def keep_sweep(*args, **kwargs):
        out = original_sweep(*args, **kwargs)
        live.append(out)
        return out

    with tempfile.TemporaryDirectory() as d:
        t = time.perf_counter()
        make_synthetic_archives(os.path.join(d, "data"), small=True)
        prep_s = time.perf_counter() - t
        out_root = os.path.join(d, "nets")
        rows = []
        # The main path: the kernel's count starts from 0 here and is read
        # just after the last run.
        fused_mcm.launches = 0
        for expt, i, n_iter, resume in CLI_RUNS:
            n0, timings, buf = fused_mcm.launches, [], io.StringIO()
            t = time.perf_counter()
            with mock.patch.object(cli, "train_one_net", keep), \
                    contextlib.redirect_stdout(buf):
                cli.train_experiment(
                    expt, n_iter=n_iter, t_log=CLI_T_LOG,
                    batch_size=TRAIN_BATCH, net_indices=[i], data_root=d,
                    out_root=out_root, resume=resume, device=device,
                    timings=timings)
            wall = time.perf_counter() - t
            n = fused_mcm.launches - n0
            # The checkpoint now on disk against the live state (a later
            # resume overwrites it); reading it launches nothing.
            _, params, state, extra = read_net(os.path.join(
                out_root, expt, "%.4i.npy" % i), device)
            same = []
            tree_map(lambda a, b: same.append(torch.equal(a, b)),
                     (params, state, extra["vel"]), live[-1][:3])
            rows.append((expt, i, n_iter, resume, timings[0], wall, n,
                         buf.getvalue(), live[-1][3],
                         bool(same) and all(same), extra["t"]))
        sweep_root = os.path.join(d, "nets-sweep")
        sweep_rows = []
        for expt, n_iter, resume in SWEEP_CLI_RUNS:
            n0, timings, buf = fused_mcm.launches, [], io.StringIO()
            t = time.perf_counter()
            with mock.patch.object(cli, "_train_sweep", keep_sweep), \
                    contextlib.redirect_stdout(buf):
                cli.train_experiment(
                    expt, n_iter=n_iter, t_log=CLI_T_LOG,
                    batch_size=TRAIN_BATCH, data_root=d,
                    out_root=sweep_root, resume=resume, device=device,
                    timings=timings, vmap_sweep=True)
            wall = time.perf_counter() - t
            n = fused_mcm.launches - n0
            same, ckpt_ts = [], []
            for j in range(N_NETS):
                _, params, state, extra = read_net(os.path.join(
                    sweep_root, expt, "%.4i.npy" % j), device)
                tree_map(lambda a, b: same.append(torch.equal(a, b)),
                         (params, state, extra["vel"]),
                         [unstack_tree(tr, j) for tr in live[-1][:3]])
                ckpt_ts.append(extra["t"])
            sweep_rows.append((expt, n_iter, resume, timings[0], wall, n,
                               buf.getvalue(), live[-1][3],
                               bool(same) and all(same), ckpt_ts))
        launches = fused_mcm.launches

        records, reached = [], {}
        for (expt, i, n_iter, resume, tm, wall, n, text, desc, same,
             ckpt_t) in rows:
            e = registry[expt]
            ds = Dataset(os.path.join(d, e.dataset), device_put=False)
            net = e.nets[i](ds.x0_shape, ds.y_shape)
            t_start = reached[expt, i] if resume else 0
            reached[expt, i] = n_iter
            evals = (sum(t % CLI_T_LOG == 0
                         for t in range(t_start + 1, n_iter + 1))
                     + (n_iter % CLI_T_LOG != 0))
            eval_batches = sum(-(-len(x) // TRAIN_BATCH)
                               for x in (ds.x0_tr, ds.x0_ts))
            per_fwd = mcm_launches_per_forward(net)
            expect = per_fwd * (n_iter - t_start + evals * eval_batches)
            label = "%s net %d to %d%s" % (expt, i, n_iter,
                                          " (resumed)" if resume else "")
            check(n == expect, "train_cli %s: %d launches, expected %d = %d "
                  "x (%d steps + %d evals x %d batches)" % (
                      label, n, expect, per_fwd, n_iter - t_start, evals,
                      eval_batches))
            check(tm["t_start"] == t_start and tm["evals"] == evals,
                  "train_cli %s: started at %d with %d evals" % (
                      label, tm["t_start"], tm["evals"]))
            if resume:
                check("[resuming %s at t=%d]" % (os.path.join(
                    out_root, expt, "%.4i.npy" % i), t_start) in text,
                      "train_cli %s: no resume at t=%d" % (label, t_start))
            root = os.path.join(out_root, expt)
            names = ["MANIFEST.json", "%.4i-stats.npy" % i,
                     "%.4i-log.txt" % i, "%.4i.npy" % i] + [
                "%.4i-stats/%.8i.npy" % (i, t)
                for t in range(CLI_T_LOG, n_iter + 1, CLI_T_LOG)]
            missing = [x for x in names
                       if not os.path.exists(os.path.join(root, x))]
            check(not missing, "train_cli %s: missing %s" % (label, missing))
            check(same and ckpt_t == n_iter,
                  "train_cli %s: checkpoint differs from the live state "
                  "(t=%s)" % (label, ckpt_t))
            check(all(np.isfinite(v) for _, v in _scalar_stats(desc)),
                  "train_cli %s: stats not finite" % label)
            imgs = tm["steps"] * tm["batch_size"]
            records.append({
                "run": label, "steps": tm["steps"], "evals": tm["evals"],
                "eval_batches": eval_batches, "launches": n,
                "launches_per_forward": per_fwd, "wall_s": wall,
                "train_s": tm["train_s"], "eval_s": tm["eval_s"],
                "write_s": tm["write_s"], "total_s": tm["total_s"],
                "eval_s_per_eval": tm["eval_s"] / tm["evals"],
                "train_img_s": imgs / tm["train_s"],
                "total_img_s": imgs / tm["total_s"],
                "acc_ts": desc["stats_ts"]["acc"]})

        reached, sweep_records = {}, []
        for (expt, n_iter, resume, tm, wall, n, text, descs, same,
             ckpt_ts) in sweep_rows:
            e = registry[expt]
            ds = Dataset(os.path.join(d, e.dataset), device_put=False)
            net = e.nets[0](ds.x0_shape, ds.y_shape)
            per_fwd = mcm_launches_per_forward(net)
            eval_batches = sum(-(-len(x) // TRAIN_BATCH)
                               for x in (ds.x0_tr, ds.x0_ts))
            t_start = reached.get(expt, 0) if resume else 0
            reached[expt] = n_iter
            evals = (sum(t % CLI_T_LOG == 0
                         for t in range(t_start + 1, n_iter + 1))
                     + (n_iter % CLI_T_LOG != 0))
            expect = per_fwd * (n_iter - t_start + evals * eval_batches)
            label = "%s --vmap-sweep to %d%s" % (
                expt, n_iter, " (resumed)" if resume else "")
            check(n == expect, "train_cli %s: %d launches, expected %d = %d "
                  "x (%d steps + %d evals x %d batches)" % (
                      label, n, expect, per_fwd, n_iter - t_start, evals,
                      eval_batches))
            check(tm["t_start"] == t_start and tm["evals"] == evals
                  and tm["n_nets"] == N_NETS, "train_cli %s: started at %d "
                  "with %d evals of %d nets" % (label, tm["t_start"],
                                                tm["evals"], tm["n_nets"]))
            if resume:
                check("[resuming %s sweep at t=%d]" % (expt, t_start) in text,
                      "train_cli %s: no resume at t=%d" % (label, t_start))
            root = os.path.join(sweep_root, expt)
            names = ["MANIFEST.json"] + [
                name % j for j in range(N_NETS)
                for name in ["%.4i-stats.npy", "%.4i-log.txt", "%.4i.npy"]
                + ["%%.4i-stats/%.8i.npy" % t
                   for t in range(CLI_T_LOG, n_iter + 1, CLI_T_LOG)]]
            missing = [x for x in names
                       if not os.path.exists(os.path.join(root, x))]
            check(not missing, "train_cli %s: missing %s" % (label, missing))
            check(same and ckpt_ts == [n_iter] * N_NETS,
                  "train_cli %s: checkpoints differ from the live state "
                  "(t=%s)" % (label, ckpt_ts))
            check(all(np.isfinite(v) for desc in descs
                      for _, v in _scalar_stats(desc)),
                  "train_cli %s: stats not finite" % label)
            imgs = N_NETS * tm["steps"] * tm["batch_size"]
            sweep_records.append({
                "run": label, "nets": N_NETS, "steps": tm["steps"],
                "evals": tm["evals"], "eval_batches": eval_batches,
                "launches": n, "launches_per_sweep_forward": per_fwd,
                "wall_s": wall, "train_s": tm["train_s"],
                "eval_s": tm["eval_s"], "write_s": tm["write_s"],
                "total_s": tm["total_s"],
                "train_img_s_all_nets": imgs / tm["train_s"],
                "total_img_s_all_nets": imgs / tm["total_s"],
                "acc_ts": [desc["stats_ts"]["acc"] for desc in descs]})

        # The sweep's final descriptor of one member, from its vmapped
        # evaluation through the kernel's net axis, against net_desc of the
        # member's checkpoint through mcm_ref.
        net, params, state, _ = read_net(os.path.join(
            sweep_root, "synth-ac", "%.4i.npy" % SWEEP_DESC_NET), device)
        ds = Dataset(os.path.join(d, registry["synth-ac"].dataset),
                     device=device)
        last = [r for r in sweep_rows if r[0] == "synth-ac"][-1]
        with mock.patch.object(kernels, "fused_mcm", _plain_stage):
            plain = net_desc(net, ds, params, state, batch_size=TRAIN_BATCH,
                             tau=τ_ds(last[1] - 1))
        sweep_diffs = [(abs(a - b) / max(1.0, abs(b)), p)
                       for (p, a), (_, b) in zip(
                           _scalar_stats(last[7][SWEEP_DESC_NET]),
                           _scalar_stats(plain))]
        sweep_worst, sweep_worst_path = max(sweep_diffs)
        check(sweep_worst <= DESC_TOL, "train_cli: the sweep's descriptor of "
              "net %d through the kernel and net_desc through mcm_ref differ "
              "by %g at %s" % (SWEEP_DESC_NET, sweep_worst,
                               sweep_worst_path))

        # The final synth-ac checkpoint, evaluated through the kernel and
        # through mcm_ref.
        net, params, state, _ = read_net(
            os.path.join(out_root, "synth-ac", "0004.npy"), device)
        ds = Dataset(os.path.join(d, registry["synth-ac"].dataset),
                     device=device)
        descs = []
        for stage in (None, _plain_stage):
            with mock.patch.object(kernels, "fused_mcm",
                                   stage or kernels.fused_mcm):
                descs.append(net_desc(net, ds, params, state,
                                      batch_size=TRAIN_BATCH,
                                      tau=τ_ds(CLI_RUNS[1][2] - 1)))
        diffs = [(abs(a - b) / max(1.0, abs(b)), p)
                 for (p, a), (_, b) in zip(_scalar_stats(descs[0]),
                                           _scalar_stats(descs[1]))]
        worst, worst_path = max(diffs)
        check(worst <= DESC_TOL, "train_cli: net_desc through the kernel "
              "and through mcm_ref differ by %g at %s" % (worst, worst_path))
    return {"batch": TRAIN_BATCH, "t_log": CLI_T_LOG, "precision": "fp32",
            "prep_s": prep_s, "runs": records, "sweep_runs": sweep_records,
            "fused_mcm_launches": launches,
            "desc_kernel_vs_plain": {"max_err": worst, "at": worst_path,
                                     "n_stats": len(diffs),
                                     "tolerance": DESC_TOL},
            "sweep_desc_kernel_vs_plain": {
                "net": SWEEP_DESC_NET, "max_err": sweep_worst,
                "at": sweep_worst_path, "n_stats": len(sweep_diffs),
                "tolerance": DESC_TOL}}


# (experiment, n_iter, t_log, stats_log, resume) of the adaptive_cli phase,
# each one `python -m mpnn_tpu_torch.train_adaptive` process.
ADAPTIVE_RUNS = [("synth-ac-tree-dynkcpt", 20, 10, True, False),
                 ("synth-ac-tree-dynkcpt", 30, 10, True, True),
                 ("synth-cr-dynkcpt", 20, None, False, False)]
# The first run again with --stacked-tails, into an output root of its own.
ADAPTIVE_STACKED_RUN = ("synth-ac-tree-dynkcpt", 20, 10, True, False)
DEFAULT_T_LOG = 2500


def _records_equal(a, b):
    """Two decoded checkpoint records equal, arrays bit for bit."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(_records_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_records_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return a == b


def adaptive_cli_phase(device):
    """The adaptive trainer's CLI, `python -m mpnn_tpu_torch.train_adaptive`,
    as separate processes on the small synthetic archive, fp32, batch 128
    (ADAPTIVE_RUNS, then ADAPTIVE_STACKED_RUN with --stacked-tails into
    another output root: the first run's file set, and its launches with
    33 a forward, 9 on the net axis). Gates: the files; net.npy read
    back by the port and
    written again equals the file bit for bit, with t = n_iter; the resume
    starts where the first run ended; each process's launches (its last
    line) equal per_forward x (steps + evaluations x eval batches), the
    evaluations one per k_cpt at every stats boundary and at the end; the
    final tree's descriptor files, written through the kernel, equal
    net_desc of its net.npy through mcm_ref within DESC_TOL x max(1,
    |stat|) at every k_cpt."""
    import subprocess
    import tempfile
    from mpnn_tpu_torch.data.dataset import Dataset
    from mpnn_tpu_torch.data.prep import save_archive, synthetic_archive
    from mpnn_tpu_torch.experiments import (k_cpts,
                                            make_adaptive_experiments)
    from mpnn_tpu_torch.ops import config, kernels
    from mpnn_tpu_torch.utils.desc import net_desc
    from mpnn_tpu_torch.utils.serdes import encode_net, read_net

    registry = make_adaptive_experiments()
    config.set_compute_dtype(None)
    records, launches, reached = [], 0, {}
    with tempfile.TemporaryDirectory() as d:
        save_archive(os.path.join(d, "data", "synth.npz"),
                     synthetic_archive("synth.npz", small=True))
        ds = Dataset(os.path.join(d, "data", "synth.npz"), device=device)
        eval_batches = sum(-(-len(x) // TRAIN_BATCH)
                           for x in (ds.x0_tr, ds.x0_ts))
        roots = {False: os.path.join(d, "nets"),
                 True: os.path.join(d, "nets-stacked")}
        file_sets = {}
        for (expt, n_iter, t_log, stats_log, resume), stacked in [
                (r, False) for r in ADAPTIVE_RUNS] + [
                (ADAPTIVE_STACKED_RUN, True)]:
            out_root = roots[stacked]
            cmd = [sys.executable, "-m", "mpnn_tpu_torch.train_adaptive",
                   expt, "--n-iter", str(n_iter), "--batch-size",
                   str(TRAIN_BATCH), "--data-root", d, "--out-root",
                   out_root]
            cmd += ["--t-log", str(t_log)] if t_log else []
            cmd += ["--stats-log"] if stats_log else []
            cmd += ["--resume"] if resume else []
            cmd += ["--stacked-tails"] if stacked else []
            t = time.perf_counter()
            proc = subprocess.run(cmd, cwd=HERE, capture_output=True,
                                  text=True, timeout=600)
            wall = time.perf_counter() - t
            label = " ".join(cmd[3:4] + cmd[4:6] + cmd[12:])
            check(proc.returncode == 0, "adaptive_cli %s: exit %d: %s"
                  % (label, proc.returncode, proc.stderr[-2000:]))
            tm = json.loads(proc.stdout.strip().splitlines()[-1])
            t_start = reached.get(expt, 0) if resume else 0
            reached[expt] = n_iter
            chunk = min(n_iter, t_log or DEFAULT_T_LOG)
            boundaries = [t for t in range(t_start + 1, n_iter)
                          if t % chunk == 0] if stats_log else []
            evals = len(k_cpts) * (len(boundaries) + 1)
            net = registry[expt].net(ds.x0_shape, ds.y_shape)
            config.set_stacked_tails(stacked)
            per_fwd = mcm_launches_per_forward(net)
            per_net = mcm_launches_per_forward(net, net_axis_only=True)
            config.set_stacked_tails(False)
            forwards = n_iter - t_start + evals * eval_batches
            expect = per_fwd * forwards
            check(tm["t_start"] == t_start and tm["evals"] == evals
                  and tm["fused_mcm_launches"] == expect
                  and tm["fused_mcm_net_launches"] == per_net * forwards
                  and tm["stacked_tails"] == stacked,
                  "adaptive_cli %s: started at %d with %d evaluations and "
                  "%d launches (%d net-axis), expected %d, %d and %d = %d "
                  "(%d) x (%d steps + %d x %d batches)" % (
                      label, tm["t_start"], tm["evals"],
                      tm["fused_mcm_launches"], tm["fused_mcm_net_launches"],
                      t_start, evals, expect, per_fwd, per_net,
                      n_iter - t_start, evals, eval_batches))
            root = os.path.join(out_root, expt)
            if not resume and (expt, n_iter) == ADAPTIVE_STACKED_RUN[:2]:
                file_sets[stacked] = sorted(
                    os.path.relpath(os.path.join(a, f), root)
                    for a, _, fs in os.walk(root) for f in fs)
            ckpt = os.path.join(root, "net.npy")
            if resume:
                check("[resuming %s at t=%d]" % (ckpt, t_start)
                      in proc.stdout, "adaptive_cli %s: no resume at t=%d"
                      % (label, t_start))
            snaps = list(range(chunk, n_iter + 1, chunk)) if stats_log else []
            names = (["MANIFEST.json", "net.npy"]
                     + ["%.4i-stats.npy" % i for i in range(len(k_cpts))]
                     + ["%.4i-stats/%.8i.npy" % (i, t_)
                        for i in range(len(k_cpts)) for t_ in snaps])
            missing = [x for x in names
                       if not os.path.exists(os.path.join(root, x))]
            check(not missing, "adaptive_cli %s: missing %s"
                  % (label, missing))
            raw = np.load(ckpt, allow_pickle=True)[()]
            net_r, params, state, extra = read_net(ckpt, device)
            again = encode_net(net_r, params, state, extra)
            check(_records_equal(again, raw) and extra["t"] == n_iter,
                  "adaptive_cli %s: net.npy does not read back bit for bit "
                  "(t=%s)" % (label, extra["t"]))
            launches += tm["fused_mcm_launches"]
            imgs = tm["steps"] * tm["batch_size"]
            records.append({
                "run": label, "steps": tm["steps"], "evals": evals,
                "eval_batches": eval_batches,
                "launches": tm["fused_mcm_launches"],
                "net_launches": tm["fused_mcm_net_launches"],
                "launches_per_forward": per_fwd, "wall_s": wall,
                "train_s": tm["train_s"], "eval_s": tm["eval_s"],
                "write_s": tm["write_s"], "total_s": tm["total_s"],
                "eval_s_per_eval": tm["eval_s"] / evals,
                "train_img_s": imgs / tm["train_s"],
                "total_img_s": imgs / tm["total_s"]})

        check(file_sets[True] == file_sets[False], "adaptive_cli: "
              "--stacked-tails wrote %s, the serial run %s"
              % (file_sets[True], file_sets[False]))

        def desc_vs_plain(root, expt):
            """The tree's final descriptor files (written through the
            kernel) against net_desc of its net.npy through mcm_ref,
            serially: the largest difference and where."""
            tau_fn = registry[expt].tau
            net, params, state, extra = read_net(
                os.path.join(root, expt, "net.npy"), device)
            worst, worst_at = 0.0, None
            with mock.patch.object(kernels, "fused_mcm", _plain_stage):
                for i, k_cpt in enumerate(k_cpts):
                    plain = net_desc(net, ds, params, state,
                                     batch_size=TRAIN_BATCH,
                                     tau=tau_fn(extra["t"] - 1), k_cpt=k_cpt)
                    written = np.load(os.path.join(root, expt,
                                                   "%.4i-stats.npy" % i),
                                      allow_pickle=True)[()]
                    a, b = _scalar_stats(written), _scalar_stats(plain)
                    check([p for p, _ in a] == [p for p, _ in b],
                          "adaptive_cli: descriptor schemas differ")
                    for (p, x), (_, y) in zip(a, b):
                        e = abs(x - y) / max(1.0, abs(y))
                        if e >= worst:
                            worst, worst_at = e, "k_cpt %d %s" % (i, p)
            check(worst <= DESC_TOL, "adaptive_cli %s: the descriptor files "
                  "and net_desc through mcm_ref differ by %g at %s"
                  % (root, worst, worst_at))
            return {"max_err": worst, "at": worst_at, "tolerance": DESC_TOL}

        desc = desc_vs_plain(roots[False], ADAPTIVE_RUNS[1][0])
        desc_stacked = desc_vs_plain(roots[True], ADAPTIVE_STACKED_RUN[0])
    return {"batch": TRAIN_BATCH, "precision": "fp32", "runs": records,
            "fused_mcm_launches": launches, "desc_kernel_vs_plain": desc,
            "stacked_desc_kernel_vs_plain": desc_stacked,
            "stacked_file_set": "the serial run's (%d files)"
                                % len(file_sets[True])}


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA GPU")
    sys.path.insert(0, HERE)
    import mpnn_tpu_torch  # noqa: F401 -- fails where the port is absent
    from mpnn_tpu_torch.kernel_bench import bound, nvidia_smi
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = nvidia_smi()
    print(smi, flush=True)
    phase("device", kind=torch.cuda.get_device_name(0),
          count=torch.cuda.device_count(), torch=torch.__version__,
          cuda=torch.version.cuda, nvidia_smi=smi)

    # 2. build
    from mpnn_tpu_torch.ops import _build
    cached = _build.library_path().exists()
    t = time.perf_counter()
    _build.load()
    phase("build", build_s=round(time.perf_counter() - t, 3), cached=cached,
          library=os.path.relpath(str(_build.library_path()), HERE))

    # 3. the kernel's gradient
    phase("grad", **grad_phase(device))

    # 4. kernel against its plain version, stage by stage; then its net
    # axis, the stages of a sweep's nets in one launch per scale.
    rows = kernel_phase(device)
    net_rows = kernel_nets_phase(device)
    tail_rows = kernel_tails_phase(device)

    # 5. serve; the bf16 serving inside it is the main path, whose
    # launches are counted from 0.
    caps, records, launches, drift = serve_phase(device)
    check(launches > 0, "fused_mcm was not launched while serving")
    phase("serve_bf16", batch=BATCH, calibrated_capacities=caps,
          bf16_kernel_vs_plain=drift, records=records,
          fused_mcm_launches=launches)

    # 6. train: the kernel against mcm_ref for one step, then the training
    # main path in each precision, its launches counted from 0.
    phase("train_fp32_vs_plain", **train_vs_plain_phase(device))
    phase("train_bf16_vs_fp32", **train_bf16_vs_fp32_phase(device))
    train = {dt: train_phase(device, dt) for dt in ("fp32", "bf16")}
    for dt, rec in train.items():
        phase("train_" + dt, **rec)

    # 7. the sweep: one step through the net axis against mcm_ref, then
    # the sweep's training main path in each precision, its launches
    # counted from 0, beside the same call's single-net rate.
    phase("sweep_fp32_vs_plain", **sweep_vs_plain_phase(device))
    sweep = {dt: sweep_train_phase(device, dt, train[dt])
             for dt in ("fp32", "bf16")}
    sweep["bf16"]["bf16_vs_fp32"] = sweep_bf16_vs_fp32(device)
    for dt, rec in sweep.items():
        phase("sweep_train_" + dt, **rec)

    # 7b. the 47-stage actor tree: one fp32 step against mcm_ref, its
    # training main path in each precision beside the chain's rate, then the
    # sweep of 8 trees; each path's launches counted from 0.
    phase("tree_train_fp32_vs_plain",
          **train_vs_plain_phase(device, "tree"))
    tree_train = {dt: train_phase(device, dt, "tree")
                  for dt in ("fp32", "bf16")}
    for dt, rec in tree_train.items():
        phase("tree_train_" + dt, chain_value=train[dt]["value"], **rec)
    tree_sweep_check = sweep_vs_plain_phase(device, "tree")
    tree_sweep = {dt: sweep_train_phase(device, dt, tree_train[dt], "tree")
                  for dt in ("fp32", "bf16")}
    phase("tree_sweep_train_fp32", vs_plain=tree_sweep_check,
          **tree_sweep["fp32"])
    phase("tree_sweep_train_bf16", **tree_sweep["bf16"])

    # 7c. the tree with stacked tails (ops.config.stacked_tails): one fp32
    # step against the serial step and against mcm_ref, its training main
    # path in each precision beside the serial tree's of 7b, then the
    # sweep of 8 trees (its tails a vmap inside the sweep's); each path's
    # launches counted from 0.
    phase("tree_stacked_vs_serial", **tree_stacked_vs_serial_phase(device))
    tree_stacked = {dt: train_phase(device, dt, "tree", stacked=True)
                    for dt in ("fp32", "bf16")}
    for dt, rec in tree_stacked.items():
        serial = tree_train[dt]
        phase("tree_stacked_train_" + dt, serial_value=serial["value"],
              serial_window_values=serial["window_values"],
              serial_profile=serial["profile"],
              vs_serial=rec["value"] / serial["value"], **rec)
    stacked_sweep_check = sweep_vs_plain_phase(device, "tree", stacked=True)
    tree_sweep_stacked = sweep_train_phase(device, "fp32", tree_train["fp32"],
                                           "tree", stacked=True)
    phase("tree_sweep_stacked", vs_plain=stacked_sweep_check,
          serial_sweep_value=tree_sweep["fp32"]["value"],
          serial_sweep_window_values=tree_sweep["fp32"]["window_values"],
          serial_sweep_profile=tree_sweep["fp32"]["profile"],
          vs_serial_sweep=(tree_sweep_stacked["value"]
                           / tree_sweep["fp32"]["value"]),
          **tree_sweep_stacked)

    # 7d. routed serving of the trained adaptive tree (its bf16 serving
    # counted from 0), and its descriptors beside its training's files.
    serve_tree, tree = tree_serve_phase(device)
    phase("tree_serve", **serve_tree)
    phase("tree_desc_vs_jax_files", **tree_desc_phase(device, tree))
    del tree

    # 8. the training CLI's path, serial and --vmap-sweep, its launches
    # counted from 0.
    cli = train_cli_phase(device)
    phase("train_cli", **cli)

    # 9. the adaptive trainer's CLI, in processes of its own.
    adaptive = adaptive_cli_phase(device)
    phase("adaptive_cli", **adaptive)
    tree_cli = {r["run"]: r["launches"] for r in cli["runs"] + cli[
        "sweep_runs"] if "-tree" in r["run"]}

    bf = [r for r in rows if r["dtype"] == "bf16" and r["batch"] == BATCH]
    bound_ms, bound_by = bound(sum(r["bytes"] for r in bf),
                               sum(r["flops"] for r in bf), "bf16")
    f32 = [r for r in rows if r["dtype"] == "fp32" and r["batch"] == BATCH]
    f32_bound_ms, f32_bound_by = bound(sum(r["bytes"] for r in f32),
                                       sum(r["flops"] for r in f32), "fp32")
    nb = [r for r in net_rows if r["dtype"] == "bf16"]
    nb_bound_ms, nb_bound_by = bound(sum(r["bytes"] for r in nb),
                                     sum(r["flops"] for r in nb), "bf16")
    print(json.dumps({"kernels": [{
        "name": "fused_mcm",
        "route": "cuda",
        "source": "mpnn_tpu_torch/ops/csrc/fused_mcm.cu",
        "replaces": "mpnn_tpu/ops/kernels.py:125",
        "launches": launches,
        "train_launches": {dt: r["fused_mcm_launches"]
                           for dt, r in train.items()},
        "train_cli_launches": {"total": cli["fused_mcm_launches"],
                               **{r["run"]: r["launches"]
                                  for r in cli["runs"]}},
        "tree_launches": {"tree_train_bf16":
                          tree_train["bf16"]["fused_mcm_launches"],
                          "tree_serve": serve_tree["fused_mcm_launches"]},
        "dtype": "bf16",
        "work": "the eight flagship stages, batch %d, one call each"
                % BATCH,
        "max_abs_err": max(r["max_abs_err"] for r in bf),
        "ms": sum(r["ms"] for r in bf),
        "plain_ms": sum(r["plain_ms"] for r in bf),
        "timing": "ms, plain_ms and library_ms: CUDA events around one call "
                  "from Python (median of 25), host work included; "
                  "*device_ms: device time, CUDA graphs of 10 calls "
                  "replayed between CUDA events",
        "device_ms": sum(r["device_ms"] for r in bf),
        "plain_device_ms": sum(r["plain_device_ms"] for r in bf),
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": sum(r["cudnn_conv_sequence_ms"] for r in bf),
        "library_device_ms": sum(r["cudnn_conv_sequence_device_ms"]
                                 for r in bf),
        "library_call": "the cuDNN conv2d sequence mcm_ref makes "
                        "(2L-1 convs per stage, pools precomputed)",
        "design": "bf16: mma.sync m16n8k16 implicit GEMM, BM=64 pixels x "
                  "BN=16-128 channels a block, one tap x 16 channels a K "
                  "step, three K steps staged in shared memory per "
                  "barrier, one launch per output scale; fp32: the entry "
                  "'fused_mcm, fp32'",
        "stages": rows,
    }, {
        "name": "fused_mcm, fp32",
        "route": "cuda",
        "source": "mpnn_tpu_torch/ops/csrc/fused_mcm.cu",
        "replaces": "mpnn_tpu/ops/kernels.py:125",
        "entry": "mcm_scale_forward and mcm_scale_forward_nets, dtype 0 "
                 "(mcm_scale_tf32)",
        "launches": train["fp32"]["fused_mcm_launches"],
        "launches_on": "the fp32 training main path (train_fp32), counted "
                       "from 0",
        "sweep_launches": sweep["fp32"]["fused_mcm_net_launches"],
        "tree_launches": {"tree_train_fp32":
                          tree_train["fp32"]["fused_mcm_launches"],
                          "adaptive_cli": adaptive["fused_mcm_launches"],
                          **tree_cli},
        "dtype": "fp32",
        "work": "the eight flagship stages, batch %d, one call each" % BATCH,
        "max_abs_err": max(r["max_abs_err"] for r in f32),
        "max_rel_err_vs_f64": max(r["rel_err_vs_f64"] for r in rows
                                  if "rel_err_vs_f64" in r),
        "ms": sum(r["ms"] for r in f32),
        "plain_ms": sum(r["plain_ms"] for r in f32),
        "timing": "as the bf16 entry's",
        "device_ms": sum(r["device_ms"] for r in f32),
        "plain_device_ms": sum(r["plain_device_ms"] for r in f32),
        "bound_ms": f32_bound_ms,
        "bound_by": f32_bound_by.split()[0],
        "bound_rate": "3xTF32: 3 x FLOPs / 495 TFLOP/s",
        "library_ms": sum(r["cudnn_conv_sequence_ms"] for r in f32),
        "library_device_ms": sum(r["cudnn_conv_sequence_device_ms"]
                                 for r in f32),
        "library_call": "the cuDNN conv2d sequence mcm_ref makes, TF32 off",
        "design": "3xTF32 mma.sync m16n8k8 implicit GEMM (hi/lo split, "
                  "three products, fp32 totals every 8 mma steps); a "
                  "block of 128 pixels (64 for 128 channels) x 16-128 "
                  "channels; chunks of 8 channels x 9 taps, each chunk's "
                  "halo patch and B tiles through a 3-slot cp.async ring, "
                  "the patch split once and read by all 9 taps; one "
                  "launch per output scale",
    }, {
        "name": "fused_mcm, net axis",
        "route": "cuda",
        "source": "mpnn_tpu_torch/ops/csrc/fused_mcm.cu",
        "replaces": "mpnn_tpu/ops/kernels.py:125",
        "entry": "mcm_scale_forward_nets",
        "launches": sweep["bf16"]["fused_mcm_net_launches"],
        "sweep_launches": {dt: r["fused_mcm_net_launches"]
                           for dt, r in sweep.items()},
        "train_cli_sweep_launches": {r["run"]: r["launches"]
                                     for r in cli["sweep_runs"]},
        "tree_sweep_launches": {dt: r["fused_mcm_net_launches"]
                                for dt, r in tree_sweep.items()},
        "tree_stacked_launches": {
            dt: {"launches": r["fused_mcm_launches"],
                 "net_launches": r["fused_mcm_net_launches"],
                 "steps": r["steps"]} for dt, r in tree_stacked.items()},
        "tree_sweep_stacked_launches": {
            "fp32": tree_sweep_stacked["fused_mcm_net_launches"],
            "steps": tree_sweep_stacked["steps"]},
        "tail_stages": [tail_summary(tail_rows, n, dt)
                        for n, dtypes in TAIL_NETS.items() for dt in dtypes],
        "dtype": "bf16",
        "work": "the eight flagship stages for %d nets x batch %d, stage "
                "0's input shared, one call each" % (N_NETS, TRAIN_BATCH),
        "max_abs_err": max(r["max_abs_err"] for r in nb),
        "ms": sum(r["ms"] for r in nb),
        "plain_ms": sum(r["plain_ms"] for r in nb),
        "timing": "as above; each call is torch.func.vmap of the stage "
                  "over the nets, as the sweep calls it",
        "device_ms": sum(r["device_ms"] for r in nb),
        "plain_device_ms": sum(r["plain_device_ms"] for r in nb),
        "bound_ms": nb_bound_ms,
        "bound_by": nb_bound_by,
        "library_ms": sum(r["library_ms"] for r in nb),
        "library_device_ms": sum(r["library_device_ms"] for r in nb),
        "library_call": "mcm_ref under torch.func.vmap over the nets "
                        "(cuDNN's grouped convs)",
        "plain": "mcm_ref on each net's slice, one net after another",
        "stages": net_rows,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
