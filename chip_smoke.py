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
              channels 3, 4 and 24), and
              stages 4-7 at batch 32 (the routed engine's deep buffers) are
              checked and timed in bf16. Each bf16 stage's error against
              mcm_ref run in fp32 on the same bf16-valued inputs is printed
              (not a gate).
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
              train_fp32 and train_bf16 then each take 5 timed
              windows of 20 steps (img/s, median and every window; the
              loss finite at each window's end); the kernel's count is set
              to 0 before each and must read 20 per step after it. bf16
              also prints the kernel path's first-step loss against the
              mcm_ref path's (not a gate).
              The kernel phase holds and times the eight stages at the
              training batch 128 too, fp32 and bf16.
7. train_cli -- the training CLI's path (`train.train_experiment`, as
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
              is printed). Prints each run's seconds and img/s over
              training alone and over training, evaluation and writes.

Then one {"kernels": [...]} line (with the training main paths' launches
in `train_launches` and the CLI path's in `train_cli_launches`), and last
the device record. Any failed
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
            ("synth-sr", 7, 20, False), ("synth-cr", 4, 20, False)]
DESC_TOL = 1e-4  # kernel vs mcm_ref net_desc, per scalar stat
N_SERVE = 20  # batches per timed serving window
N_WINDOWS = 5  # timed serving windows per capacity
MARGIN_TIE = 1e-3  # router top-2 logit margin below which exits may differ
MARGIN_BF16 = 1e-2  # the margin reported for bf16 kernel vs plain exits


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

    # Shapes off the flagship's path, checked only: widths that are not a
    # multiple of the fp32 kernel's 4-pixel step (6, 3) with an odd batch;
    # output widths that are not a multiple of the bf16 kernel's 8-wide
    # mma tiles (12, 20) or wider than one 128-channel block (160); input
    # channel counts read one value at a time (4, 3) or as vectors (8, 24).
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
    rows = []
    for dt, torch_dt in DTYPES.items():
        config.set_compute_dtype(torch_dt)
        try:
            for label, (xs, whs, wvs, bs, _) in odd:
                compare(label, [x.to(torch_dt) for x in xs], whs, wvs, bs,
                        dt)
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
                # Timed on weights already in the compute dtype, so the
                # times hold compute only (the casts are then no-ops).
                row.update(stage_times(xin, whs, wvs, bs))
                row["bound_ms"], row["bound_by"] = bound(n_bytes, flops, dt)
                rows.append(row)
        finally:
            config.set_compute_dtype(None)
    for dt, B in (("fp32", BATCH), ("bf16", BATCH), ("fp32", TRAIN_BATCH),
                  ("bf16", TRAIN_BATCH), ("bf16", ROUTED_BATCH)):
        phase("kernel", dtype=dt, batch=B, stages=[
            {k: r[k] for k in ("stage", "shape", "c_out", "max_abs_err",
                               "rel_err_vs_fp32_ref", "ms", "plain_ms",
                               "cudnn_conv_sequence_ms", "device_ms",
                               "plain_device_ms",
                               "cudnn_conv_sequence_device_ms", "bound_ms",
                               "bound_by") if k in r}
            for r in rows if r["dtype"] == dt and r["batch"] == B])
    return rows


def chain_margins(net, params, state, x0):
    """Top-2 router logit margin at every switch of the chain, per example,
    from a dense pass (every stage on the whole batch)."""
    from mpnn_tpu_torch.models.infer import chain_stages
    from mpnn_tpu_torch.models.net import Ctx
    ctx = Ctx(train=False, k_cpt=net.hypers.k_cpt)
    margins = []
    act, p, s = x0, params, state
    with torch.inference_mode():
        for node, leaf, nxt in chain_stages(net):
            o, _ = net._apply_one(node, p, s, act, None, ctx)
            act = o["x"]
            if leaf is not None:
                top2 = torch.topk(o["router_x"], 2, dim=1).values
                margins.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
            if nxt is not None:
                i = node.sinks.index(nxt)
                p, s = p["sinks"][i], s["sinks"][i]
    return np.stack(margins, axis=1)  # (B, n_switches)


def serve(net, params, state, x0, cap, reference=False):
    from mpnn_tpu_torch.models.infer import make_routed_infer_fn
    from mpnn_tpu_torch.ops import kernels
    infer = make_routed_infer_fn(net, x0.shape[0], capacities=cap)
    if not reference:
        out = infer(params, state, x0)
    else:
        def plain(xs, whs, wvs, bs, supp):
            return kernels.mcm_ref(xs, whs, wvs, bs)
        with mock.patch.object(kernels, "fused_mcm", plain):
            out = infer(params, state, x0)
    return {k: v.cpu().numpy() for k, v in out.items()}


def compare_fp32(label, net, params, state, x0, cap, margins):
    """Kernel path against the mcm_ref path, both on the GPU in fp32."""
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    launches0 = fused_mcm.launches
    k = serve(net, params, state, x0, cap)
    check(fused_mcm.launches > launches0,
          "%s: kernel path did not launch" % label)
    r = serve(net, params, state, x0, cap, reference=True)
    n_sw = margins.shape[1]
    # An example's deciding routers: every switch up to the one it left by.
    depth = np.minimum(r["exit_idx"], n_sw - 1)
    visited = np.arange(n_sw)[None, :] <= depth[:, None]
    near_tie = (visited & (margins < MARGIN_TIE)).any(axis=1)
    same_exit = k["exit_idx"] == r["exit_idx"]
    prob_err = float(np.abs(k["probs"] - r["probs"])[same_exit].max())
    mismatch = ~(same_exit & (k["ops"] == r["ops"]))
    check(not (mismatch & ~near_tie).any(),
          "%s: exit_idx/ops differ on %d examples with router margin >= %g"
          % (label, int((mismatch & ~near_tie).sum()), MARGIN_TIE))
    check(prob_err <= 1e-4, "%s: probs differ by %g > 1e-4"
          % (label, prob_err))
    forced_diff = int(np.abs(k["forced"] - r["forced"]).sum())
    check(forced_diff <= int(near_tie.sum()),
          "%s: forced differs by %d" % (label, forced_diff))
    return {"capacity": cap, "max_prob_err": prob_err,
            "near_tie_examples": int(near_tie.sum()),
            "exit_mismatches": int(mismatch.sum()),
            "forced": k["forced"].tolist(), "forced_ref": r["forced"].tolist(),
            "exit_hist": np.bincount(k["exit_idx"],
                                     minlength=len(list(net.leaves))).tolist()}


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
    margins = chain_margins(net, params, state, x0)
    fp32 = [compare_fp32("fp32 capacity %s" % cap, net, params, state, x0,
                         cap, margins)
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
    margins = chain_margins(net, params, state, x0)
    k = serve(net, params, state, x0, 1.0)
    r = serve(net, params, state, x0, 1.0, reference=True)
    n_sw = margins.shape[1]
    depth = np.minimum(np.minimum(k["exit_idx"], r["exit_idx"]), n_sw - 1)
    visited = np.arange(n_sw)[None, :] <= depth[:, None]
    near_tie = (visited & (margins < MARGIN_BF16)).any(axis=1)
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
    with mock.patch.object(kernels, "fused_mcm", stage or counter):
        n0 = counter.launches
        gen = torch.Generator(device=data[0].device).manual_seed(0)
        xb, yb, ctx = batch_ctx(0, gen, *data, None)
        loss, _, _, grads = loss_and_grads(params, state, xb, yb, ctx)
        n1 = counter.launches
        gen = torch.Generator(device=data[0].device).manual_seed(0)
        params, state, vel, _ = step(params, state, vel, 0, gen, *data)
        torch.cuda.synchronize()
        n2 = counter.launches
    return {"loss": float(loss), "grads": grads, "params": params,
            "state": state, "launches": (n1 - n0, n2 - n1)}


def train_vs_plain_phase(device):
    """One fp32 step through the kernel against the same through mcm_ref."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.ops import config
    config.set_compute_dtype(None)
    net, params, state, vel = train_bench.build(0, device)
    data = train_bench.train_data(net, device)
    k = train_once(net, params, state, vel, data)
    r = train_once(net, params, state, vel, data, _plain_stage)
    f64 = train_once(net, params, state, vel, data, _float64_stage)
    per_fwd = sum(len(a) for a in arch)
    check(k["launches"] == (per_fwd, per_fwd) and r["launches"] == (0, 0),
          "train: kernel launches per forward %s, expected %d (plain path "
          "%s)" % (k["launches"], per_fwd, r["launches"]))
    loss_err = abs(k["loss"] - r["loss"]) / abs(r["loss"])
    zero = zero_grad_paths(net)
    errs = {"gradient": tree_errs(k["grads"], r["grads"], zero),
            "parameter": tree_errs(k["params"], r["params"], zero),
            "BatchNorm statistic": tree_errs(k["state"], r["state"])}
    # Not a gate: the same comparison for a float64 stage, which rounds
    # differently from the plain path without being wrong.
    baseline = {"loss_rel_err": abs(f64["loss"] - r["loss"]) / abs(r["loss"]),
                "gradient": tree_errs(f64["grads"], r["grads"], zero),
                "parameter": tree_errs(f64["params"], r["params"], zero)}
    check(loss_err <= TRAIN_TOL["loss"], "train: loss %g vs %g"
          % (k["loss"], r["loss"]))
    check(errs["BatchNorm statistic"]["leaf"] <= TRAIN_TOL["state"],
          "train: BatchNorm statistic error %g > %g"
          % (errs["BatchNorm statistic"]["leaf"], TRAIN_TOL["state"]))
    for name in ("gradient", "parameter"):
        for key in ("tree", "leaf", "zero_grad"):
            check(errs[name][key] <= TRAIN_TOL[key], "train: %s %s error "
                  "%g > %g (worst leaf %s)" % (name, key, errs[name][key],
                                               TRAIN_TOL[key],
                                               errs[name]["worst_leaf"]))
    return {"batch": TRAIN_BATCH, "loss": k["loss"], "loss_plain": r["loss"],
            "loss_rel_err": loss_err, "errors": errs, "tolerances": TRAIN_TOL,
            "float64_stage_vs_plain": baseline,
            "n_leaves": len(_leaves(k["grads"])),
            "launches_per_forward": per_fwd}


def train_phase(device, precision):
    """The training main path in one precision: a warm-up step and timed
    windows of N_TRAIN_STEPS steps, the kernel's count from 0."""
    from mpnn_tpu_torch import train_bench
    from mpnn_tpu_torch.experiments import arch, λ_lrn, τ_ds
    from mpnn_tpu_torch.models.steps import Schedules, make_train_step
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm
    config.set_compute_dtype(DTYPES[precision])
    try:
        net, params, state, vel = train_bench.build(0, device)
        data = train_bench.train_data(net, device)
        extra = {}
        if precision == "bf16":
            r = train_once(net, params, state, vel, data, _plain_stage)
            extra["bf16_first_loss_plain"] = r["loss"]
        step = make_train_step(net, TRAIN_BATCH,
                               Schedules(lr=λ_lrn, tau=τ_ds))
        gen = torch.Generator(device=device).manual_seed(0)
        # The main path: the kernel's count starts from 0 here and is read
        # just after the last step.
        fused_mcm.launches = 0
        params, state, vel, c = step(params, state, vel, 0, gen, *data)
        loss_first, t = float(c), 0
        rates, losses = [], []
        for _ in range(N_WINDOWS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(N_TRAIN_STEPS):
                t += 1
                params, state, vel, c = step(params, state, vel, t, gen,
                                             *data)
            torch.cuda.synchronize()
            rates.append(N_TRAIN_STEPS * TRAIN_BATCH
                         / (time.perf_counter() - t0))
            losses.append(float(c))
        launches = fused_mcm.launches
    finally:
        config.set_compute_dtype(None)
    check(all(np.isfinite(losses)) and np.isfinite(loss_first),
          "train %s: loss not finite: %s" % (precision, losses))
    n_steps = 1 + N_WINDOWS * N_TRAIN_STEPS
    per_fwd = sum(len(a) for a in arch)
    check(launches == per_fwd * n_steps, "train %s: %d launches in %d "
          "steps, expected %d a step" % (precision, launches, n_steps,
                                         per_fwd))
    if precision == "bf16":
        extra["bf16_first_loss_kernel"] = loss_first
    return {"batch": TRAIN_BATCH, "metric": "train-step (%s, batch %d)"
            % (precision, TRAIN_BATCH), "value": statistics.median(rates),
            "unit": "images/sec", "window_values": rates,
            "window_steps": N_TRAIN_STEPS, "loss_first": loss_first,
            "loss_window_ends": losses, "fused_mcm_launches": launches,
            "steps": n_steps, **extra}


def mcm_launches_per_forward(net):
    """fused_mcm launches of one forward of `net`: one per output scale of
    every MultiscaleConvMax that takes the kernel."""
    from mpnn_tpu_torch.ops.layers import MultiscaleConvMax
    return sum(c._L for node in net.layers for c in node.comps
               if isinstance(c, MultiscaleConvMax) and c._kernel_eligible())


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
    from mpnn_tpu_torch.utils.tree import tree_map

    config.set_compute_dtype(None)
    registry = make_experiments()
    live = []
    original = cli.train_one_net

    def keep(*args, **kwargs):
        out = original(*args, **kwargs)
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
            "prep_s": prep_s, "runs": records, "fused_mcm_launches": launches,
            "desc_kernel_vs_plain": {"max_err": worst, "at": worst_path,
                                     "n_stats": len(diffs),
                                     "tolerance": DESC_TOL}}


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

    # 4. kernel against its plain version, stage by stage
    rows = kernel_phase(device)

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
    train = {dt: train_phase(device, dt) for dt in ("fp32", "bf16")}
    for dt, rec in train.items():
        phase("train_" + dt, **rec)

    # 7. the training CLI's path, its launches counted from 0.
    cli = train_cli_phase(device)
    phase("train_cli", **cli)

    bf = [r for r in rows if r["dtype"] == "bf16" and r["batch"] == BATCH]
    bound_ms, bound_by = bound(sum(r["bytes"] for r in bf),
                               sum(r["flops"] for r in bf), "bf16")
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
                  "barrier, one launch per output scale; fp32: FP32-pipe "
                  "4x4 register tile",
        "stages": rows,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
