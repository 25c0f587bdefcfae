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

Then one {"kernels": [...]} line, and last the device record. Any failed
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
GRAD_BATCH = 64
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
    deep = list(enumerate(stage_inputs(arch, ROUTED_BATCH, 32, seed=1,
                                       device=device)))[4:]
    runs = ([(dt, BATCH, i, st) for dt in DTYPES for i, st in stages]
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
    for dt, B in (("fp32", BATCH), ("bf16", BATCH), ("bf16", ROUTED_BATCH)):
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

    bf = [r for r in rows if r["dtype"] == "bf16" and r["batch"] == BATCH]
    bound_ms, bound_by = bound(sum(r["bytes"] for r in bf),
                               sum(r["flops"] for r in bf), "bf16")
    print(json.dumps({"kernels": [{
        "name": "fused_mcm",
        "route": "cuda",
        "source": "mpnn_tpu_torch/ops/csrc/fused_mcm.cu",
        "replaces": "mpnn_tpu/ops/kernels.py:125",
        "launches": launches,
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
