#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mpnn_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each reported as one JSON line {"phase", "ok", "elapsed_s", ...}:

1. device  -- needs torch.cuda; prints the nvidia-smi name/power-limit line.
2. build   -- builds the fused_mcm CUDA kernel with nvcc (ctypes-bound).
3. kernel  -- for each of the flagship's eight MultiscaleConvMax stage
              shapes at the serving batch, holds the kernel against its
              plain version mcm_ref in fp32 (TF32 off; max abs error <=
              1e-4 * max|ref|) and bf16 (<= 2e-2 * max|ref|), and times the
              kernel, mcm_ref and the cuDNN conv sequence mcm_ref makes;
              one ragged shape (widths 12/6/3, batch 7) is checked too.
4. serve   -- reads the trained flagship checkpoint onto the GPU and runs
              routed inference (the port's main path) at capacity 1.0 and at
              calibrated capacities: first in fp32, kernel path against the
              same net through mcm_ref, then in bf16 (the main path) over
              5 timed windows of 20 batches per capacity, with img/s (median
              and spread of the windows) and mean realized ops per example.
              The kernel's launch count is set to 0 just before the bf16
              serving and read just after; it must have risen.

Then one {"kernels": [...]} line, and last the device record. Any failed
phase raises and the script exits non-zero; it also exits non-zero, with no
result, where CUDA is absent or the port's package is not beside it."""

import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

T0 = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s per type.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"fp32": 67e12, "bf16": 989e12}
TOL = {"fp32": 1e-4, "bf16": 2e-2}  # max abs error / max|ref|
DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}
CHECKPOINT = os.path.join(HERE, "results", "nets", "hybrid-ac", "0004.npy")
BATCH = 1024  # the serving batch, also the kernel check's batch
N_TIMED = 25
N_SERVE = 20  # batches per timed serving window
N_WINDOWS = 5  # timed serving windows per capacity
MARGIN_TIE = 1e-3  # router top-2 logit margin below which exits may differ


def phase(name, ok=True, **fields):
    print(json.dumps({"phase": name, "ok": ok,
                      "elapsed_s": round(time.perf_counter() - T0, 3),
                      **fields}), flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def time_ms(fn, n=N_TIMED):
    """Median device time of fn() in ms, by CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def stage_inputs(arch, B, x_hw, seed, device, c_in=3):
    """Per stage of `arch`: (pyramid input, whs, wvs, bs, n_ops) at batch B,
    from a seeded numpy generator. Stage i's input pyramid is the shape of
    stage i-1's output."""
    from mpnn_tpu_torch.ops.layers import MultiscaleConvMax
    rng = np.random.RandomState(seed)
    shapes = [(x_hw // 2 ** i, x_hw // 2 ** i, c_in)
              for i in range(len(arch[0]))]
    stages = []
    for n_chan in arch:
        mcm = MultiscaleConvMax(n_chan=n_chan, supp=3)
        mcm.build(shapes)
        check(mcm._kernel_eligible(), "stage %s not kernel-eligible" % n_chan)
        kept = shapes[len(shapes) - len(n_chan):]

        def arr(shape, scale):
            a = (rng.standard_normal(shape) * scale).astype(np.float32)
            return torch.as_tensor(a, device=device)

        xs = [torch.relu(arr((B,) + tuple(s), 1.0)).contiguous()
              for s in kept]
        whs = [arr(s, 1.0 / 3 / np.sqrt(s[2])) for s in mcm._w_horz_shapes]
        wvs = [arr(s, 1.0 / 3 / np.sqrt(s[2])) for s in mcm._w_vert_shapes]
        bs = [arr((c,), 0.1) for c in n_chan]
        stages.append((xs, whs, wvs, bs, mcm.n_ops))
        shapes = mcm.out_shape
    return stages


def stage_cost(xs, whs, wvs, bs, n_ops, B, dt):
    """(bytes, flops) the stage must move and compute: each input read once,
    each output written once."""
    esize = 4 if dt == "fp32" else 2
    n_in = sum(x.numel() for x in xs) + sum(w.numel() for w in whs + wvs)
    n_out = sum(x.shape[0] * x.shape[1] * x.shape[2] * w.shape[-1]
                for x, w in zip(xs, whs))
    n_bytes = esize * (n_in + n_out) + 4 * sum(b.numel() for b in bs)
    return n_bytes, 2.0 * n_ops * B


def conv_sequence(xs, whs, wvs, pooled):
    """The cuDNN conv calls mcm_ref makes (pools precomputed)."""
    from mpnn_tpu_torch.ops.layers import conv_same
    outs = [conv_same(xs[0], whs[0])]
    for j in range(1, len(whs)):
        outs.append(conv_same(xs[j], whs[j]) + conv_same(pooled[j - 1],
                                                         wvs[j - 1]))
    return outs


def kernel_phase(device):
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.ops.kernels import fused_mcm, mcm_ref
    from mpnn_tpu_torch.ops.layers import _pool2

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
        return ref, err, scale

    B = BATCH
    stages = stage_inputs(arch, B, 32, seed=1, device=device)
    # Widths that are not a multiple of the kernel's 4-pixel step (6, 3),
    # vector input channels (8) and an odd batch, checked only.
    ragged = stage_inputs([[8, 8, 8]], 7, 12, seed=2, device=device,
                          c_in=8)[0]
    rows = []
    for dt, torch_dt in DTYPES.items():
        config.set_compute_dtype(torch_dt)
        try:
            xs, whs, wvs, bs, _ = ragged
            compare("ragged 12/6/3 stage", [x.to(torch_dt) for x in xs],
                    whs, wvs, bs, dt)
            for i, (xs, whs, wvs, bs, n_ops) in enumerate(stages):
                xin = [x.to(torch_dt) for x in xs]
                ref, err, scale = compare("stage %d" % i, xin, whs, wvs, bs,
                                          dt)
                # Timed on weights already in the compute dtype, so the
                # times hold compute only (the casts are then no-ops).
                pooled = [_pool2(r) for r in ref[:-1]]
                wc = [w.to(torch_dt) for w in whs]
                vc = [w.to(torch_dt) for w in wvs]
                n_bytes, flops = stage_cost(xin, whs, wvs, bs, n_ops, B, dt)
                t_bytes = n_bytes / PEAK_BYTES_S * 1e3
                t_ops = flops / PEAK_FLOPS[dt] * 1e3
                rows.append({
                    "stage": i, "dtype": dt,
                    "shape": [list(x.shape[1:]) for x in xs],
                    "c_out": [int(w.shape[-1]) for w in whs],
                    "max_abs_err": err, "max_abs_ref": scale,
                    "ms": time_ms(lambda: fused_mcm(xin, wc, vc, bs, 3)),
                    "plain_ms": time_ms(lambda: mcm_ref(xin, wc, vc, bs)),
                    "cudnn_conv_sequence_ms": time_ms(
                        lambda: conv_sequence(xin, wc, vc, pooled)),
                    "bytes": n_bytes, "flops": flops,
                    "bound_ms": max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                })
        finally:
            config.set_compute_dtype(None)
    for dt in DTYPES:
        phase("kernel", dtype=dt, batch=B, stages=[
            {k: r[k] for k in ("stage", "shape", "c_out", "max_abs_err",
                               "ms", "plain_ms", "cudnn_conv_sequence_ms",
                               "bound_ms", "bound_by")}
            for r in rows if r["dtype"] == dt])
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
    return caps_bf16, records, launches


def main():
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke test needs a CUDA GPU")
    sys.path.insert(0, HERE)
    import mpnn_tpu_torch  # noqa: F401 -- fails where the port is absent
    device = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
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

    # 3. kernel against its plain version, stage by stage
    rows = kernel_phase(device)

    # 4. serve; the bf16 serving inside it is the main path, whose
    # launches are counted from 0.
    caps, records, launches = serve_phase(device)
    check(launches > 0, "fused_mcm was not launched while serving")
    phase("serve_bf16", batch=BATCH, calibrated_capacities=caps,
          records=records, fused_mcm_launches=launches)

    bf = [r for r in rows if r["dtype"] == "bf16"]
    tot_bytes = sum(r["bytes"] for r in bf) / PEAK_BYTES_S * 1e3
    tot_ops = sum(r["flops"] for r in bf) / PEAK_FLOPS["bf16"] * 1e3
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
        "bound_ms": max(tot_bytes, tot_ops),
        "bound_by": "bytes" if tot_bytes >= tot_ops else "operations",
        "library_ms": sum(r["cudnn_conv_sequence_ms"] for r in bf),
        "library_call": "the cuDNN conv2d sequence mcm_ref makes "
                        "(2L-1 convs per stage, pools precomputed)",
        "stages": rows,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
