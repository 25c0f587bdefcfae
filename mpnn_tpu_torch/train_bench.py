"""Training benchmark: images/sec of the single-net train step of the
flagship actor chain (the per-net workload of `bench.py`).

Builds `ac_chain(k_cpt=k_cpts[4])` on 32x32x3 inputs with 10 classes fresh
from --seed (or reads --checkpoint), places a synthetic training split on
the device once, and takes one warm-up step, then --n-windows windows of
--n-steps steps of `make_train_step` at --batch-size: each step samples and
augments its batch on the device, runs the tree, the routing and the actor
loss, its gradients (the stage's backward goes through `mcm_ref`), TALR
and a momentum update. Prints one JSON line: `value` is the median of the
windows' rates, `window_values` each window's, with the loss at the first
and the last step and the fused_mcm launches per step.

With --profile DIR it then traces --n-steps more steps with
torch.profiler, writes the Chrome trace into DIR and prints a second JSON
line: the device time per step split into the fused_mcm forward, the
stage's backward through `mcm_ref`, the optimizer (TALR and momentum) and
the rest, the device operations per step, and the device's idle share.

Runs on CUDA unless --device cpu is given.

    python -m mpnn_tpu_torch.train_bench --precision bf16
"""

import json
import os
import statistics
import time
from argparse import ArgumentParser

import torch

# Autograd node of fused_mcm's backward, as the profiler names its range.
_MCM_BACKWARD = "_FusedMCMBackward"
TOP_KERNELS = 15  # device operations listed by time in the profile line


def build(seed=0, device="cuda", checkpoint=None):
    """(net, params, state, vel) of the flagship actor chain: fresh from
    `seed`, or read from `checkpoint` with zero velocities."""
    from .models.optim import momentum_init
    from .models.steps import init_training
    if checkpoint:
        from .utils.serdes import read_net
        net, params, state, _ = read_net(checkpoint, device)
        return net, params, state, momentum_init(params)
    from .experiments import ac_chain, k_cpts
    net = ac_chain(k_cpt=k_cpts[4])((32, 32, 3), (10,))
    return (net,) + init_training(net, seed, device)


def train_data(net, device, n_tr=1024, seed=0):
    """(x0_tr, y_tr, m_sym) of a synthetic split, on the device."""
    from .data import synth
    h, w, c = net.hypers.x0_shape
    ds = synth.make_synthetic(n_tr=n_tr, n_ts=1, h=h, w=w, c=c,
                              n_cls=int(net.hypers.y_shape[0]), seed=seed)
    return tuple(torch.as_tensor(ds[k], device=device)
                 for k in ("x0_tr", "y_tr", "m_sym"))


def step_split(prof, n_steps):
    """Device time per step (ms) by part, from a torch.profiler trace:
    fused_mcm's forward kernels (`mcm_scale_*`), everything its backward
    node launched, the kernels under the `optimizer` range, and the rest;
    with the device operations per step (kernels, copies and fills), the
    device's idle share over the traced window, and the operations that
    took the most device time."""
    events = prof.events()
    # Device operations; a record_function range also shows on the device
    # as an annotation spanning its kernels, which is not one of them.
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name != "optimizer"]
    total = sum(k.device_time_total for k in kernels)

    def under(name):
        return sum(e.device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and name in e.name and e.cpu_parent is None)

    fwd = sum(k.device_time_total for k in kernels
              if "mcm_scale_" in k.name)
    bwd = under(_MCM_BACKWARD)
    opt = under("optimizer")
    spans = sorted((k.time_range.start, k.time_range.end) for k in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:  # union of the kernels' intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    window = spans[-1][1] - spans[0][0] if spans else 0.0
    ms = 1e-3 / n_steps  # profiler times are in µs
    by_name = {}
    for k in kernels:
        t, n = by_name.get(k.name, (0.0, 0))
        by_name[k.name] = (t + k.device_time_total, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_KERNELS]
    return {"device_ms_per_step": total * ms,
            "fused_mcm_forward_ms": fwd * ms,
            "mcm_ref_backward_ms": bwd * ms,
            "optimizer_ms": opt * ms,
            "rest_ms": (total - fwd - bwd - opt) * ms,
            "device_ops_per_step": len(kernels) / n_steps,
            "window_ms_per_step": window * ms,
            "device_idle_share": 1.0 - busy / window if window else None,
            "top_device_ops": [{"name": name[:120], "ms_per_step": t * ms,
                                "per_step": n / n_steps}
                               for name, (t, n) in top]}


def main(argv=None):
    parser = ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", default=None,
                        help="nets/<expt>/<i>.npy chain-net checkpoint")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--batch-size", type=int, default=128)
    parser.add_argument("--n-steps", type=int, default=20,
                        help="train steps per timed window")
    parser.add_argument("--n-windows", type=int, default=5,
                        help="timed windows; the median is reported")
    parser.add_argument("--precision", choices=["fp32", "bf16"],
                        default="fp32")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="trace --n-steps more steps into DIR and "
                             "print the step's time split")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    args = parser.parse_args(argv)

    from . import resolve_device, synchronize
    from .experiments import λ_lrn, τ_ds
    from .models.steps import Schedules, make_train_step
    from .ops import config
    from .ops.kernels import fused_mcm

    device = resolve_device(args.device)
    if device.type == "cuda":
        # fp32 means fp32: no TF32 in cuDNN convs or cuBLAS matmuls.
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    config.set_compute_dtype(torch.bfloat16 if args.precision == "bf16"
                             else None)

    net, params, state, vel = build(args.seed, device, args.checkpoint)
    x0_tr, y_tr, m_sym = train_data(net, device, seed=args.seed)
    B = args.batch_size
    step = make_train_step(net, B, Schedules(lr=λ_lrn, tau=τ_ds))
    gen = torch.Generator(device).manual_seed(args.seed)

    t = 0
    params, state, vel, c = step(params, state, vel, t, gen, x0_tr, y_tr,
                                 m_sym)  # warm-up
    loss_first = float(c)
    launches0 = fused_mcm.launches
    rates = []
    for _ in range(args.n_windows):
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.n_steps):
            t += 1
            params, state, vel, c = step(params, state, vel, t, gen, x0_tr,
                                         y_tr, m_sym)
        synchronize(device)
        rates.append(args.n_steps * B / (time.perf_counter() - t0))
    n_timed = args.n_windows * args.n_steps
    print(json.dumps({
        "metric": "train-step (%s, batch %d)" % (args.precision, B),
        "value": statistics.median(rates),
        "unit": "images/sec",
        "window_values": rates,
        "window_steps": args.n_steps,
        "loss_first": loss_first,
        "loss_last": float(c),
        "fused_mcm_launches_per_step": (fused_mcm.launches - launches0)
        / n_timed,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }), flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            for _ in range(args.n_steps):
                t += 1
                params, state, vel, c = step(params, state, vel, t, gen,
                                             x0_tr, y_tr, m_sym)
            synchronize(device)
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.profile, "train_%s.json" % args.precision))
        print(json.dumps({"profile": "train-step (%s, batch %d)"
                          % (args.precision, B), "steps": args.n_steps,
                          **step_split(prof, args.n_steps)}), flush=True)


if __name__ == "__main__":
    main()
