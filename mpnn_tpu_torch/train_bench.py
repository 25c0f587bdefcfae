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

With --sweep N it measures the k_cpt sweep instead (`bench.py`'s
workload): N flagship actor chains (`ac_chain(k_cpt=0)`, member i drawn
from --seed + i, at k_cpts[i]) trained at once by
`make_sweep_train_loop`, --batch-size per net; each window is one call of
the loop for --n-steps steps (one gather, then the steps), and `value` is
the aggregate rate, N x batch x steps over the window's time.

With --arch tree the net is the 47-stage actor tree
(`ac_tree(k_cpt=k_cpts[4])`, the `*-tree` experiments' net), in both
modes.

With --stacked-tails the net's congruent subtrees run as vmapped templates
(`ops.config.stacked_tails`): the tree's eight tails, each tail stage one
launch of fused_mcm's net axis. The single-net step then takes its trees
packed once before the warm-up (`Net.pack_tree`), as the training loop
carries them; the sweep's loop packs at each call.

With --profile DIR it then traces --n-steps more steps with
torch.profiler, writes the Chrome trace into DIR and prints a second JSON
line: the device time per step split into the fused_mcm forward, the
stage's backward through `mcm_ref`, the optimizer (TALR and momentum) and
the rest, the device operations per step, and the device's idle share.

Runs on CUDA unless --device cpu is given; there with deterministic
algorithms, as the training CLIs run (`set_up_device`).

    python -m mpnn_tpu_torch.train_bench --precision bf16
    python -m mpnn_tpu_torch.train_bench --sweep 8 --precision bf16
    python -m mpnn_tpu_torch.train_bench --arch tree
    python -m mpnn_tpu_torch.train_bench --arch tree --stacked-tails
"""

import json
import os
import statistics
import time
from argparse import ArgumentParser

import torch

# Autograd node of fused_mcm's backward, as the profiler names its range:
# _FusedMCMBackward, or under torch.func (the sweep) that of the class
# functorch generates, _FusedMCMGeneratedBackward.
_MCM_BACKWARD = ("_FusedMCM", "Backward")
TOP_KERNELS = 15  # device operations listed by time in the profile line


def _ctor(arch):
    from .experiments import ac_chain, ac_tree
    return {"chain": ac_chain, "tree": ac_tree}[arch]


def build(seed=0, device="cuda", checkpoint=None, arch="chain"):
    """(net, params, state, vel) of the flagship actor chain (or, with
    arch="tree", the actor tree): fresh from `seed`, or read from
    `checkpoint` with zero velocities."""
    from .models.optim import momentum_init
    from .models.steps import init_training
    if checkpoint:
        from .utils.serdes import read_net
        net, params, state, _ = read_net(checkpoint, device)
        return net, params, state, momentum_init(params)
    from .experiments import k_cpts
    net = _ctor(arch)(k_cpt=k_cpts[4])((32, 32, 3), (10,))
    return (net,) + init_training(net, seed, device)


def build_sweep(n_nets, seed=0, device="cuda", arch="chain"):
    """(net, params_s, state_s, vel_s, k_cpts) of a sweep of n_nets
    flagship actor chains (or trees), member i drawn from seed + i, as
    `bench.py` builds it: stacked trees and the members' prices on the
    device."""
    from .experiments import k_cpts
    from .models.steps import init_training
    from .utils.tree import stack_trees
    if not 1 <= n_nets <= len(k_cpts):
        raise ValueError("a sweep has 1 to %d nets (got %d)"
                         % (len(k_cpts), n_nets))
    net = _ctor(arch)(k_cpt=0.0)((32, 32, 3), (10,))
    members = [init_training(net, seed + i, device) for i in range(n_nets)]
    trees = [stack_trees([m[j] for m in members]) for j in range(3)]
    k_arr = torch.tensor(k_cpts[:n_nets], dtype=torch.float32,
                         device=device)
    return (net, *trees, k_arr)


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

    def under(*names):
        return sum(e.device_time_total for e in events
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and all(n in e.name for n in names)
                   and e.cpu_parent is None)

    fwd = sum(k.device_time_total for k in kernels
              if "mcm_scale_" in k.name)
    bwd = under(*_MCM_BACKWARD)
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
                        help="nets/<expt>/<i>.npy checkpoint to train on")
    parser.add_argument("--arch", choices=["chain", "tree"], default="chain",
                        help="the flagship actor chain or the actor tree")
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
    parser.add_argument("--sweep", type=int, default=0, metavar="N",
                        help="measure a sweep of N flagship actor chains "
                             "trained at once (aggregate img/s)")
    parser.add_argument("--stacked-tails", action="store_true",
                        help="run the congruent subtrees (the tree's "
                             "tails) as vmapped templates")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    args = parser.parse_args(argv)

    from . import set_up_device, synchronize
    from .experiments import λ_lrn, τ_ds
    from .models.steps import (Schedules, make_sweep_train_loop,
                               make_train_step)
    from .ops import config
    from .ops.kernels import fused_mcm

    device = set_up_device(args.device, args.precision,
                           deterministic=True)
    config.set_stacked_tails(args.stacked_tails)

    B = args.batch_size
    sched = Schedules(lr=λ_lrn, tau=τ_ds)
    what = ("" if args.arch == "chain" else "tree, ") + (
        "stacked tails, " if args.stacked_tails else "")
    if args.sweep:
        net, params, state, vel, k_arr = build_sweep(args.sweep, args.seed,
                                                     device, args.arch)
        loop = make_sweep_train_loop(net, B, sched)
        n_per_call, n_nets = args.n_steps, args.sweep
        metric = "train-sweep (%s%s, %d nets x batch %d)" % (
            what, args.precision, n_nets, B)
    else:
        net, params, state, vel = build(args.seed, device, args.checkpoint,
                                        args.arch)
        step = make_train_step(net, B, sched)
        if args.stacked_tails and net._stack_plan:
            params, state, vel = (net.pack_tree(t)
                                  for t in (params, state, vel))
        n_per_call, n_nets = 1, 1
        metric = "train-step (%s%s, batch %d)" % (what, args.precision, B)
    x0_tr, y_tr, m_sym = train_data(net, device, seed=args.seed)
    gen = torch.Generator(device).manual_seed(args.seed)
    t = 0

    def run(params, state, vel):
        """n_per_call steps from t: the loop's call or one step."""
        if args.sweep:
            params, state, vel, cs = loop(params, state, vel, t, args.seed,
                                          x0_tr, y_tr, m_sym, n_per_call,
                                          k_arr)
            return params, state, vel, cs[-1]
        return step(params, state, vel, t, gen, x0_tr, y_tr, m_sym)

    params, state, vel, c = run(params, state, vel)  # warm-up
    t += n_per_call
    loss_first = c.tolist()
    launches0, net_launches0 = fused_mcm.launches, fused_mcm.net_launches
    rates = []
    for _ in range(args.n_windows):
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.n_steps // n_per_call):
            params, state, vel, c = run(params, state, vel)
            t += n_per_call
        synchronize(device)
        rates.append(n_nets * args.n_steps * B / (time.perf_counter() - t0))
    n_timed = args.n_windows * args.n_steps
    print(json.dumps({
        "metric": metric,
        "value": statistics.median(rates),
        "unit": "images/sec",
        "window_values": rates,
        "window_steps": args.n_steps,
        "nets": n_nets,
        "loss_first": loss_first,
        "loss_last": c.tolist(),
        "fused_mcm_launches_per_step": (fused_mcm.launches - launches0)
        / n_timed,
        "fused_mcm_net_launches_per_step": (fused_mcm.net_launches
                                            - net_launches0) / n_timed,
        "stacked_tails": args.stacked_tails,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }), flush=True)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            for _ in range(args.n_steps // n_per_call):
                params, state, vel, c = run(params, state, vel)
                t += n_per_call
            synchronize(device)
        os.makedirs(args.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            args.profile, "train_%s%s%s%s.json" % (
                "sweep%d_" % n_nets if args.sweep else "",
                "tree_" if args.arch == "tree" else "",
                "stacked_" if args.stacked_tails else "", args.precision)))
        print(json.dumps({"profile": metric, "steps": args.n_steps,
                          **step_split(prof, args.n_steps)}), flush=True)


if __name__ == "__main__":
    main()
