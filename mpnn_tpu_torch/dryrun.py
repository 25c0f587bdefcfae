"""A multi-rank dry run (counterpart of `__graft_entry__.dryrun_multichip`):

    python -m mpnn_tpu_torch.dryrun 8                 # on the card(s)
    python -m mpnn_tpu_torch.dryrun 8 --device cpu    # on the CPU

`dryrun_multichip(n_devices, device)` starts n_devices ranks, each a
process of its own joined at 127.0.0.1 on a free port (`multihost.
initialize`: rank r drives `cuda:r % device_count` and the ranks talk
over NCCL where each has a card of its own, over gloo where they share
one; on the CPU over gloo), and runs in them the flagship actor chain
cut to its first 3 stages (`mpnn_tpu`'s cold plan: the full training
step, augmentation, routing, the actor loss, TALR and momentum, only
shallower), at full width on 32x32 inputs, each stage a launch of
`fused_mcm` on the card:

1. one step at batch 8n on `mpnn_tpu`'s mesh: `make_mesh(n // 2, 2)`
   (dp x tp) where n is even and at least 4, with the params and
   velocity placed by `shard_params(model_parallel=True)` at its default
   min_chan of 64, else `make_mesh(n_data=n)`;
2. the k_cpt sweep's step on a ('sweep', 'data') mesh, one member a
   rank: 8x(n/8) when n divides by 8, else 4x(n/4), else 2x(n/2), as
   `mpnn_tpu` picks.

Rank 0 prints `mpnn_tpu`'s two OK lines, each naming rank 0's device
and backend; a rank that fails or a non-finite loss fails the run. At
DEPTH 3 (widths 16/16/32) no param is 64 wide, so, as in `mpnn_tpu`'s
cold plan, the 'model' axis shards nothing here and its ranks replicate
the step; `chip_smoke.py`'s tp_train phase shards the full-depth
flagship (stages 4-7) on the card.
Nothing is cached between runs, so every run is the cold plan."""

import argparse
import time

import numpy as np
import torch

__all__ = ["dryrun_multichip"]

SWEEP_K = [0.0, 1e-9, 4e-9, 1.6e-8, 6.4e-8, 2.56e-7, 1e-6, 4e-6]
DEPTH = 3


def _reduced_flagship(n_stages, x0_shape=(32, 32, 3), n_cls=10,
                      k_cpt=1e-9):
    """The flagship actor chain cut to its first n_stages conv stages."""
    from .experiments import pyr, rcm, reg
    from .models import ActorNet
    root = rcm(n_stages - 1, reg(n_cls))
    for i in reversed(range(n_stages - 1)):
        root = rcm(i, reg(n_cls), root)
    return ActorNet(x0_shape=x0_shape, y_shape=(n_cls,), root=pyr(root),
                    k_cpt=k_cpt)


def _sweep_shape(n):
    for n_sweep in (8, 4, 2):
        if n % n_sweep == 0:
            return n_sweep, n // n_sweep
    return None


def _rank(rank, n, port, device):
    from .data.dataset import Dataset
    from .data.synth import make_synthetic
    from .models.steps import (Schedules, init_training,
                               make_sweep_train_loop, make_train_step)
    from .parallel import (make_mesh, make_sweep_mesh, multihost,
                           replicate_tree, shard_params, shard_sweep_tree)
    from .utils.tree import stack_trees
    import torch.distributed as dist
    torch.set_num_threads(1)
    if device != "cpu":
        # The 'model' axis's ranks compute the replicated layers each.
        from . import set_deterministic
        set_deterministic(True)
    multihost.initialize("127.0.0.1:%d" % port, n, rank, device=device)
    try:
        dev = multihost.local_device(device)
        where = "device=%s backend=%s" % (dev, dist.get_backend())
        net = _reduced_flagship(DEPTH)
        batch = 8 * n
        ds = Dataset(make_synthetic(n_tr=max(64, batch), n_ts=32, h=32,
                                    w=32, n_cls=10, seed=0), device=dev)
        x0_tr, y_tr, m_sym = ds.train_arrays
        sched = Schedules(lr=lambda t: 0.01, tau=lambda t: 1.0)

        mesh = (make_mesh(n // 2, 2) if n % 2 == 0 and n >= 4
                else make_mesh(n_data=n))
        p, s, v = replicate_tree(init_training(net, seed=0, device=dev),
                                 mesh)
        trees = (shard_params(p, mesh, model_parallel=True), s,
                 shard_params(v, mesh, model_parallel=True))
        step = make_train_step(net, batch, sched, mesh=mesh)
        *_, c = step(*trees, 0, torch.Generator(dev).manual_seed(0), x0_tr,
                     y_tr, m_sym)
        c = float(c)
        if not np.isfinite(c):
            raise RuntimeError("non-finite loss %r" % c)
        if rank == 0:
            print("dryrun_multichip(%d): mesh=%s batch=%d loss=%.4f %s OK"
                  % (n, dict(mesh.shape), batch, c, where), flush=True)

        shape = _sweep_shape(n)
        if shape is not None:
            n_sweep, n_data = shape
            smesh = make_sweep_mesh(n_sweep=n_sweep, n_data=n_data)
            members = [init_training(net, seed=i, device=dev)
                       for i in range(n_sweep)]
            stacked = [shard_sweep_tree(stack_trees([m[j] for m in members]),
                                        smesh) for j in range(3)]
            k = shard_sweep_tree(torch.tensor(SWEEP_K[:n_sweep], device=dev),
                                 smesh)
            loop = make_sweep_train_loop(net, batch, sched, sample_tile=2,
                                         mesh=smesh)
            *_, cs = loop(*stacked, 0, 1, x0_tr, y_tr, m_sym, 1, k)
            if not torch.isfinite(cs).all():
                raise RuntimeError("non-finite sweep losses %r"
                                   % cs.tolist())
            multihost.sync_global_devices("sweep")
            if rank == 0:
                print("dryrun_multichip(%d): sweep mesh=%s %d-net step %s OK"
                      % (n, dict(smesh.shape), n_sweep, where), flush=True)
    finally:
        multihost.shutdown()


def dryrun_multichip(n_devices, device="cuda"):
    """Both phases on n_devices ranks on `device` ("cuda", the default, or
    "cpu"; see the module docstring)."""
    import torch.multiprocessing as mp
    from .parallel.multihost import free_port
    t0 = time.time()
    mp.start_processes(_rank, args=(n_devices, free_port(), device),
                       nprocs=n_devices, join=True, start_method="spawn")
    print("dryrun_multichip(%d): done in %.0fs on %s (plan {'depth': %d})"
          % (n_devices, time.time() - t0, device, DEPTH), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m mpnn_tpu_torch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8,
                    help="ranks to start (default 8)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ranks run (default: the card)")
    args = ap.parse_args(argv)
    dryrun_multichip(args.n_devices, args.device)


if __name__ == "__main__":
    # Spawned ranks import `_rank` from the module by its name.
    from mpnn_tpu_torch.dryrun import main as _main
    _main()
