"""Multi-process runs (counterpart of `mpnn_tpu/parallel/multihost.py`):
one process per rank, joined by `torch.distributed`.

    python -m torch.distributed.run --nproc-per-node N \\
        -m mpnn_tpu_torch.train synth-ac --net 4 --multihost --mesh auto

`initialize()` reads torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT), or takes an address, a count and
a rank as `mpnn_tpu`'s does. Each rank drives the device
`cuda:LOCAL_RANK % device_count`; ranks that each have a card of their
own talk over NCCL, ranks that share a card or run on the CPU over gloo
(NCCL refuses two ranks on one GPU). One rank writes files
(`is_primary`).

A failed collective raises (no fallback). `global_batch` has no
counterpart: each rank keeps its own rows of the global batch
(`mesh.Axis.rows`)."""

import os
import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..utils.tree import tree_leaves
from .mesh import all_reduce_flat, replicate_tree, world, world_axis

__all__ = ["initialize", "is_primary", "free_port", "local_device",
           "sync_global_devices", "check_replicas", "replicate_to_global",
           "shutdown"]


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, device="cuda", timeout_s=600):
    """Join the process group; returns (rank, world size).

    Without arguments, from torchrun's environment; else at
    `coordinator_address` ("host:port", or a "tcp://" / "file://" URL)
    with `num_processes` ranks, this one `process_id`, all on this host
    (the ranks a process starts itself, as `train --mesh` does). device
    "cuda" (the default) sets this rank's card, `cuda:local_rank %
    device_count`, and raises where there is none; "cpu" runs the rank on
    the CPU over gloo. Joining, and any later collective, raises after
    timeout_s seconds without the other ranks."""
    env = os.environ
    if coordinator_address is None:
        init = "env://"
        rank = int(env["RANK"])
        n = int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world_size = int(env.get("LOCAL_WORLD_SIZE", n))
    else:
        init = (coordinator_address if "://" in coordinator_address
                else "tcp://" + coordinator_address)
        rank, n = int(process_id), int(num_processes)
        local_rank, local_world_size = rank, n
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("rank %d: device %r requested but "
                               "torch.cuda.is_available() is False"
                               % (rank, device))
        n_cards = torch.cuda.device_count()
        torch.cuda.set_device(local_rank % n_cards)
        backend = "nccl" if local_world_size <= n_cards else "gloo"
    else:
        backend = "gloo"
    kw = {}
    if backend == "nccl":
        kw["device_id"] = torch.device("cuda", local_rank % n_cards)
    dist.init_process_group(backend, init_method=init, world_size=n,
                            rank=rank, timeout=timedelta(seconds=timeout_s),
                            **kw)
    return dist.get_rank(), dist.get_world_size()


def free_port():
    """A TCP port on 127.0.0.1 that is free now (bound to port 0), for a
    run whose ranks all start on this host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_device(device="cuda"):
    """The device this rank drives: its card (`initialize`) for "cuda",
    with the index spelled out; device itself otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def is_primary():
    """True on the rank that writes checkpoints, stats and logs (rank 0;
    always without a process group)."""
    return world()[0] == 0


def sync_global_devices(tag="barrier"):
    """A barrier over every rank (`tag` names it in a failure)."""
    if world()[1] == 1:
        return
    try:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError("barrier %r failed: %s" % (tag, e)) from e


def check_replicas(t_start, params, what):
    """Fail loud unless every rank holds the same (t_start, sum of |.| of
    the first four leaves of params): a checkpoint that some ranks read
    and others did not find (no shared filesystem) would otherwise train
    diverging "replicas" (`mpnn_tpu.train`'s resume check)."""
    leaves = tree_leaves(params)[:4]
    fp = torch.tensor([float(t_start)]
                      + [float(torch.sum(torch.abs(leaf.double())))
                         for leaf in leaves], device=leaves[0].device)
    rows = all_reduce_flat(world_axis(), [], [fp])[1][0]
    fps = rows.view(world()[1], -1).cpu().numpy()
    if not np.allclose(fps, fps[0]):
        raise RuntimeError(
            "multi-process resume desync: ranks disagree on (t_start, "
            "param fingerprint) %r -- %s must be visible to EVERY rank "
            "(shared filesystem or a replicated out-root)"
            % (fps.tolist(), what))


def replicate_to_global(mesh, tree, t_start=0, what="the checkpoint"):
    """Check that the ranks agree on `tree` (a (params, state, vel) tuple;
    `check_replicas`), then set every rank's to rank 0's (`replicate_tree`).
    Returns tree."""
    if world()[1] == 1:
        return tree
    check_replicas(t_start, tree[0], what)
    return replicate_tree(tree, mesh)


def shutdown():
    """Leave the process group, if this process joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
