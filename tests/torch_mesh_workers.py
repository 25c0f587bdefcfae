"""Rank processes for the port's mesh tests (torch and numpy only: each
rank is a fresh process started with the `spawn` method, which imports
this module, so it must not pull in jax or `tests/conftest.py`).

`run_ranks(fn, n, *args)` starts n ranks on the CPU, joins them through
torchrun's environment variables (`multihost.initialize()` without
arguments, gloo, a free port on 127.0.0.1), calls fn(rank, *args) in each
and returns the ranks' results in rank order. A rank that raises fails
the call with its traceback.

The nets are the 3-stage chains over 16x16 inputs of
tests/test_torch_sr_cr.py (`build_chain`), the small tree of
tests/test_torch_tree.py (`build_tree`) and the dp x tp test net of
tests/test_parallel.py (`build_tp_net`), built from the port's layers
only; the tests hold them to the parameter structure of JAX's nets."""

import os
import tempfile

import torch
import torch.multiprocessing as mp

ARCH = [[8, 8, 8], [8, 8], [8]]
K_L2 = 1e-4
K_CPT = 1e-9
LR, TAU0 = 0.02, 1.0


def _entry(rank, n, port, out_dir, fn, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from mpnn_tpu_torch.parallel import multihost
    assert multihost.initialize(device="cpu", timeout_s=120) == (rank, n)
    try:
        out = fn(rank, *args)
        multihost.sync_global_devices("done")
    finally:
        multihost.shutdown()
    torch.save(out, os.path.join(out_dir, "rank%d.pt" % rank))


def run_ranks(fn, n, *args):
    """[fn(rank, *args) for each of n ranks], each in its own process."""
    with tempfile.TemporaryDirectory() as d:
        from mpnn_tpu_torch.parallel.multihost import free_port
        mp.start_processes(_entry, args=(n, free_port(), d, fn, args),
                           nprocs=n, join=True, start_method="spawn")
        return [torch.load(os.path.join(d, "rank%d.pt" % r),
                           weights_only=False) for r in range(n)]


def many(rank, calls):
    """[fn(rank, *args) for (fn, args) in calls]: several runs in one
    start of the ranks."""
    return [fn(rank, *args) for fn, args in calls]


def schedules(**kw):
    from mpnn_tpu_torch.models.steps import Schedules
    return Schedules(lr=lambda t: LR, tau=lambda t: TAU0 / 2 ** (t / 2),
                     **kw)


def _layers(n_cls, dropout):
    from mpnn_tpu_torch.ops import layers as L

    def router(n_sinks):
        return L.Chain(name="Router", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=16, k_l2=K_L2), L.BatchNorm(),
            L.Rect(), L.LinTrans(n_chan=16, k_l2=K_L2), L.BatchNorm(),
            L.Rect(), L.LinTrans(n_chan=n_sinks, k_l2=K_L2, σ_w=0)])

    def reg():
        drop = [L.Dropout(λ=0.75)] if dropout else []
        return L.Chain(name="LogReg", comps=[
            L.Select(i=-1), *drop, L.LinTrans(n_chan=n_cls, k_l2=K_L2),
            L.Softmax(), L.CrossEntropyError()])

    def rcm(n_chan, *sinks):
        return L.Chain(name="ReConvMax", sinks=sinks,
                       router=router(len(sinks)) if len(sinks) > 1 else None,
                       comps=[L.MultiscaleConvMax(n_chan=n_chan, supp=3,
                                                  k_l2=K_L2),
                              L.MultiscaleBatchNorm(), L.MultiscaleRect()])

    def pyr(root):
        return L.Chain(name="ToPyramid", sinks=[root],
                       comps=[L.ToPyramid(n_scales=3)])

    return reg, rcm, pyr


def _net(kind, root, n_cls, hypers):
    from mpnn_tpu_torch import models
    cls = {"sr": models.SRNet, "ac": models.ActorNet,
           "cr": models.CriticNet}[kind]
    if kind != "sr":
        hypers = {"k_cpt": K_CPT, **hypers}
    return cls(x0_shape=(16, 16, 3), y_shape=(n_cls,), root=root, **hypers)


def build_chain(kind, n_cls=10, dropout=False, **hypers):
    """`tests.test_torch_sr_cr.build_chain(T, kind)`; with dropout, a
    Dropout(λ=0.75) in every leaf."""
    reg, rcm, pyr = _layers(n_cls, dropout)
    if kind == "sr":
        root = reg()
        for n_chan in reversed(ARCH):
            root = rcm(n_chan, root)
    else:
        root = rcm(ARCH[-1], reg())
        for n_chan in reversed(ARCH[:-1]):
            root = rcm(n_chan, reg(), root)
    return _net(kind, pyr(root), n_cls, hypers)


def build_tree(kind, n_cls=10, **hypers):
    """`tests.test_torch_tree.build_tree(T, kind)`: two congruent tails."""
    reg, rcm, pyr = _layers(n_cls, False)

    def tail():
        return rcm(ARCH[1], reg(), rcm(ARCH[2], reg()))

    return _net(kind, pyr(rcm(ARCH[0], reg(), tail(), tail())), n_cls,
                hypers)


def build_tp_net(kind, n_cls=10, **hypers):
    """tests/test_parallel.py's net, `pyr(rcm([8, 8, 8], reg(10),
    rcm([8, 8], reg(10))))` in the layers of tests/test_train_e2e.py (a
    router of an 8-wide LinTrans), as an SR, actor or critic net."""
    from mpnn_tpu_torch.ops import layers as L

    def router(n_sinks):
        if n_sinks < 2:
            return None
        return L.Chain(name="Router", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=8, k_l2=K_L2), L.BatchNorm(),
            L.Rect(), L.LinTrans(n_chan=n_sinks, k_l2=K_L2, σ_w=0)])

    def reg():
        return L.Chain(name="LogReg", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=n_cls, k_l2=K_L2),
            L.Softmax(), L.CrossEntropyError()])

    def rcm(n_chan, *sinks):
        return L.Chain(name="ReConvMax", sinks=sinks,
                       router=router(len(sinks)),
                       comps=[L.MultiscaleConvMax(n_chan=n_chan, supp=3,
                                                  k_l2=K_L2),
                              L.MultiscaleBatchNorm(), L.MultiscaleRect()])

    root = L.Chain(name="ToPyramid", sinks=[rcm([8, 8, 8], reg(),
                                                rcm([8, 8], reg()))],
                   comps=[L.ToPyramid(n_scales=3)])
    return _net(kind, root, n_cls, hypers)


def build(spec):
    """A net from a picklable spec: (constructor name, kind, kwargs)."""
    name, kind, kw = spec
    return {"chain": build_chain, "tree": build_tree,
            "tp": build_tp_net}[name](kind, **kw)


def to_np(tree):
    from mpnn_tpu_torch.utils.tree import tree_map
    return tree_map(lambda a: a.detach().double().numpy(), tree)


def data_parallel(rank, spec, p, s, batches, data, batch_size, stacked,
                  k_cpt_sample, loop=True):
    """One rank of a ('data',) mesh over every rank, on the CPU:
    - "steps": the presampled steps of `batches` (global (x, y) batches,
      flip and shift off) from (p, s), this rank's rows of each;
    - "loop" (with loop): `make_train_loop` for 3 steps from the same
      start on `data` = (x0, y, m_sym), augmentation on, k_cpt drawn per
      example from `k_cpt_sample` where given;
    - "eval": `make_eval_split_fn` of the start over the padded training
      split.
    Returns this rank's rows and, per part, numpy trees and the losses
    (or the sums)."""
    from mpnn_tpu_torch.data.dataset import Dataset
    from mpnn_tpu_torch.models import steps
    from mpnn_tpu_torch.ops import config
    from mpnn_tpu_torch.parallel import make_mesh, replicate_tree
    from mpnn_tpu_torch.utils.serdes import from_numpy_tree
    config.set_stacked_tails(stacked)
    net = build(spec)
    mesh = make_mesh()
    lo, hi = mesh.data.rows(batch_size)
    out = {"rows": (lo, hi)}

    def start():
        tp, ts = from_numpy_tree(p, s, device="cpu")
        tv = steps.momentum_init(tp)
        return replicate_tree((tp, ts, tv), mesh)

    step = steps._train_step_body(net, batch_size, schedules(), r_shift=0,
                                  presampled=True, mesh=mesh)
    tp, ts, tv = start()
    no_flip = torch.zeros(data[1].shape[1])
    cs = []
    for t, (x, y) in enumerate(batches):
        gen = torch.Generator().manual_seed(0)
        tp, ts, tv, c = step(tp, ts, tv, t, gen, torch.as_tensor(x[lo:hi]),
                             torch.as_tensor(y[lo:hi]), no_flip)
        cs.append(float(c))
    out["steps"] = (to_np(tp), to_np(ts), to_np(tv), cs)

    if loop:
        train = steps.make_train_loop(
            net, batch_size, schedules(k_cpt_sample=k_cpt_sample),
            sample_tile=2, mesh=mesh)
        x0, y, m_sym = (torch.as_tensor(a) for a in data)
        tp, ts, tv, cs = train(*start(), 0, 5, x0, y, m_sym, 3)
        out["loop"] = (to_np(tp), to_np(ts), to_np(tv), cs.tolist())

    ds = Dataset(dict(x0_tr=data[0], y_tr=data[1], x0_ts=data[0][:8],
                      y_ts=data[1][:8], m_sym=data[2]), device="cpu")
    x0s, ys, masks, _ = ds.padded_split("tr", batch_size)
    tp, ts, _ = start()
    ev = steps.make_eval_split_fn(net, batch_size, mesh)
    sums = ev(tp, ts, x0s, ys, masks, 0.7, K_CPT, 3)
    out["eval"] = {k: v.double().numpy() for k, v in sums.items()}
    return out


def model_parallel(rank, spec, p, s, batches, batch_size, shape,
                   min_chan=8, data=None, stacked=False, analytic_l2=False):
    """One rank of a `shape` = (n_data, n_model) mesh, params and velocity
    sharded over 'model' (`shard_params(model_parallel=True, min_chan)`),
    on the CPU; with shape (1, 1), in a process without a group, the
    single-process run:
    - "steps": the presampled steps of `batches` from (p, s), as
      `data_parallel`'s, this rank's rows of each;
    - "grads": this rank's gradient of the first batch after the step's
      all-reduce, sharded leaves as its blocks;
    - "loop" (with data, (x0, y, m_sym)): `make_train_loop` for 2 steps
      from the same start, augmentation on;
    - "eval" (with data): `make_eval_split_fn` of the start over the
      padded training split;
    - "roundtrip": `unshard_params` of the sharded start equals p.
    With stacked / analytic_l2, under `ops.config.stacked_tails` /
    `analytic_l2` (both reset on return). The trees come back whole
    (`unshard_params`), as numpy; with them the rank's coordinates and
    the paths of its sharded leaves."""
    from mpnn_tpu_torch.ops import config
    config.set_stacked_tails(stacked)
    config.set_analytic_l2(analytic_l2)
    try:
        return _model_parallel(spec, p, s, batches, batch_size, shape,
                               min_chan, data)
    finally:
        config.set_stacked_tails(False)
        config.set_analytic_l2(False)


def _model_parallel(spec, p, s, batches, batch_size, shape, min_chan, data):
    from mpnn_tpu_torch.data.dataset import Dataset
    from mpnn_tpu_torch.models import steps
    from mpnn_tpu_torch.parallel import make_mesh
    from mpnn_tpu_torch.parallel.mesh import shard_params, unshard_params
    from mpnn_tpu_torch.utils.serdes import from_numpy_tree
    from mpnn_tpu_torch.utils.tree import tree_leaves, tree_paths
    net = build(spec)
    mesh = make_mesh(*shape)
    lo, hi = mesh.data.rows(batch_size)
    whole, _ = from_numpy_tree(p, s, device="cpu")
    out = {"coords": (mesh.data.index, mesh.model.index)}

    def start():
        tp, ts = from_numpy_tree(p, s, device="cpu")
        tv = steps.momentum_init(tp)
        return (shard_params(tp, mesh, True, min_chan), ts,
                shard_params(tv, mesh, True, min_chan))

    def unshard(tree):
        return to_np(unshard_params(tree, mesh, whole))

    tp, ts, tv = start()
    out["sharded"] = [path for path, a, b in zip(
        tree_paths(tp), tree_leaves(tp), tree_leaves(whole))
        if a.shape != b.shape]
    out["roundtrip"] = [bool(torch.equal(a, b)) for a, b in zip(
        tree_leaves(unshard_params(tp, mesh, whole)), tree_leaves(whole))]
    batch_ctx, loss_and_grads = steps._step_pieces(
        net, batch_size, schedules(), 0, True, mesh)
    x, y = (torch.as_tensor(a[lo:hi]) for a in batches[0])
    no_flip = torch.zeros(y.shape[1])
    xb, yb, ctx = batch_ctx(0, torch.Generator().manual_seed(0), x, y,
                            no_flip, None)
    c, _, p_tr, grads = loss_and_grads(tp, ts, xb, yb, ctx)
    out["grads"] = to_np(steps._all_reduce_step(ctx.data, c, p_tr,
                                                grads)[2])

    step = steps._train_step_body(net, batch_size, schedules(), r_shift=0,
                                  presampled=True, mesh=mesh)
    cs = []
    for t, (x, y) in enumerate(batches):
        gen = torch.Generator().manual_seed(0)
        tp, ts, tv, c = step(tp, ts, tv, t, gen, torch.as_tensor(x[lo:hi]),
                             torch.as_tensor(y[lo:hi]), no_flip)
        cs.append(float(c))
    out["steps"] = (unshard(tp), to_np(ts), unshard(tv), cs)
    if data is None:
        return out

    train = steps.make_train_loop(net, batch_size, schedules(),
                                  sample_tile=2, mesh=mesh)
    x0, y, m_sym = (torch.as_tensor(a) for a in data)
    tp, ts, tv, cs = train(*start(), 0, 5, x0, y, m_sym, 2)
    out["loop"] = (unshard(tp), to_np(ts), unshard(tv), cs.tolist())

    ds = Dataset(dict(x0_tr=data[0], y_tr=data[1], x0_ts=data[0][:8],
                      y_ts=data[1][:8], m_sym=data[2]), device="cpu")
    x0s, ys, masks, _ = ds.padded_split("tr", batch_size)
    tp, ts, _ = start()
    ev = steps.make_eval_split_fn(net, batch_size, mesh)
    sums = ev(tp, ts, x0s, ys, masks, 0.7, K_CPT, 3)
    out["eval"] = {k: v.double().numpy() for k, v in sums.items()}
    return out


def sweep_mesh(rank, spec, members, k_cpts, n_sweep, n_data, data,
               batch_size, n_steps):
    """One rank of a (n_sweep, n_data) sweep mesh: `make_sweep_train_loop`
    of its members of the stacked `members` [(p, s)] for n_steps on
    `data`. Returns its coordinates, its members' numpy trees and their
    losses."""
    from mpnn_tpu_torch.models import steps
    from mpnn_tpu_torch.parallel import make_sweep_mesh, shard_sweep_tree
    from mpnn_tpu_torch.utils.serdes import from_numpy_tree
    from mpnn_tpu_torch.utils.tree import stack_trees
    net = build(spec)
    mesh = make_sweep_mesh(n_sweep=n_sweep, n_data=n_data)
    trees = [from_numpy_tree(p, s, device="cpu") for p, s in members]
    trees = [(p, s, steps.momentum_init(p)) for p, s in trees]
    stacked = [shard_sweep_tree(stack_trees([m[j] for m in trees]), mesh)
               for j in range(3)]
    k = shard_sweep_tree(torch.tensor(k_cpts), mesh)
    loop = steps.make_sweep_train_loop(net, batch_size, schedules(),
                                       sample_tile=2, mesh=mesh)
    x0, y, m_sym = (torch.as_tensor(a) for a in data)
    tp, ts, tv, cs = loop(*stacked, 0, 5, x0, y, m_sym, n_steps, k)
    return {"coords": (mesh.axes["sweep"].index, mesh.data.index),
            "trees": (to_np(tp), to_np(ts), to_np(tv)),
            "losses": cs.double().numpy()}


SWEEP_K = [0.0, 1e-6, 4e-6, 1.6e-5]


def tiny_registry():
    """{"tiny-ac": a 4-net actor sweep, "tiny-sr": one SR net} of the
    3-stage chains on data/tiny.npz (16x16 inputs), in the registry's
    form, for `experiments.make_experiments`."""
    from types import SimpleNamespace as Ns
    from mpnn_tpu_torch import experiments as cfg

    def ctor(kind, **hypers):
        return lambda x0_shape, y_shape: build_chain(kind, y_shape[0],
                                                     **hypers)
    return {"tiny-ac": Ns(dataset="data/tiny.npz", tau=cfg.AC_TAU,
                          sweep_k_cpts=list(SWEEP_K),
                          nets=[ctor("ac", k_cpt=k) for k in SWEEP_K]),
            "tiny-sr": Ns(dataset="data/tiny.npz", tau=None,
                          nets=[ctor("sr")])}


def train_rank(rank, data_root, out_root, expt, sweep_shape, n_iter):
    """`train.train_experiment` of the tiny registry on one rank, on the
    CPU, writing under out_root/rank<r>: over a ('data',) mesh of every
    rank (sweep_shape None) or a (sweep, data) mesh with --vmap-sweep.
    A data-parallel run is then resumed to n_iter + 2, each rank looking
    for the checkpoint in its own directory, which only rank 0 wrote.
    Returns the run's timings and what the resumed run raised."""
    from mpnn_tpu_torch import experiments as cfg
    from mpnn_tpu_torch import train
    from mpnn_tpu_torch.parallel import make_mesh, make_sweep_mesh
    cfg.make_experiments = tiny_registry
    mesh = (make_mesh() if sweep_shape is None
            else make_sweep_mesh(*sweep_shape))
    out = os.path.join(out_root, "rank%d" % rank)
    kw = dict(t_log=2, batch_size=8, data_root=data_root, out_root=out,
              verbose=False, device="cpu", mesh=mesh,
              vmap_sweep=sweep_shape is not None)
    timings = []
    train.train_experiment(expt, n_iter=n_iter, timings=timings, **kw)
    resumed = None
    if sweep_shape is None:
        try:
            train.train_experiment(expt, n_iter=n_iter + 2, resume=True,
                                   **kw)
        except RuntimeError as e:
            resumed = str(e)
    return {"timings": timings, "resumed": resumed}


def collectives(rank):
    """multihost's helpers on 2 ranks: is_primary, the flat all-reduce's
    gather over every rank, the broadcast of replicate_tree, the desync
    check, a barrier."""
    from mpnn_tpu_torch.parallel import (make_mesh, make_sweep_mesh,
                                         multihost, replicate_tree)
    from mpnn_tpu_torch.parallel.mesh import all_reduce_flat, world_axis
    mesh = make_mesh()
    smesh = make_sweep_mesh()
    rows = all_reduce_flat(world_axis(), [],
                           [torch.tensor([rank, 10.0 + rank])])[1][0]
    rows = rows.view(2, 2)
    tree = {"w": torch.full((3,), float(rank)), "v": [torch.arange(2.0)
                                                      + rank]}
    replicate_tree(tree, mesh)
    try:
        multihost.check_replicas(rank, [torch.ones(2)], "ckpt")
        desync = None
    except RuntimeError as e:
        desync = str(e)
    multihost.check_replicas(7, [torch.ones(2)], "ckpt")
    multihost.sync_global_devices("test")
    return {"primary": multihost.is_primary(), "rows": rows.numpy(),
            "tree": to_np(tree), "desync": desync,
            "device": str(multihost.local_device("cpu")),
            "mesh": (mesh.shape, mesh.data.index),
            "reduces": (mesh.data.reduces, smesh.data.reduces)}
