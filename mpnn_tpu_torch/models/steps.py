"""The train step, the chunked train loop and the full-split evaluator
(counterpart of `mpnn_tpu/models/steps.py`, single net, node-structured
trees).

One step: sample and augment a batch on the device, run the whole tree
(`Net.forward`), propagate routing probabilities and form the loss
(`net.loss`), take the gradients with `torch.autograd.grad`, optionally
add the analytic L2 gradient, scale by TALR, and take a TF momentum step
in place. Schedules are host functions of the step counter `t`.

`make_train_loop` runs a span of steps as `mpnn_tpu`'s scan does: one
gather of many batches per tile of steps, then the presampled step on
each. Its draws are functions of integers, as JAX's `fold_in` keys are:
the tile's gather of (seed, t_first), each step's augmentation of
(seed, t); so a run resumed at a span boundary draws what the
uninterrupted run draws. A net with an active Dropout draws its masks
from a stream of (seed, t) of its own, beside augmentation's
(`_drop_stream`); a net without one draws nothing more.
`ops.config.remat_policy` recomputes the forward in the backward
(`_remat`).
`make_eval_split_fn` loops `_eval_batch_fn` over a padded split.

Under `ops.config.stacked_tails` the forward runs the net's stack-plan
groups as vmapped templates (`Net.forward`), in the steps, the loops and
the evaluators alike. The loops then carry params, state and velocity in
`Net.pack_tree`'s layout through a span (the members pre-stacked, so no
step stacks them again), packed at entry and unpacked at exit; the trees
they take and return, and every tree of the evaluators, checkpoints and
stats, are in the node layout.

`make_sweep_train_loop` trains a k_cpt sweep of same-architecture nets
in one step: `torch.func.vmap` of the loss and gradient over stacked
params, state and k_cpt, with the batch shared (sampled and augmented
once, outside the vmap), then of TALR and analytic L2 per member, and
one TF momentum update over the stacked leaves. `make_sweep_eval_split_fn`
evaluates every member per batch. Under `stacked_tails` the sweep's loop
packs with the members after the nets (axis 1), and each stacked group
runs as a vmap inside the sweep's vmap: both fold into one launch of
`fused_mcm`'s net axis. The sweep's members share the step's Dropout
stream and masks, as JAX's `vstep` shares its key. Its gradient is
`torch.autograd.grad` through the vmapped forward, which a remat policy
checkpoints as it does the single net's (torch.func.grad takes no
saved-tensor hooks).

Meshes (`parallel.mesh`): with a mesh, the steps, loops and evaluators
are data-parallel over its 'data' axis, one process per rank. Every rank
draws the global batch (indices, augmentation, per-example k_cpt,
Dropout masks: the same functions of (seed, t) as on one process) and
keeps its rows; BatchNorm's moments and the loss's mean reduce over the
axis inside the forward (`Ctx.data`), and after the backward one
all-reduce sums the gradient and the loss and gathers every node's p_tr
for TALR and the analytic L2 (`_all_reduce_step`). So a rank takes the
single-process step at the global batch. A sweep mesh's 'sweep' axis
splits the sweep's members over ranks, with no collective between
nets.

A ('data', 'model') mesh's 'model' axis goes into the context beside
'data' (`Ctx.model`): where the trees are sharded over it
(`parallel.shard_params(model_parallel=True)`; params and velocity alike,
state whole), the layers compute this rank's output channels and gather
them (`ops.layers`), and the ranks along 'model', which share their data
index and so their rows, run the rest of the step identically. The
step's all-reduce stays over 'data': a sharded leaf has the same block
on every rank of a data group. With replicated trees (the CLI's DxM, as
`mpnn_tpu`'s) nothing is gathered and the ranks along 'model' compute
the same rows. Since the ranks along 'model' each compute the replicated
layers' gradients themselves, their replicas stay equal only if those
computations repeat bit for bit: on CUDA a train step over a 'model'
axis of several ranks needs `mpnn_tpu_torch.set_deterministic(True)`
(cuDNN's default backward algorithms sum in a varying order) and
raises without it (`_check_model_repeats`)."""

import numpy as np
import torch

from ..data.augment import augment_presampled, augmented_batch
from ..ops import config as ops_config
from ..ops.layers import fold_stream
from ..parallel.mesh import all_reduce_flat
from ..utils.tree import tree_leaves, tree_map, tree_paths
from .net import Ctx, _hyper
from .optim import (momentum_init, momentum_update, talr_scale_grads,
                    tree_l2_decay)
from .stats import state_stats


class Schedules:
    """Per-step hyper schedules.

    lr:     t -> learning rate
    tau:    t -> routing temperature, or None for the net's own τ
    k_cpt_sample: values of k_cpt to sample per example each batch, or
            None for the net's static k_cpt."""

    def __init__(self, lr=lambda t: 1e-3, tau=None, k_cpt_sample=None):
        self.lr = lr
        self.tau = tau
        self.k_cpt_sample = (None if k_cpt_sample is None
                             else np.asarray(k_cpt_sample, np.float32))


def _data_part(mesh, batch_size):
    """(axis, part) of a step under `mesh`: its 'data' axis (None without a
    mesh) and this rank's rows of the global batch, part = (lo, hi,
    batch_size), or None where the rank takes the whole batch."""
    axis = None if mesh is None else mesh.data
    if axis is None or axis.size == 1:
        return axis, None
    return axis, axis.rows(batch_size) + (batch_size,)


def _model_of(mesh):
    """The 'model' axis of a step under `mesh`, or None (no mesh, or a
    sweep mesh)."""
    return None if mesh is None else mesh.model


def _rows(t, part):
    """This rank's rows of t, drawn for the global batch."""
    return t if part is None else t[part[0]:part[1]]


def _step_pieces(net, batch_size, schedules, r_shift, presampled,
                 mesh=None):
    """(batch_ctx, loss_and_grads) closures of the step.

    batch_ctx(t, gen, x0_tr, y_tr, m_sym, k_cpt) -> (xb, yb, ctx) samples
    and augments the batch from the generator `gen` (with presampled, x0_tr
    and y_tr are the batch itself and only flip and shift run); ctx carries
    the step's Dropout stream and masks (`_drop_stream`). Under a mesh with
    a 'data' axis over several ranks, every draw is the global batch's
    and the rank keeps its rows (`_data_part`; presampled, x0_tr / y_tr
    are its rows already), and ctx carries the axis, over which BatchNorm
    and the loss's mean reduce.

    loss_and_grads(params, state, xb, yb, ctx) -> (c_tot, new_state,
    p_tr_by_uid, grads): grads has the structure of params; p_tr_by_uid
    holds each node's detached p_tr of the same forward. Under
    `ops.config.remat_policy` the forward is recomputed in the backward
    (`_remat`)."""
    eps_rte = float(_hyper(net, "ϵ", 1e-6))
    tau_default = float(_hyper(net, "τ", 1.0))
    k_cpt_static = _hyper(net, "k_cpt", 0.0)
    k_cpt_values = {}  # device -> schedules.k_cpt_sample as a tensor
    axis, part = _data_part(mesh, batch_size)
    model = _model_of(mesh)

    def batch_ctx(t, gen, x0_tr, y_tr, m_sym, k_cpt):
        if presampled:
            xb, yb = augment_presampled(gen, x0_tr, y_tr, m_sym, r_shift,
                                        part)
        else:
            xb, yb = augmented_batch(gen, x0_tr, y_tr, m_sym, batch_size,
                                     r_shift, part)
        tau = schedules.tau(t) if schedules.tau is not None else tau_default
        if schedules.k_cpt_sample is not None:
            dev = xb.device
            if dev not in k_cpt_values:
                k_cpt_values[dev] = torch.as_tensor(schedules.k_cpt_sample,
                                                    device=dev)
            vals = k_cpt_values[dev]
            k_cpt = vals[_rows(torch.randint(0, len(vals), (batch_size,),
                                             generator=gen, device=dev),
                               part)]
        elif k_cpt is None:
            k_cpt = k_cpt_static
        _check_model_repeats(model, xb.device)
        rng, masks = _drop_stream(net, gen, t, xb, part)
        return xb, yb, Ctx(train=True, rng=rng, tau=tau, eps=eps_rte,
                           k_cpt=k_cpt, masks=masks, data=axis, model=model)

    loss_fn = _loss_fn(net, _n_rows(batch_size, part))

    def loss_and_grads(params, state, xb, yb, ctx):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            c_tot, (new_state, p_tr_by_uid) = _remat(loss_fn)(
                live, state, xb, yb, ctx)
            grads = torch.autograd.grad(c_tot, leaves,
                                        materialize_grads=True)
        p_tr_by_uid = {k: v.detach() for k, v in p_tr_by_uid.items()}
        it = iter(grads)
        return (c_tot.detach(), new_state, p_tr_by_uid,
                tree_map(lambda _: next(it), params))

    return batch_ctx, loss_and_grads


def _check_model_repeats(model, device):
    """Raise unless a train step over the 'model' axis `model` repeats
    itself on `device`: on CUDA, with several ranks along the axis, the
    deterministic algorithms must be on (see the module docstring)."""
    if (model is not None and model.reduces and device.type == "cuda"
            and not (torch.are_deterministic_algorithms_enabled()
                     and torch.backends.cudnn.deterministic)):
        raise RuntimeError(
            "a train step over a 'model' axis of %d ranks on CUDA needs "
            "deterministic algorithms (mpnn_tpu_torch.set_deterministic("
            "True)): each rank computes the replicated layers' gradients "
            "itself, and cuDNN's default backward algorithms would let the "
            "replicas drift apart" % model.size)


def _n_rows(batch_size, part):
    """The rows of the batch a rank's forward takes."""
    return batch_size if part is None else part[1] - part[0]


def _drop_stream(net, gen, t, xb, part=None):
    """(rng, masks) of a train step's Dropout: the stream is a function of
    the step's generator seed and t, so of (seed, t) in the loops (the
    counterpart of JAX's `k_drop`, split from the step's key beside
    augmentation's), and the masks of every active Dropout are drawn from
    it (`Net.dropout_masks`), for the global batch under `part`, whose
    rows the rank keeps. A net without one draws nothing."""
    rng = _fold(gen.initial_seed(), _DROP_STREAM, t)
    n = xb.shape[0] if part is None else part[2]
    return rng, {k: _rows(m, part) for k, m in
                 net.dropout_masks(rng, n, xb.device).items()}


def _all_reduce_step(axis, c, p_tr_by_uid, grads):
    """(c, p_tr_by_uid, grads) of the global batch from a rank's share,
    in the step's one all-reduce over the 'data' axis, a flat fp32 bucket:
    the gradient leaves and the loss are summed (each rank's are its
    rows' share of the global mean, `parallel.mesh.batch_mean`), and each
    node's p_tr is gathered (each rank fills its rows of a zero block; the
    batch is p_tr's last axis). TALR and the analytic L2 then take their
    means over the global batch, as on one process. As it is without an
    axis that reduces."""
    if axis is None or not axis.reduces:
        return c, p_tr_by_uid, grads
    keys = list(p_tr_by_uid)
    (c, *leaves), rows = all_reduce_flat(
        axis, [c] + tree_leaves(grads), [p_tr_by_uid[k] for k in keys])
    it = iter(leaves)
    return c, dict(zip(keys, rows)), tree_map(lambda _: next(it), grads)


# Ops whose outputs the "dots" policy saves: convs and matmuls, and the
# MultiscaleConvMax stage's operator (`kernels.MCM_STAGE`).
_DOTS = ("convolution", "mm", "addmm", "bmm", "baddbmm")


def _dots_policy(ctx, op, *args, **kwargs):
    from torch.utils.checkpoint import CheckpointPolicy
    from ..ops.kernels import MCM_STAGE
    if op.overloadpacket.__name__ in _DOTS or op is MCM_STAGE:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(loss_fn):
    """loss_fn under `ops.config.remat_policy` (the counterpart of JAX's
    `jax.checkpoint` of the loss): None as it is; "full" recomputes the
    whole forward in the backward (`torch.utils.checkpoint`); "dots"
    saves the conv, matmul and `fused_mcm` outputs and recomputes the
    rest (selective checkpointing, as `dots_saveable`). The Dropout masks
    are drawn before the loss function, so a recompute applies the same
    ones."""
    policy = ops_config.remat_policy
    if policy is None:
        return loss_fn
    from torch.utils.checkpoint import (checkpoint,
                                        create_selective_checkpoint_contexts)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _dots_policy)

    def remat_loss(*args):
        return checkpoint(loss_fn, *args, use_reentrant=False, **kw)

    return remat_loss


def _loss_fn(net, batch_size):
    """loss_fn(params, state, xb, yb, ctx) -> (c_tot, (new_state,
    p_tr_by_uid)): the loss of one forward, with the new BatchNorm state
    and each node's p_tr."""

    def loss_fn(params, state, xb, yb, ctx):
        recs, new_state = net.forward(params, state, xb, yb, ctx)
        c_tot = net.loss(recs, batch_size, ctx)
        return c_tot, (new_state, {str(l._uid): recs[l].p_tr
                                   for l in net.layers
                                   if recs[l].p_tr is not None})

    return loss_fn


def make_train_step(net, batch_size, schedules, r_shift=4, mesh=None):
    """The train step.

    step(params, state, vel, t, gen, x0_tr, y_tr, m_sym, k_cpt=None)
        -> (params, state, vel, c_tot)

    params and vel are updated in place and returned; state is a new tree
    (BatchNorm running statistics); c_tot is the loss as a device scalar.
    The trees may be in `Net.pack_tree`'s layout under `stacked_tails`
    (the loops' carry); in the node layout the forward stacks each
    group's members itself.
    x0_tr / y_tr / m_sym are the training split on the device, `gen` a
    torch.Generator on the same device, `t` the host step counter of the
    schedules; k_cpt overrides the net's static price.

    With a mesh (`parallel.make_mesh`), the step is data-parallel over its
    'data' axis: every rank samples the global batch of batch_size from
    the same generator state and runs its rows; BatchNorm's moments, the
    loss's mean, TALR's and the analytic L2's means are the global
    batch's, and the gradient is all-reduced, so each rank takes the
    single-process step at the global batch (`_all_reduce_step`). The
    trees must be replicas (`parallel.replicate_tree`), or, over a
    'model' axis, params and velocity sharded by `parallel.shard_params`
    from replicas (see the module docstring)."""
    return _train_step_body(net, batch_size, schedules, r_shift, mesh=mesh)


def _train_step_body(net, batch_size, schedules, r_shift=4,
                     presampled=False, mesh=None):
    """The single train step; with presampled, x0_tr / y_tr are the step's
    already gathered batch (this rank's rows of it under a mesh) and only
    flip and shift run."""
    mu = float(_hyper(net, "μ_lrn", 0.9))
    batch_ctx, loss_and_grads = _step_pieces(net, batch_size, schedules,
                                             r_shift, presampled, mesh)
    scale_grads = _grad_transform(net, _model_of(mesh))
    axis = _data_part(mesh, batch_size)[0]

    def step(params, state, vel, t, gen, x0_tr, y_tr, m_sym, k_cpt=None):
        xb, yb, ctx = batch_ctx(t, gen, x0_tr, y_tr, m_sym, k_cpt)
        c_tot, new_state, p_tr_by_uid, grads = loss_and_grads(
            params, state, xb, yb, ctx)
        c_tot, p_tr_by_uid, grads = _all_reduce_step(axis, c_tot,
                                                     p_tr_by_uid, grads)
        # A profiler range: train_bench --profile reads the update's time.
        with torch.profiler.record_function("optimizer"):
            grads, c_tot = scale_grads(params, grads, p_tr_by_uid, c_tot)
            params, vel = momentum_update(params, vel, grads,
                                          schedules.lr(t), mu)
        if ops_config.debug_nans:
            check_nans(t, loss=c_tot, gradients=grads, params=params,
                       state=new_state, velocity=vel)
        return params, new_state, vel, c_tot

    return step


def check_nans(t, **trees):
    """Raise FloatingPointError if a leaf of `trees` holds a NaN, naming
    step t and the first such leaf (in the order of the keywords, then
    `tree_leaves`' order); Inf passes, as under jax_debug_nans. One fused
    check: a leaf's 2-norm is NaN iff the leaf holds a NaN (its squares
    are never negative, so Inf + -Inf cannot arise), the norms of every
    leaf come from one `torch._foreach_norm`, and one host read brings
    their flags back. The train steps call it after the update under
    `ops.config.debug_nans` (`train --debug-nans`)."""
    names, leaves = [], []
    for name, tree in trees.items():
        got = tree_leaves(tree)
        names += [name] * len(got)
        leaves += got
    bad = torch.isnan(torch.stack(torch._foreach_norm(leaves))).cpu()
    if not bad.any():
        return
    first = int(bad.nonzero()[0, 0])
    name = names[first]
    path = tree_paths(trees[name])[first - names.index(name)]
    raise FloatingPointError(
        "NaN at step %d in %s (%d of %d leaves hold a NaN)"
        % (t, name + ("/" + path if path else ""), int(bad.sum()),
           len(leaves)))


def _grad_transform(net, model=None):
    """scale(params, grads, p_tr_by_uid, c_tot) -> (grads, c_tot): the
    analytic L2 gradient and loss (`ops.config.analytic_l2`; its value
    summed over the 'model' axis `model` for sharded weights), then TALR
    for nets with the expectation optimizer; of one net, so the sweep
    vmaps it over its members."""
    alpha_rtr = float(_hyper(net, "α_rtr", 1.0))
    talr = bool(_hyper(net, "talr", True))

    def scale(params, grads, p_tr_by_uid, c_tot):
        if ops_config.analytic_l2:
            grads, c_l2 = tree_l2_decay(net, params, grads, p_tr_by_uid,
                                        model)
            c_tot = c_tot + c_l2
        if net.uses_expectation_optimizer:
            grads = talr_scale_grads(net, grads, p_tr_by_uid,
                                     alpha_rtr=alpha_rtr, talr=talr)
        return grads, c_tot

    return scale


def _eval_batch_fn(net, batch_size, model=None):
    """eval_batch(params, state, x0b, yb, maskb, tau, k_cpt, rng=None,
    drop=None) -> dict of the per-example stats summed over the examples
    where maskb is 1 (padding rows carry 0). rng is the batch's Dropout
    stream and drop its masks (`_split_sums`), or None; `model` is the
    'model' axis of sharded params."""
    eps_rte = float(_hyper(net, "ϵ", 1e-6))

    @torch.no_grad()
    def eval_batch(params, state, x0b, yb, maskb, tau, k_cpt, rng=None,
                   drop=None):
        ctx = Ctx(train=False, rng=rng, tau=tau, eps=eps_rte, k_cpt=k_cpt,
                  masks=drop, model=model)
        recs, _ = net.forward(params, state, x0b, yb, ctx)
        net.route_for_stats(recs, batch_size, ctx)
        stats = state_stats(net, recs, yb)

        def msum(v):
            m = maskb.reshape((-1,) + (1,) * (v.dim() - 1))
            return torch.sum(v * m, dim=0)

        return {k: msum(v) for k, v in stats.items()}

    return eval_batch


def _has_active_dropout(net):
    """True if a layer of the net is a Dropout with λ < 1: only then do
    the evaluators thread a Dropout stream per batch (Dropout is not gated
    by mode, as in the reference)."""
    return net._has_dropout


_SAMPLE_STREAM = 7919  # seed tag separating batch sampling from augmentation
_DROP_STREAM = 7927  # seed tag of the step's Dropout stream

# The counterpart of chaining `jax.random.fold_in`: a generator seed that
# is a function of integers only.
_fold = fold_stream


def _chunk_sampler(batch_size, x0_tr, y_tr, part=None):
    """sample_span(gen, seed, t_first, n) -> (xc, yc): one gather of
    n * batch_size rows drawn uniformly with replacement, reshaped to
    (n, batch_size, ...), the generator re-seeded from (seed, t_first);
    with part = (lo, hi, batch_size), only rows lo:hi of each batch are
    gathered, (n, hi - lo, ...). Under a bf16 policy the image chunk is
    stored bf16, as in `mpnn_tpu`."""

    def sample_span(gen, seed, t_first, n):
        gen.manual_seed(_fold(seed, _SAMPLE_STREAM, t_first))
        idx = torch.randint(0, x0_tr.shape[0], (n * batch_size,),
                            generator=gen, device=x0_tr.device)
        if part is not None:
            idx = idx.view(n, batch_size)[:, part[0]:part[1]].reshape(-1)
        b = _n_rows(batch_size, part)
        xc = x0_tr[idx].reshape((n, b) + tuple(x0_tr.shape[1:]))
        if ops_config.compute_dtype is not None:
            xc = xc.to(ops_config.compute_dtype)
        yc = y_tr[idx].reshape((n, b) + tuple(y_tr.shape[1:]))
        return xc, yc

    return sample_span


def _spans(t0, n_steps, sample_tile):
    """[(t_first, n)] of a chunk of n_steps steps from t0, laid out as
    `mpnn_tpu`'s `_tiled_scan_loop` lays them: tiles of
    min(sample_tile, n_steps) steps, then the remainder."""
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1 (got %r)" % (n_steps,))
    tile = min(sample_tile, n_steps)
    n_full, rem = divmod(n_steps, tile)
    spans = [(t0 + k * tile, tile) for k in range(n_full)]
    return spans + ([(t0 + n_full * tile, rem)] if rem else [])


def _run_spans(step, batch_size, sample_tile, carry, t0, seed, x0_tr,
               y_tr, m_sym, n_steps, k_cpt, part=None, on_step=None):
    """The chunked loop shared by `make_train_loop` and
    `make_sweep_train_loop` (the counterpart of `mpnn_tpu`'s
    `_tiled_scan_loop`): per span one gather from (seed, t_first), of this
    rank's rows under `part`, then `step` on each of its batches with the
    generator re-seeded from (seed, t), and `on_step(t)` after it where
    given. Returns (params, state, vel, losses[n_steps, ...])."""
    params, state, vel = carry
    gen = torch.Generator(device=x0_tr.device)
    sample_span = _chunk_sampler(batch_size, x0_tr, y_tr, part)
    cs = []
    for t_first, n in _spans(t0, n_steps, sample_tile):
        xc, yc = sample_span(gen, seed, t_first, n)
        for i in range(n):
            t = t_first + i
            gen.manual_seed(_fold(seed, t))
            params, state, vel, c = step(params, state, vel, t, gen, xc[i],
                                         yc[i], m_sym, k_cpt)
            cs.append(c)
            if on_step is not None:
                on_step(t)
    return params, state, vel, torch.stack(cs)


def make_train_loop(net, batch_size, schedules, r_shift=4, sample_tile=256,
                    mesh=None):
    """Chunked training: n_steps train steps in one call.

    loop(params, state, vel, t0, seed, x0_tr, y_tr, m_sym, n_steps,
         k_cpt=None, on_step=None) -> (params, state, vel, losses[n_steps])

    `seed` is an integer. Every `sample_tile` steps one gather pulls the
    tile's batches from the training split (`_chunk_sampler`); each step
    then augments its contiguous slice of it from the generator re-seeded
    from (seed, t). The returned trees are the trained ones: under
    `stacked_tails` the loop trains packed copies (`_packed`), so the
    arguments may hold the start of the span, and a caller uses what the
    loop returns. The losses stay on the device and the loop makes no
    host synchronisation. With a mesh, each step is `make_train_step`'s
    data-parallel step, and each span gathers only this rank's rows of
    its batches; the losses are the global batch's. `on_step(t)`, where
    given, is called after each step t (`train --profile-dir`'s hook)."""
    step = _train_step_body(net, batch_size, schedules, r_shift,
                            presampled=True, mesh=mesh)
    part = _data_part(mesh, batch_size)[1]

    def loop(params, state, vel, t0, seed, x0_tr, y_tr, m_sym, n_steps,
             k_cpt=None, on_step=None):
        return _packed(net, 0, lambda trees: _run_spans(
            step, batch_size, sample_tile, trees, t0, seed, x0_tr, y_tr,
            m_sym, n_steps, k_cpt, part, on_step), (params, state, vel))

    return loop


def _packed(net, axis, run, trees):
    """run(trees) -> (params, state, vel, losses), with the trees in
    `Net.pack_tree`'s layout (member axis at `axis`) while it runs when
    `stacked_tails` is on and the net has a stack plan; the trees go in
    and come out in the node layout."""
    if not (ops_config.stacked_tails and net._stack_plan):
        return run(trees)
    *out, cs = run(tuple(net.pack_tree(t, axis) for t in trees))
    return (*(net.unpack_tree(t, axis) for t in out), cs)


def make_sweep_train_loop(net, batch_size, schedules, r_shift=4,
                          sample_tile=256, mesh=None):
    """Train a whole k_cpt sweep of same-architecture nets at once.

    loop(params_s, state_s, vel_s, t0, seed, x0_tr, y_tr, m_sym, n_steps,
         k_cpts) -> (params_s, state_s, vel_s, losses[n_steps, n_nets])

    The trees carry the nets on a leading axis (`utils.tree.stack_trees`)
    and k_cpts is the (n_nets,) float32 tensor of their prices. Each step
    is `torch.func.vmap` of the loss over params, state and k_cpt, the
    members' gradients through it, then a vmap of TALR and analytic L2
    per member (`_sweep_members`), with the batch shared:
    it is sampled and augmented once, outside the vmap, on the chunked
    loop's spans and draws (`_run_spans`), so every net sees the same
    batch stream (the common random numbers of `mpnn_tpu`'s sweep) and
    member i takes the serial step of net i on it. Every stage of the
    forward is one launch of `fused_mcm`'s net axis for all the nets. One
    TF momentum update covers the stacked leaves (lr and μ are shared).
    The returned trees are the trained ones, as in `make_train_loop`;
    under `stacked_tails` the loop packs each group's members after the
    nets' axis (axis 1).

    With a ('sweep', 'data') mesh (`parallel.make_sweep_mesh`) the trees
    and k_cpts are this rank's members (`parallel.shard_sweep_tree`), and
    the losses too: each rank steps its members with no collective
    between nets, and a 'data' axis over several ranks splits each
    member's batch as `make_train_loop`'s mesh does. `stacked_tails`
    does not compose with a sweep mesh, as in `mpnn_tpu`: the loop
    refuses it."""
    _reject_stacked_mesh(mesh)
    step = _sweep_step_body(net, batch_size, schedules, r_shift, mesh)
    part = _data_part(mesh, batch_size)[1]

    def loop(params_s, state_s, vel_s, t0, seed, x0_tr, y_tr, m_sym, n_steps,
             k_cpts):
        # The flag is module state: check again when the loop runs.
        _reject_stacked_mesh(mesh)
        return _packed(net, 1, lambda trees: _run_spans(
            step, batch_size, sample_tile, trees, t0, seed, x0_tr, y_tr,
            m_sym, n_steps, k_cpts, part), (params_s, state_s, vel_s))

    return loop


def _reject_stacked_mesh(mesh):
    if mesh is not None and ops_config.stacked_tails:
        raise ValueError(
            "stacked_tails cannot compose with a sweep mesh (as in "
            "mpnn_tpu, whose conv batching under a double vmap and a "
            "sharding fails); disable ops.config.stacked_tails (drop "
            "--stacked-tails) for --vmap-sweep runs over a mesh")


def _sweep_step_body(net, batch_size, schedules, r_shift=4, mesh=None):
    """The sweep's step on a presampled batch (this rank's rows of it
    under a mesh's 'data' axis):

    step(params_s, state_s, vel_s, t, gen, xb, yb, m_sym, k_cpts)
        -> (params_s, state_s, vel_s, losses[n_nets])

    flips and shifts the shared batch from `gen`, then takes every
    member's step (see `make_sweep_train_loop`)."""
    if schedules.k_cpt_sample is not None:
        raise ValueError("a k_cpt sweep trains each net at its own static "
                         "k_cpt; per-example k_cpt sampling is not swept")
    mu = float(_hyper(net, "μ_lrn", 0.9))
    tau_default = float(_hyper(net, "τ", 1.0))
    axis, part = _data_part(mesh, batch_size)
    loss_and_grads, scale_grads = _sweep_members(
        net, _n_rows(batch_size, part), axis)

    def step(params_s, state_s, vel_s, t, gen, xb, yb, m_sym, k_cpts):
        xb, yb = augment_presampled(gen, xb, yb, m_sym, r_shift, part)
        tau = schedules.tau(t) if schedules.tau is not None else tau_default
        grads, (c, (state_s, p_tr_by_uid)) = loss_and_grads(
            params_s, state_s, k_cpts, xb, yb, tau,
            *_drop_stream(net, gen, t, xb, part))
        c, p_tr_by_uid, grads = _all_reduce_step(axis, c, p_tr_by_uid,
                                                 grads)
        # A profiler range: train_bench --profile reads the update's time.
        with torch.profiler.record_function("optimizer"):
            grads, c = scale_grads(params_s, grads, p_tr_by_uid, c)
            params_s, vel_s = momentum_update(params_s, vel_s, grads,
                                              schedules.lr(t), mu)
        if ops_config.debug_nans:
            check_nans(t, loss=c, gradients=grads, params=params_s,
                       state=state_s, velocity=vel_s)
        return params_s, state_s, vel_s, c

    return step


def _sweep_members(net, batch_size, axis=None):
    """(loss_and_grads, scale) of a sweep's members:

    loss_and_grads(params_s, state_s, k_cpts, xb, yb, tau, rng=None,
    masks=None) -> (grads_s, (losses, (state_s, p_tr_by_uid))): each
    member's loss (`torch.func.vmap` of `_loss_fn` over the nets) on the
    shared batch at its price, with the shared Dropout stream and masks
    (drawn outside the vmap, as JAX's `vstep` shares its key; without a
    stream Dropout is the identity), BatchNorm and the loss reduced over
    the 'data' `axis` where there is one; and each member's gradient,
    `torch.autograd.grad` of the sum of the members' losses through the
    vmapped forward: the members are independent, so each member's
    gradient is its own loss's. Under `ops.config.remat_policy` the
    vmapped forward is checkpointed as the single net's is (`_remat`);

    scale(params_s, grads_s, p_tr_by_uid, losses) -> (grads_s, losses):
    each member's analytic L2 and TALR (`_grad_transform`)."""
    eps_rte = float(_hyper(net, "ϵ", 1e-6))
    loss_fn = _loss_fn(net, batch_size)

    def member_loss(params, state, k_cpt, xb, yb, tau, rng, masks):
        return loss_fn(params, state, xb, yb, Ctx(
            train=True, rng=rng, tau=tau, eps=eps_rte, k_cpt=k_cpt,
            masks=masks, data=axis))

    losses = torch.func.vmap(member_loss, in_dims=(0, 0, 0) + (None,) * 5)

    def loss_and_grads(params_s, state_s, k_cpts, xb, yb, tau, rng=None,
                       masks=None):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params_s)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params_s)
        with torch.enable_grad():
            c, (state_s, p_tr_by_uid) = _remat(losses)(
                live, state_s, k_cpts, xb, yb, tau, rng, masks)
            grads = torch.autograd.grad(c.sum(), leaves,
                                        materialize_grads=True)
        it = iter(grads)
        return (tree_map(lambda _: next(it), params_s),
                (c.detach(), (state_s, {k: v.detach() for k, v in
                                        p_tr_by_uid.items()})))

    return loss_and_grads, torch.func.vmap(_grad_transform(net))


def make_eval_split_fn(net, batch_size, mesh=None):
    """A full-split evaluator.

    eval_split(params, state, x0s, ys, masks, tau, k_cpt, eval_key=None)
        -> {stat key: per-split SUM of the per-example stat}

    x0s / ys / masks are the (n_batches, B, ...) padded stacks of
    `Dataset.padded_split`; divide by the split's count for the means.
    The sums stay on the device. For a net with an active Dropout each
    batch draws its masks from a stream of its own, folded from the
    integer eval_key (0 if None) and the batch index, as `mpnn_tpu`
    splits its key per batch; the trainers pass a key of (seed, t), so
    every evaluation draws fresh masks. For other nets eval_key is
    ignored. With a mesh, each rank evaluates its rows of every batch
    (B = batch_size) and the sums are all-reduced over the 'data' axis
    once per split: every rank returns the whole split's sums. Params
    sharded over the mesh's 'model' axis are gathered as in the step."""
    axis, part = _data_part(mesh, batch_size)
    return _split_sums(net, _eval_batch_fn(net, _n_rows(batch_size, part),
                                           _model_of(mesh)), axis, part)


def make_sweep_eval_split_fn(net, batch_size, mesh=None):
    """The full-split evaluator of a k_cpt sweep: every member evaluated
    per batch (`torch.func.vmap` of the batch's stats over params, state
    and k_cpt, the batch and its Dropout masks shared). Takes stacked
    trees and a (n_nets,) k_cpt tensor; the sums carry a leading (n_nets,)
    axis. With a ('sweep', 'data') mesh, the trees are this rank's
    members, whose batches split over 'data' as `make_eval_split_fn`'s
    do."""
    axis, part = _data_part(mesh, batch_size)
    return _split_sums(net, torch.func.vmap(
        _eval_batch_fn(net, _n_rows(batch_size, part)),
        in_dims=(0, 0, None, None, None, None, 0, None, None)), axis, part)


def _split_sums(net, eval_batch, axis=None, part=None):
    """eval_split of `make_eval_split_fn`: `eval_batch` summed over the
    batches of a padded split (this rank's rows of each under `part`),
    each batch's Dropout masks drawn here, for the whole batch and outside
    any vmap, where the net has an active Dropout; the sums all-reduced
    over `axis` when it has several ranks."""
    use_rng = _has_active_dropout(net)

    def eval_split(params, state, x0s, ys, masks, tau, k_cpt,
                   eval_key=None):
        sums = None
        for i in range(x0s.shape[0]):
            rng = drop = None
            if use_rng:
                rng = _fold(0 if eval_key is None else eval_key, i)
                drop = {k: _rows(m, part) for k, m in net.dropout_masks(
                    rng, x0s.shape[1], x0s.device).items()}
            s = eval_batch(params, state, _rows(x0s[i], part),
                           _rows(ys[i], part), _rows(masks[i], part), tau,
                           k_cpt, rng, drop)
            sums = s if sums is None else {k: sums[k] + v
                                           for k, v in s.items()}
        if axis is not None and axis.reduces:
            keys = sorted(sums)
            sums = dict(zip(keys, all_reduce_flat(
                axis, [sums[k] for k in keys])[0]))
        return sums

    return eval_split


def init_training(net, seed=0, device="cuda"):
    """(params, state, vel) of a fresh net, drawn from `seed`."""
    params, state = net.init(torch.Generator().manual_seed(seed), device)
    return params, state, momentum_init(params)
