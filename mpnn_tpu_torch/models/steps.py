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
uninterrupted run draws. `make_eval_split_fn` loops `_eval_batch_fn`
over a padded split. The vmapped sweep of `mpnn_tpu` is not ported."""

import numpy as np
import torch

from ..data.augment import augment_presampled, augmented_batch
from ..ops import config as ops_config
from ..utils.tree import tree_leaves, tree_map
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


def _step_pieces(net, batch_size, schedules, r_shift, presampled):
    """(batch_ctx, loss_and_grads) closures of the step.

    batch_ctx(t, gen, x0_tr, y_tr, m_sym, k_cpt) -> (xb, yb, ctx) samples
    and augments the batch from the generator `gen` (with presampled, x0_tr
    and y_tr are the batch itself and only flip and shift run).

    loss_and_grads(params, state, xb, yb, ctx) -> (c_tot, new_state,
    p_tr_by_uid, grads): grads has the structure of params; p_tr_by_uid
    holds each node's detached p_tr of the same forward."""
    eps_rte = float(_hyper(net, "ϵ", 1e-6))
    tau_default = float(_hyper(net, "τ", 1.0))
    k_cpt_static = _hyper(net, "k_cpt", 0.0)
    k_cpt_values = {}  # device -> schedules.k_cpt_sample as a tensor

    def batch_ctx(t, gen, x0_tr, y_tr, m_sym, k_cpt):
        if presampled:
            xb, yb = augment_presampled(gen, x0_tr, y_tr, m_sym, r_shift)
        else:
            xb, yb = augmented_batch(gen, x0_tr, y_tr, m_sym, batch_size,
                                     r_shift)
        tau = schedules.tau(t) if schedules.tau is not None else tau_default
        if schedules.k_cpt_sample is not None:
            dev = xb.device
            if dev not in k_cpt_values:
                k_cpt_values[dev] = torch.as_tensor(schedules.k_cpt_sample,
                                                    device=dev)
            vals = k_cpt_values[dev]
            k_cpt = vals[torch.randint(0, len(vals), (batch_size,),
                                       generator=gen, device=dev)]
        elif k_cpt is None:
            k_cpt = k_cpt_static
        return xb, yb, Ctx(train=True, tau=tau, eps=eps_rte, k_cpt=k_cpt)

    def loss_and_grads(params, state, xb, yb, ctx):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            recs, new_state = net.forward(live, state, xb, yb, ctx)
            c_tot = net.loss(recs, batch_size, ctx)
            grads = torch.autograd.grad(c_tot, leaves,
                                        materialize_grads=True)
        p_tr_by_uid = {str(l._uid): recs[l].p_tr.detach()
                       for l in net.layers if recs[l].p_tr is not None}
        it = iter(grads)
        return (c_tot.detach(), new_state, p_tr_by_uid,
                tree_map(lambda _: next(it), params))

    return batch_ctx, loss_and_grads


def make_train_step(net, batch_size, schedules, r_shift=4):
    """The train step.

    step(params, state, vel, t, gen, x0_tr, y_tr, m_sym, k_cpt=None)
        -> (params, state, vel, c_tot)

    params and vel are updated in place and returned; state is a new tree
    (BatchNorm running statistics); c_tot is the loss as a device scalar.
    x0_tr / y_tr / m_sym are the training split on the device, `gen` a
    torch.Generator on the same device, `t` the host step counter of the
    schedules; k_cpt overrides the net's static price."""
    return _train_step_body(net, batch_size, schedules, r_shift)


def _train_step_body(net, batch_size, schedules, r_shift=4,
                     presampled=False):
    """The single train step; with presampled, x0_tr / y_tr are the step's
    already gathered batch and only flip and shift run."""
    mu = float(_hyper(net, "μ_lrn", 0.9))
    alpha_rtr = float(_hyper(net, "α_rtr", 1.0))
    talr = bool(_hyper(net, "talr", True))
    batch_ctx, loss_and_grads = _step_pieces(net, batch_size, schedules,
                                             r_shift, presampled)

    def step(params, state, vel, t, gen, x0_tr, y_tr, m_sym, k_cpt=None):
        xb, yb, ctx = batch_ctx(t, gen, x0_tr, y_tr, m_sym, k_cpt)
        c_tot, new_state, p_tr_by_uid, grads = loss_and_grads(
            params, state, xb, yb, ctx)
        # A profiler range: train_bench --profile reads the update's time.
        with torch.profiler.record_function("optimizer"):
            if ops_config.analytic_l2:
                grads, c_l2 = tree_l2_decay(net, params, grads, p_tr_by_uid)
                c_tot = c_tot + c_l2
            if net.uses_expectation_optimizer:
                grads = talr_scale_grads(net, grads, p_tr_by_uid,
                                         alpha_rtr=alpha_rtr, talr=talr)
            params, vel = momentum_update(params, vel, grads,
                                          schedules.lr(t), mu)
        return params, new_state, vel, c_tot

    return step


def _eval_batch_fn(net, batch_size):
    """eval_batch(params, state, x0b, yb, maskb, tau, k_cpt) -> dict of the
    per-example stats summed over the examples where maskb is 1 (padding
    rows carry 0)."""
    eps_rte = float(_hyper(net, "ϵ", 1e-6))

    @torch.no_grad()
    def eval_batch(params, state, x0b, yb, maskb, tau, k_cpt):
        ctx = Ctx(train=False, tau=tau, eps=eps_rte, k_cpt=k_cpt)
        recs, _ = net.forward(params, state, x0b, yb, ctx)
        net.route_for_stats(recs, batch_size, ctx)
        stats = state_stats(net, recs, yb)

        def msum(v):
            m = maskb.reshape((-1,) + (1,) * (v.dim() - 1))
            return torch.sum(v * m, dim=0)

        return {k: msum(v) for k, v in stats.items()}

    return eval_batch


_SAMPLE_STREAM = 7919  # seed tag separating batch sampling from augmentation
_MASK64 = (1 << 64) - 1


def _splitmix64(x):
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def _fold(seed, *tags):
    """A generator seed that is a function of integers only (the
    counterpart of chaining `jax.random.fold_in`): splitmix64 over the
    sequence, cut to 63 bits."""
    h = _splitmix64(int(seed) & _MASK64)
    for tag in tags:
        h = _splitmix64(h ^ (int(tag) & _MASK64))
    return h >> 1


def _chunk_sampler(batch_size, x0_tr, y_tr):
    """sample_span(gen, seed, t_first, n) -> (xc, yc): one gather of
    n * batch_size rows drawn uniformly with replacement, reshaped to
    (n, batch_size, ...), the generator re-seeded from (seed, t_first).
    Under a bf16 policy the image chunk is stored bf16, as in `mpnn_tpu`."""

    def sample_span(gen, seed, t_first, n):
        gen.manual_seed(_fold(seed, _SAMPLE_STREAM, t_first))
        idx = torch.randint(0, x0_tr.shape[0], (n * batch_size,),
                            generator=gen, device=x0_tr.device)
        xc = x0_tr[idx].reshape((n, batch_size) + tuple(x0_tr.shape[1:]))
        if ops_config.compute_dtype is not None:
            xc = xc.to(ops_config.compute_dtype)
        yc = y_tr[idx].reshape((n, batch_size) + tuple(y_tr.shape[1:]))
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


def make_train_loop(net, batch_size, schedules, r_shift=4, sample_tile=256):
    """Chunked training: n_steps train steps in one call.

    loop(params, state, vel, t0, seed, x0_tr, y_tr, m_sym, n_steps,
         k_cpt=None) -> (params, state, vel, losses[n_steps])

    `seed` is an integer. Every `sample_tile` steps one gather pulls the
    tile's batches from the training split (`_chunk_sampler`); each step
    then augments its contiguous slice of it from the generator re-seeded
    from (seed, t). params and vel are updated in place; the losses stay
    on the device and the loop makes no host synchronisation."""
    step = _train_step_body(net, batch_size, schedules, r_shift,
                            presampled=True)

    def loop(params, state, vel, t0, seed, x0_tr, y_tr, m_sym, n_steps,
             k_cpt=None):
        gen = torch.Generator(device=x0_tr.device)
        sample_span = _chunk_sampler(batch_size, x0_tr, y_tr)
        cs = []
        for t_first, n in _spans(t0, n_steps, sample_tile):
            xc, yc = sample_span(gen, seed, t_first, n)
            for i in range(n):
                t = t_first + i
                gen.manual_seed(_fold(seed, t))
                params, state, vel, c = step(params, state, vel, t, gen,
                                             xc[i], yc[i], m_sym, k_cpt)
                cs.append(c)
        return params, state, vel, torch.stack(cs)

    return loop


def make_eval_split_fn(net, batch_size):
    """A full-split evaluator.

    eval_split(params, state, x0s, ys, masks, tau, k_cpt, eval_key=None)
        -> {stat key: per-split SUM of the per-example stat}

    x0s / ys / masks are the (n_batches, B, ...) padded stacks of
    `Dataset.padded_split`; divide by the split's count for the means.
    The sums stay on the device. eval_key seeds dropout noise in
    `mpnn_tpu`; the port has no Dropout, so it is accepted and ignored,
    as JAX ignores it for dropout-free nets."""
    eval_batch = _eval_batch_fn(net, batch_size)

    def eval_split(params, state, x0s, ys, masks, tau, k_cpt,
                   eval_key=None):
        sums = None
        for i in range(x0s.shape[0]):
            s = eval_batch(params, state, x0s[i], ys[i], masks[i], tau,
                           k_cpt)
            sums = s if sums is None else {k: sums[k] + v
                                           for k, v in s.items()}
        return sums

    return eval_split


def init_training(net, seed=0, device="cuda"):
    """(params, state, vel) of a fresh net, drawn from `seed`."""
    params, state = net.init(torch.Generator().manual_seed(seed), device)
    return params, state, momentum_init(params)
