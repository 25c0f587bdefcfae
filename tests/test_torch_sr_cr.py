"""The port's SRNet and CriticNet against mpnn_tpu on the CPU, fp32: the
loss and every gradient leaf (after TALR for the critic) for the registry's
variants, and one and three whole train steps from JAX's init on the
batches JAX's steps drew. Nets are 3-stage chains over 16x16 inputs, the
shape of tests/test_torch_train.py; the critic's routers get seeded random
parameters so they split the batch. Values agree to 1e-5 in
||port - jax|| / ||jax||, gradients and parameters to 1e-4 per leaf."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu import models as jmodels
from mpnn_tpu.models import steps as jsteps
from mpnn_tpu.models.optim import talr_scale_grads as j_talr
from mpnn_tpu.ops import layers as J
from mpnn_tpu_torch import models as tmodels
from mpnn_tpu_torch.models import steps as tsteps
from mpnn_tpu_torch.models.net import Ctx as TCtx
from mpnn_tpu_torch.models.optim import talr_scale_grads as t_talr
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils.serdes import from_numpy_tree
from tests.test_torch_train import (
    EPS, K_CPT, LEAF_TOL, SCHED, TAU, VALUE_TOL, _assert_tree_close, _batch,
    _dataset, _jax_loss_and_grads, _port_batch_from_jax_draws,
    _port_loss_and_grads, _randomize)
from tests.torch_threads import share_cores  # noqa: F401

B = 32
ARCH = [[8, 8, 8], [8, 8], [8]]
K_L2 = 1e-4
N_STEPS = 3

# The registry's critic variants (mpnn_tpu/experiments.py: hybrid-cr,
# -opt, -clserr, -notalr).
CR_VARIANTS = {"default": {}, "optimistic": dict(optimistic=True),
               "use_cls_err": dict(use_cls_err=True),
               "notalr": dict(talr=False)}


def build_chain(L, kind, x0_shape=(16, 16, 3), n_cls=10, **hypers):
    """A 3-stage chain of `kind` "sr" (sr_chain's shape: one leaf at the
    end, no routers), "ac" or "cr" (dr_chain's shape: a leaf and a router
    at every stage), with the registry's k_l2."""
    def router():
        return L.Chain(name="Router", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=16, k_l2=K_L2), L.BatchNorm(),
            L.Rect(), L.LinTrans(n_chan=16, k_l2=K_L2), L.BatchNorm(),
            L.Rect(), L.LinTrans(n_chan=2, k_l2=K_L2, σ_w=0)])

    def reg():
        return L.Chain(name="LogReg", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=n_cls, k_l2=K_L2),
            L.Softmax(), L.CrossEntropyError()])

    def rcm(n_chan, *sinks):
        return L.Chain(name="ReConvMax", sinks=sinks,
                       router=router() if len(sinks) > 1 else None,
                       comps=[L.MultiscaleConvMax(n_chan=n_chan, supp=3,
                                                  k_l2=K_L2),
                              L.MultiscaleBatchNorm(), L.MultiscaleRect()])

    if kind == "sr":
        root = reg()
        for n_chan in reversed(ARCH):
            root = rcm(n_chan, root)
    else:
        root = rcm(ARCH[-1], reg())
        for n_chan in reversed(ARCH[:-1]):
            root = rcm(n_chan, reg(), root)
    root = L.Chain(name="ToPyramid", sinks=[root],
                   comps=[L.ToPyramid(n_scales=3)])
    mod = jmodels if L is J else tmodels
    cls = {"sr": mod.SRNet, "ac": mod.ActorNet, "cr": mod.CriticNet}[kind]
    if kind != "sr":
        hypers = {"k_cpt": K_CPT, **hypers}
    return cls(x0_shape=x0_shape, y_shape=(n_cls,), root=root, **hypers)


def random_pair(kind, seed=4, **hypers):
    """(jnet, tnet, numpy params, numpy state) with seeded random values in
    JAX's parameter structure."""
    jnet, tnet = build_chain(J, kind, **hypers), build_chain(T, kind, **hypers)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    p, s = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    rng = np.random.RandomState(seed)
    return jnet, tnet, _randomize(p, rng), _randomize(s, rng)


def _loss_and_grads_match(kind, **hypers):
    jnet, tnet, p, s = random_pair(kind, **hypers)
    x, y = _batch()
    (jc, (jstate, jp_tr)), jg = _jax_loss_and_grads(jnet, p, s, x, y)
    tp, ts = from_numpy_tree(p, s, device="cpu")
    tc, tstate, tp_tr, tg = _port_loss_and_grads(
        tnet, tp, ts, torch.as_tensor(x), torch.as_tensor(y),
        TCtx(train=True, tau=TAU, eps=EPS, k_cpt=K_CPT))
    assert tc.dim() == 0 and tc.dtype == torch.float32
    assert abs(float(tc) - float(jc)) <= VALUE_TOL * abs(float(jc))
    _assert_tree_close(tg, jg, LEAF_TOL, zero_grad_biases=True)
    _assert_tree_close(tstate, jstate, VALUE_TOL)
    return jnet, tnet, jg, jp_tr, tg, tp_tr


def test_sr_loss_and_grads_match_jax():
    """SRNet: the summed-cost loss, p_ev = 1 everywhere and no p_tr, so no
    TALR; every gradient leaf."""
    jnet, tnet, _, _, _, tp_tr = _loss_and_grads_match("sr")
    assert not tnet.uses_expectation_optimizer
    assert tp_tr == {}
    assert not list(tnet.switches)


@pytest.mark.parametrize("variant", list(CR_VARIANTS))
def test_critic_loss_and_grads_match_jax(variant):
    """CriticNet: the post-order costs-to-go (optimistic and use_cls_err
    change the targets and the error term), the sg(p_tr)-weighted loss,
    every gradient leaf, and the gradients after TALR."""
    hypers = CR_VARIANTS[variant]
    jnet, tnet, jg, jp_tr, tg, tp_tr = _loss_and_grads_match("cr", **hypers)
    h = jnet.hypers
    _assert_tree_close(
        t_talr(tnet, tg, tp_tr, alpha_rtr=h.α_rtr, talr=h.talr),
        j_talr(jnet, jg, jp_tr, alpha_rtr=h.α_rtr, talr=h.talr), LEAF_TOL,
        zero_grad_biases=True)


def test_critic_cost_to_go_matches_jax():
    """c_ev, c_opt and c_cre of every node, from the same routed records."""
    jnet, tnet, p, s = random_pair("cr", optimistic=True)
    x, y = _batch()

    def jf(p, s, x, y):
        ctx = jmodels.net.Ctx(train=True, tau=TAU, eps=EPS, k_cpt=K_CPT)
        recs, _ = jnet.forward(p, s, x, y, ctx)
        jmodels.routing.propagate(jnet, recs, B, TAU, EPS)
        jnet._cost_to_go(recs, ctx)
        return [(recs[l].c_ev, recs[l].c_opt, recs[l].c_cre)
                for l in jnet.layers]

    jout = jax.jit(jf)(*jax.tree.map(jnp.asarray, (p, s, x, y)))
    tp, ts = from_numpy_tree(p, s, device="cpu")
    ctx = TCtx(train=True, tau=TAU, eps=EPS, k_cpt=K_CPT)
    recs, _ = tnet.forward(tp, ts, torch.as_tensor(x), torch.as_tensor(y),
                           ctx)
    tmodels.propagate(tnet, recs, B, TAU, EPS)
    tnet._cost_to_go(recs, ctx)
    n_switch = 0
    for l, jvals in zip(tnet.layers, jout):
        for tv, jv in zip((recs[l].c_ev, recs[l].c_opt, recs[l].c_cre),
                          jvals):
            a = np.broadcast_to(np.asarray(torch.as_tensor(tv).detach()),
                                np.shape(jv))
            b = np.asarray(jv)
            assert np.linalg.norm(a - b) <= VALUE_TOL * max(
                np.linalg.norm(b), 1e-30), l.name
        n_switch += len(l.sinks) > 1
        assert isinstance(recs[l].c_cre, float) == (len(l.sinks) < 2)
    assert n_switch == 2


def _jax_steps(kind):
    """JAX's make_train_step for 3 steps from init_training(seed 0): its
    state after steps 1 and 3 and the batch each step saw, re-made by the
    port from JAX's draws."""
    jnet = build_chain(J, kind)
    ds = _dataset()
    x0_tr, y_tr, m_sym = (jnp.asarray(a) for a in ds)
    step = jsteps.make_train_step(jnet, B, jsteps.Schedules(**SCHED))
    jp, js, jv = jax.jit(lambda: jsteps.init_training(jnet, seed=0))()
    init = jax.tree.map(np.array, (jp, js, jv))  # copies: donated below
    rng = jax.random.PRNGKey(7)
    out, batches = {}, []
    for t in range(N_STEPS):
        batches.append(_port_batch_from_jax_draws(rng, t, ds))
        jp, js, jv, c = step(jp, js, jv, t, rng, x0_tr, y_tr, m_sym)
        out[t + 1] = jax.tree.map(np.array, (jp, js, jv, c))
    return init, out, batches


@pytest.fixture(scope="module", params=["sr", "cr"])
def jax_steps(request):
    return (request.param,) + _jax_steps(request.param)


@pytest.mark.parametrize("n_steps", [1, N_STEPS])
def test_train_steps_match_jax(jax_steps, n_steps):
    """Whole steps of SRNet (plain momentum) and CriticNet (TALR): params,
    state, vel and the loss after 1 and 3 steps, on JAX's batches."""
    kind, init, out, batches = jax_steps
    tnet = build_chain(T, kind)
    step = tsteps._train_step_body(tnet, B, tsteps.Schedules(**SCHED),
                                   r_shift=0, presampled=True)
    tp, ts, tv = from_numpy_tree(*init, device="cpu")
    gen = torch.Generator().manual_seed(0)
    no_flip = torch.zeros(10)
    for t in range(n_steps):
        xb, yb = batches[t]
        tp, ts, tv, c = step(tp, ts, tv, t, gen, xb, yb, no_flip)
    jp, js, jv, jc = out[n_steps]
    assert abs(float(c) - float(jc)) <= VALUE_TOL * abs(float(jc))
    _assert_tree_close(tp, jp, LEAF_TOL, zero_grad_biases=True)
    _assert_tree_close(ts, js, LEAF_TOL)
    _assert_tree_close(tv, jv, LEAF_TOL, zero_grad_biases=True)
