"""Routing trees in the port against mpnn_tpu on the CPU, fp32: the loss,
every gradient leaf, the BatchNorm state and the TALR-scaled gradients of
the actor and critic trees, at a static price and (dyn_k_cpt) at a price
per example, and a sweep step of trees against jax.vmap of mpnn_tpu's
step; the registry's
full-size dr_tree and a compact checkpoint of a trained tree read by both
packages. The small tree has dr_tree's shape cut to 3 stages on 16x16
inputs: a 2-way fan (its node also feeds a leaf, so a 3-way router) into
two 2-stage tails with a leaf and a 2-way router at each stage. Values
agree to 1e-5 in ||port - jax|| / ||jax||, gradients and parameters to
1e-4 per leaf."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu import experiments as jcfg
from mpnn_tpu import models as jmodels
from mpnn_tpu.models import steps as jsteps
from mpnn_tpu.models.optim import talr_scale_grads as j_talr
from mpnn_tpu.ops import layers as J
from mpnn_tpu.utils import serdes as jserdes
from mpnn_tpu_torch import experiments as tcfg
from mpnn_tpu_torch import models as tmodels
from mpnn_tpu_torch.models import steps as tsteps
from mpnn_tpu_torch.models.net import Ctx as TCtx
from mpnn_tpu_torch.models.optim import talr_scale_grads as t_talr
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils import serdes as tserdes
from mpnn_tpu_torch.utils.serdes import from_numpy_tree
from mpnn_tpu_torch.utils.tree import unstack_tree
from tests.test_torch_sweep_steps import _port_batch_from_jax_draws
from tests.test_torch_train import (
    B, EPS, K_CPT, LEAF_TOL, SCHED, TAU, VALUE_TOL, _assert_tree_close,
    _batch, _dataset, _jax_loss_and_grads, _port_loss_and_grads, _randomize)
from tests.torch_threads import share_cores  # noqa: F401

ARCH = [[8, 8, 8], [8, 8], [8]]
K_L2 = 1e-4
COMPACT = os.path.join(os.path.dirname(os.path.dirname(__file__)), "results",
                       "nets", "hybrid-ac-tree-dynkcpt", "net.npy.cz")


def build_tree(L, kind, x0_shape=(16, 16, 3), n_cls=10, **hypers):
    """dr_tree's shape at 3 stages: pyr -> fan node (leaf, tail, tail) ->
    tails of 2 stages (leaf, next) with a leaf at the end; an "ac", "cr"
    or "sr" net with the registry's k_l2."""
    def router(n_sinks):
        return L.Chain(name="Router", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=16, k_l2=K_L2), L.BatchNorm(),
            L.Rect(), L.LinTrans(n_chan=16, k_l2=K_L2), L.BatchNorm(),
            L.Rect(), L.LinTrans(n_chan=n_sinks, k_l2=K_L2, σ_w=0)])

    def reg():
        return L.Chain(name="LogReg", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=n_cls, k_l2=K_L2),
            L.Softmax(), L.CrossEntropyError()])

    def rcm(n_chan, *sinks):
        return L.Chain(name="ReConvMax", sinks=sinks,
                       router=router(len(sinks)) if len(sinks) > 1 else None,
                       comps=[L.MultiscaleConvMax(n_chan=n_chan, supp=3,
                                                  k_l2=K_L2),
                              L.MultiscaleBatchNorm(), L.MultiscaleRect()])

    def tail():
        return rcm(ARCH[1], reg(), rcm(ARCH[2], reg()))

    root = L.Chain(name="ToPyramid", sinks=[rcm(ARCH[0], reg(), tail(),
                                                tail())],
                   comps=[L.ToPyramid(n_scales=3)])
    mod = jmodels if L is J else tmodels
    cls = {"ac": mod.ActorNet, "cr": mod.CriticNet, "sr": mod.SRNet}[kind]
    hypers = {"k_cpt": K_CPT, **hypers}
    return cls(x0_shape=x0_shape, y_shape=(n_cls,), root=root, **hypers)


def random_tree_pair(kind, seed=4, **hypers):
    """(jnet, tnet, numpy params, numpy state) of the small tree with
    seeded random values in JAX's parameter structure (the routers split
    the batch)."""
    jnet = build_tree(J, kind, **hypers)
    tnet = build_tree(T, kind, **hypers)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    p, s = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    rng = np.random.RandomState(seed)
    return jnet, tnet, _randomize(p, rng), _randomize(s, rng)


def test_registry_tree_matches_jax():
    """dr_tree at the registry's size: 47 stages, 47 leaves, 39 switches
    (7 of them 3-way), every node's op count and the layer uids as
    mpnn_tpu builds them."""
    jnet = jcfg.ac_tree(dyn_k_cpt=True)((32, 32, 3), (10,))
    tnet = tcfg.ac_tree(dyn_k_cpt=True)((32, 32, 3), (10,))
    assert [len(n.sinks) for n in tnet.layers] == [
        len(n.sinks) for n in jnet.layers]
    assert len(list(tnet.leaves)) == 47
    assert sorted(len(sw.sinks) for sw in tnet.switches) == [2] * 32 + [3] * 7
    assert [n.n_ops for n in tnet.layers] == [n.n_ops for n in jnet.layers]
    assert [n.router.n_ops for n in tnet.switches] == [
        n.router.n_ops for n in jnet.switches]
    assert [l._uid for l in tnet.layers] == [l._uid for l in jnet.layers]


def _check_tree_step(kind, k_cpt, **hypers):
    """The tree's loss, every gradient leaf, the new BatchNorm state and
    the gradients after TALR against JAX's at price k_cpt (a float or a
    (B,) array), with the batch split over every leaf by the randomized
    routers."""
    jnet, tnet, p, s = random_tree_pair(kind, **hypers)
    x, y = _batch()
    (jc, (jstate, jp_tr)), jg = _jax_loss_and_grads(jnet, p, s, x, y, k_cpt)
    tp, ts = from_numpy_tree(p, s, device="cpu")
    tc, tstate, tp_tr, tg = _port_loss_and_grads(
        tnet, tp, ts, torch.as_tensor(x), torch.as_tensor(y),
        TCtx(train=True, tau=TAU, eps=EPS,
             k_cpt=k_cpt if np.isscalar(k_cpt) else torch.as_tensor(k_cpt)))
    assert abs(float(tc) - float(jc)) <= VALUE_TOL * abs(float(jc))
    _assert_tree_close(tg, jg, LEAF_TOL, zero_grad_biases=True)
    _assert_tree_close(tstate, jstate, VALUE_TOL)
    h = jnet.hypers
    _assert_tree_close(
        t_talr(tnet, tg, tp_tr, alpha_rtr=h.α_rtr, talr=h.talr),
        j_talr(jnet, jg, jp_tr, alpha_rtr=h.α_rtr, talr=h.talr), LEAF_TOL,
        zero_grad_biases=True)
    # Every leaf of the tree takes a share of the batch.
    leaf_p = [float(tp_tr[str(l._uid)].sum()) for l in tnet.leaves]
    assert len(leaf_p) == 5 and min(leaf_p) > 1e-3
    return tnet


@pytest.mark.parametrize("kind", ["ac", "cr"])
def test_tree_loss_and_grads_match_jax(kind):
    """A static-price tree, 1e-4 per leaf (_check_tree_step)."""
    _check_tree_step(kind, K_CPT)


@pytest.mark.parametrize("kind", ["ac", "cr"])
def test_dyn_k_cpt_tree_loss_and_grads_match_jax(kind):
    """An adaptive (dyn_k_cpt) tree at a (B,) price per example, as the
    adaptive trainer samples it: every router takes α_cpt·k_cpt as an
    extra input column, so its first weight matrix has a row for the
    price, whose gradient is held with the rest (1e-4 per leaf)."""
    k = np.linspace(0, 6.4e-8, B).astype(np.float32)
    tnet = _check_tree_step(kind, k, dyn_k_cpt=True)
    assert tnet.hypers.dyn_k_cpt and tnet.hypers.α_cpt * k.max() > 0.1


def test_tree_sweep_step_matches_jax():
    """One sweep step of 3 actor trees at their own prices, batch 8,
    against jax.vmap of mpnn_tpu's presampled step from JAX's stacked
    init: every member's params, state and velocity (1e-4 per leaf) and
    the losses."""
    from tests.test_torch_sweep import B, K_CPTS, N_NETS, _raw_batches
    jnet, tnet = build_tree(J, "ac"), build_tree(T, "ac")
    _, _, m_sym = _dataset()
    step = jsteps._train_step_body(jnet, B, jsteps.Schedules(**SCHED),
                                   presampled=True)
    vstep = jax.jit(jax.vmap(step, in_axes=(0, 0, 0, None, None, None,
                                            None, None, 0)))
    init = jax.jit(lambda: [jsteps.stack_trees(list(t)) for t in zip(
        *(jsteps.init_training(jnet, seed=i) for i in range(N_NETS)))])()
    ps, ss, vs = init
    init = jax.tree.map(np.array, init)
    rng = jax.random.PRNGKey(7)
    xb, yb = next(iter(_raw_batches()))
    batch = _port_batch_from_jax_draws(rng, 0, xb, yb, m_sym)
    jp, js, jv, jc = jax.tree.map(np.asarray, vstep(
        ps, ss, vs, 0, rng, jnp.asarray(xb), jnp.asarray(yb),
        jnp.asarray(m_sym), jnp.asarray(K_CPTS, jnp.float32)))
    tstep = tsteps._sweep_step_body(tnet, B, tsteps.Schedules(**SCHED),
                                    r_shift=0)
    tp, ts, tv = from_numpy_tree(*init, device="cpu")
    tp, ts, tv, c = tstep(tp, ts, tv, 0, torch.Generator().manual_seed(0),
                          *batch, torch.zeros(10), torch.tensor(K_CPTS))
    assert c.shape == (N_NETS,)
    for i in range(N_NETS):
        assert abs(float(c[i]) - float(jc[i])) <= VALUE_TOL * abs(
            float(jc[i]))
        _assert_tree_close(unstack_tree(tp, i), unstack_tree(jp, i),
                           LEAF_TOL, zero_grad_biases=True)
        _assert_tree_close(unstack_tree(ts, i), unstack_tree(js, i),
                           LEAF_TOL)
        _assert_tree_close(unstack_tree(tv, i), unstack_tree(jv, i),
                           LEAF_TOL, zero_grad_biases=True)


def test_compact_tree_checkpoint_reads_as_jax_reads_it():
    """The committed compact archive of the trained adaptive tree (its
    floats stored as bfloat16): the port's read_compact returns JAX's
    record bit for bit without ml_dtypes, and read_net of the directory
    rebuilds the 47-stage dyn_k_cpt tree with those arrays."""
    j = jserdes.read_compact(COMPACT)
    t = tserdes.read_compact(COMPACT)
    assert jax.tree.structure(t) == jax.tree.structure(j)
    for a, b in zip(jax.tree.leaves(t), jax.tree.leaves(j)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)
    net, params, state, extra = tserdes.read_net(COMPACT, "cpu")
    assert type(net).__name__ == "ActorNet" and net.hypers.dyn_k_cpt
    assert len(list(net.leaves)) == 47 and extra["t"] == 80000
    w = params["sinks"][0]["layer"]["comps"][0]["w_horz_0"]
    np.testing.assert_array_equal(
        w.numpy(), j["root"]["sinks"][0]["comps"][0]["params"]["w_horz_0"])


def test_steps_evals_and_serving_free_their_tensors():
    """A train step, an evaluation batch and a routed batch of the critic
    tree leave no tensor behind in reference cycles: with the garbage
    collector off, the live tensors do not grow from one call to the
    next (the recursive closures of the forward, the routing, the critic,
    TALR and the engine once kept every activation alive until a
    collection)."""
    import gc
    from mpnn_tpu_torch.models.infer import make_routed_infer_fn
    net = build_tree(T, "cr")
    p, s, v = tsteps.init_training(net, 0, "cpu")
    x = torch.rand(8, 16, 16, 3)
    y = torch.eye(10)[torch.randint(0, 10, (8,))]
    step = tsteps.make_train_step(
        net, 8, tsteps.Schedules(k_cpt_sample=[0.0, 1e-9]))
    gen = torch.Generator().manual_seed(0)
    evaluate = tsteps._eval_batch_fn(net, 8)
    infer = make_routed_infer_fn(net, 8, 0.5)

    def live():
        return sum(1 for o in gc.get_objects() if torch.is_tensor(o))

    gc.collect()
    gc.disable()
    try:
        counts = []
        for t in range(3):
            p, s, v, _ = step(p, s, v, t, gen, x, y, torch.zeros(10))
            evaluate(p, s, x, y, torch.ones(8), 1.0, 0.0)
            infer(p, s, x)
            counts.append(live())
    finally:
        gc.enable()
    assert counts[2] == counts[1], counts


def test_full_tree_checkpoint_round_trips_through_both_packages(tmp_path):
    """A 47-stage dyn_k_cpt tree's checkpoint, with momentum and step,
    written by the port, read and written again by mpnn_tpu, and read by
    the port: every array bit for bit, the hypers and the step kept."""
    net = tcfg.ac_tree(dyn_k_cpt=True)((32, 32, 3), (10,))
    params, state, vel = tsteps.init_training(net, 3, "cpu")
    a, b = str(tmp_path / "a.npy"), str(tmp_path / "b.npy")
    tserdes.write_net(a, net, params, state, extra={"vel": vel, "t": 7})
    jnet, jp, js, jextra = jserdes.read_net(a)
    assert len(list(jnet.leaves)) == 47 and int(jextra["t"]) == 7
    jserdes.write_net(b, jnet, jp, js, extra=jextra)
    net2, p2, s2, extra2 = tserdes.read_net(b, "cpu")
    assert vars(net2.hypers) == vars(net.hypers) and extra2["t"] == 7
    for x, y in ((params, p2), (state, s2), (vel, extra2["vel"])):
        _assert_tree_close(y, x, 0.0)
    ra = np.load(a, allow_pickle=True)[()]
    rb = np.load(b, allow_pickle=True)[()]
    assert jax.tree.structure(ra) == jax.tree.structure(rb)
