"""The congruent-subtree stack plan of the port (`ops.config.stacked_tails`)
against mpnn_tpu's on the CPU, fp32, on the 3-stage 16x16 tree of
tests/test_torch_tree.py (its two 2-stage tails are congruent) and on a
3-stage chain whose first two LogReg leaves are congruent.

The plan's groups, members and preorders are JAX's, by uid, on those nets
and on the registry's dr_tree and dr_chain. From the same numpy params the
stacked forward's records, loss, BatchNorm state, gradients and
TALR-scaled gradients equal JAX's stacked path (values 1e-5 in
||port - jax|| / ||jax||, gradients 1e-4 per leaf), and the port's serial
path to the same tolerances. pack_tree / unpack_tree round-trip bit for
bit at axis 0 and 1; the packed forward is the dynamically stacked one;
the loops stacked track the serial loops and resume bit for bit at a span
boundary; the stacked evaluators equal the serial ones; the stacked
forward leaves no tensor behind; fused_mcm under nested vmaps folds every
level into one call of the net axis, with mcm_ref's values and gradients.

Not ported here: JAX's Dropout member streams (the port has no Dropout)
and its two mesh tests (the port has no meshes)."""

import gc

import numpy as np
import pytest
import torch

from mpnn_tpu import experiments as jcfg
from mpnn_tpu import models as jmodels
from mpnn_tpu.models.optim import talr_scale_grads as j_talr
from mpnn_tpu.ops import config as jconfig
from mpnn_tpu.ops import layers as J
from mpnn_tpu_torch import experiments as tcfg
from mpnn_tpu_torch import models as tmodels
from mpnn_tpu_torch.models import steps as tsteps
from mpnn_tpu_torch.models.net import Ctx as TCtx
from mpnn_tpu_torch.models.optim import talr_scale_grads as t_talr
from mpnn_tpu_torch.ops import config as tconfig
from mpnn_tpu_torch.ops import kernels
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils.serdes import from_numpy_tree
from mpnn_tpu_torch.utils.tree import stack_trees, tree_leaves, tree_map
from tests.test_torch_train import (
    B, EPS, K_CPT, K_L2, LEAF_TOL, TAU, VALUE_TOL, _assert_tree_close,
    _batch, _check_value, _jax_loss_and_grads, _jax_run, _port_loss_and_grads)
from tests.test_torch_tree import build_tree, random_tree_pair
from tests.torch_threads import share_cores  # noqa: F401

SCHED = dict(lr=lambda t: 0.02, tau=lambda t: 1.0 / 2 ** (t / 4))
# The stacked and serial loops after a few steps: fp32 reassociation in the
# vmapped stages moves the trajectory by reorder noise (mpnn_tpu's own
# gates for the same comparison, tests/test_stacked.py).
LOOP_TOL = dict(rtol=5e-3, atol=1e-5)


@pytest.fixture
def stacked():
    """The flag on in both packages for the test, off after it."""
    tconfig.set_stacked_tails(True)
    jconfig.set_stacked_tails(True)
    yield
    tconfig.set_stacked_tails(False)
    jconfig.set_stacked_tails(False)


def _chain(L, kind="ac"):
    """A 3-stage chain whose first two stages output the same 2-scale
    pyramid, so their LogReg leaves are congruent (a leaf-only group, as
    dr_chain's)."""
    def router():
        return L.Chain(name="Router", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=16, k_l2=K_L2), L.BatchNorm(),
            L.Rect(), L.LinTrans(n_chan=2, k_l2=K_L2, σ_w=0)])

    def reg():
        return L.Chain(name="LogReg", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=10, k_l2=K_L2), L.Softmax(),
            L.CrossEntropyError()])

    def rcm(n_chan, *sinks):
        return L.Chain(name="ReConvMax", sinks=sinks,
                       router=router() if len(sinks) > 1 else None,
                       comps=[L.MultiscaleConvMax(n_chan=n_chan, supp=3,
                                                  k_l2=K_L2),
                              L.MultiscaleBatchNorm(), L.MultiscaleRect()])

    root = rcm([8], reg())
    for n_chan in ([8, 8], [8, 8]):
        root = rcm(n_chan, reg(), root)
    root = L.Chain(name="ToPyramid", sinks=[root],
                   comps=[L.ToPyramid(n_scales=3)])
    mod = jmodels if L is J else tmodels
    return mod.ActorNet(x0_shape=(16, 16, 3), y_shape=(10,), root=root,
                        k_cpt=K_CPT)


def _plan_uids(net):
    return [[[n._uid for n in pre] for pre in g["preorders"]]
            for g in net._stack_plan]


NETS = {
    "tree": lambda L: build_tree(L, "ac"),
    "chain": _chain,
    "dr_tree": lambda L: (jcfg if L is J else tcfg).ac_tree(
        dyn_k_cpt=True)((32, 32, 3), (10,)),
    "dr_chain": lambda L: (jcfg if L is J else tcfg).ac_chain()(
        (32, 32, 3), (10,)),
}


@pytest.mark.parametrize("name", list(NETS))
def test_stack_plan_matches_jax(name):
    """The same groups, members and preorders as mpnn_tpu's plan, by uid
    (so the packed layouts line up leaf for leaf); dr_tree's eight
    10-node tails are its first group, and chains group leaves only."""
    jnet, tnet = NETS[name](J), NETS[name](T)
    assert _plan_uids(tnet) == _plan_uids(jnet) and tnet._stack_plan
    widths = [(len(g["members"]), len(g["preorders"][0]))
              for g in tnet._stack_plan]
    if name == "dr_tree":
        assert widths[0] == (8, 10)
    if name.endswith("chain"):
        assert all(size == 1 for _, size in widths)


def _port_step(tnet, p, s, x, y, k_cpt, pack=False):
    """The port's loss, new state, p_tr and gradients (node layout) of
    one forward from numpy params."""
    tp, ts = from_numpy_tree(p, s, device="cpu")
    if pack:
        tp, ts = tnet.pack_tree(tp), tnet.pack_tree(ts)
    ctx = TCtx(train=True, tau=TAU, eps=EPS,
               k_cpt=k_cpt if np.isscalar(k_cpt) else torch.as_tensor(k_cpt))
    c, state, p_tr, g = _port_loss_and_grads(
        tnet, tp, ts, torch.as_tensor(x), torch.as_tensor(y), ctx)
    if pack:
        state, g = tnet.unpack_tree(state), tnet.unpack_tree(g)
    return c, state, p_tr, g


@pytest.mark.parametrize("kind,price", [
    ("ac", "static"), ("cr", "static"), ("sr", "static"),
    ("ac", "per_example")])
def test_stacked_step_matches_jax(stacked, kind, price):
    """Loss, BatchNorm state, every gradient leaf and (actor, critic) the
    TALR-scaled gradients of the stacked forward against mpnn_tpu's
    stacked forward; the port's stacked path (stacked in the forward,
    and packed) against its serial path. per_example is the adaptive
    tree: dyn_k_cpt, a price per example."""
    hypers = {"dyn_k_cpt": True} if price == "per_example" else {}
    k_cpt = (np.linspace(0, 6.4e-8, B).astype(np.float32)
             if price == "per_example" else K_CPT)
    jnet, tnet, p, s = random_tree_pair(kind, **hypers)
    x, y = _batch()
    (jc, (jstate, jp_tr)), jg = _jax_loss_and_grads(jnet, p, s, x, y, k_cpt)
    runs = {"stacked": _port_step(tnet, p, s, x, y, k_cpt),
            "packed": _port_step(tnet, p, s, x, y, k_cpt, pack=True)}
    tconfig.set_stacked_tails(False)
    serial = _port_step(tnet, p, s, x, y, k_cpt)
    for tc, tstate, tp_tr, tg in list(runs.values()) + [serial]:
        assert abs(float(tc) - float(jc)) <= VALUE_TOL * abs(float(jc))
        _assert_tree_close(tg, jg, LEAF_TOL, zero_grad_biases=True)
        _assert_tree_close(tstate, jstate, VALUE_TOL)
    for name, (tc, tstate, tp_tr, tg) in runs.items():
        assert abs(float(tc) - float(serial[0])) <= VALUE_TOL * abs(
            float(serial[0]))
        _assert_tree_close(tg, serial[3], LEAF_TOL, zero_grad_biases=True)
        if kind != "sr":
            # TALR of the packed layout, per member of each group.
            h = jnet.hypers
            if name == "packed":
                tg = tnet.pack_tree(tg)
            scaled = t_talr(tnet, tg, tp_tr, alpha_rtr=h.α_rtr,
                            talr=h.talr)
            if name == "packed":
                scaled = tnet.unpack_tree(scaled)
            _assert_tree_close(
                scaled,
                j_talr(jnet, jg, jp_tr, alpha_rtr=h.α_rtr, talr=h.talr),
                LEAF_TOL, zero_grad_biases=True)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_stacked_records_match_jax(stacked, train):
    """Every node's record of the stacked forward (outputs, loss terms,
    router logits, and after routing p_tr / p_ev) against mpnn_tpu's
    stacked forward, and the new state."""
    jnet, tnet, p, s = random_tree_pair("ac")
    x, y = _batch()
    jrecs, jstate, _ = _jax_run(jnet, p, s, x, y, train, route=True)
    tp, ts = from_numpy_tree(p, s, device="cpu")
    ctx = TCtx(train=train, tau=TAU, eps=EPS, k_cpt=K_CPT)
    with torch.no_grad():
        trecs, tstate = tnet.forward(tp, ts, torch.as_tensor(x),
                                     torch.as_tensor(y), ctx)
        tnet.route_for_stats(trecs, B, ctx)
    for jl, tl in zip(jnet.layers, tnet.layers):
        jr, tr = jrecs[jl], trecs[tl]
        xs = jr.x if isinstance(jr.x, list) else [jr.x]
        txs = tr.x if isinstance(tr.x, list) else [tr.x]
        assert len(txs) == len(xs)
        for a, b in zip(txs, xs):
            _check_value(a, b, jl.name)
        for f in ("c_err", "c_mod", "delta_cor", "router_x",
                  "router_c_mod", "p_tr", "p_ev"):
            _check_value(getattr(tr, f), getattr(jr, f), (jl.name, f))
    _assert_tree_close(tstate, jstate, VALUE_TOL)


@pytest.mark.parametrize("axis", [0, 1])
def test_pack_unpack_round_trip(axis):
    """pack_tree / unpack_tree are inverses bit for bit, for params, state
    and velocity, at member axis 0 and (leaves with a leading sweep
    axis) 1; the packed layout holds each group's members stacked."""
    net = build_tree(T, "ac")
    trees = tsteps.init_training(net, 3, "cpu")
    if axis:
        trees = [stack_trees([t, tree_map(lambda a: a + 1.0, t)])
                 for t in trees]
    for tree in trees:
        packed = net.pack_tree(tree, axis)
        assert net.is_packed(packed) and not net.is_packed(tree)
        g = net._stack_plan[0]
        assert all(a.shape[axis] == len(g["members"])
                   for a in tree_leaves(packed["groups"][0]))
        back = net.unpack_tree(packed, axis)
        a, b = tree_leaves(tree), tree_leaves(back)
        assert len(a) == len(b)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_packed_forward_matches_dynamic_stacking(stacked):
    """The forward on pack_tree's layout is the forward that stacks the
    members itself: records bit for bit, the new state equal unpacked."""
    net = build_tree(T, "cr")
    params, state, _ = tsteps.init_training(net, 3, "cpu")
    x, y = (torch.as_tensor(a) for a in _batch())
    ctx = TCtx(train=True, tau=0.8, eps=EPS, k_cpt=K_CPT)
    recs, ns = net.forward(params, state, x, y, ctx)
    recs_p, ns_p = net.forward(net.pack_tree(params), net.pack_tree(state),
                               x, y, ctx)
    assert net.is_packed(ns_p)
    for node in net.layers:
        for f in ("x", "c_err", "c_mod", "router_x"):
            a, b = getattr(recs[node], f), getattr(recs_p[node], f)
            assert type(a) is type(b)
            for u, v in zip(tree_leaves(a), tree_leaves(b)):
                assert (torch.equal(u, v) if torch.is_tensor(u)
                        else u == v), (node._uid, f)
    assert all(torch.equal(u, v) for u, v in zip(
        tree_leaves(ns), tree_leaves(net.unpack_tree(ns_p))))
    with pytest.raises(ValueError, match="packed"):
        net.forward(net.pack_tree(params), state, x, y, ctx)


def _data(n=48, seed=2):
    rng = np.random.RandomState(seed)
    x0 = torch.as_tensor(rng.rand(n, 16, 16, 3).astype(np.float32))
    y = torch.eye(10)[torch.as_tensor(rng.randint(0, 10, n))]
    return x0, y, torch.as_tensor(np.array([0] * 5 + [1] * 5, np.float32))


@pytest.mark.parametrize("analytic_l2", [False, True],
                         ids=["in_graph_l2", "analytic_l2"])
def test_stacked_train_loop_matches_serial(stacked, analytic_l2):
    """make_train_loop with the tails packed through the loop (the packed
    TALR, analytic L2 and momentum) tracks the serial loop over 5 steps,
    returns the node layout, and resumed at a span boundary ends bit for
    bit where the uninterrupted stacked run ends."""
    net = build_tree(T, "ac")
    data = _data()
    tconfig.set_analytic_l2(analytic_l2)
    try:
        def run(flag, spans):
            tconfig.set_stacked_tails(flag)
            trees = tsteps.init_training(net, 0, "cpu")
            loop = tsteps.make_train_loop(net, 8, tsteps.Schedules(**SCHED),
                                          sample_tile=3)
            cs, t = [], 0
            for n in spans:
                *trees, c = loop(*trees, t, 5, *data, n)
                cs.append(c)
                t += n
            assert not net.is_packed(trees[0])
            return torch.cat(cs), trees

        cs_s, serial = run(False, [5])
        cs_p, stacked_run = run(True, [5])
        cs_r, resumed = run(True, [3, 2])
    finally:
        tconfig.set_analytic_l2(False)
    np.testing.assert_allclose(cs_p.numpy(), cs_s.numpy(), rtol=1e-4)
    for a, b in zip(tree_leaves(stacked_run), tree_leaves(serial)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **LOOP_TOL)
    assert torch.equal(cs_r, cs_p)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed),
                                                 tree_leaves(stacked_run)))


def test_stacked_sweep_loop_matches_serial(stacked):
    """make_sweep_train_loop of 3 trees with the tails packed after the
    nets' axis (a vmap inside the sweep's vmap) tracks the plain sweep
    loop, and resumes at a span boundary bit for bit."""
    net = build_tree(T, "ac", k_cpt=0.0)
    data = _data()
    k = torch.tensor([0.0, 1e-9, 4e-9])

    def run(flag, spans):
        tconfig.set_stacked_tails(flag)
        members = [tsteps.init_training(net, i, "cpu") for i in range(3)]
        trees = [stack_trees([m[j] for m in members]) for j in range(3)]
        loop = tsteps.make_sweep_train_loop(
            net, 8, tsteps.Schedules(lr=SCHED["lr"], tau=SCHED["tau"]),
            sample_tile=2)
        cs, t = [], 0
        for n in spans:
            *trees, c = loop(*trees, t, 5, *data, n, k)
            cs.append(c)
            t += n
        assert not net.is_packed(trees[0])
        return torch.cat(cs), trees

    cs_s, serial = run(False, [3])
    cs_p, stacked_run = run(True, [3])
    cs_r, resumed = run(True, [2, 1])
    assert cs_p.shape == (3, 3)
    np.testing.assert_allclose(cs_p.numpy(), cs_s.numpy(), rtol=1e-4,
                               atol=1e-6)
    for a, b in zip(tree_leaves(stacked_run), tree_leaves(serial)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **LOOP_TOL)
    assert torch.equal(cs_r, cs_p)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed),
                                                 tree_leaves(stacked_run)))


@pytest.mark.parametrize("sweep", [False, True], ids=["net", "sweep"])
def test_stacked_eval_split_matches_serial(stacked, sweep):
    """The full-split evaluators (one net, and a sweep of 2) under the
    flag give the serial sums."""
    net = build_tree(T, "ac")
    rng = np.random.RandomState(5)
    x0s = torch.as_tensor(rng.rand(2, 8, 16, 16, 3).astype(np.float32))
    ys = torch.eye(10)[torch.as_tensor(rng.randint(0, 10, (2, 8)))]
    masks = torch.ones(2, 8)
    masks[1, 5:] = 0
    params, state, _ = tsteps.init_training(net, 2, "cpu")
    if sweep:
        other = tsteps.init_training(net, 3, "cpu")
        params, state = (stack_trees([a, b]) for a, b in
                         zip((params, state), other))
        make, k_cpt = tsteps.make_sweep_eval_split_fn, torch.tensor([0, 1e-9])
    else:
        make, k_cpt = tsteps.make_eval_split_fn, 1e-9
    sums = {}
    for flag in (True, False):
        tconfig.set_stacked_tails(flag)
        sums[flag] = make(net, 8)(params, state, x0s, ys, masks, 1.0, k_cpt)
    assert set(sums[True]) == set(sums[False])
    for key, v in sums[False].items():
        np.testing.assert_allclose(sums[True][key].numpy(), v.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_stacked_forward_frees_its_tensors(stacked):
    """A stacked train step (packed and stacked in the forward) and a
    stacked evaluation batch leave no tensor behind in reference cycles:
    with the garbage collector off, the live tensors do not grow from one
    call to the next."""
    net = build_tree(T, "cr")
    p, s, v = tsteps.init_training(net, 0, "cpu")
    pp, ps, pv = (net.pack_tree(t) for t in (p, s, v))
    x, y, _ = _data(8)
    step = tsteps.make_train_step(
        net, 8, tsteps.Schedules(k_cpt_sample=[0.0, 1e-9]))
    gen = torch.Generator().manual_seed(0)
    evaluate = tsteps._eval_batch_fn(net, 8)

    def live():
        return sum(1 for o in gc.get_objects() if torch.is_tensor(o))

    gc.collect()
    gc.disable()
    try:
        counts = []
        for t in range(3):
            p, s, v, _ = step(p, s, v, t, gen, x, y, torch.zeros(10))
            pp, ps, pv, _ = step(pp, ps, pv, t, gen, x, y, torch.zeros(10))
            evaluate(p, s, x, y, torch.ones(8), 1.0, 0.0)
            counts.append(live())
    finally:
        gc.enable()
    assert counts[2] == counts[1], counts


def test_fused_mcm_nested_vmap_folds_into_one_call(monkeypatch):
    """fused_mcm under vmap inside vmap (the stacked tails inside the
    sweep) runs as ONE call of the net axis with outer x inner nets,
    tensors batched at either level or both; its values are mcm_ref's per
    slice, and its gradients under vmap(grad(vmap)) mcm_ref's."""
    rng = np.random.RandomState(0)
    n_out, n_in, b = 2, 3, 4

    def arr(*shape, scale=1.0):
        return torch.as_tensor((scale * rng.randn(*shape)).astype(
            np.float32))

    # The input pyramid per outer net (shared by the inner ones), the
    # weights per outer and inner net, the biases per inner net only.
    xs = [arr(n_out, b, 8, 8, 4).relu(), arr(n_out, b, 4, 4, 4).relu()]
    whs = [arr(n_out, n_in, 3, 3, 4, 8, scale=0.2) for _ in range(2)]
    wvs = [arr(n_out, n_in, 3, 3, 8, 8, scale=0.2)]
    bs = [arr(n_in, 8) for _ in range(2)]
    calls = []
    forward = kernels._forward

    def spy(*args, **kwargs):
        calls.append(kwargs.get("n_nets", 0))
        return forward(*args, **kwargs)

    monkeypatch.setattr(kernels, "_forward", spy)

    def nested(stage):
        def outer(xs, whs, wvs):
            return torch.func.vmap(lambda w, v, b_: stage(xs, w, v, b_))(
                whs, wvs, bs)
        return torch.func.vmap(outer)(xs, whs, wvs)

    out = nested(lambda x, w, v, b_: kernels.fused_mcm(x, w, v, b_, 3))
    assert calls == [n_out * n_in]
    ref = nested(kernels.mcm_ref)
    assert all(torch.equal(o, r) for o, r in zip(out, ref))

    def grads(stage):
        def loss(whs, wvs, xs):
            outs = torch.func.vmap(lambda w, v, b_: stage(xs, w, v, b_))(
                whs, wvs, bs)
            return sum(torch.sum(o * o) for o in outs)
        return torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)))(
            whs, wvs, xs)

    got = grads(lambda x, w, v, b_: kernels.fused_mcm(x, w, v, b_, 3))
    want = grads(kernels.mcm_ref)
    for a, b_ in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-5,
                                   atol=1e-6)
