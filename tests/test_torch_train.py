"""The training slice of the PyTorch port against mpnn_tpu on the CPU, fp32:
forward records, routing propagation, the actor loss and its gradients,
stats, TALR, the analytic L2 decay and whole train steps, on a 3-stage
dr_chain-shaped actor net over 16x16 inputs (the shape of
tests/test_torch_infer.py, with the registry's weight L2). The same numpy
parameters and inputs go through both packages; mpnn_tpu runs its plain
XLA path. Values agree to 1e-5 in ||port - jax|| / ||jax|| per array,
gradients and parameters to 1e-4 in the same norm per leaf. The loss and
TALR scales are also held against the float64 oracle (mpnn_tpu/oracle.py)
at the tolerances of tests/test_reference_oracle.py."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu import oracle
from mpnn_tpu.data.augment import augmented_batch as j_augmented_batch
from mpnn_tpu.models import ActorNet as JActorNet
from mpnn_tpu.models import steps as jsteps
from mpnn_tpu.models.net import Ctx as JCtx
from mpnn_tpu.models.net import _all_sublayers as j_all_sublayers
from mpnn_tpu.models.optim import talr_scale_grads as j_talr
from mpnn_tpu.models.optim import tree_l2_decay as j_l2_decay
from mpnn_tpu.models.routing import propagate as j_propagate
from mpnn_tpu.models.stats import state_stats as j_state_stats
from mpnn_tpu.ops import layers as J
from mpnn_tpu_torch.models import ActorNet as TActorNet
from mpnn_tpu_torch.models import steps as tsteps
from mpnn_tpu_torch.models.net import Ctx as TCtx
from mpnn_tpu_torch.models.net import _all_sublayers as t_all_sublayers
from mpnn_tpu_torch.models.optim import talr_scale_grads as t_talr
from mpnn_tpu_torch.models.optim import tree_l2_decay as t_l2_decay
from mpnn_tpu_torch.models.routing import propagate as t_propagate
from mpnn_tpu_torch.models.stats import state_stats as t_state_stats
from mpnn_tpu_torch.data.augment import flip_batch, shift_batch
from mpnn_tpu_torch.ops import config as tconfig
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils.serdes import from_numpy_tree
from mpnn_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.torch_threads import share_cores  # noqa: F401

B = 32
ARCH = [[8, 8, 8], [8, 8], [8]]
K_L2 = 1e-4
TAU, EPS, K_CPT = 0.7, 1e-6, 1e-9
VALUE_TOL = 1e-5  # ||port - jax|| / ||jax|| of a value
LEAF_TOL = 1e-4  # the same of a gradient or parameter leaf

# The registry's actor variants (mpnn_tpu/experiments.py: hybrid-ac,
# -nokdec, -notalr, -globopt).
VARIANTS = {"default": {}, "k_dec0": dict(k_dec=0),
            "notalr": dict(talr=False),
            "globopt": dict(globopt=True, talr=False)}


def _build(L, **hypers):
    """dr_chain's shape at 3 stages, with the registry's k_l2."""
    def router():
        return L.Chain(name="Router", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=16, k_l2=K_L2), L.BatchNorm(),
            L.Rect(), L.LinTrans(n_chan=16, k_l2=K_L2), L.BatchNorm(),
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

    root = rcm(ARCH[-1], reg())
    for n_chan in reversed(ARCH[:-1]):
        root = rcm(n_chan, reg(), root)
    root = L.Chain(name="ToPyramid", sinks=[root],
                   comps=[L.ToPyramid(n_scales=3)])
    Net = JActorNet if L is J else TActorNet
    return Net(x0_shape=(16, 16, 3), y_shape=(10,), root=root,
               k_cpt=K_CPT, **hypers)


def _np(tree):
    if isinstance(tree, (list, tuple)):
        return [_np(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().double().numpy()
    return np.asarray(tree, np.float64)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _paths(tree, path=""):
    """[(path, numpy leaf, feeds_train_bn)] of a params-shaped tree.

    feeds_train_bn marks the biases right before a train-mode BatchNorm:
    a stage's last-scale conv bias (the coarser scales' biases also reach
    the next scale through its zero-padded vertical conv) and the
    router's first two dense biases. BN subtracts the batch mean, so their
    exact gradient is zero and what either package computes is rounding
    noise."""
    tree = _np(tree)
    if isinstance(tree, dict):
        last_b = "b_%d" % (sum(k.startswith("b_") for k in tree) - 1)
        return [(p, a, z or k == last_b) for k in sorted(tree)
                for p, a, z in _paths(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [e for i, t in enumerate(tree)
                for e in _paths(t, f"{path}[{i}]")]
    return [(path, tree, path.endswith(("/router/comps[1]/b",
                                        "/router/comps[4]/b")))]


def _assert_tree_close(t, j, tol, zero_grad_biases=False):
    """Per leaf ||t - j|| / ||j|| <= tol, over trees of one structure. With
    zero_grad_biases (gradients, and parameters that moved by them), the
    leaves whose exact gradient is zero (`_paths`) are held to be noise in
    both packages: below 1e-6 of the whole tree's norm."""
    tp, jp = _paths(t), _paths(j)
    assert [e[0] for e in tp] == [e[0] for e in jp]
    total = np.sqrt(sum(np.sum(np.square(e[1])) for e in jp))
    for (path, a, zero), (_, b, _) in zip(tp, jp):
        assert a.shape == b.shape, path
        if zero_grad_biases and zero:
            assert max(np.linalg.norm(a), np.linalg.norm(b)) <= (
                1e-6 * total), path
            continue
        err = np.linalg.norm(a - b)
        assert err <= tol * np.linalg.norm(b), (path, err,
                                                np.linalg.norm(b))


def _randomize(tree, rng):
    """Seeded random parameters (routers then split the batch; positive
    variances)."""
    if isinstance(tree, list):
        return [_randomize(t, rng) for t in tree]
    if isinstance(tree, dict):
        return {k: (_randomize(v, rng) if isinstance(v, (dict, list))
                    else rng.uniform(0.5, 2.0, np.shape(v)).astype(np.float32)
                    if k == "v_avg" else
                    (0.4 * rng.standard_normal(np.shape(v))).astype(
                        np.float32))
                for k, v in tree.items()}
    raise TypeError(type(tree))


def _pair(**hypers):
    """(jnet, tnet, numpy params, numpy state) of one hyper variant, with
    seeded random values in JAX's parameter structure."""
    jnet, tnet = _build(J, **hypers), _build(T, **hypers)
    shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0))
    p, s = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), shapes)
    rng = np.random.RandomState(4)
    return jnet, tnet, _randomize(p, rng), _randomize(s, rng)


def _batch(seed=1, n=B):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 16, 16, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, n)]
    return x, y


def _jax_run(jnet, p, s, x, y, train, route=None, stats=False):
    """JAX's forward under jit (a first op-by-op call costs seconds a
    primitive on the CPU): ({node: record fields}, new_state, stats), the
    records routed when `route` (the mixture flag) is given, and the
    per-example state_stats when asked."""
    def f(p, s, x, y):
        recs, ns = jnet.forward(p, s, x, y, JCtx(train=train, tau=TAU,
                                                 eps=EPS, k_cpt=K_CPT))
        if route is not None:
            j_propagate(jnet, recs, B, TAU, EPS, mixture=route)
        return ([dict(vars(recs[l])) for l in jnet.layers], ns,
                j_state_stats(jnet, recs, y) if stats else None)
    out, ns, st = jax.jit(f)(*jax.tree.map(jnp.asarray, (p, s, x, y)))
    return ({l: SimpleNamespace(**o) for l, o in zip(jnet.layers, out)},
            ns, st)


def _forward_both(jnet, tnet, p, s, train, x, y, route=None, stats=False):
    jrecs, jstate, jstats = _jax_run(jnet, p, s, x, y, train, route, stats)
    tp, ts = from_numpy_tree(p, s, device="cpu")
    trecs, tstate = tnet.forward(tp, ts, torch.as_tensor(x),
                                 torch.as_tensor(y),
                                 TCtx(train=train, tau=TAU, eps=EPS,
                                      k_cpt=K_CPT))
    return jrecs, jstate, jstats, trecs, tstate


def _check_value(tv, jv, tag):
    """||port - jax|| / ||jax|| <= VALUE_TOL; a value that is zero in JAX
    (a loss term a node does not have) is zero in the port."""
    if jv is None:
        assert tv is None, tag
        return
    a, b = _np(tv), _np(jv)
    if not b.any():
        assert a.shape == b.shape and not a.any(), tag
    else:
        assert _rel(a, b) <= VALUE_TOL, tag


def _nodes(jnet, tnet):
    return list(zip(jnet.layers, tnet.layers))


@pytest.fixture(scope="module")
def default_pair():
    return _pair()


def test_uids_and_stats_keys_match_jax(default_pair):
    """Every layer object reachable through comps and router gets JAX's
    uid: the same preorder numbering of the same tree."""
    jnet, tnet, _, _ = default_pair
    juids = [(type(sub).__name__, sub._uid) for l in jnet.layers
             for sub in j_all_sublayers(l)]
    tuids = [(type(sub).__name__, sub._uid) for l in tnet.layers
             for sub in t_all_sublayers(l)]
    assert tuids == juids
    assert tnet._n_leaves_root == jnet._n_leaves_root == 3


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_forward_records_match_jax(default_pair, train):
    jnet, tnet, p, s = default_pair
    x, y = _batch()
    jrecs, jstate, _, trecs, tstate = _forward_both(jnet, tnet, p, s,
                                                    train, x, y)
    for jl, tl in _nodes(jnet, tnet):
        jr, tr = jrecs[jl], trecs[tl]
        xs = jr.x if isinstance(jr.x, list) else [jr.x]
        txs = tr.x if isinstance(tr.x, list) else [tr.x]
        assert len(txs) == len(xs)
        for a, b in zip(txs, xs):
            _check_value(a, b, jl.name)
        for f in ("c_err", "c_mod", "delta_cor", "router_x",
                  "router_c_mod"):
            _check_value(getattr(tr, f), getattr(jr, f), (jl.name, f))
        if jr.router_x is not None:
            assert tr.router_x.dtype == torch.float32
    # Train mode updates the BatchNorm EMAs; eval leaves them.
    _assert_tree_close(tstate, jstate, VALUE_TOL)


@pytest.mark.parametrize("mixture", [True, False],
                         ids=["mixture", "no_mixture"])
def test_propagate_matches_jax(default_pair, mixture):
    jnet, tnet, p, s = default_pair
    x, y = _batch()
    jrecs, _, _, trecs, _ = _forward_both(jnet, tnet, p, s, True, x, y,
                                          route=mixture)
    t_propagate(tnet, trecs, B, TAU, EPS, mixture=mixture)
    n_split = 0
    for jl, tl in _nodes(jnet, tnet):
        for f in ("p_tr", "p_ev", "pi_tr", "pi_ev"):
            tv = getattr(trecs[tl], f)
            assert tv is None or tv.dtype == torch.float32
            _check_value(tv, getattr(jrecs[jl], f), (jl.name, f))
        if trecs[tl].pi_ev is not None:
            n_split += int(0 < trecs[tl].pi_ev[:, 0].sum() < B)
    assert n_split >= 1  # the randomized routers really split the batch
    with pytest.raises(ValueError, match="eps"):
        t_propagate(tnet, trecs, B, TAU, 0.0)


def _jax_loss_and_grads(jnet, p, s, x, y, k_cpt=K_CPT):
    """((loss, (new_state, p_tr by uid)), grads) of JAX, under jit."""
    def f(p, s, x, y, k):
        ctx = JCtx(train=True, tau=TAU, eps=EPS, k_cpt=k)

        def loss_fn(params):
            recs, new_state = jnet.forward(params, s, x, y, ctx)
            c = jnet.loss(recs, B, ctx)
            return c, (new_state, {str(l._uid): recs[l].p_tr
                                   for l in jnet.layers})
        return jax.value_and_grad(loss_fn, has_aux=True)(p)
    return jax.jit(f)(*jax.tree.map(jnp.asarray, (p, s, x, y, k_cpt)))


def _port_loss_and_grads(tnet, p, s, x, y, ctx):
    _, loss_and_grads = tsteps._step_pieces(
        tnet, B, tsteps.Schedules(), 0, presampled=True)
    return loss_and_grads(p, s, x, y, ctx)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_actor_loss_and_grads_match_jax(variant):
    """The loss, every gradient leaf, and the gradients after TALR (whose
    scale is 1 for talr=False); a misplaced detach changes the gradients
    and not the loss."""
    hypers = VARIANTS[variant]
    jnet, tnet, p, s = _pair(**hypers)
    x, y = _batch()
    (jc, (jstate, jp_tr)), jg = _jax_loss_and_grads(jnet, p, s, x, y)
    tp, ts = from_numpy_tree(p, s, device="cpu")
    tc, tstate, tp_tr, tg = _port_loss_and_grads(
        tnet, tp, ts, torch.as_tensor(x), torch.as_tensor(y),
        TCtx(train=True, tau=TAU, eps=EPS, k_cpt=K_CPT))
    assert abs(float(tc) - float(jc)) <= VALUE_TOL * abs(float(jc))
    _assert_tree_close(tg, jg, LEAF_TOL, zero_grad_biases=True)
    _assert_tree_close(tstate, jstate, VALUE_TOL)
    h = jnet.hypers
    _assert_tree_close(
        t_talr(tnet, tg, tp_tr, alpha_rtr=h.α_rtr, talr=h.talr),
        j_talr(jnet, jg, jp_tr, alpha_rtr=h.α_rtr, talr=h.talr), LEAF_TOL,
        zero_grad_biases=True)


def test_per_example_k_cpt_loss_matches_jax(default_pair):
    """A (B,) k_cpt (k_cpt_sample) broadcasts through c_cpt."""
    jnet, tnet, p, s = default_pair
    x, y = _batch()
    k = np.linspace(0, 6.4e-8, B).astype(np.float32)
    (jc, _), _ = _jax_loss_and_grads(jnet, p, s, x, y, k)
    tp, ts = from_numpy_tree(p, s, device="cpu")
    tc = _port_loss_and_grads(tnet, tp, ts, torch.as_tensor(x),
                              torch.as_tensor(y),
                              TCtx(train=True, tau=TAU, eps=EPS,
                                   k_cpt=torch.as_tensor(k)))[0]
    assert abs(float(tc) - float(jc)) <= VALUE_TOL * abs(float(jc))


def test_k_cpt_sample_draws_per_example_prices():
    """Schedules.k_cpt_sample: each example's price is drawn on the batch's
    device from the given values; without it the net's static k_cpt."""
    tnet = _build(T)
    x0, y, m_sym = (torch.as_tensor(a) for a in _dataset())
    values = [0.0, 1e-9, 6.4e-8]
    gen = torch.Generator().manual_seed(2)
    for sample, expect in ((values, None), (None, K_CPT)):
        batch_ctx, _ = tsteps._step_pieces(
            tnet, B, tsteps.Schedules(k_cpt_sample=sample), 4, False)
        xb, yb, ctx = batch_ctx(0, gen, x0, y, m_sym, None)
        assert xb.shape == (B, 16, 16, 3) and yb.shape == (B, 10)
        assert ctx.train and ctx.tau == 1.0 and ctx.eps == EPS
        if expect is not None:
            assert ctx.k_cpt == expect
            continue
        assert ctx.k_cpt.shape == (B,) and ctx.k_cpt.dtype == torch.float32
        drawn = set(ctx.k_cpt.tolist())
        assert drawn <= set(np.float32(values).tolist()) and len(drawn) > 1


def test_loss_and_talr_match_oracle(default_pair):
    """The port's loss and TALR scales against the float64 oracle, in
    train mode; the pyramid is the port's own output, as data, as
    tests/test_reference_oracle.py does for JAX's."""
    _, tnet, p, s = default_pair
    x, y = _batch()
    tp, ts = from_numpy_tree(p, s, device="cpu")
    ctx = TCtx(train=True, tau=TAU, eps=EPS, k_cpt=K_CPT)
    recs, _ = tnet.forward(tp, ts, torch.as_tensor(x), torch.as_tensor(y),
                           ctx)
    loss = float(tnet.loss(recs, B, ctx))
    pyr = tnet.root.comps[0]
    pyr_out = pyr.apply({}, {}, torch.as_tensor(x), None, ctx)[0]
    infos = oracle.net_forward(
        tnet, _np(p), _np(s), np.float64(x), np.float64(y), True,
        overrides={id(pyr): [_np(o) for o in pyr_out]})
    oracle.route(tnet.root, infos, eps=EPS, tau=TAU)
    o_loss, _ = oracle.actor_loss(tnet, infos, k_cpt=K_CPT,
                                  k_dec=tnet.hypers.k_dec)
    assert np.isclose(loss, o_loss, rtol=2e-5), (loss, o_loss)

    ones = tree_map(torch.ones_like, tp)
    p_tr = {str(l._uid): recs[l].p_tr for l in tnet.layers}
    scaled = t_talr(tnet, ones, p_tr, alpha_rtr=0.3)
    o_scales = oracle.talr_scales(tnet, infos, alpha_rtr=0.3)

    def check(node, g):
        s_layer, s_router = o_scales[node]
        for leaf in tree_leaves(g["layer"]):
            np.testing.assert_allclose(float(leaf.reshape(-1)[0]), s_layer,
                                       rtol=2e-5)
        for leaf in tree_leaves(g["router"]):
            np.testing.assert_allclose(float(leaf.reshape(-1)[0]), s_router,
                                       rtol=2e-5)
        for snk, gs in zip(node.sinks, g["sinks"]):
            check(snk, gs)

    check(tnet.root, scaled)


def test_eval_batch_stats_match_jax(default_pair):
    """_eval_batch_fn: the same keys ('net/...' and '<uid>/...') and the
    masked sums over the batch."""
    jnet, tnet, p, s = default_pair
    x, y = _batch()
    mask = (np.arange(B) < B - 5).astype(np.float32)
    j = jax.jit(jsteps._eval_batch_fn(jnet, B))(
        *jax.tree.map(jnp.asarray, (p, s, x, y, mask, TAU, K_CPT)))
    tp, ts = from_numpy_tree(p, s, device="cpu")
    t = tsteps._eval_batch_fn(tnet, B)(
        tp, ts, torch.as_tensor(x), torch.as_tensor(y),
        torch.as_tensor(mask), TAU, K_CPT)
    assert sorted(t) == sorted(j)
    assert any(k.endswith("/x_rte") for k in t)
    for k in j:
        assert _rel(_np(t[k]), _np(j[k])) <= VALUE_TOL, k


def test_state_stats_per_example_match_jax(default_pair):
    jnet, tnet, p, s = default_pair
    x, y = _batch()
    _, _, j, trecs, _ = _forward_both(jnet, tnet, p, s, False, x, y,
                                      route=True, stats=True)
    tnet.route_for_stats(trecs, B, TCtx(train=False, tau=TAU, eps=EPS))
    t = t_state_stats(tnet, trecs, torch.as_tensor(y))
    assert sorted(t) == sorted(j)
    for k in j:
        assert _rel(_np(t[k]), _np(j[k])) <= VALUE_TOL, k


def _random_grads(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32), tree)


def test_talr_and_l2_decay_match_jax(default_pair):
    """talr_scale_grads and tree_l2_decay on the same grads and p_tr."""
    jnet, tnet, p, s = default_pair
    g = _random_grads(p, 5)
    rng = np.random.RandomState(6)
    p_tr = {str(l._uid): rng.uniform(1e-7, 1.0, B).astype(np.float32)
            for l in jnet.layers}
    jp_tr = {k: jnp.asarray(v) for k, v in p_tr.items()}
    tp_tr = {k: torch.as_tensor(v) for k, v in p_tr.items()}
    tp, tg = from_numpy_tree(p, g, device="cpu")
    jpa, jga = jax.tree.map(jnp.asarray, (p, g))
    _assert_tree_close(t_talr(tnet, tg, tp_tr, alpha_rtr=0.3),
                       j_talr(jnet, jga, jp_tr, alpha_rtr=0.3), LEAF_TOL)
    tgd, tval = t_l2_decay(tnet, tp, tg, tp_tr)
    jgd, jval = j_l2_decay(jnet, jpa, jga, jp_tr)
    _assert_tree_close(tgd, jgd, LEAF_TOL)
    assert _rel(float(tval), float(jval)) <= VALUE_TOL


def test_analytic_l2_equals_in_graph_l2(default_pair):
    """With analytic_l2 the forward drops c_mod and tree_l2_decay adds its
    gradient and value back: the loss and every gradient leaf are the same
    as differentiating c_mod in the graph."""
    _, tnet, p, s = default_pair
    x, y = _batch()
    ctx = TCtx(train=True, tau=TAU, eps=EPS, k_cpt=K_CPT)
    tp, ts = from_numpy_tree(p, s, device="cpu")
    args = (tnet, tp, ts, torch.as_tensor(x), torch.as_tensor(y), ctx)
    c_ref, _, _, g_ref = _port_loss_and_grads(*args)
    tconfig.set_analytic_l2(True)
    try:
        c, _, p_tr, g = _port_loss_and_grads(*args)
        g, c_l2 = t_l2_decay(tnet, tp, g, p_tr)
    finally:
        tconfig.set_analytic_l2(False)
    assert float(c_l2) > 0
    assert abs(float(c + c_l2) - float(c_ref)) <= 2e-6 * abs(float(c_ref))
    _assert_tree_close(g, g_ref, 2e-5, zero_grad_biases=True)


N_STEPS = 3
SCHED = dict(lr=lambda t: 0.02, tau=lambda t: 1.0 / 2 ** (t / 2))


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's make_train_step for 3 steps from init_training(seed 0): the
    state after steps 1 and 3, each step's loss, and the batch each step
    saw, re-made by the port's pure augmentation halves from JAX's own
    draws."""
    jnet, tnet = _build(J), _build(T)
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
    return jnet, tnet, init, out, batches


def _dataset():
    rng = np.random.RandomState(2)
    x0 = rng.rand(64, 16, 16, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 64)]
    m_sym = np.array([0] * 5 + [1] * 5, np.float32)
    return x0, y, m_sym


def _port_batch_from_jax_draws(rng, t, ds, r_shift=4):
    """The batch JAX's step t samples, made by the port: JAX's step key
    split as `_step_pieces` and `augmented_batch` split it, its draws read
    out, and handed to the port's shift_batch / flip_batch. Checked against
    JAX's own augmented batch."""
    x0, y, m_sym = ds
    k_aug = jax.random.split(jax.random.fold_in(rng, t), 3)[0]
    k_idx, k_rest = jax.random.split(k_aug)
    k_flip, k_shift = jax.random.split(k_rest)
    idx = np.array(jax.random.randint(k_idx, (B,), 0, x0.shape[0]))
    coin = np.array(jax.random.bernoulli(k_flip, 0.5, (B,)))
    duv = np.array(jax.random.randint(k_shift, (B, 2), -r_shift,
                                      r_shift + 1))
    xb, yb = torch.as_tensor(x0[idx]), torch.as_tensor(y[idx])
    do_flip = torch.as_tensor(coin) & (yb @ torch.as_tensor(m_sym) != 0)
    xb = shift_batch(flip_batch(xb, do_flip), torch.as_tensor(duv[:, 0]),
                     torch.as_tensor(duv[:, 1]))
    jx, jy = j_augmented_batch(k_aug, jnp.asarray(x0), jnp.asarray(y),
                               jnp.asarray(m_sym), B, r_shift)
    np.testing.assert_allclose(xb.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_array_equal(yb.numpy(), np.asarray(jy))
    return xb, yb


@pytest.mark.parametrize("n_steps", [1, N_STEPS])
def test_train_steps_match_jax(jax_steps, n_steps):
    """Whole train steps: params, state, vel and c_tot after 1 and 3 steps
    from the same init, on the batches JAX's steps saw (fed presampled,
    with augmentation off on the port's side)."""
    jnet, tnet, init, out, batches = jax_steps
    step = tsteps._train_step_body(tnet, B, tsteps.Schedules(**SCHED),
                                   r_shift=0, presampled=True)
    tp, ts, tv = from_numpy_tree(*init, device="cpu")
    gen = torch.Generator().manual_seed(0)
    no_flip = torch.zeros(10)
    for t in range(n_steps):
        xb, yb = batches[t]
        tp, ts, tv, c = step(tp, ts, tv, t, gen, xb, yb, no_flip)
        assert c.dim() == 0 and c.dtype == torch.float32
    jp, js, jv, jc = out[n_steps]
    assert abs(float(c) - float(jc)) <= VALUE_TOL * abs(float(jc))
    _assert_tree_close(tp, jp, LEAF_TOL, zero_grad_biases=True)
    _assert_tree_close(ts, js, LEAF_TOL)
    _assert_tree_close(tv, jv, LEAF_TOL, zero_grad_biases=True)


def test_make_train_step_samples_on_its_generator():
    """make_train_step draws the batch from its generator: the same seed
    gives the same steps, with finite losses."""
    tnet = _build(T)
    x0, y, m_sym = (torch.as_tensor(a) for a in _dataset())
    step = tsteps.make_train_step(tnet, B, tsteps.Schedules(**SCHED))
    runs = []
    for _ in range(2):
        p, s, v = tsteps.init_training(tnet, seed=3, device="cpu")
        gen = torch.Generator().manual_seed(11)
        cs = []
        for t in range(4):
            p, s, v, c = step(p, s, v, t, gen, x0, y, m_sym)
            cs.append(float(c))
        runs.append((cs, p))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(tree_leaves(runs[0][1]), tree_leaves(runs[1][1])):
        assert torch.equal(a, b)
    assert all(np.isfinite(runs[0][0]))

