"""The rest of the layer zoo, the TF1 parity modes, Dropout streams and
remat in the PyTorch port, against mpnn_tpu on the CPU in fp32: the same
numpy inputs and parameters go through both packages.

Each new layer's outputs, loss terms and gradients agree within 1e-5 x
max(1, max|jax|); MaxPool at odd sizes in both modes; TF1's legacy
resize at x2 and at 32 -> 12, and ToPyramid under `pyramid_tf1`. Dropout
masks cannot equal JAX's (the generators differ), so the port's Dropout
is held by its law, its determinism in (stream, uid), distinct streams
per stacked member, and JAX's own mask through the port's formula. One
train step of a 3-stage chain that uses every new layer (Dropout at
λ = 1) against JAX's: loss within 1e-5, every leaf within 1e-4. remat's
gradients equal the plain step's."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.models import ActorNet as JActorNet
from mpnn_tpu.models import steps as jsteps
from mpnn_tpu.models.net import Ctx as JCtx
from mpnn_tpu.ops import config as jconfig
from mpnn_tpu.ops import layers as J
from mpnn_tpu_torch.models import ActorNet as TActorNet
from mpnn_tpu_torch.models import steps as tsteps
from mpnn_tpu_torch.models.net import Ctx as TCtx
from mpnn_tpu_torch.ops import config as tconfig
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils.serdes import from_numpy_tree
from mpnn_tpu_torch.utils.tree import tree_leaves
from tests.torch_threads import share_cores  # noqa: F401

TOL = 1e-5  # max abs error / max(1, max|jax|) of a value or gradient
LEAF_TOL = 1e-4  # ||port - jax|| / ||jax|| of a leaf after a step
B = 16
W_CLS = np.array([[0, 0, 0, 0, 0, 0, 0, 1, 0, 0],
                  [1, 1, 1, 1, 1, 1, 1, 0, 1, 1]], np.float32).T  # 10 -> 2
MODES = ("pyramid_tf1", "maxpool_tf1", "remat_policy", "stacked_tails")


@pytest.fixture
def modes():
    """Both packages' global modes, restored after the test (config is
    module state, shared by the tests of a worker)."""
    saved = [(c, k, getattr(c, k)) for c in (jconfig, tconfig)
             for k in MODES]
    yield
    for c, k, v in saved:
        setattr(c, k, v)


def _set_both(name, value):
    setattr(jconfig, name, value)
    setattr(tconfig, name, value)


def _np(tree):
    if isinstance(tree, (list, tuple)):
        return [_np(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().double().numpy()
    return np.asarray(tree, np.float64)


def _close(a, b, tol=TOL):
    a, b = _np(a), _np(b)
    if isinstance(b, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y, tol)
        return
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _close(a[k], b[k], tol)
        return
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(b).max()) if b.size else 0.0)
    assert float(np.abs(a - b).max()) <= tol * scale


def _leaves(x):
    return x if isinstance(x, list) else [x]


def _layer_both(make, x_np, y_np, ctx_kw=None):
    """Apply the layer in both packages on the same params and input
    (JAX's init), and differentiate sum(out * cot) + sum(c_err) +
    sum(c_mod) with respect to the params and the input. Returns
    (jax results, port results), each (out, aux, params grad, input
    grad)."""
    x_shape = ([tuple(a.shape[1:]) for a in x_np] if isinstance(x_np, list)
               else tuple(x_np.shape[1:]))
    jl, tl = make(J), make(T)
    jl.build(x_shape)
    tl.build(x_shape)
    p = jax.tree.map(np.asarray, jl.init(jax.random.PRNGKey(3), x_shape))
    rng = np.random.RandomState(5)
    outs = jl.apply(jax.tree.map(jnp.asarray, p), {},
                    jax.tree.map(jnp.asarray, x_np),
                    None if y_np is None else jnp.asarray(y_np),
                    JCtx(**(ctx_kw or {})))[0]
    cots = [rng.standard_normal(np.shape(o)).astype(np.float32)
            for o in _leaves(outs)]

    def jfn(p, x):
        out, _, aux = jl.apply(p, {}, x, None if y_np is None
                               else jnp.asarray(y_np), JCtx())
        tot = sum(jnp.sum(o * c) for o, c in zip(_leaves(out), cots))
        return tot + jnp.sum(aux.c_err) + jnp.sum(aux.c_mod), (
            out, (aux.c_err, aux.c_mod, aux.delta_cor))

    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(
            jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, x_np))

    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    tx = [torch.tensor(a, requires_grad=True) for a in _leaves(x_np)]
    xin = tx if isinstance(x_np, list) else tx[0]
    tout, _, taux = tl.apply(tp, {}, xin, None if y_np is None
                             else torch.as_tensor(y_np), TCtx())
    tot = sum(torch.sum(o * torch.as_tensor(c))
              for o, c in zip(_leaves(tout), cots))
    tot = tot + torch.sum(torch.as_tensor(taux.c_err)) + torch.sum(
        torch.as_tensor(taux.c_mod))
    grads = torch.autograd.grad(tot, list(tp.values()) + tx,
                                allow_unused=True)
    tgp = {k: (g if g is not None else torch.zeros_like(tp[k]))
           for k, g in zip(tp, grads[:len(tp)])}
    tgx = list(grads[len(tp):])
    return ((jout, jaux, jgp, _leaves(jgx)), (tout, taux, tgp, tgx), jl, tl)


def _images(rng, shape):
    return rng.rand(B, *shape).astype(np.float32)


def _probs(rng, n):
    z = rng.standard_normal((B, n))
    return (np.exp(z) / np.exp(z).sum(1, keepdims=True)).astype(np.float32)


def _labels(rng, n=10):
    return np.eye(n, dtype=np.float32)[rng.randint(0, n, B)]


PYR3 = [(16, 16, 3), (8, 8, 3), (4, 4, 3)]

LAYER_CASES = {
    "conv": (lambda L: L.Conv(n_chan=6, supp=3, k_l2=1e-2),
             lambda r: _images(r, (7, 5, 4)), _labels),
    "conv_res": (lambda L: L.Conv(n_chan=4, supp=3, k_l2=1e-2, res=True),
                 lambda r: _images(r, (6, 6, 4)), _labels),
    "conv_supp1": (lambda L: L.Conv(n_chan=5, supp=1, k_l2=1e-3),
                   lambda r: _images(r, (4, 4, 3)), _labels),
    "global_max_pool": (lambda L: L.GlobalMaxPool(),
                        lambda r: _images(r, (5, 7, 4)), None),
    "multiscale_lln": (lambda L: L.MultiscaleLLN(),
                       lambda r: [_images(r, s) for s in PYR3], None),
    "squared_error": (lambda L: L.SquaredError(), lambda r: _probs(r, 10),
                      _labels),
    "superclass_cross_entropy": (
        lambda L: L.SuperclassCrossEntropyError(w_cls=W_CLS),
        lambda r: _probs(r, 2), _labels),
    "activity_error": (lambda L: L.ActivityError(α=0.1),
                       lambda r: _images(r, (4, 4, 3)), _labels),
    "dropout_keep1": (lambda L: L.Dropout(),
                      lambda r: _images(r, (4, 4, 3)), None),
}


@pytest.mark.parametrize("case", sorted(LAYER_CASES))
def test_layer_matches_jax(case):
    """Outputs, c_err / c_mod / delta_cor, n_ops, out_shape and the
    gradients of params and input, against mpnn_tpu's layer (with labels
    wherever the layer has a loss term: the port computes none without,
    as routed serving asks)."""
    make, make_x, make_y = LAYER_CASES[case]
    rng = np.random.RandomState(0)
    x = make_x(rng)
    y = make_y(rng) if make_y else None
    (jout, jaux, jgp, jgx), (tout, taux, tgp, tgx), jl, tl = _layer_both(
        make, x, y)
    _close(tout, jout)
    j_err, j_mod, j_cor = jaux
    _close(torch.as_tensor(taux.c_err), j_err)
    _close(torch.as_tensor(taux.c_mod), j_mod)
    if j_cor is not None:
        np.testing.assert_array_equal(_np(taux.delta_cor), _np(j_cor))
    assert tl.n_ops == jl.n_ops and tl.out_shape == jl.out_shape
    _close(tgp, jax.tree.map(np.asarray, jgp))
    _close(tgx, [np.asarray(g) for g in jgx])


@pytest.mark.parametrize("tf1", [False, True], ids=["intent", "tf1"])
@pytest.mark.parametrize("hw,supp,stride", [
    ((7, 5), 3, 2), ((9, 9), 3, 2), ((5, 7), 2, 3), ((6, 4), 2, 2)])
def test_max_pool_modes_match_jax(modes, tf1, hw, supp, stride):
    """MaxPool at odd sizes, window = supp and stride = stride, or under
    maxpool_tf1 the reference's transposed arguments; SAME padding with
    the odd pad at the bottom / right, as XLA's."""
    _set_both("maxpool_tf1", tf1)
    rng = np.random.RandomState(1)
    x = rng.standard_normal((B,) + hw + (3,)).astype(np.float32)
    (jout, _, _, jgx), (tout, _, _, tgx), jl, tl = _layer_both(
        lambda L: L.MaxPool(supp=supp, stride=stride), x, None)
    assert tl.out_shape == jl.out_shape
    assert tuple(tout.shape[1:]) == tl.out_shape
    _close(tout, jout)
    _close(tgx, [np.asarray(g) for g in jgx])


@pytest.mark.parametrize("out_hw", [(16, 16), (12, 12), (12, 20)])
def test_tf1_legacy_resize_matches_jax(out_hw):
    """TF1's legacy grid: a strided slice at x2, the clamped grid without
    a half-pixel shift at 32 -> 12 (and a mixed 32 -> 12 x 20)."""
    x = np.random.RandomState(2).rand(3, 32, 40, 3).astype(np.float32)
    h, w = out_hw
    got = T._tf1_legacy_resize(torch.as_tensor(x), h, w)
    want = np.asarray(J._tf1_legacy_resize(jnp.asarray(x), h, w))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    if 32 % h == 0 and 40 % w == 0:
        np.testing.assert_array_equal(got.numpy(),
                                      x[:, ::32 // h, ::40 // w])


def test_to_pyramid_tf1_matches_jax(modes):
    """ToPyramid under pyramid_tf1: JAX's scales exactly, each the strided
    slice x[:, ::2^k, ::2^k] (no antialiasing)."""
    _set_both("pyramid_tf1", True)
    x = np.random.RandomState(3).rand(4, 32, 32, 3).astype(np.float32)
    jl, tl = J.ToPyramid(n_scales=4), T.ToPyramid(n_scales=4)
    jl.build((32, 32, 3))
    tl.build((32, 32, 3))
    jo = jl.apply({}, {}, jnp.asarray(x), None, JCtx())[0]
    to = tl.apply({}, {}, torch.as_tensor(x), None, TCtx())[0]
    for k, (a, b) in enumerate(zip(to, jo)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), x[:, ::2 ** k, ::2 ** k])


def _dropout(lam, shape=(4, 4, 3), uid=7):
    d = T.Dropout(λ=lam)
    d.build(shape)
    d._uid = uid
    return d


def test_dropout_identity_at_keep1_and_without_stream():
    x = torch.rand(8, 4, 4, 3)
    assert _dropout(1).apply({}, {}, x, None, TCtx(rng=5))[0] is x
    assert _dropout(0.5).apply({}, {}, x, None, TCtx())[0] is x
    assert not _dropout(1).active() and _dropout(0.5).active()


@pytest.mark.parametrize("lam", [0.5, 0.3])
def test_dropout_formula_on_jax_mask(lam):
    """JAX's own mask (bernoulli of the key folded with the uid) through
    the port's formula gives JAX's output."""
    uid = 7
    x = np.random.RandomState(4).standard_normal((8, 4, 4, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    jd = J.Dropout(λ=lam)
    jd._uid = uid
    want = np.asarray(jd.apply({}, {}, jnp.asarray(x), None,
                               JCtx(train=True, rng=key))[0])
    keep = np.asarray(jax.random.bernoulli(jax.random.fold_in(key, uid),
                                           lam, x.shape))
    got = _dropout(lam, uid=uid).apply(
        {}, {}, torch.as_tensor(x), None,
        TCtx(train=True, rng=1, masks={uid: torch.tensor(keep)}))[0]
    np.testing.assert_array_equal(got.numpy(), want)


def test_dropout_law_and_determinism():
    """The kept share is λ (within 0.5% of λ on 2e6 elements), kept
    values are x / λ, and the mask is a function of (stream, uid): the
    same pair draws the same mask, another stream or uid another."""
    lam = 0.3
    x = torch.ones(200, 100, 100)
    d = T.Dropout(λ=lam)
    d.build((100, 100))
    outs = {}
    for rng, uid in [(1, 7), (1, 7), (2, 7), (1, 8)]:
        d._uid = uid
        outs.setdefault((rng, uid), []).append(
            d.apply({}, {}, x, None, TCtx(rng=rng))[0])
    a, a2 = outs[(1, 7)]
    assert torch.equal(a, a2)
    assert not torch.equal(a, outs[(2, 7)][0])
    assert not torch.equal(a, outs[(1, 8)][0])
    kept = a != 0
    assert abs(float(kept.float().mean()) - lam) <= 0.005 * lam
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / lam))


def _stage(L, sinks, n_chan=(8, 8, 8)):
    router = None
    if len(sinks) > 1:
        router = L.Chain(name="Router", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=8, k_l2=1e-4), L.BatchNorm(),
            L.Rect(), L.LinTrans(n_chan=len(sinks), k_l2=1e-4, σ_w=0)])
    return L.Chain(name="ReConvMax", sinks=sinks, router=router, comps=[
        L.MultiscaleConvMax(n_chan=list(n_chan), supp=3, k_l2=1e-4),
        L.MultiscaleBatchNorm(), L.MultiscaleRect()])


def zoo_leaf(L, lam):
    """Select -> Conv -> Rect -> MaxPool -> Dropout -> GlobalMaxPool ->
    LinTrans -> Softmax -> SquaredError."""
    return L.Chain(name="ZooLeaf", comps=[
        L.Select(i=0), L.Conv(n_chan=8, supp=3, k_l2=1e-4, res=True),
        L.Rect(), L.MaxPool(supp=3, stride=2), L.Dropout(λ=lam),
        L.GlobalMaxPool(), L.LinTrans(n_chan=10, k_l2=1e-4), L.Softmax(),
        L.SquaredError()])


def super_leaf(L):
    """Select -> LinTrans(2) -> ActivityError -> Softmax ->
    SuperclassCrossEntropyError (w_cls 10 -> 2)."""
    return L.Chain(name="SuperLeaf", comps=[
        L.Select(i=-1), L.LinTrans(n_chan=2, k_l2=1e-4),
        L.ActivityError(α=1e-3), L.Softmax(),
        L.SuperclassCrossEntropyError(w_cls=W_CLS)])


def zoo_chain(L, lam=1.0):
    """A 3-stage actor chain on 16x16 inputs that uses every new layer:
    ToPyramid + MultiscaleLLN, three ReConvMax stages, the zoo leaf at
    stages 0 and 1 (congruent: one stack-plan group of two) and the
    superclass leaf at stage 2."""
    root = _stage(L, [super_leaf(L)])
    for _ in range(2):
        root = _stage(L, [zoo_leaf(L, lam), root])
    root = L.Chain(name="ToPyramid", sinks=[root], comps=[
        L.ToPyramid(n_scales=3), L.MultiscaleLLN()])
    Net = JActorNet if L is J else TActorNet
    return Net(x0_shape=(16, 16, 3), y_shape=(10,), root=root, k_cpt=1e-9)


def _batch(seed=6):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, 16, 16, 3).astype(np.float32), _labels(rng))


def test_dropout_streams_distinct_per_stacked_member(modes):
    """With identical params in two congruent branches on the same input,
    each member of the stacked group draws its own mask (the member
    root's uid folded into the stream), deterministic per stream (the
    counterpart of JAX's test); without stacking each branch draws its
    own layer's."""
    from mpnn_tpu_torch.models.sr import SRNet

    def leaf():
        return T.Chain(name="DropReg", comps=[
            T.Select(i=-1), T.LinTrans(n_chan=10), T.Dropout(λ=0.5),
            T.Softmax(), T.CrossEntropyError()])

    net = SRNet(x0_shape=(8, 8, 3), y_shape=(10,), root=T.Chain(
        name="Stem", comps=[T.ToPyramid(n_scales=1)],
        sinks=(leaf(), leaf())))
    params, state, _ = tsteps.init_training(net, seed=0, device="cpu")
    params["sinks"][1] = params["sinks"][0]
    x0, y = torch.ones(4, 8, 8, 3), torch.eye(10)[:4]
    assert len(net._stack_plan[0]["members"]) == 2
    leaves = list(net.leaves)
    for stacked in (True, False):
        tconfig.set_stacked_tails(stacked)
        ctx = TCtx(train=True, rng=11)
        recs, _ = net.forward(params, state, x0, y, ctx)
        a, b = (recs[l].x for l in leaves)
        assert not torch.allclose(a, b)
        recs2, _ = net.forward(params, state, x0, y, ctx)
        assert torch.equal(a, recs2[leaves[0]].x)


def test_step_dropout_stream_is_a_function_of_seed_and_t():
    """The step's Dropout masks are a function of (generator seed, t):
    the same pair draws the same masks, another t or seed others; a net
    without an active Dropout draws none."""
    x = torch.zeros(B, 16, 16, 3)

    def masks(net, seed, t):
        return tsteps._drop_stream(net, torch.Generator().manual_seed(seed),
                                   t, x)[1]

    net = zoo_chain(T, lam=0.5)
    a = masks(net, 3, 0)
    assert len(a) == 2
    for other, same in ((masks(net, 3, 0), True), (masks(net, 3, 1), False),
                        (masks(net, 4, 0), False)):
        assert all(torch.equal(a[k], other[k]) == same for k in a)
    assert masks(zoo_chain(T, lam=1.0), 3, 0) == {}


def test_sweep_members_share_the_step_stream(modes):
    """With an active Dropout, each member of the vmapped sweep step (and
    of the sweep evaluator) equals the serial step (the serial evaluator)
    of its net: the members share the step's stream and masks, drawn
    outside the vmap, as JAX's vstep shares its key."""
    from mpnn_tpu_torch.utils.tree import stack_trees, unstack_tree
    net = zoo_chain(T, lam=0.5)
    members = [tsteps.init_training(net, seed=i, device="cpu")
               for i in range(2)]
    x, y = (torch.as_tensor(a) for a in _batch())
    m_sym = torch.zeros(10)
    k_cpts = torch.tensor([0.0, 1e-9])
    sched = tsteps.Schedules(**SCHED)
    sweep = tsteps._sweep_step_body(net, B, sched, r_shift=0)
    trees = [stack_trees([m[j] for m in members]) for j in range(3)]
    out = sweep(*trees, 0, torch.Generator().manual_seed(5), x, y, m_sym,
                k_cpts)
    serial = tsteps._train_step_body(net, B, sched, r_shift=0,
                                     presampled=True)
    ev, sev = (f(net, 8) for f in (tsteps.make_eval_split_fn,
                                    tsteps.make_sweep_eval_split_fn))
    split = (x.reshape(2, 8, 16, 16, 3), y.reshape(2, 8, 10),
             torch.ones(2, 8))
    sums = sev(out[0], out[1], *split, 0.8, k_cpts, 7)
    for i, m in enumerate(members):
        got = serial(*m, 0, torch.Generator().manual_seed(5), x, y, m_sym,
                     float(k_cpts[i]))
        assert abs(float(got[3]) - float(out[3][i])) <= 1e-5 * abs(
            float(got[3]))
        for a, b in zip(tree_leaves(got[0]),
                        tree_leaves(unstack_tree(out[0], i))):
            assert float((a - b).abs().max()) <= TOL * max(
                1.0, float(b.abs().max()))
        one = ev(got[0], got[1], *split, 0.8, float(k_cpts[i]), 7)
        assert all(float((one[k] - sums[k][i]).abs().max()) <= 1e-4
                   for k in one)


def test_eval_threads_streams_only_for_active_dropout():
    """The evaluators thread a Dropout stream per batch only for nets with
    an active Dropout (the counterpart of JAX's test): those draw the
    same sums for the same eval_key and others for another; nets without
    one ignore the key."""
    def make(lam):
        root = T.Chain(comps=[T.Dropout(λ=lam), T.LinTrans(n_chan=4),
                              T.Softmax(), T.CrossEntropyError()])
        from mpnn_tpu_torch.models.sr import SRNet
        return SRNet(root=root, x0_shape=(6,), y_shape=(4,))

    jmake = jsteps._has_active_dropout
    from mpnn_tpu.models.sr import SRNet as JSRNet
    for lam in (1, 0.5):
        jnet = JSRNet(root=J.Chain(comps=[
            J.Dropout(λ=lam), J.LinTrans(n_chan=4), J.Softmax(),
            J.CrossEntropyError()]), x0_shape=(6,), y_shape=(4,))
        assert tsteps._has_active_dropout(make(lam)) == jmake(jnet)
    rng = np.random.RandomState(7)
    x0s = torch.as_tensor(rng.standard_normal((3, 8, 6)).astype(np.float32))
    ys = torch.as_tensor(np.eye(4, dtype=np.float32)[
        rng.randint(0, 4, (3, 8))])
    masks = torch.ones(3, 8)
    for lam, fresh in ((1, False), (0.5, True)):
        net = make(lam)
        p, s, _ = tsteps.init_training(net, seed=0, device="cpu")
        ev = tsteps.make_eval_split_fn(net, 8)
        run = lambda key: ev(p, s, x0s, ys, masks, 1.0, 0.0, key)["net/acc"]
        assert torch.equal(run(3), run(3))
        assert (not torch.equal(run(3), run(4))) == fresh


def _zoo_pair(lam=1.0):
    jnet, tnet = zoo_chain(J, lam), zoo_chain(T, lam)
    jp, js = jnet.init(jax.random.PRNGKey(0))
    return jnet, tnet, jax.tree.map(np.array, (jp, js))


SCHED = dict(lr=lambda t: 0.02, tau=lambda t: 0.8)


def test_zoo_train_step_matches_jax():
    """One train step of the zoo chain (Dropout at λ = 1) from the same
    params on the same batch, augmentation off on both sides: the loss
    within 1e-5, every param, state and momentum leaf within 1e-4."""
    jnet, tnet, (p, s) = _zoo_pair()
    x, y = _batch()
    v = jax.tree.map(np.zeros_like, p)
    no_flip = np.zeros(10, np.float32)
    jstep = jsteps._train_step_body(jnet, B, jsteps.Schedules(**SCHED),
                                    r_shift=0, presampled=True)
    jout = jax.jit(jstep)(*jax.tree.map(jnp.asarray, (p, s, v)), 0,
                          jax.random.PRNGKey(1), jnp.asarray(x),
                          jnp.asarray(y), jnp.asarray(no_flip))
    jout = jax.tree.map(np.asarray, jout)
    tstep = tsteps._train_step_body(tnet, B, tsteps.Schedules(**SCHED),
                                    r_shift=0, presampled=True)
    tp, ts, tv = from_numpy_tree(p, s, v, device="cpu")
    tout = tstep(tp, ts, tv, 0, torch.Generator().manual_seed(1),
                 torch.as_tensor(x), torch.as_tensor(y),
                 torch.as_tensor(no_flip))
    assert abs(float(tout[3]) - float(jout[3])) <= TOL * abs(float(jout[3]))
    for got, want in zip(tout[:3], jout[:3]):
        pairs = [(_np(a), np.asarray(b, np.float64)) for a, b in
                 zip(tree_leaves(got), jax.tree.leaves(want))]
        total = np.sqrt(sum(np.sum(np.square(b)) for _, b in pairs))
        for a, b in pairs:
            if np.linalg.norm(b) <= 1e-6 * total:
                # A bias right before a train-mode BatchNorm: its exact
                # gradient is zero, and both packages hold rounding noise.
                assert np.linalg.norm(a) <= 1e-6 * total
                continue
            assert np.linalg.norm(a - b) <= LEAF_TOL * np.linalg.norm(b)


@pytest.mark.parametrize("stacked", [False, True], ids=["serial", "stacked"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_equal_plain(modes, policy, stacked):
    """remat_policy "full" and "dots" give the gradients, loss and new
    state of the plain step (Dropout at λ = 0.5, its masks drawn before
    the loss, so the recompute applies the same ones)."""
    tconfig.set_stacked_tails(stacked)
    net = zoo_chain(T, lam=0.5)
    params, state, _ = tsteps.init_training(net, seed=2, device="cpu")
    x, y = (torch.as_tensor(a) for a in _batch())
    batch_ctx, loss_and_grads = tsteps._step_pieces(
        net, B, tsteps.Schedules(**SCHED), 0, True)
    gen = torch.Generator().manual_seed(9)
    xb, yb, ctx = batch_ctx(0, gen, x, y, torch.zeros(10), None)
    assert ctx.masks  # the step drew its Dropout masks
    ref = loss_and_grads(params, state, xb, yb, ctx)
    tconfig.set_remat(policy)
    got = loss_and_grads(params, state, xb, yb, ctx)
    assert abs(float(got[0]) - float(ref[0])) <= 1e-6 * abs(float(ref[0]))
    for a, b in zip(tree_leaves((got[1], got[3])),
                    tree_leaves((ref[1], ref[3]))):
        assert float((a - b).abs().max()) <= TOL * max(
            1.0, float(b.abs().max()))


def test_dots_remat_saves_the_stage_instead_of_recomputing_it(modes,
                                                              monkeypatch):
    """Under remat "dots" the MultiscaleConvMax operator's outputs are
    saved (`steps._dots_policy` names `kernels.MCM_STAGE`), so the
    backward's recompute does not run the stage again: the stage's plain
    version is called as often as with no remat (each forward once, each
    backward once), where "full" recomputes it."""
    from mpnn_tpu_torch.ops import kernels
    net = zoo_chain(T, lam=0.5)
    params, state, _ = tsteps.init_training(net, seed=2, device="cpu")
    x, y = (torch.as_tensor(a) for a in _batch())
    batch_ctx, loss_and_grads = tsteps._step_pieces(
        net, B, tsteps.Schedules(**SCHED), 0, True)
    xb, yb, ctx = batch_ctx(0, torch.Generator().manual_seed(9), x, y,
                            torch.zeros(10), None)
    calls = []
    plain = kernels.mcm_ref
    monkeypatch.setattr(kernels, "mcm_ref",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    counts = {}
    for policy in (None, "dots", "full"):
        tconfig.set_remat(policy)
        n = len(calls)
        loss_and_grads(params, state, xb, yb, ctx)
        counts[policy] = len(calls) - n
    n_stages = 3
    assert counts == {None: 2 * n_stages, "dots": 2 * n_stages,
                      "full": 3 * n_stages}
