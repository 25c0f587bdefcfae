"""Routed inference of the PyTorch port (mpnn_tpu_torch.models.infer) against
mpnn_tpu's on the CPU: a 3-stage narrow dr_chain-shaped actor net on 16x16
inputs, JAX's params (randomized so routers really split the batch) carried
over with from_numpy_tree. Exits, realized ops and forced exits are equal;
probs agree to atol 1e-5."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.models import ActorNet as JActorNet
from mpnn_tpu.models.infer import calibrate_capacities as j_calibrate
from mpnn_tpu.models.infer import chain_stages as j_chain_stages
from mpnn_tpu.models.infer import make_routed_infer_fn as j_infer
from mpnn_tpu.ops import layers as J
from mpnn_tpu_torch.models import ActorNet as TActorNet
from mpnn_tpu_torch.models.infer import calibrate_capacities as t_calibrate
from mpnn_tpu_torch.models.infer import chain_stages as t_chain_stages
from mpnn_tpu_torch.models.infer import make_routed_infer_fn as t_infer
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils.serdes import from_numpy_tree
from tests.torch_threads import share_cores  # noqa: F401

B = 48
ARCH = [[8, 8, 8], [8, 8], [8]]


def _build(L, Net, **hypers):
    """dr_chain's shape at 3 stages: pyr -> rcm(switch) x2 -> rcm -> leaf."""
    def router():
        return L.Chain(name="Router", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=16), L.BatchNorm(), L.Rect(),
            L.LinTrans(n_chan=16), L.BatchNorm(), L.Rect(),
            L.LinTrans(n_chan=2)])

    def reg():
        return L.Chain(name="LogReg", comps=[
            L.Select(i=-1), L.LinTrans(n_chan=10), L.Softmax(),
            L.CrossEntropyError()])

    def rcm(n_chan, *sinks):
        return L.Chain(name="ReConvMax", sinks=sinks,
                       router=router() if len(sinks) > 1 else None,
                       comps=[L.MultiscaleConvMax(n_chan=n_chan, supp=3),
                              L.MultiscaleBatchNorm(), L.MultiscaleRect()])

    root = rcm(ARCH[-1], reg())
    for n_chan in reversed(ARCH[:-1]):
        root = rcm(n_chan, reg(), root)
    root = L.Chain(name="ToPyramid", sinks=[root],
                   comps=[L.ToPyramid(n_scales=3)])
    return Net(x0_shape=(16, 16, 3), y_shape=(10,), root=root, **hypers)


def _randomize(tree, rng):
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


def _nets(**hypers):
    jnet = _build(J, JActorNet, k_cpt=1e-9, **hypers)
    tnet = _build(T, TActorNet, k_cpt=1e-9, **hypers)
    jp, js = jnet.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(4)  # routes to all three leaves
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    p = _randomize(to_np(jp), rng)
    s = _randomize(to_np(js), rng)
    jtree = jax.tree.map(jnp.asarray, (p, s))
    ttree = from_numpy_tree(p, s, device="cpu")
    return jnet, jtree, tnet, ttree


@pytest.fixture(scope="module")
def nets():
    return _nets()


@pytest.fixture(scope="module")
def batch():
    return np.random.RandomState(1).rand(B, 16, 16, 3).astype(np.float32)


def _run(nets, x, cap, k_cpt=None):
    jnet, (jp, js), tnet, (tp, ts) = nets
    jo = j_infer(jnet, B, cap)(jp, js, jnp.asarray(x), k_cpt)
    to = t_infer(tnet, B, cap)(tp, ts, torch.as_tensor(x), k_cpt)
    return ({k: np.asarray(v) for k, v in jo.items()},
            {k: v.numpy() for k, v in to.items()})


def _assert_same(jo, to):
    np.testing.assert_array_equal(to["exit_idx"], jo["exit_idx"])
    np.testing.assert_array_equal(to["ops"], jo["ops"])
    np.testing.assert_array_equal(to["forced"], jo["forced"])
    np.testing.assert_allclose(to["probs"], jo["probs"], atol=1e-5, rtol=0)
    assert to["exit_idx"].dtype == np.int32 and to["probs"].shape == (B, 10)


@pytest.mark.parametrize("cap,forces", [(1.0, False), (0.5, False),
                                        (0.25, True), ([0.25, 0.0625], True)],
                         ids=["cap1", "cap0.5", "cap0.25", "per_switch"])
def test_routed_infer_matches_jax(nets, batch, cap, forces):
    jo, to = _run(nets, batch, cap)
    _assert_same(jo, to)
    assert (to["forced"].sum() > 0) == forces
    if not forces:  # the randomized routers use every leaf
        assert len(np.unique(to["exit_idx"])) == 3


def test_calibrate_capacities_matches_jax(nets, batch):
    jnet, (jp, js), tnet, (tp, ts) = nets
    jf = j_calibrate(jnet, jp, js, jnp.asarray(batch), margin=1.2)
    tf = t_calibrate(tnet, tp, ts, torch.as_tensor(batch), margin=1.2)
    assert tf == jf and len(tf) == 2
    jo, to = _run(nets, batch, tf)
    _assert_same(jo, to)


def test_chain_stages_matches_jax(nets):
    jnet, _, tnet, _ = nets
    kinds = lambda st: [("switch" if leaf is not None else  # noqa: E731
                         "terminal" if nxt is None else "pass")
                        for _, leaf, nxt in st]
    assert kinds(t_chain_stages(tnet)) == kinds(j_chain_stages(jnet))
    assert [n.n_ops for n in tnet.layers] == [n.n_ops for n in jnet.layers]


def test_dyn_k_cpt_router_input_matches_jax(batch):
    """dyn_k_cpt routers see alpha_cpt * k_cpt as an extra input column."""
    nets = _nets(dyn_k_cpt=True, α_cpt=1e8)
    for k_cpt in (0.0, 4e-9):
        jo, to = _run(nets, batch, 1.0, k_cpt=k_cpt)
        _assert_same(jo, to)


def test_capacity_without_leaf_child_raises():
    tnet = _build(T, TActorNet)
    sw = next(tnet.switches)
    sw.sinks = [s for s in sw.sinks if s.sinks]  # drop the leaf child
    sw.sinks.append(sw.sinks[0])
    with pytest.raises(ValueError, match="no leaf child"):
        t_infer(tnet, B, 0.5)
