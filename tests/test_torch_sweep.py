"""The port's vmapped k_cpt sweep against mpnn_tpu's on the CPU: stacked
trees, the MultiscaleConvMax stage under torch.func.vmap (forward against
mcm_ref on each net's slice, gradients against jax.vmap of jax.vjp of
mcm_xla), each member of a sweep step against the port's serial step,
the sweep loop's spans and draws, and the sweep's descriptors against
mpnn_tpu's sweep_net_descs (whole sweep steps against jax.vmap of
mpnn_tpu's step are in tests/test_torch_sweep_steps.py). Nets are the
3-stage chains on 16x16 inputs of tests/test_torch_sr_cr.py, 3 nets at
batch 8. Values agree to 1e-5 in ||port - jax|| / ||jax||, descriptor
stats to 1e-4 x max(1, |stat|)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.data.dataset import Dataset as JDataset
from mpnn_tpu.models import steps as jsteps
from mpnn_tpu.ops import layers as J
from mpnn_tpu.ops.kernels import mcm_xla
from mpnn_tpu.utils.desc import sweep_net_descs as j_sweep_net_descs
from mpnn_tpu_torch.data.dataset import Dataset as TDataset
from mpnn_tpu_torch.data.synth import make_synthetic
from mpnn_tpu_torch.models import steps as tsteps
from mpnn_tpu_torch.ops import kernels
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils.desc import net_desc, sweep_net_descs
from mpnn_tpu_torch.utils.serdes import from_numpy_tree
from mpnn_tpu_torch.utils.tree import (stack_trees, tree_leaves, tree_map,
                                       tree_to_host, unstack_tree)
from tests.test_torch_sr_cr import build_chain, random_pair
from tests.test_torch_train import (TAU, VALUE_TOL, _assert_tree_close,
                                    _dataset)

N_NETS, B = 3, 8
K_CPTS = [0.0, 2e-6, 1e-5]  # the members' prices
N_STEPS = 3  # batches of _raw_batches
SCHED = dict(lr=lambda t: 0.02, tau=lambda t: 1.0 / 2 ** (t / 2))
DESC_TOL = 1e-4


def _np_stack(trees):
    return tree_map(lambda *a: np.stack(a), *trees)


def test_stack_and_unstack_trees_match_jax():
    """stack_trees puts the members on a new leading axis and unstack_tree
    takes member i back out, exactly as mpnn_tpu's do."""
    trees = [random_pair("ac", seed=i)[2] for i in range(N_NETS)]
    jt = jsteps.stack_trees([jax.tree.map(jnp.asarray, t) for t in trees])
    tt = stack_trees(from_numpy_tree(*trees, device="cpu"))
    _assert_tree_close(tt, jax.tree.map(np.asarray, jt), 0.0)
    assert tree_leaves(tt)[0].shape[0] == N_NETS
    for i in range(N_NETS):
        _assert_tree_close(unstack_tree(tt, i), trees[i], 0.0)
        _assert_tree_close(unstack_tree(tt, i),
                           jax.tree.map(np.asarray,
                                        jsteps.unstack_tree(jt, i)), 0.0)
    host = tree_to_host(tt)
    assert [a.device.type for a in tree_leaves(host)] == ["cpu"] * len(
        tree_leaves(tt))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(host),
                                                 tree_leaves(tt)))


def _stage_nets(x_batched, seed=0):
    """N_NETS members of a 3-scale MCM stage (16/8/4, 3 -> 8 channels),
    weights per net; the input pyramid per net or shared."""
    rng = np.random.RandomState(seed)
    lead = (N_NETS,) if x_batched else ()
    xs = [rng.rand(*lead, B, s, s, 3).astype(np.float32) for s in (16, 8, 4)]
    whs = [(0.2 * rng.randn(N_NETS, 3, 3, 3, 8)).astype(np.float32)
           for _ in range(3)]
    wvs = [(0.2 * rng.randn(N_NETS, 3, 3, 8, 8)).astype(np.float32)
           for _ in range(2)]
    bs = [rng.randn(N_NETS, 8).astype(np.float32) for _ in range(3)]
    cot = [rng.randn(N_NETS, B, s, s, 8).astype(np.float32)
           for s in (16, 8, 4)]
    return xs, whs, wvs, bs, cot


@pytest.mark.parametrize("x_batched", [False, True],
                         ids=["shared_input", "input_per_net"])
def test_fused_mcm_under_vmap_matches_jax(x_batched, monkeypatch):
    """fused_mcm under torch.func.vmap takes its vmap rule, once per call,
    with every net in one call; each net's outputs equal mcm_ref on its
    slice; the gradients under vmap(grad) of every input match
    jax.vmap of jax.vjp of mcm_xla."""
    xs, whs, wvs, bs, cot = _stage_nets(x_batched)
    calls = []
    forward = kernels._forward

    def spy(*args, **kwargs):
        calls.append(kwargs.get("n_nets", 0))
        return forward(*args, **kwargs)

    monkeypatch.setattr(kernels, "_forward", spy)
    txs, twhs, twvs, tbs, tcot = ([torch.as_tensor(a) for a in group]
                                  for group in (xs, whs, wvs, bs, cot))
    x_dim = 0 if x_batched else None

    def stage(whs, wvs, bs, xs):
        return kernels.fused_mcm(xs, whs, wvs, bs, 3)

    outs = torch.func.vmap(stage, in_dims=(0, 0, 0, x_dim))(twhs, twvs, tbs,
                                                            txs)
    assert calls == [N_NETS]
    for i in range(N_NETS):
        xi = [x[i] for x in txs] if x_batched else txs
        ref = kernels.mcm_ref(xi, [w[i] for w in twhs], [w[i] for w in twvs],
                              [b[i] for b in tbs])
        for o, r in zip(outs, ref):
            assert torch.equal(o[i], r)

    def loss(whs, wvs, bs, xs, cot):
        return sum(torch.sum(o * c) for o, c in zip(stage(whs, wvs, bs, xs),
                                                    cot))

    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3)),
                            in_dims=(0, 0, 0, x_dim, 0))(twhs, twvs, tbs,
                                                         txs, tcot)

    def j_grads(whs, wvs, bs, xs, cot):
        _, vjp = jax.vjp(lambda w, v, b, x: mcm_xla(x, w, v, b), whs, wvs,
                         bs, xs)
        return vjp(cot)

    jg = jax.vmap(j_grads, in_axes=(0, 0, 0, x_dim, 0))(
        *(list(map(jnp.asarray, g)) for g in (whs, wvs, bs, xs, cot)))
    for tgroup, jgroup in zip(grads, jg):
        for t, j in zip(tgroup, jgroup):
            j = np.asarray(j)
            assert t.shape == j.shape
            assert np.linalg.norm(t.numpy() - j) <= VALUE_TOL * (
                np.linalg.norm(j))


def _raw_batches():
    """N_STEPS presampled (not augmented) batches of the shared dataset."""
    x0, y, _ = _dataset()
    draw = np.random.RandomState(5)
    return [(x0[idx], y[idx]) for idx in (draw.randint(0, len(x0), B)
                                          for _ in range(N_STEPS))]


@pytest.mark.parametrize("kind", ["ac", "cr"])
def test_sweep_member_equals_serial_step(kind):
    """Member i of one sweep step equals the port's serial presampled step
    of net i at k_cpt_i on the same batch, augmented from the same
    generator state (the batch is augmented once, outside the vmap)."""
    tnet = build_chain(T, kind)
    m_sym = torch.as_tensor(_dataset()[2])
    xb, yb = (torch.as_tensor(a) for a in _raw_batches()[0])
    sched = tsteps.Schedules(**SCHED)
    members = [tsteps.init_training(tnet, seed=i, device="cpu")
               for i in range(N_NETS)]
    ps, ss, vs = (stack_trees([m[j] for m in members]) for j in range(3))
    sweep = tsteps._sweep_step_body(tnet, B, sched)
    ps, ss, vs, c = sweep(ps, ss, vs, 1, torch.Generator().manual_seed(3),
                          xb, yb, m_sym, torch.tensor(K_CPTS))
    serial = tsteps._train_step_body(tnet, B, sched, presampled=True)
    for i, (p, s, v) in enumerate(members):
        p, s, v, ci = serial(p, s, v, 1, torch.Generator().manual_seed(3),
                             xb, yb, m_sym, float(np.float32(K_CPTS[i])))
        assert abs(float(c[i]) - float(ci)) <= VALUE_TOL * abs(float(ci))
        _assert_tree_close(unstack_tree(ps, i), p, VALUE_TOL,
                           zero_grad_biases=True)
        _assert_tree_close(unstack_tree(ss, i), s, VALUE_TOL)
        _assert_tree_close(unstack_tree(vs, i), v, VALUE_TOL,
                           zero_grad_biases=True)


def test_sweep_loop_spans_and_losses():
    """make_sweep_train_loop runs the sweep step on the chunked loop's
    spans and draws: its trees and (n_steps, n_nets) losses equal, bit for
    bit, the step run on the same gathers and re-seeded generators."""
    tnet = build_chain(T, "ac")
    arch = make_synthetic(n_tr=48, n_ts=24, h=16, w=16, c=3, n_cls=10,
                          seed=3)
    x0_tr, y_tr, m_sym = TDataset(arch, device="cpu").train_arrays
    sched, k = tsteps.Schedules(**SCHED), torch.tensor(K_CPTS)
    runs = []
    for use_loop in (True, False):
        members = [tsteps.init_training(tnet, seed=i, device="cpu")
                   for i in range(N_NETS)]
        ps, ss, vs = (stack_trees([m[j] for m in members]) for j in range(3))
        if use_loop:
            loop = tsteps.make_sweep_train_loop(tnet, B, sched,
                                                sample_tile=2)
            ps, ss, vs, cs = loop(ps, ss, vs, 3, 11, x0_tr, y_tr, m_sym, 3,
                                  k)
        else:
            step = tsteps._sweep_step_body(tnet, B, sched)
            gen = torch.Generator()
            sample = tsteps._chunk_sampler(B, x0_tr, y_tr)
            cs = []
            for t_first, n in ((3, 2), (5, 1)):
                xc, yc = sample(gen, 11, t_first, n)
                for i in range(n):
                    gen.manual_seed(tsteps._fold(11, t_first + i))
                    ps, ss, vs, c = step(ps, ss, vs, t_first + i, gen,
                                         xc[i], yc[i], m_sym, k)
                    cs.append(c)
            cs = torch.stack(cs)
        runs.append((ps, ss, vs, cs))
    (lp, ls, lv, lc), (sp, ss_, sv, sc) = runs
    assert lc.shape == (3, N_NETS) and torch.isfinite(lc).all()
    assert torch.equal(lc, sc)
    for a, b in zip(tree_leaves((lp, ls, lv)), tree_leaves((sp, ss_, sv))):
        assert torch.equal(a, b)


def _scalar_stats(desc, path=""):
    out = [(path + "/" + key + "/" + k, v)
           for key in ("stats_tr", "stats_ts")
           for k, v in sorted(desc.get(key, {}).items())
           if np.ndim(v) == 0]
    for i, s in enumerate(desc.get("sinks", [desc["root"]] if "root" in desc
                                   else [])):
        out += _scalar_stats(s, "%s/%d" % (path, i))
    return out


def _schema(obj):
    if isinstance(obj, dict):
        return {k: _schema(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_schema(v) for v in obj]
    return type(obj).__name__


def test_sweep_net_descs_match_jax():
    """The sweep's descriptors from seeded random stacked nets: the schema
    of mpnn_tpu's sweep_net_descs and of the port's net_desc, every scalar
    stat against JAX's within 1e-4 x max(1, |stat|), and against the
    port's serial net_desc of the same member."""
    jnet, tnet = build_chain(J, "ac"), build_chain(T, "ac")
    members = [random_pair("ac", seed=i)[2:] for i in range(N_NETS)]
    jp, js = (_np_stack([m[j] for m in members]) for j in range(2))
    arch = make_synthetic(n_tr=40, n_ts=20, h=16, w=16, c=3, n_cls=10,
                          seed=1)
    tds = TDataset(arch, device="cpu")
    jdescs = j_sweep_net_descs(jnet, JDataset(arch), jp, js, K_CPTS,
                               batch_size=B, tau=TAU)
    tp, ts = from_numpy_tree(jp, js, device="cpu")
    tdescs = sweep_net_descs(tnet, tds, tp, ts, K_CPTS, batch_size=B,
                             tau=TAU)
    assert len(tdescs) == N_NETS
    for i, (td, jd) in enumerate(zip(tdescs, jdescs)):
        serial = net_desc(tnet, tds, unstack_tree(tp, i),
                          unstack_tree(ts, i), batch_size=B, tau=TAU,
                          k_cpt=float(np.float32(K_CPTS[i])))
        assert _schema(td) == _schema(jd) == _schema(serial)
        for (path, a), (_, b), (_, c) in zip(_scalar_stats(td),
                                             _scalar_stats(jd),
                                             _scalar_stats(serial)):
            assert abs(a - b) <= DESC_TOL * max(1.0, abs(b)), (i, path)
            assert abs(a - c) <= DESC_TOL * max(1.0, abs(c)), (i, path)
    assert tdescs[0] != tdescs[1]
