"""mpnn_tpu_torch.paritycheck, the port's checkpoint-vs-oracle harness, on
the CPU: the counterparts of tests/test_paritycheck.py's five tests
(parametrized as there) on the same nets built in both packages and the
same params; the port's oracle against mpnn_tpu.oracle (infos equal to
1e-12); the port's check_parity report against mpnn_tpu's on the same
params, on the two-switch Conv tree and on the 3-stage 16x16 pyramid
chain (MultiscaleConvMax stages, the ToPyramid override); and the
check_parity CLI on the CPU."""

import contextlib
import io
import json

import numpy as np
import jax
import pytest
import torch

from mpnn_tpu import oracle as j_oracle
from mpnn_tpu import paritycheck as jpc
from mpnn_tpu.models import ActorNet as JActorNet
from mpnn_tpu.models import CriticNet as JCriticNet
from mpnn_tpu.models import SRNet as JSRNet
from mpnn_tpu.ops import layers as J
from mpnn_tpu_torch import oracle as t_oracle
from mpnn_tpu_torch import paritycheck as tpc
from mpnn_tpu_torch.models import ActorNet as TActorNet
from mpnn_tpu_torch.models import CriticNet as TCriticNet
from mpnn_tpu_torch.models import SRNet as TSRNet
from mpnn_tpu_torch.ops import config
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.utils.serdes import from_numpy_tree, write_net

from .test_reference_oracle import H, W, C, NCLS, _data
from .test_torch_infer import _nets as _pyramid_nets
from tests.torch_threads import share_cores  # noqa: F401

NETS = {"actor": (JActorNet, TActorNet), "critic": (JCriticNet, TCriticNet)}


def _two_switch_tree(L, net_cls, **hypers):
    """tests/test_reference_oracle.py's root(switch) -> [reg leaf,
    mid(switch) -> [reg leaf, reg leaf]], from the layer module L."""
    def reg():
        return L.Chain(comps=[L.LinTrans(n_chan=NCLS, k_l2=1e-4, σ_w=1.5),
                              L.Softmax(), L.CrossEntropyError()])

    def router():
        return L.Chain(comps=[L.LinTrans(n_chan=8, k_l2=1e-4),
                              L.BatchNorm(), L.Rect(),
                              L.LinTrans(n_chan=2, k_l2=1e-4)])

    def body():
        return [L.Conv(n_chan=C, supp=3, k_l2=1e-4, res=True),
                L.BatchNorm(), L.Rect()]

    inner = L.Chain(comps=body(), router=router(), sinks=[reg(), reg()])
    root = L.Chain(comps=body(), router=router(), sinks=[reg(), inner])
    return net_cls(root=root, x0_shape=(H, W, C), y_shape=(NCLS,), **hypers)


def _pair(kind, seed, jitter=None, **hypers):
    """The net in both packages, JAX's init (jittered with seed `jitter`
    as test_paritycheck's _jitter does) as numpy, and the port's copy."""
    jcls, tcls = NETS[kind]
    jnet = _two_switch_tree(J, jcls, **hypers)
    tnet = _two_switch_tree(T, tcls, **hypers)
    p, s = jax.tree.map(np.asarray, jnet.init(jax.random.PRNGKey(seed)))
    if jitter is not None:
        r = np.random.RandomState(jitter)
        p = jax.tree.map(
            lambda a: a + (0.05 * r.randn(*np.shape(a))).astype(a.dtype), p)
    return jnet, tnet, (p, s), from_numpy_tree(p, s, device="cpu")


CASES = [("actor", dict(k_cpt=3e-9, k_dec=0.02)),
         ("critic", dict(k_cpt=3e-9, k_cre=1e-2)),
         ("actor", dict(k_cpt=0.0, dyn_k_cpt=True, α_cpt=1e7))]
GRAD_CASES = [("actor", dict(k_cpt=3e-9, k_dec=0.02)),
              ("critic", dict(k_cpt=3e-9, k_cre=1e-2)),
              ("actor", dict(k_cpt=1e-9, dyn_k_cpt=True, α_cpt=1e7))]
IDS = ["actor", "critic", "actor_dyn"]


@pytest.mark.parametrize("kind,kw", CASES, ids=IDS)
def test_check_parity_passes_fp32(kind, kw):
    _, tnet, _, (tp, ts) = _pair(kind, 0, jitter=1, τ=0.7, ϵ=0.05, **kw)
    x0, y = _data(0)
    report = tpc.check_parity(tnet, tp, ts, x0, y)
    assert report["ok"], report
    assert report["checks"]["p_tr"]["n"] > 0


def test_check_parity_sr_and_eval_mode():
    def sr(L, net_cls):
        body = L.Chain(comps=[
            L.Conv(n_chan=C, supp=3, k_l2=1e-4, res=True), L.BatchNorm(),
            L.Rect(), L.LinTrans(n_chan=NCLS, k_l2=1e-4), L.Softmax(),
            L.CrossEntropyError()])
        return net_cls(root=body, x0_shape=(H, W, C), y_shape=(NCLS,))

    jnet, tnet = sr(J, JSRNet), sr(T, TSRNet)
    tp, ts = from_numpy_tree(*jax.tree.map(
        np.asarray, jnet.init(jax.random.PRNGKey(1))), device="cpu")
    x0, y = _data(1)
    for train in (True, False):
        report = tpc.check_parity(tnet, tp, ts, x0, y, train=train)
        assert report["ok"], (train, report)
        assert "p_tr" not in report["checks"]
        assert report["checks"]["x_root"]["n"] == 1


def test_check_parity_detects_bf16_divergence():
    """Negative control: under a bf16 compute dtype the fp32-grade
    tolerances must fail."""
    _, tnet, _, (tp, ts) = _pair("actor", 2, jitter=3, k_cpt=3e-9, τ=0.7,
                                 ϵ=0.05)
    x0, y = _data(2)
    config.set_compute_dtype(torch.bfloat16)
    try:
        report = tpc.check_parity(tnet, tp, ts, x0, y)
    finally:
        config.set_compute_dtype(None)
    assert not report["ok"], report


def test_tau_aware_routing_tolerance():
    """Sharp temperatures widen only the routing rtol, in proportion to
    n_switches / tau; tau = 1 keeps the base."""
    _, tnet, _, (tp, ts) = _pair("actor", 4, jitter=5, k_cpt=3e-9, τ=1.0,
                                 ϵ=0.05)
    base = tpc._effective_tols(tnet, tau=1.0)
    sharp = tpc._effective_tols(tnet, tau=0.01)
    assert base["p_tr"]["rtol"] == pytest.approx(2e-4)
    assert sharp["p_tr"]["rtol"] == pytest.approx(2 * 2e-5 / 0.01)
    assert sharp["c_err"] == base["c_err"]
    x0, y = _data(4)
    report = tpc.check_parity(tnet, tp, ts, x0, y, tau=0.01)
    assert report["ok"], report


@pytest.mark.parametrize("kind,kw", GRAD_CASES, ids=IDS)
def test_check_grad_parity(kind, kw):
    """The port's gradient against the oracle's finite difference, and
    against JAX's harness on the same params and direction."""
    jnet, tnet, (p, s), (tp, ts) = _pair(kind, 6, jitter=7, τ=0.7, ϵ=0.05,
                                         **kw)
    x0, y = _data(6)
    report = tpc.check_grad_parity(tnet, tp, ts, x0, y)
    assert report["ok"], report
    j = jpc.check_grad_parity(jnet, p, s, x0, y)
    assert report["oracle_fd"] == pytest.approx(j["oracle_fd"], rel=1e-9)
    assert report["repo_grad_dot"] == pytest.approx(j["repo_grad_dot"],
                                                    rel=1e-4)


def _infos_close(ji, ti, nodes, tol=1e-12):
    def close(a, b):
        if isinstance(a, list):
            return all(close(u, v) for u, v in zip(a, b))
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return a.shape == b.shape and np.allclose(a, b, rtol=tol, atol=tol)
    for n in nodes:
        for k in ("x", "c_err", "c_mod", "router_x", "p_tr", "p_ev",
                  "c_ev", "c_opt", "c_cre"):
            a, b = getattr(ji[n[0]], k, None), getattr(ti[n[1]], k, None)
            assert (a is None) == (b is None), k
            if a is not None:
                assert close(a, b), k


@pytest.mark.parametrize("kind,kw", CASES, ids=IDS)
def test_oracle_matches_jax_oracle(kind, kw):
    """The port's oracle, walking the port's objects, against mpnn_tpu's,
    walking JAX's, on the same float64 params: every info within 1e-12
    after the forward, the routing and the losses."""
    jnet, tnet, (p, s), (tp, ts) = _pair(kind, 0, jitter=1, τ=0.7, ϵ=0.05,
                                         **kw)
    x0, y = (np.float64(a) for a in _data(0))
    dyn = kw.get("dyn_k_cpt", False)
    okw = dict(k_cpt=np.full(len(x0), kw["k_cpt"]) if dyn else None,
               alpha_cpt=kw.get("α_cpt"), dyn_k_cpt=dyn)
    p64 = jax.tree.map(lambda a: np.asarray(a, np.float64), (p, s))
    ji = j_oracle.net_forward(jnet, *p64, x0, y, True, **okw)
    ti = t_oracle.net_forward(tnet, *tpc._np64((tp, ts)), x0, y, True, **okw)
    nodes = list(zip(jnet.layers, tnet.layers))
    for o, infos, net in ((j_oracle, ji, jnet), (t_oracle, ti, tnet)):
        o.route(net.root, infos, eps=0.05, tau=0.7)
    loss = {}
    for o, infos, net in ((j_oracle, ji, jnet), (t_oracle, ti, tnet)):
        if kind == "actor":
            loss[o] = o.actor_loss(net, infos, kw["k_cpt"], 0.02)[0]
        else:
            loss[o] = o.critic_loss(net, infos, kw["k_cpt"], 1e-2, False,
                                    False)[0]
    _infos_close(ji, ti, nodes)
    assert loss[t_oracle] == pytest.approx(loss[j_oracle], rel=1e-12)


@pytest.mark.parametrize("arch", ["two_switch_tree", "pyramid_chain"])
def test_report_matches_jax_report(arch, monkeypatch):
    """The port's check_parity report against mpnn_tpu's on the same
    params: the same oracle loss, the loss within 1e-5, the same
    verdicts. The pyramid chain runs MultiscaleConvMax through fused_mcm;
    each package's ToPyramid output (the override) agrees within 1e-6,
    and the port's oracle then takes JAX's, so the oracle losses are of
    the same inputs."""
    if arch == "two_switch_tree":
        jnet, tnet, (jp, js), (tp, ts) = _pair(
            "actor", 0, jitter=1, k_cpt=3e-9, k_dec=0.02, τ=0.7, ϵ=0.05)
        x0, y = _data(0)
    else:
        jnet, (jp, js), tnet, (tp, ts) = _pyramid_nets()
        r = np.random.RandomState(2)
        x0 = r.rand(8, 16, 16, 3).astype(np.float32)
        y = np.eye(10, dtype=np.float32)[r.randint(0, 10, 8)]
        jp, js = jax.tree.map(np.asarray, (jp, js))
        mcms = [(jc, tc) for jn, tn in zip(jnet.layers, tnet.layers)
                for jc, tc in zip(jn.comps, tn.comps)
                if type(tc).__name__ == "MultiscaleConvMax"]
        assert len(mcms) == 3
        for jc, tc in mcms:
            assert (t_oracle.mcm_n_ops(tc) == j_oracle.mcm_n_ops(jc)
                    == tc.n_ops)
        (jpyr,), (tpyr,) = (list(f(n, x0).values()) for f, n in (
            (jpc.pyramid_override, jnet), (tpc.pyramid_override, tnet)))
        for a, b in zip(jpyr, tpyr):
            np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)
        tp_id = id(tnet.root.comps[0])
        monkeypatch.setattr(tpc, "pyramid_override",
                            lambda *a: {tp_id: jpyr})
    t = tpc.check_parity(tnet, tp, ts, x0, y)
    j = jpc.check_parity(jnet, jp, js, x0, y)
    assert t["ok"] and j["ok"], (t, j)
    assert t["oracle_loss"] == pytest.approx(j["oracle_loss"], rel=1e-12)
    assert t["loss"] == pytest.approx(j["loss"], rel=1e-5)
    assert {k: (v["ok"], v["n"]) for k, v in t["checks"].items()} == {
        k: (v["ok"], v["n"]) for k, v in j["checks"].items()}
    assert {k: t[k] for k in ("net", "train", "tau", "eps", "batch",
                              "p_rtol")} == {
        k: j[k] for k in ("net", "train", "tau", "eps", "batch", "p_rtol")}


def test_check_parity_cli_on_cpu(tmp_path):
    """`python -m mpnn_tpu_torch.check_parity` on the CPU: a checkpoint
    with --grads prints both reports and PARITY OK, exit 0; a registry
    net fresh at init with --expt."""
    from mpnn_tpu_torch import check_parity
    _, _, tnet, (tp, ts) = _pyramid_nets()
    ckpt = str(tmp_path / "net.npy")
    write_net(ckpt, tnet, tp, ts)
    for argv in ([ckpt, "--grads"], ["--expt", "synth-sr", "--net", "0",
                                     "--eval", "--batch-size", "4"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = check_parity.main(argv + ["--device", "cpu"])
        out = buf.getvalue()
        assert rc == 0 and out.rstrip().endswith("PARITY OK"), out
        reports, text = [], out.rstrip()[:-len("PARITY OK")].strip()
        while text:
            rec, end = json.JSONDecoder().raw_decode(text)
            reports.append(rec)
            text = text[end:].strip()
        assert len(reports) == (2 if "--grads" in argv else 1)
        assert all(r["ok"] for r in reports)
