"""Checkpoint-vs-oracle parity harness (counterpart of
`mpnn_tpu/paritycheck.py`).

Runs a net's forward and loss in the port and the independent float64
NumPy oracle (`mpnn_tpu_torch.oracle`, which shares nothing with the
port's path but the parameter arrays) on the same batch, and reports
per-quantity deviations: routing probabilities p_tr / p_ev, router
logits, per-leaf error costs, the root output and the total training
loss. `python -m mpnn_tpu_torch.check_parity` wraps it for any
checkpoint on disk.

The port's forward runs on the device the params live on: on CUDA that is
the kernel path (`fused_mcm`), which the caller runs in fp32 with TF32
off (`mpnn_tpu_torch.set_up_device`) for the fp32-grade tolerances. The
report and the tolerances are JAX's.

ToPyramid is the one documented-deviant operator (its resize grid,
PARITY.md): the port's output of it is substituted into the oracle, so
everything downstream is still pinned independently."""

import numpy as np
import torch

from . import oracle
from .models.net import Ctx, _hyper
from .utils.tree import tree_leaves, tree_map

# Default tolerances: fp32 forward against the float64 oracle across the
# registry architectures (deep chains put p_tr across ~7 orders of
# magnitude), as `mpnn_tpu.paritycheck.TOLS`.
TOLS = {
    "p_tr": dict(rtol=2e-4, atol=1e-10),
    "p_ev": dict(rtol=2e-4, atol=1e-10),
    "router_x": dict(rtol=2e-4, atol=2e-5),
    "c_err": dict(rtol=2e-4, atol=1e-6),
    "x_root": dict(rtol=2e-4, atol=2e-5),
    "loss": dict(rtol=5e-4, atol=0.0),
}


def _np64(tree):
    """A tree of tensors as float64 numpy arrays, dict keys sorted at every
    level (JAX's leaf order, which the seeded direction of
    `check_grad_parity` is drawn in)."""
    if isinstance(tree, dict):
        return {k: _np64(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_np64(v) for v in tree]
    return _as64(tree)


def _as64(a):
    """A tensor, array or number as a float64 numpy value."""
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, np.float64)


def _device(params):
    return tree_leaves(params)[0].device


def pyramid_override(net, x0, device="cpu"):
    """{id(ToPyramid): the port's output} when the net starts with a
    pyramid, computed on `device`."""
    from .ops.layers import ToPyramid
    comps = getattr(net.root, "comps", None) or []
    if not comps or not isinstance(comps[0], ToPyramid):
        return None
    tp = comps[0]
    with torch.no_grad():
        out, _, _ = tp.apply({}, {}, torch.as_tensor(x0, device=device),
                             None, Ctx(train=False, rng=None))
    return {id(tp): [_as64(o) for o in out]}


def _dev(a, b, tol):
    a, b = _as64(a), _as64(b)
    abs_err = np.abs(a - b)
    max_abs = float(abs_err.max()) if abs_err.size else 0.0
    over = abs_err - (tol["atol"] + tol["rtol"] * np.abs(b))
    return {"max_abs": max_abs, "ok": bool((over <= 0).all())}


def _merge(report, key, a, b, tols=TOLS):
    d = _dev(a, b, tols[key])
    slot = report["checks"].setdefault(
        key, {"max_abs": 0.0, "ok": True, "n": 0})
    slot["max_abs"] = max(slot["max_abs"], d["max_abs"])
    slot["ok"] = slot["ok"] and d["ok"]
    slot["n"] += 1


def _effective_tols(net, tau):
    """Routing tolerances scale with the temperature: pi_tr's log error is
    the logit error amplified by 1/tau (softmax(rx/tau)), compounding
    over the switches on a path, so rtol_p = max(base, n_switches *
    atol_logit / tau); everything else keeps the base."""
    tols = {k: dict(v) for k, v in TOLS.items()}
    amp = len(list(net.switches)) * TOLS["router_x"]["atol"] / max(tau,
                                                                   1e-12)
    for k in ("p_tr", "p_ev"):
        tols[k]["rtol"] = max(tols[k]["rtol"], amp)
    return tols


def _settings(net, x0, tau, eps, k_cpt):
    """(tau, eps, dyn, k_cpt) with the net's hypers as defaults; k_cpt is
    a per-example fp32 array for dyn_k_cpt nets."""
    tau = float(_hyper(net, "τ", 1.0)) if tau is None else float(tau)
    eps = float(_hyper(net, "ϵ", 1e-6)) if eps is None else float(eps)
    dyn = bool(_hyper(net, "dyn_k_cpt", False))
    if k_cpt is None:
        k_cpt = _hyper(net, "k_cpt", 0.0)
        if dyn:
            k_cpt = np.full((len(x0),), float(k_cpt), np.float32)
    return tau, eps, dyn, k_cpt


def _oracle_kw(net, x0, dyn, k_cpt, device):
    return dict(k_cpt=(np.float64(k_cpt) if dyn else None),
                alpha_cpt=(float(_hyper(net, "α_cpt", 1e7)) if dyn
                           else None),
                dyn_k_cpt=dyn, overrides=pyramid_override(net, x0, device))


def _port_ctx(train, tau, eps, dyn, k_cpt, device):
    return Ctx(train=train, rng=None, tau=tau, eps=eps,
               k_cpt=(torch.as_tensor(k_cpt, device=device) if dyn
                      else k_cpt))


def check_parity(net, params, state, x0, y, *, train=True, tau=None,
                 eps=None, k_cpt=None):
    """Compare the port's forward and loss against the float64 oracle.

    x0 / y: a host batch (B, ...) / (B, n_cls). tau / eps / k_cpt default
    to the net's hypers (k_cpt may be a per-example array for dyn_k_cpt
    nets). Returns a JSON-able report dict with per-quantity max
    deviations and an overall "ok"."""
    tau, eps, dyn, k_cpt = _settings(net, x0, tau, eps, k_cpt)
    x0 = np.asarray(x0, np.float32)
    y = np.asarray(y, np.float32)
    dev = _device(params)

    ctx = _port_ctx(train, tau, eps, dyn, k_cpt, dev)
    with torch.no_grad():
        recs, _ = net.forward(params, state, torch.as_tensor(x0, device=dev),
                              torch.as_tensor(y, device=dev), ctx)
        loss = float(net.loss(recs, len(x0), ctx))

    infos = oracle.net_forward(
        net, _np64(params), _np64(state), np.float64(x0), np.float64(y),
        train, **_oracle_kw(net, x0, dyn, k_cpt, dev))
    routed = net.uses_expectation_optimizer
    globopt = bool(_hyper(net, "globopt", False))
    if routed:
        oracle.route(net.root, infos, eps=eps, tau=tau, mixture=not globopt)
        kind = type(net).__name__
        if kind == "ActorNet":
            o_loss, _ = oracle.actor_loss(
                net, infos, k_cpt=np.float64(k_cpt),
                k_dec=float(_hyper(net, "k_dec", 0.01)),
                globopt=globopt,
                k_pol=float(_hyper(net, "k_pol", 0.01)))
        else:
            o_loss, _ = oracle.critic_loss(
                net, infos, k_cpt=np.float64(k_cpt),
                k_cre=float(_hyper(net, "k_cre", 1e-3)),
                use_cls_err=bool(_hyper(net, "use_cls_err", False)),
                optimistic=bool(_hyper(net, "optimistic", False)))
    else:
        o_loss = oracle.sr_loss(net, infos)

    tols = _effective_tols(net, tau)
    report = {"net": type(net).__name__, "train": train, "tau": tau,
              "eps": eps, "batch": int(len(x0)), "loss": loss,
              "oracle_loss": float(o_loss),
              "p_rtol": tols["p_tr"]["rtol"], "checks": {}}
    for l in net.layers:
        if routed:
            _merge(report, "p_tr", recs[l].p_tr, infos[l].p_tr, tols)
            _merge(report, "p_ev", recs[l].p_ev, infos[l].p_ev, tols)
        if recs[l].router_x is not None:
            _merge(report, "router_x", recs[l].router_x, infos[l].router_x)
    for l in net.leaves:
        if recs[l].c_err is not None:
            _merge(report, "c_err", recs[l].c_err, infos[l].c_err)
    root_x = recs[net.root].x
    if not isinstance(root_x, (list, tuple)):
        _merge(report, "x_root", root_x, infos[net.root].x)
    _merge(report, "loss", loss, o_loss)
    report["ok"] = all(c["ok"] for c in report["checks"].values())
    return report


def check_grad_parity(net, params, state, x0, y, *, tau=None, eps=None,
                      k_cpt=None, seed=0, fd_eps=1e-6, rtol=2e-3):
    """Directional training-gradient parity against the oracle.

    Compares <the port's autograd gradient of L(theta), d> for a seeded
    random direction d (drawn as JAX's harness draws it) against a float64
    central finite difference of the oracle's stop-gradient-explicit loss
    (quantities the reference wraps in stop_gradient are held at the
    unperturbed params), so a misplaced sg boundary fails the check even
    when all values agree. Train mode only."""
    tau, eps, dyn, k_cpt = _settings(net, x0, tau, eps, k_cpt)
    x0 = np.asarray(x0, np.float32)
    y = np.asarray(y, np.float32)
    kind = type(net).__name__
    dev = _device(params)

    ctx = _port_ctx(True, tau, eps, dyn, k_cpt, dev)
    live = tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    recs, _ = net.forward(live, state, torch.as_tensor(x0, device=dev),
                          torch.as_tensor(y, device=dev), ctx)
    loss = net.loss(recs, len(x0), ctx)
    grads = torch.autograd.grad(loss, tree_leaves(live),
                                materialize_grads=True)
    it = iter(grads)
    grads = _np64(tree_map(lambda _: next(it), live))
    params_np, state_np = _np64(params), _np64(state)
    r = np.random.RandomState(seed)
    d = tree_map(lambda a: np.float64(r.randn(*np.shape(a))), params_np)
    repo_dot = sum(float(np.sum(g * dd))
                   for g, dd in zip(tree_leaves(grads), tree_leaves(d)))

    okw = _oracle_kw(net, x0, dyn, k_cpt, dev)
    globopt = bool(_hyper(net, "globopt", False))

    def infos_at(p):
        infos = oracle.net_forward(net, p, state_np, np.float64(x0),
                                   np.float64(y), True, **okw)
        if net.uses_expectation_optimizer:
            oracle.route(net.root, infos, eps=eps, tau=tau,
                         mixture=not globopt)
        return infos

    def perturbed(sign):
        return tree_map(lambda a, b: a + sign * fd_eps * b, params_np, d)

    frozen = infos_at(params_np)
    kc = np.float64(k_cpt)
    if kind == "ActorNet":
        k_dec = float(_hyper(net, "k_dec", 0.01))
        k_pol = float(_hyper(net, "k_pol", 0.01))

        def loss_sg(live):
            return oracle.actor_loss_sg(net, live, frozen, kc, k_dec,
                                        globopt=globopt, k_pol=k_pol)
    elif kind == "CriticNet":
        def loss_sg(live):
            return oracle.critic_loss_sg(
                net, live, frozen, kc, float(_hyper(net, "k_cre", 1e-3)),
                bool(_hyper(net, "use_cls_err", False)),
                bool(_hyper(net, "optimistic", False)))
    else:
        def loss_sg(live):
            return oracle.sr_loss(net, live)
    fd = (loss_sg(infos_at(perturbed(+1)))
          - loss_sg(infos_at(perturbed(-1)))) / (2 * fd_eps)

    ok = bool(np.isclose(repo_dot, fd, rtol=rtol, atol=1e-7))
    return {"net": kind, "loss": float(loss.detach()),
            "repo_grad_dot": repo_dot,
            "oracle_fd": float(fd), "rtol": rtol, "ok": ok}
