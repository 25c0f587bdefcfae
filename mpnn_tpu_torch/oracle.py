"""Independent float64 NumPy oracle of the reference's forward, routing
and loss math (the port's copy of `mpnn_tpu/oracle.py`).

It re-derives the reference's semantics (its scripts/lib/layer_types.py
and net_types.py) in plain NumPy, sharing nothing with the port's torch
path but the parameter arrays, so the port can be pinned against an
implementation independent of it (port-vs-oracle rather than
port-vs-port). `mpnn_tpu_torch.paritycheck` and `python -m
mpnn_tpu_torch.check_parity` expose it as a harness for any trained
checkpoint.

The oracle walks the port's tree of layer objects (structure and
hyperparameters are configuration, not math): `type(layer).__name__`,
`layer.hypers`, `layer.comps`, `layer.router`, `layer.sinks`,
`layer.n_ops`, `layer.out_shape` and MultiscaleConvMax's
`_w_horz_shapes` / `_w_vert_shapes`, and `net.root`. The port's layers
carry these under the names and layouts of `mpnn_tpu`'s, and its
parameter trees are nested dicts in `mpnn_tpu`'s layout, so nothing of
the JAX package's oracle had to change: the math below is its line for
line, since that oracle is what this one is held against
(`tests/test_torch_paritycheck.py`). The caller hands it params and state
as nested dicts of float64 numpy arrays (`paritycheck._np64` of the
port's tensors). Every reference citation per formula is inline.

Everything runs in float64 for a tight tolerance against the port's fp32.
"""

import numpy as np


# ---------------------------------------------------------------- layer math

def conv_same(x, w):
    """SAME stride-1 2-D conv (reference layer_types.py:72,
    tf.nn.conv2d(..., 'SAME')): zero pad (supp-1)//2 before / rest after."""
    s = w.shape[0]
    pb = (s - 1) // 2
    pa = s - 1 - pb
    xp = np.pad(x, ((0, 0), (pb, pa), (pb, pa), (0, 0)))
    h, wd = x.shape[1:3]
    out = np.zeros(x.shape[:3] + (w.shape[3],))
    for i in range(s):
        for j in range(s):
            out += np.einsum('bhwc,cd->bhwd', xp[:, i:i + h, j:j + wd], w[i, j])
    return out


def softmax(z, axis=-1):
    z = z - np.max(z, axis=axis, keepdims=True)
    e = np.exp(z)
    return e / np.sum(e, axis=axis, keepdims=True)


def lin_trans_w_eq(n_in, n_chan, res):
    """w_eq = eye(n_in, n_chan) if res else 0 (layer_types.py:47)."""
    return np.eye(n_in, n_chan) if res else 0.0


def conv_w_eq(supp, n_in, n_chan, res):
    """Identity kernel (layer_types.py:65-69)."""
    if not res:
        return 0.0
    return ((np.arange(supp) == supp // 2)[:, None, None, None]
            * (np.arange(supp) == supp // 2)[:, None, None]
            * np.eye(n_in, n_chan))


class Info:
    """Per-layer forward results the reference hangs on the layer object."""

    def __init__(self, x, c_err=0.0, c_mod=0.0, delta_cor=None):
        self.x = x
        self.c_err = c_err
        self.c_mod = c_mod
        self.delta_cor = delta_cor


def pool2(x):
    """2x2 stride-2 max pool (reference layer_types.py:109-110); the
    experiments only pool even spatial dims."""
    b, h, w, c = x.shape
    assert h % 2 == 0 and w % 2 == 0, (h, w)
    return x.reshape(b, h // 2, 2, w // 2, 2, c).max((2, 4))


def lln_kernel(sigma):
    """Gaussian Rec.709 luma kernel (layer_types.py:131-137)."""
    s = int(np.ceil(2 * sigma))
    u = np.linspace(-s, s, 2 * s + 1)[:, None, None, None]
    v = np.linspace(-s, s, 2 * s + 1)[:, None, None]
    return (np.exp(-(u ** 2 + v ** 2) / (2 * sigma ** 2))
            / (2 * np.pi * sigma ** 2)
            * [[0.2126], [0.7152], [0.0722]])


def layer_forward(layer, params, state, x, y, train, overrides=None):
    """Forward one layer per the reference's link-time math; params/state
    are the repo pytrees for this layer (plain nested dict/list of numpy
    arrays). Returns Info. `layer` supplies only structure + hypers.

    overrides: {id(layer): output} for layers whose operator the repo
    deviates from BY DESIGN (ToPyramid's resize grid, PARITY.md) -- the
    override substitutes that one layer's output so everything downstream
    is still pinned independently."""
    kind = type(layer).__name__
    h = layer.hypers
    if overrides and id(layer) in overrides:
        return Info(overrides[id(layer)])

    if kind == "NoOp":
        return Info(x)
    if kind == "LinTrans":
        # layer_types.py:44-53
        w, b = np.asarray(params["w"], np.float64), np.asarray(params["b"])
        n_in = w.shape[0]
        x2 = x.reshape(x.shape[0], -1)
        w_eq = lin_trans_w_eq(n_in, w.shape[1], h.res)
        return Info(x2 @ w + b,
                    c_mod=h.k_l2 * np.sum(np.square(w - w_eq)))
    if kind == "Conv":
        # layer_types.py:55-74
        w, b = np.asarray(params["w"], np.float64), np.asarray(params["b"])
        w_eq = conv_w_eq(w.shape[0], w.shape[2], w.shape[3], h.res)
        return Info(conv_same(x, w) + b,
                    c_mod=h.k_l2 * np.sum(np.square(w - w_eq)))
    if kind == "Rect":
        return Info(np.maximum(x, 0.0))
    if kind == "Softmax":
        return Info(softmax(x))
    if kind == "GlobalMaxPool":
        return Info(np.max(x, axis=tuple(range(1, x.ndim - 1))))
    if kind == "BatchNorm":
        # layer_types.py:219-239: train normalizes with batch moments
        # (population variance), eval with the EMA running stats.
        g = np.asarray(params["γ"], np.float64)
        b = np.asarray(params["β"], np.float64)
        if train:
            axes = tuple(range(x.ndim - 1))
            m = np.mean(x, axes)
            v = np.mean(np.square(x), axes) - np.square(m)
        else:
            m = np.asarray(state["m_avg"], np.float64)
            v = np.asarray(state["v_avg"], np.float64)
        return Info(g * (x - m) / np.sqrt(v + h.ϵ) + b)
    if kind == "Dropout":
        # Only the keep=1 identity case is deterministic (layer_types.py:
        # 212-217); the oracle covers exactly that.
        assert h.λ >= 1, "oracle only covers keep-prob 1 dropout"
        return Info(x)
    if kind == "SquaredError":
        # layer_types.py:255-260
        return Info(x, c_err=np.sum(np.square(x - y), axis=1),
                    delta_cor=(np.argmax(x, 1) == np.argmax(y, 1))
                    .astype(np.float64))
    if kind == "CrossEntropyError":
        # layer_types.py:262-272: eps-floored probs.
        n_cls = y.shape[1]
        p_cls = h.ϵ / n_cls + (1 - h.ϵ) * x
        return Info(x, c_err=-np.sum(y * np.log(p_cls), axis=1),
                    delta_cor=(np.argmax(x, 1) == np.argmax(y, 1))
                    .astype(np.float64))
    if kind == "SuperclassCrossEntropyError":
        # layer_types.py:274-285
        y_sup = y @ np.asarray(h.w_cls, np.float64)
        n_cls = y_sup.shape[1]
        p_cls = h.ϵ / n_cls + (1 - h.ϵ) * x
        return Info(x, c_err=-np.sum(y_sup * np.log(p_cls), axis=1),
                    delta_cor=(np.argmax(x, 1) == np.argmax(y_sup, 1))
                    .astype(np.float64))
    if kind == "ActivityError":
        # layer_types.py:287-293
        dims = tuple(range(1, x.ndim))
        return Info(x, c_mod=h.α * np.sum(np.square(x), axis=dims))
    if kind == "MaxPool":
        # Documented-intent semantics (window supp, stride stride);
        # the reference transposes the args -- see PARITY.md. Oracle
        # covers the repo-documented intent at supp == stride == 2 only.
        assert h.supp == 2 and h.stride == 2, "oracle covers 2x2/2 only"
        return Info(pool2(x))
    if kind == "Select":
        # layer_types.py:201-206
        return Info(x[h.i])
    if kind == "MultiscaleRect":
        return Info([np.maximum(x_i, 0.0) for x_i in x])
    if kind == "MultiscaleBatchNorm":
        # layer_types.py:241-249: one BatchNorm per scale as comps.
        outs = []
        for comp, p, s, x_i in zip(layer.comps, params["comps"],
                                   state["comps"], x):
            outs.append(layer_forward(comp, p, s, x_i, y, train).x)
        return Info(outs)
    if kind == "MultiscaleLLN":
        # layer_types.py:127-147: divide by Gaussian luma corrected by
        # the border density (conv of a ones image with the same kernel).
        k = lln_kernel(h.σ)
        outs = []
        for x_i in x:
            lum = conv_same(x_i, k)
            dens = conv_same(np.ones_like(x_i[:1]), k)
            outs.append(x_i / (lum / dens + h.ϵ))
        return Info(outs)
    if kind == "MultiscaleConvMax":
        # layer_types.py:149-194: per-scale horizontal convs of the kept
        # input scales + vertical convs of the pooled previous output
        # scale, coarse-to-fine accumulation; L2 over w_horz + w_vert.
        L = len(h.n_chan)
        kept = x[len(x) - L:]
        out = [None] * L
        w0 = np.asarray(params["w_horz_0"], np.float64)
        out[0] = conv_same(kept[0], w0) + np.asarray(params["b_0"])
        for j in range(1, L):
            wh = np.asarray(params[f"w_horz_{j}"], np.float64)
            wv = np.asarray(params[f"w_vert_{j-1}"], np.float64)
            out[j] = (conv_same(kept[j], wh)
                      + conv_same(pool2(out[j - 1]), wv)
                      + np.asarray(params[f"b_{j}"]))
        c_mod = h.k_l2 * (
            sum(np.sum(np.square(np.asarray(params[f"w_horz_{j}"])))
                for j in range(L))
            + sum(np.sum(np.square(np.asarray(params[f"w_vert_{j}"])))
                  for j in range(L - 1)))
        return Info(out, c_mod=c_mod)
    if kind == "Chain":
        # layer_types.py:299-310: sum costs, forward last delta_cor.
        c_err, c_mod, delta_cor = 0.0, 0.0, None
        for comp, p, s in zip(layer.comps, params["comps"], state["comps"]):
            info = layer_forward(comp, p, s, x, y, train, overrides)
            x = info.x
            c_err = c_err + info.c_err
            c_mod = c_mod + info.c_mod
            delta_cor = info.delta_cor
        return Info(x, c_err=c_err, c_mod=c_mod, delta_cor=delta_cor)
    raise NotImplementedError(f"oracle has no {kind}")


def mcm_n_ops(layer):
    """Independent op-count for MultiscaleConvMax
    (layer_types.py:186-194): sum over output scales of
    n_pix(out_i) * (n_el(w_horz_i) + n_el(w_vert_{i-1}) if i > 0)."""
    h = layer.hypers
    L = len(h.n_chan)
    total = 0
    for j in range(L):
        hh, ww, _ = layer.out_shape[j]
        n = int(np.prod(layer._w_horz_shapes[j]))
        if j > 0:
            n += int(np.prod(layer._w_vert_shapes[j - 1]))
        total += hh * ww * n
    return float(total)


# ----------------------------------------------------------------- tree walk

def n_leaves(layer):
    return 1 if not layer.sinks else sum(n_leaves(s) for s in layer.sinks)


def net_forward(net, params, state, x0, y, train, k_cpt=None,
                alpha_cpt=None, dyn_k_cpt=False, overrides=None):
    """link_layer recursion (net_types.py:56-63 / :146-163): forward each
    node, then its router on the node's output (with the alpha_cpt*k_cpt
    column appended when dyn_k_cpt, net_types.py:149-160), then its sinks
    on the node's output. Returns {node: Info} with .router_x/.router_c_mod
    set on routed nodes. `overrides` substitutes outputs of
    documented-deviant layers (see layer_forward)."""
    infos = {}

    def cat_k_cpt(x_i):
        flat = x_i.reshape(x_i.shape[0], -1)
        col = (alpha_cpt * np.asarray(k_cpt, np.float64)
               * np.ones(x_i.shape[0])).reshape(-1, 1)
        return np.concatenate([flat, col], axis=1)

    def visit(node, p, s, x):
        info = layer_forward(node, p["layer"], s["layer"], x, y, train,
                             overrides)
        infos[node] = info
        if node.router is not None:
            x_rte = info.x
            if dyn_k_cpt:
                # net_types.py:149-160: per-scale concat for pyramids.
                x_rte = ([cat_k_cpt(x_i) for x_i in x_rte]
                         if isinstance(x_rte, list) else cat_k_cpt(x_rte))
            r = layer_forward(node.router, p["router"], s["router"],
                              x_rte, y, train, overrides)
            info.router_x = r.x
            info.router_c_mod = r.c_mod
        for i, snk in enumerate(node.sinks):
            visit(snk, p["sinks"][i], s["sinks"][i], info.x)

    visit(net.root, params, state, x0)
    return infos


def route(root, infos, eps, tau, mixture=True):
    """Probability propagation (net_types.py:108-131): root starts at
    p_tr = p_ev = 1; at switches
      pi_tr = (1 - eps_l/p_tr) * softmax(router_x/tau) + eps_sinks/p_tr
      pi_ev = one-hot argmax(router_x)
    with eps_l = eps * n_leaves(l)/n_leaves(root). Probabilities multiply
    down the tree. Fills info.p_tr/.p_ev/.pi_tr/.pi_ev.

    mixture=False is the globopt actor's routing (a reconstruction — the
    reference plots `hybrid-ac-globopt` but never defines it): pi_tr is
    the bare softmax policy, no eps mixture."""
    n_root = n_leaves(root)

    def p_tr_eps(l):
        return eps * n_leaves(l) / n_root

    def visit(node, p_tr, p_ev):
        info = infos[node]
        info.p_tr, info.p_ev = p_tr, p_ev
        if len(node.sinks) < 2:
            for s in node.sinks:
                visit(s, p_tr, p_ev)
            return
        rx = infos[node].router_x
        if mixture:
            pi_tr = ((1 - p_tr_eps(node) / p_tr[:, None])
                     * softmax(rx / tau)
                     + np.array([p_tr_eps(s) for s in node.sinks])
                     / p_tr[:, None])
        else:
            pi_tr = softmax(rx / tau)
        pi_ev = (np.argmax(rx, 1)[:, None]
                 == np.arange(len(node.sinks))).astype(np.float64)
        info.pi_tr, info.pi_ev = pi_tr, pi_ev
        for i, s in enumerate(node.sinks):
            visit(s, p_tr * pi_tr[:, i], p_ev * pi_ev[:, i])

    batch = _batch_of(infos[root])
    visit(root, np.ones(batch), np.ones(batch))


def _batch_of(info):
    x = info.x
    while isinstance(x, list):
        x = x[0]
    return x.shape[0]


def _layers(root):
    yield root
    for s in root.sinks:
        yield from _layers(s)


def router_n_ops(node):
    return node.router.n_ops if node.router is not None else 0.0


# ------------------------------------------------------------------- losses

def sr_loss(net, infos):
    """SRNet (net_types.py:85-97): p_ev = 1 everywhere;
    mean over batch of sum(c_err + c_mod)."""
    batch = _batch_of(infos[net.root])
    tot = np.zeros(batch)
    for l in _layers(net.root):
        tot = tot + infos[l].c_err + infos[l].c_mod
    return np.mean(tot)


def actor_loss(net, infos, k_cpt, k_dec, globopt=False, k_pol=0.01):
    """ActorNet loss terms (net_types.py:167-177). Returns (total, parts).
    stop_gradient placement does not change VALUES, so the oracle sums the
    same expressions without it.

    globopt=True replaces the decisiveness term with the policy entropy
    regularizer k_pol * sum(pi ln pi) (route() must have been called with
    mixture=False so pi_tr is the bare softmax; +1e-12 matches the JAX
    path's underflow guard)."""
    batch = _batch_of(infos[net.root])
    k_cpt = np.asarray(k_cpt, np.float64)
    c_err = np.zeros(batch)
    c_cpt = np.zeros(batch)
    c_mod = np.zeros(batch)
    c_dec = np.zeros(batch)
    for l in _layers(net.root):
        i = infos[l]
        c_err = c_err + i.p_tr * i.c_err
        c_cpt = c_cpt + i.p_tr * k_cpt * (l.n_ops + router_n_ops(l))
        c_mod = c_mod + i.p_tr * (i.c_mod + getattr(i, "router_c_mod", 0.0))
        if len(l.sinks) > 1:
            if globopt:
                c_dec = c_dec + i.p_tr * k_pol * np.sum(
                    i.pi_tr * np.log(i.pi_tr + 1e-12), axis=1)
            else:
                c_dec = c_dec + i.p_tr * k_dec * np.sum(
                    np.square(i.router_x), axis=1)
    total = np.mean(c_err + c_cpt + c_mod + c_dec)
    return total, dict(c_err=c_err, c_cpt=c_cpt, c_mod=c_mod, c_dec=c_dec)


def critic_cost_to_go(net, infos, k_cpt, k_cre, use_cls_err, optimistic):
    """c_ev / c_opt / c_cre recursion (net_types.py:198-243). Fills
    info.c_ev/.c_opt/.c_cre. Router ops count only at switches
    (net_types.py:233 vs :245)."""
    k_cpt = np.asarray(k_cpt, np.float64)

    def visit(node):
        for s in node.sinks:
            visit(s)
        info = infos[node]
        if use_cls_err:
            # getattr(l, 'delta_cor', 1) => layers without the indicator
            # contribute 1 - 1 = 0 (net_types.py:204-207).
            c_err = (1.0 - info.delta_cor) if info.delta_cor is not None \
                else 0.0
        else:
            c_err = info.c_err
        if len(node.sinks) < 2:
            info.c_ev = (c_err + k_cpt * node.n_ops
                         + sum(infos[s].c_ev for s in node.sinks))
            info.c_opt = (c_err + k_cpt * node.n_ops
                          + sum(infos[s].c_opt for s in node.sinks))
            info.c_cre = 0.0
        else:
            ops = node.n_ops + node.router.n_ops
            info.c_ev = (c_err + k_cpt * ops
                         + sum(info.pi_ev[:, i] * infos[s].c_ev
                               for i, s in enumerate(node.sinks)))
            c_opts = [infos[s].c_opt for s in node.sinks]
            m = c_opts[0]
            for c in c_opts[1:]:
                m = np.minimum(m, c)
            info.c_opt = c_err + k_cpt * ops + m
            info.c_cre = k_cre * sum(
                np.square(info.router_x[:, i]
                          + (infos[s].c_opt if optimistic else infos[s].c_ev))
                for i, s in enumerate(node.sinks))

    visit(net.root)


def critic_loss(net, infos, k_cpt, k_cre, use_cls_err, optimistic):
    """CriticNet total (net_types.py:275-280): mean of sg(p_tr)-weighted
    c_err + c_cre + c_mod. Returns (total, parts)."""
    critic_cost_to_go(net, infos, k_cpt, k_cre, use_cls_err, optimistic)
    batch = _batch_of(infos[net.root])
    c_err = np.zeros(batch)
    c_cre = np.zeros(batch)
    c_mod = np.zeros(batch)
    for l in _layers(net.root):
        i = infos[l]
        c_err = c_err + i.p_tr * i.c_err
        c_cre = c_cre + i.p_tr * i.c_cre
        c_mod = c_mod + i.p_tr * (i.c_mod + getattr(i, "router_c_mod", 0.0))
    return np.mean(c_err + c_cre + c_mod), dict(c_err=c_err, c_cre=c_cre,
                                                c_mod=c_mod)


def actor_loss_sg(net, live, frozen, k_cpt, k_dec, globopt=False,
                  k_pol=0.01):
    """Actor loss with stop_gradient semantics made EXPLICIT for
    finite-difference gradient checks: quantities the reference wraps in
    sg (net_types.py:171-176) are read from `frozen` (the infos at the
    unperturbed parameters), everything else from `live` (the infos at
    the perturbed parameters). d/d(theta) of this function via central
    differences equals the reference's training gradient:
      c_err = p_tr_live * c_err_live      (policy gradient flows via p_tr)
      c_cpt = p_tr_live * k_cpt * ops
      c_mod = sg(p_tr) * c_mod            -> p_tr_frozen * c_mod_live
      c_dec = sg(p_tr) * k_dec * |rx|^2   -> p_tr_frozen * |rx_live|^2.

    globopt=True: the regularizer is instead the live policy's negative
    entropy, sg(p_tr)-weighted (matches ActorNet.loss with globopt):
      c_pol = p_tr_frozen * k_pol * sum(pi_live * ln(pi_live + 1e-12))."""
    batch = _batch_of(live[net.root])
    k_cpt = np.asarray(k_cpt, np.float64)
    tot = np.zeros(batch)
    for l in _layers(net.root):
        lv, fz = live[l], frozen[l]
        tot = tot + lv.p_tr * lv.c_err
        tot = tot + lv.p_tr * k_cpt * (l.n_ops + router_n_ops(l))
        tot = tot + fz.p_tr * (lv.c_mod + getattr(lv, "router_c_mod", 0.0))
        if len(l.sinks) > 1:
            if globopt:
                tot = tot + fz.p_tr * k_pol * np.sum(
                    lv.pi_tr * np.log(lv.pi_tr + 1e-12), axis=1)
            else:
                tot = tot + fz.p_tr * k_dec * np.sum(
                    np.square(lv.router_x), axis=1)
    return np.mean(tot)


def critic_loss_sg(net, live, frozen, k_cpt, k_cre, use_cls_err,
                   optimistic):
    """Critic loss with sg semantics explicit (net_types.py:239-243,
    275-280): the regression TARGETS (sink cost-to-go) and every p_tr
    weight come from `frozen`; router logits and per-layer costs from
    `live`. Fills nothing; returns the scalar."""
    critic_cost_to_go(net, frozen, k_cpt, k_cre, use_cls_err, optimistic)
    batch = _batch_of(live[net.root])
    tot = np.zeros(batch)
    for l in _layers(net.root):
        lv, fz = live[l], frozen[l]
        tot = tot + fz.p_tr * lv.c_err
        if len(l.sinks) > 1:
            c_cre = k_cre * sum(
                np.square(lv.router_x[:, i]
                          + (frozen[s].c_opt if optimistic
                             else frozen[s].c_ev))
                for i, s in enumerate(l.sinks))
            tot = tot + fz.p_tr * c_cre
        tot = tot + fz.p_tr * (lv.c_mod + getattr(lv, "router_c_mod", 0.0))
    return np.mean(tot)


def talr_scales(net, infos, alpha_rtr, talr=True):
    """Per-node gradient scales of minimize_expectation
    (net_types.py:24-37): layer params get 1/sqrt(mean(p_tr^2)), router
    params additionally alpha_rtr. Returns {node: (layer_scale,
    router_scale)}."""
    out = {}
    for l in _layers(net.root):
        s = (1.0 / np.sqrt(np.mean(np.square(infos[l].p_tr)))
             if talr else 1.0)
        out[l] = (s, alpha_rtr * s)
    return out
