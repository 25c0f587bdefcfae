"""Momentum SGD with throughput-adaptive learning rates (TALR), the
counterpart of `mpnn_tpu/models/optim.py` for the node-structured layout
(the packed layout of stacked subtrees is not ported).

TALR rescales each parameter's gradient by its tree node's
1 / sqrt(mean(p_tr²)) (1 when talr=False), router parameters by α_rtr
times that, before a TF-style momentum step:

    vel <- μ * vel + grad;  param <- param - lr * vel"""

import torch
from torch._C._functorch import is_functorch_wrapped_tensor

from ..utils.tree import tree_leaves, tree_map


def talr_scale_grads(net, grads, p_tr_by_uid, alpha_rtr=1.0, talr=True):
    """Rescale a node-structured grads tree by per-node TALR factors.

    p_tr_by_uid maps str(node._uid) to the node's (B,) training path
    probability from the forward pass these gradients come from."""

    def scaled(tree, s):
        # One multi-tensor launch for all of a node's layer (or router)
        # leaves instead of one per leaf; under torch.func.vmap (the
        # sweep), which has no batching rule for it, one product a leaf.
        leaves = tree_leaves(tree)
        if leaves and is_functorch_wrapped_tensor(leaves[0]):
            it = iter([leaf * s for leaf in leaves])
        else:
            it = iter(torch._foreach_mul(leaves, s) if leaves else [])
        return tree_map(lambda _: next(it), tree)

    def visit(node, g):
        if talr:
            p_tr = p_tr_by_uid[str(node._uid)]
            s = 1.0 / torch.sqrt(torch.mean(torch.square(p_tr)))
        else:
            s = 1.0
        return {
            "layer": scaled(g["layer"], s),
            "router": scaled(g["router"], alpha_rtr * s),
            "sinks": [visit(snk, gs) for snk, gs in zip(node.sinks,
                                                        g["sinks"])],
        }

    return visit(net.root, grads)


def tree_l2_decay(net, params, grads, p_tr_by_uid):
    """Analytic weight L2 (`ops.config.analytic_l2`): add each decayed
    weight's gradient coeff * 2 * k_l2 * (w - w_eq) and return
    (new_grads, loss_value), where coeff is the node's mean p_tr (the
    sg(p_tr) weighting of the c_mod loss term), or 1 for a node without
    p_tr. Equal to differentiating the c_mod terms of the forward."""
    value = [0.0]

    def layer_mod(layer, p, g, coeff):
        out = dict(g)
        if layer.comps:
            out["comps"] = [layer_mod(c, pc, gc, coeff) for c, pc, gc in
                            zip(layer.comps, p["comps"], g["comps"])]
            return out
        for name, (k2, weq) in layer.l2_specs().items():
            if k2 == 0.0:
                continue
            w = p[name]
            diff = w if weq is None else w - weq.to(w.device)
            out[name] = g[name] + coeff * (2.0 * k2) * diff
            value[0] = value[0] + coeff * k2 * torch.sum(torch.square(diff))
        return out

    def node_mod(node, p, g):
        uid = str(node._uid)
        coeff = (torch.mean(p_tr_by_uid[uid]) if uid in p_tr_by_uid
                 else 1.0)
        return {
            "layer": layer_mod(node, p["layer"], g["layer"], coeff),
            "router": (layer_mod(node.router, p["router"], g["router"],
                                 coeff)
                       if node.router is not None else g["router"]),
            "sinks": [node_mod(s, ps, gs) for s, ps, gs in
                      zip(node.sinks, p["sinks"], g["sinks"])],
        }

    new_grads = node_mod(net.root, params, grads)
    return new_grads, torch.as_tensor(value[0], dtype=torch.float32)


def momentum_init(params):
    return tree_map(torch.zeros_like, params)


@torch.no_grad()
def momentum_update(params, vel, grads, lr, mu):
    """TF momentum, in place on params and vel (the counterpart of JAX's
    donated buffers), with multi-tensor launches over all the leaves;
    returns (params, vel)."""
    ps, vs = tree_leaves(params), tree_leaves(vel)
    torch._foreach_mul_(vs, mu)
    torch._foreach_add_(vs, tree_leaves(grads))
    torch._foreach_add_(ps, vs, alpha=-lr)
    return params, vel
