"""Momentum SGD with throughput-adaptive learning rates (TALR), the
counterpart of `mpnn_tpu/models/optim.py`, on the node-structured layout
and on `Net.pack_tree`'s packed layout (a stack-plan group's members
stacked, member axis leading).

TALR rescales each parameter's gradient by its tree node's
1 / sqrt(mean(p_tr²)) (1 when talr=False), router parameters by α_rtr
times that, before a TF-style momentum step:

    vel <- μ * vel + grad;  param <- param - lr * vel

On the packed layout a group's stacked leaf is scaled by a (G,) vector of
its members' own factors, broadcast over the parameter's dims; the walks
work inside and outside the sweep's `torch.func.vmap`."""

import torch
from torch._C._functorch import is_functorch_wrapped_tensor

from ..utils.tree import tree_leaves, tree_map


def _walk_packed_group(grp, fn, *trees):
    """Walk one stack-plan group's member-stacked subtree(s) over the
    template's topology, calling fn(template node, members' nodes at that
    place, *node dicts) at each template node; fn returns the node's dict
    without "sinks", which this walk fills by recursing. The one place
    that keeps the cursor into the plan's "preorders"."""
    pres = grp["preorders"]  # [member][preorder j] -> that member's node
    pos = [0]

    def rec(tnode, *ts):
        j = pos[0]
        pos[0] += 1
        out = fn(tnode, [pre[j] for pre in pres], *ts)
        out["sinks"] = [rec(snk, *[t["sinks"][i] for t in ts])
                        for i, snk in enumerate(tnode.sinks)]
        return out

    out = rec(grp["members"][0], *trees)
    del rec  # break the closure's cycle (see Net.forward)
    return out


def _member_scale(s, a):
    """A (G,) vector of per-member factors shaped to multiply a's leading
    member axis."""
    return s.reshape((-1,) + (1,) * (a.dim() - 1))


def talr_scale_grads(net, grads, p_tr_by_uid, alpha_rtr=1.0, talr=True):
    """Rescale a grads tree by per-node TALR factors.

    p_tr_by_uid maps str(node._uid) to the node's (B,) training path
    probability from the forward pass these gradients come from. On the
    packed layout each group's stacks take a (G,) factor per template
    node, each member's own."""

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

    def scale_of(node):
        if not talr:
            return 1.0
        p_tr = p_tr_by_uid[str(node._uid)]
        return 1.0 / torch.sqrt(torch.mean(torch.square(p_tr)))

    packed = net.is_packed(grads)
    member_ids = net.packed_member_ids() if packed else set()

    def visit(node, g):
        s = scale_of(node)
        return {
            "layer": scaled(g["layer"], s),
            "router": scaled(g["router"], alpha_rtr * s),
            "sinks": [{} if id(snk) in member_ids else visit(snk, gs)
                      for snk, gs in zip(node.sinks, g["sinks"])],
        }

    def gvisit(tnode, members, g):
        if not talr:
            return {"layer": scaled(g["layer"], 1.0),
                    "router": scaled(g["router"], alpha_rtr)}
        s = torch.stack([scale_of(m) for m in members])
        return {"layer": tree_map(lambda a: a * _member_scale(s, a),
                                  g["layer"]),
                "router": tree_map(
                    lambda a: a * _member_scale(alpha_rtr * s, a),
                    g["router"])}

    if not packed:
        out = visit(net.root, grads)
    else:
        out = {"tree": visit(net.root, grads["tree"]),
               "groups": [_walk_packed_group(grp, gvisit, gg)
                          for grp, gg in zip(net._stack_plan,
                                             grads["groups"])]}
    del visit  # break the closure's cycle (see Net.forward)
    return out


def tree_l2_decay(net, params, grads, p_tr_by_uid, model=None):
    """Analytic weight L2 (`ops.config.analytic_l2`): add each decayed
    weight's gradient coeff * 2 * k_l2 * (w - w_eq) and return
    (new_grads, loss_value), where coeff is the node's mean p_tr (the
    sg(p_tr) weighting of the c_mod loss term), or 1 for a node without
    p_tr. Equal to differentiating the c_mod terms of the forward. On the
    packed layout a group's stacks take a (G,) coefficient per template
    node, each member's own, and the value sums the members' terms.

    A weight narrower than its whole width is this rank's block over the
    'model' axis `model` (`parallel.shard_params`): it decays against its
    block of w_eq, and its term of the value, a partial sum, is summed
    over the axis (`parallel.mesh.sum_model`)."""
    from ..parallel.mesh import model_block, sum_model
    value = [0.0, 0.0]  # the whole weights' terms, the blocks'

    def layer_mod(layer, p, g, coeff, per_member=False):
        out = dict(g)
        if layer.comps:
            out["comps"] = [layer_mod(c, pc, gc, coeff, per_member)
                            for c, pc, gc in
                            zip(layer.comps, p["comps"], g["comps"])]
            return out
        for name, (k2, weq, width) in layer.l2_specs().items():
            if k2 == 0.0:
                continue
            w = p[name]
            block = w.shape[-1] != width
            if block and weq is not None:
                weq = model_block(weq, model)
            diff = w if weq is None else w - weq.to(w.device)
            if per_member:
                c = _member_scale(coeff, diff)
                out[name] = g[name] + c * (2.0 * k2) * diff
                term = k2 * torch.sum(
                    coeff * torch.sum(torch.square(diff),
                                      dim=tuple(range(1, diff.dim()))))
            else:
                out[name] = g[name] + coeff * (2.0 * k2) * diff
                term = coeff * k2 * torch.sum(torch.square(diff))
            value[block] = value[block] + term
        return out

    def coeff_of(node):
        uid = str(node._uid)
        return (torch.mean(p_tr_by_uid[uid]) if uid in p_tr_by_uid
                else 1.0)

    packed = net.is_packed(grads)
    member_ids = net.packed_member_ids() if packed else set()

    def node_mod(node, p, g):
        coeff = coeff_of(node)
        return {
            "layer": layer_mod(node, p["layer"], g["layer"], coeff),
            "router": (layer_mod(node.router, p["router"], g["router"],
                                 coeff)
                       if node.router is not None else g["router"]),
            "sinks": [{} if id(s) in member_ids else node_mod(s, ps, gs)
                      for s, ps, gs in
                      zip(node.sinks, p["sinks"], g["sinks"])],
        }

    def gmod(tnode, members, p, g):
        # Without p_tr (an SR net) every member's coefficient is 1, and
        # the scalar path sums the members' terms.
        coeffs = [coeff_of(m) for m in members]
        per = torch.is_tensor(coeffs[0])
        coeff = torch.stack(coeffs) if per else 1.0
        return {
            "layer": layer_mod(tnode, p["layer"], g["layer"], coeff, per),
            "router": (layer_mod(tnode.router, p["router"], g["router"],
                                 coeff, per)
                       if tnode.router is not None else g["router"]),
        }

    if not packed:
        new_grads = node_mod(net.root, params, grads)
    else:
        new_grads = {
            "tree": node_mod(net.root, params["tree"], grads["tree"]),
            "groups": [_walk_packed_group(grp, gmod, gp, gg)
                       for grp, gp, gg in zip(net._stack_plan,
                                              params["groups"],
                                              grads["groups"])]}
    del node_mod, layer_mod  # break the closures' cycles (see Net.forward)
    whole, blocks = value
    if torch.is_tensor(blocks):
        whole = whole + sum_model(blocks, model)
    return new_grads, torch.as_tensor(whole, dtype=torch.float32)


def momentum_init(params):
    return tree_map(torch.zeros_like, params)


@torch.no_grad()
def momentum_update(params, vel, grads, lr, mu):
    """TF momentum, in place on params and vel (the counterpart of JAX's
    donated buffers), with multi-tensor launches over all the leaves, in
    either layout (the trees share one); returns (params, vel)."""
    ps, vs = tree_leaves(params), tree_leaves(vel)
    torch._foreach_mul_(vs, mu)
    torch._foreach_add_(vs, tree_leaves(grads))
    torch._foreach_add_(ps, vs, alpha=-lr)
    return params, vel
