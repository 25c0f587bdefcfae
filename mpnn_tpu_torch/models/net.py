"""Net base class: a static routing tree over layers (counterpart of
`mpnn_tpu/models/net.py`). `forward` runs the whole tree densely and returns
a per-node record table, from which each net type assembles its loss.

Parameters and state are nested dicts of tensors that mirror the tree, one
dict per tree node:

    node_params = {"layer": <layer params>, "router": <router params or {}>,
                   "sinks": [child node_params...]}

and identically for state.

`build` also makes the congruent-subtree stack plan (`_stack_plan`, the
groups `mpnn_tpu` selects, in its order). Under `ops.config.stacked_tails`
`forward` runs each group as one `torch.func.vmap` of its template's walk
over the members' stacked params, state and inputs (dr_tree's eight
5-stage tails: one launch of `fused_mcm`'s net axis per tail stage and
scale), and slices the results back into per-node records. The train
loops carry the members pre-stacked in `pack_tree`'s layout; every tree
a caller sees outside them is in the node layout.

Dropout draws from the context's stream (`Ctx.rng`): `forward` draws the
keep masks of the call first (`dropout_masks`), outside any vmap, each
layer's from the stream folded with its uid, and each member of a
stacked group its own, as `mpnn_tpu` folds the member root's uid into
its key."""

import itertools
import unicodedata
from types import SimpleNamespace as Ns

import numpy as np
import torch

from ..ops import config
from ..ops.layers import Dropout, NoOp, fold_stream, nfkc_hypers
from ..utils.tree import stack_trees, tree_leaves, tree_map


class Ctx(Ns):
    """Per-call context: `train` (BatchNorm uses batch moments and updates
    its running statistics), the Dropout stream `rng` (an integer seed, or
    None: Dropout is then the identity), routing temperature `tau`,
    exploration `eps` and the cost-of-compute price `k_cpt` (a float, or a
    (B,) tensor). `masks` holds the Dropout keep masks of the call
    (`Net.dropout_masks`), drawn by `Net.forward` from `rng` unless the
    caller drew them. `data` is the 'data' axis of a mesh
    (`parallel.mesh.Axis`) whose ranks share the batch, or None: under
    one, train-mode BatchNorm's moments and the loss's batch mean are
    over the global batch. `model` is the mesh's 'model' axis, over which
    the layers gather the output channels of sharded weights
    (`ops.layers`), or None."""

    def __init__(self, train=False, rng=None, tau=1.0, eps=1e-6,
                 k_cpt=0.0, masks=None, data=None, model=None):
        super().__init__(train=train, rng=rng, tau=tau, eps=eps,
                         k_cpt=k_cpt, masks=masks, data=data, model=model)


class Rec(Ns):
    """Per-node forward record: the node's output `x`, its loss terms, its
    router's logits (fp32) and penalty, the routing probabilities that
    `routing.propagate` fills in, and the critic's costs-to-go."""

    def __init__(self):
        super().__init__(
            x=None, c_err=0.0, c_mod=0.0, delta_cor=None,
            router_x=None, router_c_mod=0.0,
            p_tr=None, p_ev=None, pi_tr=None, pi_ev=None,
            c_ev=None, c_opt=None, c_cre=0.0)


def n_leaves(layer):
    """Number of leaves under a tree node."""
    if len(layer.sinks) == 0:
        return 1
    return sum(n_leaves(s) for s in layer.sinks)


def _hyper_sig(v):
    """Hashable congruence signature of one hyper value."""
    if isinstance(v, (np.ndarray, torch.Tensor)):
        a = np.asarray(v)
        return ("ndarray", a.shape, str(a.dtype), hash(a.tobytes()))
    return repr(v)


def _subtree_nodes(node):
    """Preorder tree-node list of `node`'s subtree (sinks only)."""
    out = [node]
    for s in node.sinks:
        out.extend(_subtree_nodes(s))
    return out


def _all_sublayers(layer):
    """Every Layer object reachable from `layer` through comps and router
    (not sinks): the unit whose params share one TALR scale."""
    yield layer
    for c in layer.comps:
        yield from _all_sublayers(c)
    if layer.router is not None:
        yield from _all_sublayers(layer.router)


_TENSOR = object()  # marks a tensor's place in `_run_group`'s skeleton


def _unbind_tree(tree, n):
    """n trees: member i's slice of every tensor leaf of `tree` (one
    unbind a leaf, so the backward stacks the members' gradients in one
    operation), the other leaves as they are."""
    cols = [a.unbind(0) if torch.is_tensor(a) else (a,) * n
            for a in tree_leaves(tree)]
    out = []
    for i in range(n):
        it = iter([c[i] for c in cols])
        out.append(tree_map(lambda _: next(it), tree))
    return out


def _active_dropouts(node):
    """The Dropout layers with λ < 1 of one tree node (comps and router)."""
    return [sub for sub in _all_sublayers(node)
            if isinstance(sub, Dropout) and sub.active()]


def _hyper(net, name, default):
    """Hyper lookup by name, NFKC-normalized as Python normalizes the
    identifier of a kwarg (ϵ U+03F5 is stored as ε U+03B5)."""
    return getattr(net.hypers, unicodedata.normalize("NFKC", name), default)


class Net:
    default_hypers = dict(x0_shape=(), y_shape=())

    def __init__(self, root=None, **hypers):
        self.root = root if root is not None else NoOp()
        self.hypers = Ns(**{**dict(type(self).default_hypers),
                            **nfkc_hypers(hypers)})
        self.build()

    def _router_in_shape(self, node):
        """Shape fed to a node's router: the node's output shape
        (dyn_k_cpt nets append the cost feature)."""
        return node.out_shape

    def build(self):
        def build_node(node, x_shape):
            node.build(x_shape)
            if node.router is not None:
                node.router.build(self._router_in_shape(node))
            for s in node.sinks:
                build_node(s, node.out_shape)

        build_node(self.root, tuple(self.hypers.x0_shape))

        # Stable integer uids for every layer object, assigned after build
        # (so build-created comps such as MultiscaleBatchNorm's count), in
        # the order mpnn_tpu assigns them: tree nodes in preorder, each
        # followed by its comps and router. They key stats and TALR.
        counter = itertools.count()
        for node in self.layers:
            for sub in _all_sublayers(node):
                sub._uid = next(counter)
        self._n_leaves_root = n_leaves(self.root)
        self._compute_stack_plan()
        self._has_dropout = any(_active_dropouts(node)
                                for node in self.layers)

    # -------------------------------------------- congruent-subtree batching

    def _layer_sig(self, layer, in_shape, memo):
        """Structural signature: two layers with equal signatures build the
        same params, state and computation (class, hypers, input shape,
        comps, router and sink subtrees)."""
        if id(layer) in memo:
            return memo[id(layer)]
        h = tuple(sorted((k, _hyper_sig(v))
                         for k, v in vars(layer.hypers).items()))
        shape = in_shape
        comp_sigs = []
        for c in layer.comps:
            comp_sigs.append(self._layer_sig(c, shape, memo))
            shape = c.out_shape
        r_sig = (self._layer_sig(layer.router, self._router_in_shape(layer),
                                 memo)
                 if layer.router is not None else None)
        s_sigs = tuple(self._layer_sig(s, layer.out_shape, memo)
                       for s in layer.sinks)
        sig = (type(layer).__name__, h, repr(in_shape), repr(layer.out_shape),
               tuple(comp_sigs), r_sig, s_sigs)
        memo[id(layer)] = sig
        return sig

    def _compute_stack_plan(self):
        """Greedy maximal grouping of congruent non-root subtrees, as
        `mpnn_tpu` groups them: each entry is a group of >= 2 disjoint,
        structurally identical subtrees ({"members": [root node],
        "preorders": [[node of the member's subtree, preorder]]}); the
        groups are taken in order of (width - 1) * subtree size, the
        largest first, each without the members that an earlier group
        covers."""
        memo, classes = {}, {}

        def walk(node, in_shape, is_root):
            if not is_root:
                classes.setdefault(
                    self._layer_sig(node, in_shape, memo), []).append(node)
            for s in node.sinks:
                walk(s, node.out_shape, False)

        walk(self.root, tuple(self.hypers.x0_shape), True)
        del walk  # break the closure's cycle (see forward)
        cands = [(members, len(_subtree_nodes(members[0])))
                 for members in classes.values() if len(members) >= 2]
        cands.sort(key=lambda c: (len(c[0]) - 1) * c[1], reverse=True)
        covered, plan = set(), []
        for members, _ in cands:
            elig = [m for m in members
                    if not any(id(n) in covered for n in _subtree_nodes(m))]
            if len(elig) < 2:
                continue
            plan.append({"members": elig,
                         "preorders": [_subtree_nodes(m) for m in elig]})
            for m in elig:
                covered.update(id(n) for n in _subtree_nodes(m))
        self._stack_plan = plan

    # --------------------------------------------------------- packed layout

    def _member_at(self):
        """id(member node) -> (group index, member index) of the plan."""
        return {id(m): (gi, mi)
                for gi, g in enumerate(self._stack_plan)
                for mi, m in enumerate(g["members"])}

    def packed_member_ids(self):
        """{id(member node)} over the plan's groups: the node slots a walk
        of the packed layout skips (their subtrees live in "groups")."""
        return {id(m) for g in self._stack_plan for m in g["members"]}

    def pack_tree(self, tree, axis=0):
        """A node-structured tree (params, state, velocities or gradients)
        in the PACKED layout

            {"tree": <the node tree, each member's subtree an empty dict>,
             "groups": [<one member-stacked subtree per plan group>]}

        with the member axis at `axis` of the stacked leaves: 0, or 1 when
        the leaves carry a leading sweep axis. The train loops pack once a
        span, so their steps take the stacks as they are."""
        member_at = self._member_at()
        groups = [[None] * len(g["members"]) for g in self._stack_plan]

        def walk(node, t):
            out = {"layer": t["layer"], "router": t["router"], "sinks": []}
            for i, snk in enumerate(node.sinks):
                at = member_at.get(id(snk))
                if at is not None:
                    groups[at[0]][at[1]] = t["sinks"][i]
                    out["sinks"].append({})
                else:
                    out["sinks"].append(walk(snk, t["sinks"][i]))
            return out

        packed = walk(self.root, tree)
        del walk  # break the closure's cycle (see forward)
        return {"tree": packed,
                "groups": [tree_map(lambda *a: torch.stack(a, axis), *g)
                           for g in groups]}

    def unpack_tree(self, packed, axis=0):
        """The node layout of a `pack_tree` tree: each member sliced out of
        its group's stack (contiguous) and put back in its node slot."""
        member_at = self._member_at()

        def walk(node, t):
            out = {"layer": t["layer"], "router": t["router"], "sinks": []}
            for i, snk in enumerate(node.sinks):
                at = member_at.get(id(snk))
                if at is not None:
                    gi, mi = at
                    out["sinks"].append(tree_map(
                        lambda a: a.select(axis, mi).contiguous(),
                        packed["groups"][gi]))
                else:
                    out["sinks"].append(walk(snk, t["sinks"][i]))
            return out

        tree = walk(self.root, packed["tree"])
        del walk  # break the closure's cycle (see forward)
        return tree

    @staticmethod
    def is_packed(tree):
        """True for a tree in `pack_tree`'s layout."""
        return isinstance(tree, dict) and "groups" in tree

    @property
    def layers(self):
        """Preorder tree-node iterator."""
        def all_in_tree(layer):
            yield layer
            for sink in layer.sinks:
                yield from all_in_tree(sink)
        yield from all_in_tree(self.root)

    @property
    def leaves(self):
        return (l for l in self.layers if len(l.sinks) == 0)

    @property
    def switches(self):
        return (l for l in self.layers if len(l.sinks) > 1)

    def init(self, gen, device="cuda"):
        """(params, state) for the whole tree, drawn from the CPU
        torch.Generator `gen` and placed on `device`."""
        def init_node(node, x_shape):
            p = {"layer": node.init(gen, x_shape), "router": {},
                 "sinks": []}
            s = {"layer": node.init_state(x_shape), "router": {},
                 "sinks": []}
            if node.router is not None:
                rshape = self._router_in_shape(node)
                p["router"] = node.router.init(gen, rshape)
                s["router"] = node.router.init_state(rshape)
            for snk in node.sinks:
                ps, ss = init_node(snk, node.out_shape)
                p["sinks"].append(ps)
                s["sinks"].append(ss)
            return p, s

        params, state = init_node(self.root, tuple(self.hypers.x0_shape))
        return (tree_map(lambda t: t.to(device), params),
                tree_map(lambda t: t.to(device), state))

    def _router_input(self, x, ctx):
        """A node's output as its router's input; identity here."""
        return x

    def _apply_one(self, node, p, s, x, y, ctx):
        """Apply one tree node and its router. Returns (field dict, new
        state subtree with empty sinks)."""
        x_out, ns_layer, aux = node.apply(p["layer"], s["layer"], x, y, ctx)
        o = {"x": x_out, "c_err": aux.c_err, "c_mod": aux.c_mod,
             "delta_cor": aux.delta_cor, "router_x": None,
             "router_c_mod": 0.0}
        ns = {"layer": ns_layer, "router": s["router"], "sinks": []}
        if node.router is not None:
            x_rte = self._router_input(x_out, ctx)
            r_x, ns_rtr, r_aux = node.router.apply(
                p["router"], s["router"], x_rte, y, ctx)
            o["router_x"] = r_x.float()
            o["router_c_mod"] = r_aux.c_mod
            ns["router"] = ns_rtr
        return o, ns

    def _walk_subtree(self, root, p, s, x, y, ctx, outs):
        """Apply `root`'s subtree node by node, appending each node's field
        dict to `outs` in preorder; returns the new state subtree. A method
        that recurses through `self`, so no closure holds it."""
        o, ns = self._apply_one(root, p, s, x, y, ctx)
        outs.append(o)
        for i, snk in enumerate(root.sinks):
            ns["sinks"].append(self._walk_subtree(
                snk, p["sinks"][i], s["sinks"][i], o["x"], y, ctx, outs))
        return ns

    def dropout_masks(self, rng, batch, device):
        """The keep masks of every Dropout with λ < 1 for one forward of
        `batch` examples with stream `rng`, drawn here, outside any vmap
        (torch.func refuses random draws inside one): {uid: mask} of the
        layers the forward applies one by one, each from the stream folded
        with its uid; under `stacked_tails`, {(member root uid, template
        uid): mask} of each group member's, from the stream folded with
        the member root's uid and then the template layer's, as
        `mpnn_tpu` folds them, so members draw their own masks."""
        if not self._has_dropout:
            return {}
        gen = torch.Generator(device=device)
        plan = self._stack_plan if config.stacked_tails else []
        masks, grouped = {}, set()
        for g in plan:
            subs = [d for node in g["preorders"][0]
                    for d in _active_dropouts(node)]
            for m, nodes in zip(g["members"], g["preorders"]):
                grouped.update(id(n) for n in nodes)
                member = fold_stream(rng, m._uid)
                for d in subs:
                    masks[(m._uid, d._uid)] = d.draw_keep(
                        fold_stream(member, d._uid), batch, device, gen)
        for node in self.layers:
            if id(node) not in grouped:
                for d in _active_dropouts(node):
                    masks[d._uid] = d.draw_keep(fold_stream(rng, d._uid),
                                                batch, device, gen)
        return masks

    def _run_group(self, template, members, p_st, s_st, x_st, y, ctx):
        """One stack-plan group: `torch.func.vmap` of the template's walk
        over the members' stacked params, state and inputs (and Dropout
        masks, each member's own). Returns (field dicts in the template's
        preorder, new state), every tensor with the members on its leading
        axis; the fields that are not tensors (0.0, None) come back as
        they are."""
        skeleton = []
        masks = {d._uid: torch.stack([ctx.masks[(m._uid, d._uid)]
                                      for m in members])
                 for node in _subtree_nodes(template)
                 for d in _active_dropouts(node)} if ctx.masks else {}

        def run(p, s, x, m):
            outs = []
            c = Ctx(**dict(vars(ctx), masks=m))
            ns = self._walk_subtree(template, p, s, x, y, c, outs)
            skeleton.append(tree_map(
                lambda a: _TENSOR if torch.is_tensor(a) else a, (outs, ns)))
            return tuple(a for a in tree_leaves((outs, ns))
                         if torch.is_tensor(a))

        stacked = iter(torch.func.vmap(run)(p_st, s_st, x_st, masks))
        return tree_map(lambda a: next(stacked) if a is _TENSOR else a,
                        skeleton[0])

    def forward(self, params, state, x0, y, ctx):
        """Run the whole tree densely; returns ({node: Rec}, new_state).

        Under a bf16 compute policy the input is cast to bf16 here and
        activations stay bf16 through the tree; router logits are recorded
        in fp32 (`_apply_one`).

        Under `ops.config.stacked_tails` each group of the stack plan runs
        as one vmapped template (`_run_group`) over the members' params
        and state, stacked here, and inputs; its results are sliced back
        into per-node records (one unbind a field), so routing, the losses
        and the stats see the records of the node-by-node walk. params and
        state may also come in `pack_tree`'s layout (the train loops'):
        then the group runs take the stacks as they are and the new state
        is returned packed."""
        packed = self.is_packed(params)
        if packed and not (self.is_packed(state) and config.stacked_tails):
            raise ValueError("packed params need packed state and "
                             "ops.config.stacked_tails")
        if config.compute_dtype is not None:
            x0 = x0.to(config.compute_dtype)
        if ctx.rng is not None and ctx.masks is None and self._has_dropout:
            ctx = Ctx(**dict(vars(ctx), masks=self.dropout_masks(
                ctx.rng, x0.shape[0], x0.device)))
        plan = self._stack_plan if config.stacked_tails else []
        group_of = self._member_at() if plan else {}
        # Per member: (params, state, input, parent's sinks list, index).
        pend = [[None] * len(g["members"]) for g in plan]
        recs = {}

        def fwd(node, p, s, x):
            o, ns = self._apply_one(node, p, s, x, y, ctx)
            recs[node] = Rec()
            vars(recs[node]).update(o)
            for i, snk in enumerate(node.sinks):
                at = group_of.get(id(snk))
                if at is not None:
                    ns["sinks"].append({})
                    pend[at[0]][at[1]] = (
                        None if packed else p["sinks"][i],
                        None if packed else s["sinks"][i],
                        o["x"], ns["sinks"], i)
                else:
                    ns["sinks"].append(
                        fwd(snk, p["sinks"][i], s["sinks"][i], o["x"]))
            return ns

        new_state = fwd(self.root, params["tree"] if packed else params,
                        state["tree"] if packed else state, x0)
        # fwd's closure holds fwd itself and recs: a reference cycle that
        # would keep every activation (and its autograd graph) alive until
        # the garbage collector runs. Emptying the cell breaks it, as it
        # does for the other recursive closures of the port.
        del fwd
        ns_groups = []
        for gi, g in enumerate(plan):
            members = pend[gi]
            if packed:
                p_st, s_st = params["groups"][gi], state["groups"][gi]
            else:
                p_st, s_st = (stack_trees([m[k] for m in members])
                              for k in (0, 1))
            outs, ns_st = self._run_group(
                g["members"][0], g["members"], p_st, s_st,
                stack_trees([m[2] for m in members]), y, ctx)
            for o, nodes in zip(outs, zip(*g["preorders"])):
                for node, o_m in zip(nodes, _unbind_tree(o, len(members))):
                    recs[node] = Rec()
                    vars(recs[node]).update(o_m)
            if packed:
                ns_groups.append(ns_st)
            else:
                for (_, _, _, sinks, i), ns_m in zip(
                        members, _unbind_tree(ns_st, len(members))):
                    sinks[i] = ns_m
        if packed:
            new_state = {"tree": new_state, "groups": ns_groups}
        return recs, new_state

    def loss(self, recs, batch_size, ctx):
        """The scalar training loss from forward records; fills p_tr / p_ev
        on the records. Subclasses implement it."""
        raise NotImplementedError

    # Whether the train step applies TALR and α_rtr gradient scaling.
    uses_expectation_optimizer = False
