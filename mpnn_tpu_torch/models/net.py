"""Net base class: a static routing tree over layers (counterpart of
`mpnn_tpu/models/net.py`). `forward` runs the whole tree densely and returns
a per-node record table, from which each net type assembles its loss.

Parameters and state are nested dicts of tensors that mirror the tree, one
dict per tree node:

    node_params = {"layer": <layer params>, "router": <router params or {}>,
                   "sinks": [child node_params...]}

and identically for state. The congruent-subtree stack plan and the packed
layouts of `mpnn_tpu` are not ported: the net walks the tree node by node."""

import itertools
import unicodedata
from types import SimpleNamespace as Ns


from ..ops import config
from ..ops.layers import NoOp, nfkc_hypers
from ..utils.tree import tree_map


class Ctx(Ns):
    """Per-call context: `train` (BatchNorm uses batch moments and updates
    its running statistics), routing temperature `tau`, exploration `eps`
    and the cost-of-compute price `k_cpt` (a float, or a (B,) tensor)."""

    def __init__(self, train=False, tau=1.0, eps=1e-6, k_cpt=0.0):
        super().__init__(train=train, tau=tau, eps=eps, k_cpt=k_cpt)


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

    def forward(self, params, state, x0, y, ctx):
        """Run the whole tree densely; returns ({node: Rec}, new_state).

        Under a bf16 compute policy the input is cast to bf16 here and
        activations stay bf16 through the tree; router logits are recorded
        in fp32 (`_apply_one`)."""
        if config.compute_dtype is not None:
            x0 = x0.to(config.compute_dtype)
        recs = {}

        def fwd(node, p, s, x):
            o, ns = self._apply_one(node, p, s, x, y, ctx)
            recs[node] = Rec()
            vars(recs[node]).update(o)
            for i, snk in enumerate(node.sinks):
                ns["sinks"].append(
                    fwd(snk, p["sinks"][i], s["sinks"][i], o["x"]))
            return ns

        new_state = fwd(self.root, params, state, x0)
        # fwd's closure holds fwd itself and recs: a reference cycle that
        # would keep every activation (and its autograd graph) alive until
        # the garbage collector runs. Emptying the cell breaks it, as it
        # does for the other recursive closures of the port.
        del fwd
        return recs, new_state

    def loss(self, recs, batch_size, ctx):
        """The scalar training loss from forward records; fills p_tr / p_ev
        on the records. Subclasses implement it."""
        raise NotImplementedError

    # Whether the train step applies TALR and α_rtr gradient scaling.
    uses_expectation_optimizer = False
