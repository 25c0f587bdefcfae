"""Net base class: a static routing tree over layers (counterpart of
`mpnn_tpu/models/net.py`).

Parameters and state are nested dicts of tensors that mirror the tree, one
dict per tree node:

    node_params = {"layer": <layer params>, "router": <router params or {}>,
                   "sinks": [child node_params...]}

and identically for state. The congruent-subtree stack plan of `mpnn_tpu`
is not ported: routed inference walks the tree node by node."""

import unicodedata
from types import SimpleNamespace as Ns


from ..ops.layers import NoOp, nfkc_hypers


class Ctx(Ns):
    """Per-call context: `train` (only False is served), routing
    temperature `tau`, exploration `eps` and the cost-of-compute price
    `k_cpt` (a float or a tensor)."""

    def __init__(self, train=False, tau=1.0, eps=1e-6, k_cpt=0.0):
        super().__init__(train=train, tau=tau, eps=eps, k_cpt=k_cpt)


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


def _hyper(net, name, default):
    """Hyper lookup by name, NFKC-normalized as Python normalizes the
    identifier of a kwarg (ϵ U+03F5 is stored as ε U+03B5)."""
    return getattr(net.hypers, unicodedata.normalize("NFKC", name), default)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


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
        return _tree_to(params, device), _tree_to(state, device)

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
