"""The dyn_k_cpt router feature shared by routed nets (counterpart of
`mpnn_tpu/models/routed.py`): when enabled, each router sees its layer's
activations flattened per scale with an extra column alpha_cpt * k_cpt, so
the per-example compute price is an input the routing policy conditions
on."""

import torch

from ..ops.layers import _prod


class DynRoutedMixin:
    """Mixin for Net subclasses with routers and optional dyn_k_cpt."""

    def route_for_stats(self, recs, batch_size, ctx):
        """Fill p_tr / p_ev on every Rec for the stats pass; a globopt
        actor routes by the bare softmax policy here too."""
        from .routing import propagate
        return propagate(self, recs, batch_size, ctx.tau, ctx.eps,
                         mixture=not getattr(self.hypers, "globopt", False))

    def router_n_ops(self, node):
        return node.router.n_ops if node.router is not None else 0.0

    def _router_in_shape(self, node):
        if not self.hypers.dyn_k_cpt:
            return node.out_shape
        shp = node.out_shape
        if isinstance(shp, list):
            return [(_prod(s) + 1,) for s in shp]
        return (_prod(shp) + 1,)

    def _router_input(self, x, ctx):
        if not self.hypers.dyn_k_cpt:
            return x

        def cat(xi):
            flat = xi.reshape(xi.shape[0], -1)
            k = torch.as_tensor(ctx.k_cpt, dtype=torch.float32,
                                device=xi.device)
            kcol = ((self.hypers.α_cpt * k).reshape(-1, 1)
                    * torch.ones((xi.shape[0], 1), device=xi.device))
            return torch.cat([flat, kcol.to(flat.dtype)], dim=1)

        return [cat(xi) for xi in x] if isinstance(x, list) else cat(x)
