"""Actor networks (counterpart of `mpnn_tpu/models/actor.py`): stochastic
routing policies trained by policy gradient.

Loss terms, per example, summed over the tree's nodes l:
  c_err = p_tr * c_err_l          (the gradient flows through p_tr)
  c_cpt = p_tr * k_cpt * (n_ops_l + router n_ops_l)
  c_mod = sg(p_tr) * (c_mod_l + router c_mod_l)
  c_dec = sg(p_tr) * k_dec * sum(router_x²)   (at switches: decisiveness)
with sg the stop-gradient (`.detach()`). Trained with TALR-scaled momentum.

globopt=True is the "regularized policy" variant: no eps mixture (pi_tr is
the bare softmax), and the decisiveness term is replaced by the policy
entropy regularizer sg(p_tr) * k_pol * sum(pi ln pi); it requires
talr=False, since without the eps floor TALR's 1/sqrt(E[p_tr²]) is
unbounded."""

import torch

from ..parallel.mesh import batch_mean
from .net import Net
from .routed import DynRoutedMixin
from .routing import propagate


class ActorNet(DynRoutedMixin, Net):
    default_hypers = dict(
        Net.default_hypers,
        k_cpt=0.0, k_dec=0.01, ϵ=1e-6, τ=1.0, λ_lrn=1e-3, μ_lrn=0.9,
        dyn_k_cpt=False, α_cpt=1e7, talr=True, α_rtr=1.0,
        globopt=False, k_pol=0.01)

    uses_expectation_optimizer = True

    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        if self.hypers.globopt and self.hypers.talr:
            raise ValueError(
                "globopt requires talr=False: without the eps-mixture floor "
                "TALR's 1/sqrt(E[p_tr^2]) scale is unbounded")

    def loss(self, recs, batch_size, ctx):
        h = self.hypers
        propagate(self, recs, batch_size, ctx.tau, ctx.eps,
                  mixture=not h.globopt)
        dev = recs[self.root].p_tr.device
        # A host float stays a Python scalar (it multiplies as fp32, as
        # JAX's weakly typed scalar does); a per-example price is a tensor.
        k_cpt = (ctx.k_cpt if isinstance(ctx.k_cpt, (int, float))
                 else torch.as_tensor(ctx.k_cpt, dtype=torch.float32,
                                      device=dev))

        c_err = sum(recs[l].p_tr * recs[l].c_err for l in self.layers)
        c_cpt = sum(recs[l].p_tr * k_cpt * (l.n_ops + self.router_n_ops(l))
                    for l in self.layers)
        c_mod = sum(recs[l].p_tr.detach()
                    * (recs[l].c_mod + recs[l].router_c_mod)
                    for l in self.layers)
        if h.globopt:
            # +1e-12 guards pi ln pi where a sharp-tau softmax underflows
            # an entry to 0 in fp32.
            c_reg = sum(
                recs[l].p_tr.detach() * h.k_pol
                * torch.sum(recs[l].pi_tr
                            * torch.log(recs[l].pi_tr + 1e-12), dim=1)
                for l in self.switches)
        else:
            c_reg = sum(
                recs[l].p_tr.detach() * h.k_dec
                * torch.sum(torch.square(recs[l].router_x), dim=1)
                for l in self.switches)
        zeros = torch.zeros((batch_size,), dtype=torch.float32, device=dev)
        return batch_mean(c_err + c_cpt + c_mod + c_reg + zeros, ctx.data)
