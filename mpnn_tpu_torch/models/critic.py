"""Critic networks (counterpart of `mpnn_tpu/models/critic.py`):
value-estimation routing.

Router logits regress toward the negative downstream cost-to-go, so the
argmax routes each example down its cheapest path. Per node, post-order:

  c_ev  = c_err' + k_cpt * ops + sum_i pi_ev[:, i] * sink_i.c_ev
  c_opt = c_err' + k_cpt * ops + min_i sink_i.c_opt
  c_cre = k_cre * sum_i (router_x[:, i] + sg(target_i))^2  (switches only)

with c_err' the per-example error cost, or the 0/1 misclassification
indicator when use_cls_err; ops counts the router's operations only at
switches; target = c_opt if optimistic else c_ev; sg the stop-gradient
(`.detach()`).

Total loss: c_err, c_cre and c_mod, each weighted by sg(p_tr); no policy
gradient term. `dyn_k_cpt` is the router feature of `routed.py`; the
adaptive trainer (`train.train_adaptive_experiment`) samples k_cpt per
example."""

from functools import reduce

import torch

from ..parallel.mesh import batch_mean
from .net import Net
from .routed import DynRoutedMixin
from .routing import propagate


class CriticNet(DynRoutedMixin, Net):
    default_hypers = dict(
        Net.default_hypers,
        k_cpt=0.0, k_cre=1e-3, ϵ=1e-6, τ=0.01, optimistic=False,
        dyn_k_cpt=False, α_cpt=1e7, use_cls_err=False, λ_lrn=1e-3, μ_lrn=0.9,
        talr=True, α_rtr=1.0)

    uses_expectation_optimizer = True

    def _cost_to_go(self, recs, ctx):
        """Post-order c_ev / c_opt / c_cre on every node's Rec."""
        h = self.hypers
        ref = recs[self.root].p_tr
        # A float price is filled on the device (no host copy); a
        # per-example price is a tensor already.
        k_cpt = (ref.new_full((), ctx.k_cpt)
                 if isinstance(ctx.k_cpt, (int, float))
                 else torch.as_tensor(ctx.k_cpt, dtype=torch.float32,
                                      device=ref.device))

        def visit(node):
            for s in node.sinks:
                visit(s)
            rec = recs[node]
            if h.use_cls_err:
                # A node without a correctness indicator contributes 0.
                c_err = (1.0 - rec.delta_cor if rec.delta_cor is not None
                         else 0.0)
            else:
                c_err = rec.c_err
            if len(node.sinks) < 2:
                rec.c_ev = (c_err + k_cpt * node.n_ops
                            + sum(recs[s].c_ev for s in node.sinks))
                rec.c_opt = (c_err + k_cpt * node.n_ops
                             + sum(recs[s].c_opt for s in node.sinks))
                rec.c_cre = 0.0
            else:
                ops = node.n_ops + node.router.n_ops
                rec.c_ev = (c_err + k_cpt * ops
                            + sum(rec.pi_ev[:, i] * recs[s].c_ev
                                  for i, s in enumerate(node.sinks)))
                rec.c_opt = (c_err + k_cpt * ops
                             + reduce(torch.minimum,
                                      (recs[s].c_opt for s in node.sinks)))
                rec.c_cre = h.k_cre * sum(
                    torch.square(rec.router_x[:, i] + (
                        recs[s].c_opt if h.optimistic
                        else recs[s].c_ev).detach())
                    for i, s in enumerate(node.sinks))

        visit(self.root)
        del visit  # break the closure's cycle (see Net.forward)
        return recs

    def loss(self, recs, batch_size, ctx):
        propagate(self, recs, batch_size, ctx.tau, ctx.eps)
        self._cost_to_go(recs, ctx)
        c_err = sum(recs[l].p_tr.detach() * recs[l].c_err
                    for l in self.layers)
        c_cre = sum(recs[l].p_tr.detach() * recs[l].c_cre
                    for l in self.layers)
        c_mod = sum(recs[l].p_tr.detach()
                    * (recs[l].c_mod + recs[l].router_c_mod)
                    for l in self.layers)
        zeros = torch.zeros((batch_size,), dtype=torch.float32,
                            device=recs[self.root].p_tr.device)
        return batch_mean(c_err + c_cre + c_mod + zeros, ctx.data)
