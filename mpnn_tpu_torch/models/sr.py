"""Statically routed networks (counterpart of `mpnn_tpu/models/sr.py`).

Every layer runs with p_ev = 1; the loss is the batch mean of the summed
per-layer error and regularization costs, trained with plain momentum SGD
(no TALR)."""

import torch

from ..parallel.mesh import batch_mean
from .net import Net


class SRNet(Net):
    default_hypers = dict(Net.default_hypers, λ_lrn=1e-3, μ_lrn=0.9)

    uses_expectation_optimizer = False

    def route_for_stats(self, recs, batch_size, ctx):
        dev = recs[self.root].x
        dev = (dev[0] if isinstance(dev, list) else dev).device
        ones = torch.ones((batch_size,), dtype=torch.float32, device=dev)
        for l in self.layers:
            recs[l].p_ev = ones
        return recs

    def loss(self, recs, batch_size, ctx):
        self.route_for_stats(recs, batch_size, ctx)
        zeros = torch.zeros((batch_size,), dtype=torch.float32,
                            device=recs[self.root].p_ev.device)
        return batch_mean(sum(recs[l].c_err + recs[l].c_mod
                              for l in self.layers) + zeros, ctx.data)
