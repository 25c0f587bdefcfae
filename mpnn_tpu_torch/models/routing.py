"""Routing probability propagation (counterpart of
`mpnn_tpu/models/routing.py`), a top-down walk over the static tree:

- training path probability at a switch:
      pi_tr = (1 - eps_l / p_tr) * softmax(router_x / tau) + eps_sinks / p_tr
  with eps_l = eps * n_leaves(l) / n_leaves(root), so rows sum to 1 and
  every sink keeps at least its eps floor;
- eval path: the one-hot argmax of the router logits;
- probabilities multiply down the tree.

All paths run (masked dense execution): the probabilities only weight the
loss terms and the statistics."""

import numpy as np
import torch

from .net import n_leaves


def switch_probs(node, router_x, p_tr, tau, eps, n_leaves_root,
                 mixture=True):
    """(pi_tr, pi_ev) of a switch node, each (B, n_sinks).

    mixture=False drops the eps mixture: pi_tr is the bare softmax policy
    (the `globopt` actor)."""
    soft = torch.softmax(router_x / tau, dim=1)
    if mixture:
        def over_p(e):
            # A tensor numerator made on the device (no host copy, which
            # would stall the host until the device catches up), so the
            # division rounds once, as JAX's does: a Python scalar over a
            # tensor is a reciprocal and a product.
            return p_tr.new_full((), e) / p_tr

        eps_node = eps * n_leaves(node) / n_leaves_root
        # eps * n_leaves(sink) / n_leaves(root), rounded as JAX's fp32
        # vector times eps is.
        eps_sinks = torch.stack(
            [over_p(float(np.float32(n_leaves(s) / n_leaves_root)
                          * np.float32(eps))) for s in node.sinks], dim=1)
        pi_tr = (1.0 - over_p(eps_node))[:, None] * soft + eps_sinks
    else:
        pi_tr = soft
    # One-hot of the argmax by comparison (F.one_hot checks its indices on
    # the host, a device sync).
    pick = torch.argmax(router_x, dim=1)
    pi_ev = (pick[:, None] == torch.arange(
        len(node.sinks), device=pick.device)[None, :]).to(torch.float32)
    return pi_tr, pi_ev


def _device_of(x):
    return (x[0] if isinstance(x, list) else x).device


def propagate(net, recs, batch_size, tau, eps, mixture=True):
    """Fill p_tr / p_ev (and pi_tr / pi_ev at switches) on every node's
    Rec; the root starts at probability 1.

    With mixture=False the eps floor is unused and eps may be anything;
    with the mixture, eps must be positive, since it divides by the running
    p_tr whose floor it sets."""
    if mixture and not eps > 0:
        raise ValueError("routing eps must be > 0 (got %r)" % (eps,))
    ones = torch.ones((batch_size,), dtype=torch.float32,
                      device=_device_of(recs[net.root].x))

    def visit(node, p_tr, p_ev):
        rec = recs[node]
        rec.p_tr, rec.p_ev = p_tr, p_ev
        if len(node.sinks) < 2:
            for s in node.sinks:
                visit(s, p_tr, p_ev)
        else:
            pi_tr, pi_ev = switch_probs(
                node, rec.router_x, p_tr, tau, eps, net._n_leaves_root,
                mixture=mixture)
            rec.pi_tr, rec.pi_ev = pi_tr, pi_ev
            for i, s in enumerate(node.sinks):
                visit(s, p_tr * pi_tr[:, i], p_ev * pi_ev[:, i])

    visit(net.root, ones, ones)
    del visit  # break the closure's cycle (see Net.forward)
    return recs
