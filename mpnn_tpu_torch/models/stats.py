"""Per-example statistics on the device (counterpart of
`mpnn_tpu/models/stats.py`).

Keys are strings: net-level stats 'net/<name>', per-node stats
'<uid>/<name>' with uid the layer's build-time id (`Net.build`), the same
keys as `mpnn_tpu`'s for the same tree.

  net/acc       sum over leaves of p_ev * delta_cor
  net/moc       sum over nodes of p_ev * (n_ops + router n_ops)
  leaf p_cor / p_inc (and their _by_cls forms), p_tr, c_err
  switch x_rte  mean |router logits|"""

import torch


def tot_n_ops(layer):
    return layer.n_ops + (layer.router.n_ops if layer.router is not None
                          else 0.0)


def state_stats(net, recs, y):
    """Per-example stats dict from forward records (p_ev / p_tr filled)."""
    stats = {}
    leaves = [l for l in net.leaves if recs[l].delta_cor is not None]
    stats["net/acc"] = sum(recs[l].p_ev * recs[l].delta_cor for l in leaves)
    stats["net/moc"] = sum(recs[l].p_ev * tot_n_ops(l) for l in net.layers)
    for l in leaves:
        rec = recs[l]
        p_cor = rec.p_ev * rec.delta_cor
        p_inc = rec.p_ev * (1.0 - rec.delta_cor)
        stats[f"{l._uid}/p_cor"] = p_cor
        stats[f"{l._uid}/p_inc"] = p_inc
        stats[f"{l._uid}/p_cor_by_cls"] = p_cor[:, None] * y
        stats[f"{l._uid}/p_inc_by_cls"] = p_inc[:, None] * y
        if rec.p_tr is not None:
            stats[f"{l._uid}/p_tr"] = rec.p_tr
        stats[f"{l._uid}/c_err"] = rec.c_err
    for l in net.layers:
        if recs[l].router_x is not None:
            stats[f"{l._uid}/x_rte"] = torch.mean(
                torch.abs(recs[l].router_x), dim=1)
    return stats
