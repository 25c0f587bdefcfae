"""Descriptors (statistics snapshots) and their text rendering
(counterpart of `mpnn_tpu/utils/desc.py`, serial nets).

The nested dict schema the reference's figure scripts read:

    {'type': <net class name>, 'stats_tr': {...}, 'stats_ts': {...},
     'root': {'name': ..., 'stats_tr': {...}, 'stats_ts': {...},
              'sinks': [<same shape>...]}}

with scalar stats as Python floats and per-class stats as lists. Sink
order is meaningful (the figure scripts walk sinks[0] / sinks[1]).

The rendering reproduces the reference's box-drawing log format byte for
byte: the appended `-log.txt` files are part of the output contract. The
descriptors of a vmapped sweep (`sweep_net_descs`) are not ported."""

import numpy as np
import torch

from ..models.steps import make_eval_split_fn

__all__ = ["net_desc", "render_net_desc", "mean_split_stats"]


def mean_split_stats(net, eval_split, params, state, dataset, split,
                     batch_size=128, tau=None, k_cpt=None, eval_key=None):
    """Dataset-mean stats of one split: {stat key: float | list}, keys in
    sorted order (as JAX's pytree of sums has them, so the descriptors'
    dicts come out in the same order). The sums come to the host in one
    copy."""
    x0s, ys, masks, count = dataset.padded_split(split, batch_size)
    if tau is None:
        tau = float(getattr(net.hypers, "τ", 1.0))
    if k_cpt is None:
        k_cpt = getattr(net.hypers, "k_cpt", 0.0)
    sums = eval_split(params, state, x0s, ys, masks, tau, k_cpt, eval_key)
    keys = sorted(sums)
    flat = torch.cat([sums[k].reshape(-1).float() for k in keys]).cpu()
    flat = flat.numpy()
    out, i = {}, 0
    for k in keys:
        shape = tuple(sums[k].shape)
        n = int(np.prod(shape))
        out[k] = (flat[i:i + n].reshape(shape) / count).tolist()
        i += n
    return out


def _layer_desc(layer, stats_tr, stats_ts):
    """Per-layer descriptor node."""
    prefix = f"{layer._uid}/"
    return {
        "name": layer.name,
        "stats_tr": {k[len(prefix):]: v for k, v in stats_tr.items()
                     if k.startswith(prefix)},
        "stats_ts": {k[len(prefix):]: v for k, v in stats_ts.items()
                     if k.startswith(prefix)},
        "sinks": [_layer_desc(s, stats_tr, stats_ts) for s in layer.sinks],
    }


def net_desc(net, dataset, params, state, batch_size=128, tau=None,
             k_cpt=None, eval_split=None, eval_key=None):
    """The whole net's descriptor over both splits."""
    if eval_split is None:
        eval_split = make_eval_split_fn(net, batch_size)
    stats_tr = mean_split_stats(net, eval_split, params, state, dataset,
                                "tr", batch_size, tau, k_cpt, eval_key)
    stats_ts = mean_split_stats(net, eval_split, params, state, dataset,
                                "ts", batch_size, tau, k_cpt, eval_key)

    def net_keys(d):
        return {k[len("net/"):]: v for k, v in d.items()
                if k.startswith("net/")}

    return {
        "type": type(net).__name__,
        "stats_tr": net_keys(stats_tr),
        "stats_ts": net_keys(stats_ts),
        "root": _layer_desc(net.root, stats_tr, stats_ts),
    }


################################################################################
# Rendering (the reference's log format)
################################################################################

def render_stats(stats):
    return (
        "(%s)" % "; ".join(
            "%s=%.3g" % i
            for i in sorted(stats.items())
            if np.ndim(i[1]) == 0)
        if len(stats) > 0 else "")


def render_layer_desc(desc, stats_key):
    sink_text = "".join(
        "\n↳ " + render_layer_desc(s, stats_key).replace(
            "\n", "\n| " if i < len(desc["sinks"]) - 1 else "\n  ")
        for i, s in enumerate(desc["sinks"]))
    return "%s %s%s" % (desc["name"], render_stats(desc[stats_key]),
                        sink_text)


def render_net_desc(desc, name="Network"):
    return (
        "┌───────────────────────────────────────────────────────────\n"
        "│ {name}\n"
        "├───────────────────────────────────────────────────────────\n"
        "│ Training Set:\n"
        "│\n"
        "│   [{net_type}] {net_stats_tr}\n"
        "│     {layers_tr}\n"
        "│\n"
        "│ Test Set:\n"
        "│\n"
        "│   [{net_type}] {net_stats_ts}\n"
        "│     {layers_ts}\n"
        "│").format(
            name=name,
            net_type=desc["type"],
            net_stats_tr=render_stats(desc["stats_tr"]),
            net_stats_ts=render_stats(desc["stats_ts"]),
            layers_tr=render_layer_desc(desc["root"], "stats_tr")
                      .replace("\n", "\n│     "),
            layers_ts=render_layer_desc(desc["root"], "stats_ts")
                      .replace("\n", "\n│     "))
