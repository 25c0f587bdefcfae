"""Descriptors (statistics snapshots) and their text rendering
(counterpart of `mpnn_tpu/utils/desc.py`, serial nets).

The nested dict schema the reference's figure scripts read:

    {'type': <net class name>, 'stats_tr': {...}, 'stats_ts': {...},
     'root': {'name': ..., 'stats_tr': {...}, 'stats_ts': {...},
              'sinks': [<same shape>...]}}

with scalar stats as Python floats and per-class stats as lists. Sink
order is meaningful (the figure scripts walk sinks[0] / sinks[1]).

The rendering reproduces the reference's box-drawing log format byte for
byte: the appended `-log.txt` files are part of the output contract.
`sweep_net_descs` gives every member's descriptor of a vmapped k_cpt
sweep from one pass per split."""

import numpy as np
import torch

from ..models.steps import make_eval_split_fn, make_sweep_eval_split_fn

__all__ = ["net_desc", "render_net_desc", "mean_split_stats",
           "sweep_net_descs"]


def mean_split_stats(net, eval_split, params, state, dataset, split,
                     batch_size=128, tau=None, k_cpt=None, eval_key=None):
    """Dataset-mean stats of one split: {stat key: float | list}, keys in
    sorted order (`_host_means`)."""
    x0s, ys, masks, count = dataset.padded_split(split, batch_size)
    if tau is None:
        tau = float(getattr(net.hypers, "τ", 1.0))
    if k_cpt is None:
        k_cpt = getattr(net.hypers, "k_cpt", 0.0)
    sums = eval_split(params, state, x0s, ys, masks, tau, k_cpt, eval_key)
    return {k: v.tolist() for k, v in _host_means(sums, count).items()}


def _host_means(sums, count):
    """{stat key: numpy array of sum / count}, keys in sorted order (as
    JAX's pytree of sums has them, so the descriptors' dicts come out in
    the same order); the sums come to the host in one copy."""
    keys = sorted(sums)
    flat = torch.cat([sums[k].reshape(-1).float() for k in keys]).cpu()
    flat = flat.numpy()
    out, i = {}, 0
    for k in keys:
        shape = tuple(sums[k].shape)
        n = int(np.prod(shape))
        out[k] = flat[i:i + n].reshape(shape) / count
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
    return _desc(net, stats_tr, stats_ts)


def _desc(net, stats_tr, stats_ts):
    """The descriptor of one net from its two splits' mean stats."""
    def net_keys(d):
        return {k[len("net/"):]: v for k, v in d.items()
                if k.startswith("net/")}

    return {
        "type": type(net).__name__,
        "stats_tr": net_keys(stats_tr),
        "stats_ts": net_keys(stats_ts),
        "root": _layer_desc(net.root, stats_tr, stats_ts),
    }


def sweep_net_descs(net, dataset, params_s, state_s, k_cpts, *,
                    batch_size=128, tau=None, eval_split=None,
                    eval_key=None):
    """Every member's descriptor of a k_cpt sweep, from one vmapped pass
    per split (`models.steps.make_sweep_eval_split_fn`) over the stacked
    trees; each dict is schema-identical to `net_desc`'s."""
    if eval_split is None:
        eval_split = make_sweep_eval_split_fn(net, batch_size)
    if tau is None:
        tau = float(getattr(net.hypers, "τ", 1.0))
    k_arr = torch.as_tensor(np.asarray(k_cpts, np.float32),
                            device=dataset.device)
    means = {}
    for split in ("tr", "ts"):
        x0s, ys, masks, count = dataset.padded_split(split, batch_size)
        means[split] = _host_means(eval_split(params_s, state_s, x0s, ys,
                                              masks, tau, k_arr, eval_key),
                                   count)
    return [_desc(net, *({k: v[i].tolist() for k, v in means[split].items()}
                         for split in ("tr", "ts")))
            for i in range(len(k_arr))]


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
