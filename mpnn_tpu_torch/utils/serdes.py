"""Checkpoint reading (counterpart of `mpnn_tpu/utils/serdes.py`), with
numpy alone.

A checkpoint is a single `.npy` pickled nested dict; each layer record is

    {'type': <class name>, 'name': ..., 'hypers': {...},
     'params': {name: ndarray, ...}, 'sinks': [...], 'comps': [...],
     'router': <record or None>}

and the net record is {'type', 'root', 'hypers', 'params'} plus an
optional 'extra' (optimizer state). BatchNorm running statistics (m_avg /
v_avg) sit under 'params' in the file and are state at run time. Hyper keys
may be raw unicode (e.g. 'ϵ' U+03F5); layers and nets NFKC-normalize them.

Records are pickles: read only checkpoints this project wrote."""

import numpy as np
import torch

from ..ops import layers as layer_lib
from ..models import actor as actor_lib
from .tree import tree_map

__all__ = ["decode_net", "read_net", "from_numpy_tree"]

STATE_KEYS = frozenset({"m_avg", "v_avg"})

_LAYER_TYPES = {name: getattr(layer_lib, name) for name in (
    "NoOp", "LinTrans", "Rect", "Softmax", "ToPyramid", "MultiscaleConvMax",
    "MultiscaleRect", "Select", "BatchNorm", "MultiscaleBatchNorm",
    "CrossEntropyError", "Chain")}
_NET_TYPES = {"ActorNet": actor_lib.ActorNet}


def from_numpy_tree(*trees, device="cuda"):
    """Carry nested dicts/lists of arrays -- e.g. `mpnn_tpu`'s (params,
    state) or (params, state, vel), converted with np.asarray -- into the
    port's tensors on `device`, one tree per argument. Arrays keep their
    dtype, and the tensors are copies: the train step updates them in
    place."""
    return tuple(tree_map(lambda a: torch.tensor(np.asarray(a),
                                                 device=device), t)
                 for t in trees)


def _lookup(table, name, what):
    if name not in table:
        raise ValueError("%s type %r is not ported to mpnn_tpu_torch yet"
                         % (what, name))
    return table[name]


def _decode_layer_obj(rec):
    if rec is None:
        return None
    cls = _lookup(_LAYER_TYPES, rec["type"], "layer")
    return cls(
        name=rec["name"],
        router=_decode_layer_obj(rec["router"]),
        sinks=[_decode_layer_obj(r) for r in rec["sinks"]],
        comps=[_decode_layer_obj(r) for r in rec["comps"]],
        **dict(rec["hypers"]))


def _layer_params_from_record(layer, rec):
    p = {k: v for k, v in rec["params"].items() if k not in STATE_KEYS}
    s = {k: v for k, v in rec["params"].items() if k in STATE_KEYS}
    if layer.comps:
        pc, sc = [], []
        for comp, crec in zip(layer.comps, rec["comps"]):
            cp, cs = _layer_params_from_record(comp, crec)
            pc.append(cp)
            sc.append(cs)
        p["comps"], s["comps"] = pc, sc
    return p, s


def _node_params_from_record(node, rec):
    lp, ls = _layer_params_from_record(node, rec)
    p = {"layer": lp, "router": {}, "sinks": []}
    s = {"layer": ls, "router": {}, "sinks": []}
    if node.router is not None:
        p["router"], s["router"] = _layer_params_from_record(
            node.router, rec["router"])
    for snk, srec in zip(node.sinks, rec["sinks"]):
        sp, ss = _node_params_from_record(snk, srec)
        p["sinks"].append(sp)
        s["sinks"].append(ss)
    return p, s


def decode_net(record, device="cuda"):
    """Rebuild (net, params, state, extra) from a decoded record: classes
    re-instantiated by name, shapes re-inferred by build(), arrays placed
    on `device`. `extra` (training state) is returned as read, or None."""
    from .. import resolve_device
    device = resolve_device(device)
    net_cls = _lookup(_NET_TYPES, record["type"], "net")
    root = _decode_layer_obj(record["root"])
    net = net_cls(root=root, **dict(record["hypers"]))
    params, state = _node_params_from_record(net.root, record["root"])
    params, state = from_numpy_tree(params, state, device=device)
    return net, params, state, record.get("extra")


def read_net(path, device="cuda"):
    return decode_net(np.load(path, allow_pickle=True)[()], device)
