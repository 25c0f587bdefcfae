"""Checkpoint writing and reading (counterpart of
`mpnn_tpu/utils/serdes.py`).

A checkpoint is a single `.npy` pickled nested dict; each layer record is

    {'type': <class name>, 'name': ..., 'hypers': {...},
     'params': {name: ndarray, ...}, 'sinks': [...], 'comps': [...],
     'router': <record or None>}

and the net record is {'type', 'root', 'hypers', 'params'} plus an
optional 'extra' = {'vel': <momentum tree>, 't': <step>} for resume.
BatchNorm running statistics (m_avg / v_avg) sit under 'params' in the
file and are state at run time. Hyper keys may be raw unicode (e.g. 'ϵ'
U+03F5); layers and nets NFKC-normalize them. Every layer type of
`mpnn_tpu`'s zoo reads and writes back; a hyper may be an array
(SuperclassCrossEntropyError's `w_cls`).

Records written by the reference (class, hyper and parameter names are
shared) read as they are, but parameters trained by it evaluate
correctly only under the TF1 pyramid grid (`ops.config.pyramid_tf1`,
`--pyramid-tf1`), and a MaxPool of such a record needs
`ops.config.maxpool_tf1`.

A written record holds float32 numpy arrays, plain Python hypers and
`t` as a 0-d int64 array, as `mpnn_tpu` writes it, so either package
(and numpy alone) reads it. Records are pickles: read only checkpoints
this project wrote."""

import hashlib
import io
import json
import os
import pickle
import zlib

import numpy as np
import torch

from ..ops import layers as layer_lib
from ..models import actor as actor_lib
from ..models import critic as critic_lib
from ..models import sr as sr_lib
from .tree import tree_map

__all__ = ["encode_net", "decode_net", "write_net", "read_net",
           "read_compact", "write_compact", "compact_src_sha", "atomic_save",
           "from_numpy_tree"]

# Parameter names that are run-time state (BatchNorm running statistics).
STATE_KEYS = frozenset({"m_avg", "v_avg"})

_LAYER_TYPES = {name: getattr(layer_lib, name) for name in (
    "NoOp", "LinTrans", "Conv", "Rect", "Softmax", "MaxPool", "GlobalMaxPool",
    "ToPyramid", "MultiscaleLLN", "MultiscaleConvMax", "MultiscaleRect",
    "Select", "Dropout", "BatchNorm", "MultiscaleBatchNorm", "SquaredError",
    "CrossEntropyError", "SuperclassCrossEntropyError", "ActivityError",
    "Chain")}
_NET_TYPES = {"ActorNet": actor_lib.ActorNet,
              "CriticNet": critic_lib.CriticNet, "SRNet": sr_lib.SRNet}


def atomic_save(path, obj):
    """np.save through a temporary file and os.replace, so a process
    killed mid-write never leaves a torn checkpoint or stats file."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.save(f, obj)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _to_np(t):
    """A tensor as a numpy array that shares no memory with it."""
    return np.array(t.detach().cpu().numpy())


def _np_tree(tree):
    """A tree of tensors as numpy arrays, dict keys sorted at every level
    (the order JAX's pytrees, and so `mpnn_tpu`'s records, have)."""
    if isinstance(tree, dict):
        return {k: _np_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return _to_np(tree)


def _encode_layer(layer, params, state):
    if layer is None:
        return None
    merged = {k: _to_np(params[k]) for k in sorted(params) if k != "comps"}
    merged.update({k: _to_np(state[k]) for k in sorted(state)
                   if k != "comps"})
    comp_params = params.get("comps", [{}] * len(layer.comps))
    comp_state = state.get("comps", [{}] * len(layer.comps))
    return dict(
        type=type(layer).__name__,
        name=layer.name,
        hypers=dict(vars(layer.hypers)),
        params=merged,
        sinks=[],
        comps=[_encode_layer(c, cp, cs)
               for c, cp, cs in zip(layer.comps, comp_params, comp_state)],
        router=None,
    )


def _encode_node(node, node_params, node_state):
    rec = _encode_layer(node, node_params["layer"], node_state["layer"])
    if node.router is not None:
        rec["router"] = _encode_layer(node.router, node_params["router"],
                                      node_state["router"])
    rec["sinks"] = [
        _encode_node(s, node_params["sinks"][i], node_state["sinks"][i])
        for i, s in enumerate(node.sinks)]
    return rec


def encode_net(net, params, state, extra=None):
    """The checkpoint record of (net, params, state); `extra`, when given,
    is {"vel": <params-shaped tree>, "t": <int step>}."""
    rec = dict(
        type=type(net).__name__,
        root=_encode_node(net.root, params, state),
        hypers=dict(vars(net.hypers)),
        params={},  # net-level params: always empty (reference schema)
    )
    if extra is not None:
        rec["extra"] = {k: (_np_tree(extra[k]) if k == "vel"
                            else np.asarray(extra[k]))
                        for k in sorted(extra)}
    return rec


def write_net(path, net, params, state, extra=None):
    atomic_save(path, encode_net(net, params, state, extra))


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
        raise ValueError("unknown %s type %r" % (what, name))
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
    on `device`. `extra` (training state), when present, comes back with
    `vel` as tensors on `device` and `t` as an int; else None."""
    from .. import resolve_device
    device = resolve_device(device)
    net_cls = _lookup(_NET_TYPES, record["type"], "net")
    root = _decode_layer_obj(record["root"])
    net = net_cls(root=root, **dict(record["hypers"]))
    params, state = _node_params_from_record(net.root, record["root"])
    params, state = from_numpy_tree(params, state, device=device)
    extra = record.get("extra")
    if extra is not None:
        extra = dict(extra)
        if "vel" in extra:
            # In the params' key order, which the optimizer's leaf lists
            # rely on.
            extra["vel"], = from_numpy_tree(
                tree_map(lambda _, v: v, params, extra["vel"]),
                device=device)
        if "t" in extra:
            extra["t"] = int(extra["t"])
    return net, params, state, extra


def read_net(path, device="cuda"):
    """(net, params, state, extra) of a `.npy` checkpoint, or of a compact
    archive directory (`read_compact`)."""
    if os.path.isdir(path):
        return decode_net(read_compact(path), device)
    return decode_net(np.load(path, allow_pickle=True)[()], device)


class _CompactUnpickler(pickle.Unpickler):
    """Unpickles a compact archive's record without ml_dtypes: its
    bfloat16 arrays come back as uint16 arrays of the same bits."""

    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return np.uint16
        if module.startswith("numpy._core"):
            try:
                return super().find_class(module, name)
            except ModuleNotFoundError:  # numpy 1.x names it numpy.core
                module = "numpy.core" + module[len("numpy._core"):]
        return super().find_class(module, name)


def _bf16_bits_to_f32(obj):
    """Every uint16 array of a record (the bfloat16 bits of a compact
    archive; records hold no other uint16 arrays) as float32, exactly."""
    if isinstance(obj, dict):
        return {k: _bf16_bits_to_f32(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_bf16_bits_to_f32(v) for v in obj]
        return out if isinstance(obj, list) else tuple(out)
    if isinstance(obj, np.ndarray) and obj.dtype == np.uint16:
        return (obj.astype(np.uint32) << 16).view(np.float32)
    return obj


_COMPACT_MANIFEST = "MANIFEST.json"


class _BF16:
    """Stands for `ml_dtypes.bfloat16` in a compact archive's pickle, which
    names it as a global (`_CompactPickler`) without importing it."""


class _BF16Dtype:
    """Stands for `numpy.dtype(ml_dtypes.bfloat16)`: one instance, so the
    pickle memoizes it as it memoizes numpy's dtype singleton."""


_BF16_DTYPE = _BF16Dtype()
# numpy's reduction of an array and of the bfloat16 dtype (ndarray and
# dtype __reduce__, with ml_dtypes' dtype state).
_RECONSTRUCT = np.zeros(0).__reduce__()[0]
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


class _BF16Bits:
    """The bfloat16 bits of a float array (uint16) and whether the array
    was Fortran-ordered, pickled as numpy pickles the bfloat16 array
    (`_CompactPickler`): a bfloat16 array to a reader with ml_dtypes
    (`mpnn_tpu`'s `read_compact`), the uint16 bits to
    `_CompactUnpickler`."""

    def __init__(self, bits, fortran):
        self.bits, self.fortran = bits, fortran


class _CompactPickler(pickle._Pickler):
    """pickle's Python pickler, which lets `save_global` be overridden:
    `_BF16` is written as the global ml_dtypes.bfloat16, which this
    process need not be able to import. A `_BF16Bits` is written as
    numpy writes the bfloat16 array, so the stream is the one
    `pickle.dumps(record, protocol=4)` gives `mpnn_tpu` for its cast
    record, byte for byte."""

    def reducer_override(self, obj):
        if isinstance(obj, _BF16Bits):
            # A fresh (0,) each time, as numpy's reduce makes one: a
            # shared tuple would be memoized where numpy's is not.
            return (_RECONSTRUCT, (np.ndarray, tuple([0]), b"b"),
                    (1, obj.bits.shape, _BF16_DTYPE, obj.fortran,
                     obj.bits.tobytes(order="F" if obj.fortran else "C")))
        if obj is _BF16_DTYPE:
            return np.dtype, (_BF16, False, True), _BF16_DTYPE_STATE
        return NotImplemented

    def save_global(self, obj, name=None):
        if obj is not _BF16:
            return super().save_global(obj, name)
        self.save("ml_dtypes")
        self.save("bfloat16")
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def _bf16_bits(a):
    """The bfloat16 bits of a float array, rounded to nearest even through
    float32 as ml_dtypes casts (NaNs stay quiet NaNs)."""
    f = np.ascontiguousarray(a, np.float32)
    u = f.view(np.uint32)
    bits = ((u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1)))
            >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(f)
    bits[nan] = ((u[nan] >> np.uint32(16)) | np.uint32(0x40)).astype(
        np.uint16)
    return bits


def _floats_to_bf16(obj):
    """Every float ndarray of an encoded record as `_BF16Bits`, as
    `mpnn_tpu`'s `_cast_record_floats` casts them to bfloat16."""
    if isinstance(obj, dict):
        return {k: _floats_to_bf16(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        out = [_floats_to_bf16(v) for v in obj]
        return out if isinstance(obj, list) else tuple(out)
    if isinstance(obj, np.ndarray) and obj.dtype.kind == "f":
        return _BF16Bits(_bf16_bits(obj), bool(
            obj.flags.f_contiguous and not obj.flags.c_contiguous))
    return obj


def write_compact(dirpath, record, *, part_bytes=7 << 20, src_sha=None):
    """Write an encoded net record as a compact archive directory (the
    counterpart of `mpnn_tpu`'s, without ml_dtypes): zlib of the pickled
    record with its floats cast to bfloat16, split into part-NN files of
    at most `part_bytes` each, and a MANIFEST.json with the sha256 of the
    whole; every file through a temporary and `os.replace`, and the parts
    of an earlier, larger archive at `dirpath` removed. `src_sha` (hex)
    records the hash of the source checkpoint, so re-archiving an
    unchanged source can be skipped (`compact_src_sha`). Both packages'
    `read_compact` read it, and its files are the ones `mpnn_tpu`'s
    `write_compact` writes for the record, byte for byte. Returns the
    manifest."""
    buf = io.BytesIO()
    _CompactPickler(buf, protocol=4).dump(_floats_to_bf16(record))
    blob = zlib.compress(buf.getvalue(), level=6)
    os.makedirs(dirpath, exist_ok=True)
    parts = []
    for i in range(0, max(1, -(-len(blob) // part_bytes))):
        chunk = blob[i * part_bytes:(i + 1) * part_bytes]
        name = "part-%02d" % i
        tmp = os.path.join(dirpath, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(chunk)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(dirpath, name))
        parts.append({"name": name, "bytes": len(chunk)})
    manifest = {"format": "mpnn-compact-v1", "codec": "zlib+pickle",
                "float_dtype": "bfloat16", "parts": parts,
                "sha256": hashlib.sha256(blob).hexdigest(),
                "src_sha256": src_sha}
    # Stale parts of an earlier (larger) archive at the same path would
    # corrupt reassembly.
    names = {p["name"] for p in parts}
    for name in os.listdir(dirpath):
        if (name.startswith("part-") and not name.endswith(".tmp")
                and name not in names):
            os.remove(os.path.join(dirpath, name))
    tmp = os.path.join(dirpath, _COMPACT_MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(dirpath, _COMPACT_MANIFEST))
    return manifest


def compact_src_sha(dirpath):
    """The source checkpoint's sha256 recorded in a compact archive, or
    None (no archive, or none recorded)."""
    try:
        with open(os.path.join(dirpath, _COMPACT_MANIFEST)) as f:
            return json.load(f).get("src_sha256")
    except (OSError, ValueError):
        return None


def read_compact(dirpath):
    """The record of a compact archive directory (`mpnn_tpu`'s
    `write_compact`: zlib of the pickled record with its floats cast to
    bfloat16, split into part-NN files, a MANIFEST.json with the sha256),
    its floats back in float32, as `mpnn_tpu`'s `read_compact` returns
    it; decode it with `decode_net`."""
    with open(os.path.join(dirpath, _COMPACT_MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["format"] != "mpnn-compact-v1":
        raise ValueError("unknown compact format %r" % manifest["format"])
    blob = b"".join(open(os.path.join(dirpath, p["name"]), "rb").read()
                    for p in manifest["parts"])
    got = hashlib.sha256(blob).hexdigest()
    if got != manifest["sha256"]:
        raise IOError("compact archive %s corrupt: sha %s != manifest %s"
                      % (dirpath, got, manifest["sha256"]))
    rec = _CompactUnpickler(io.BytesIO(zlib.decompress(blob))).load()
    return _bf16_bits_to_f32(rec)
