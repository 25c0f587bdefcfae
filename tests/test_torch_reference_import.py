"""Records the reference writes, and records mpnn_tpu writes with every
layer type of the zoo, through the PyTorch port's `read_net`, against
mpnn_tpu's: the rebuilt nets' forwards at batch 4 under the TF1 pyramid
grid agree within 1e-4 x max(1, max|jax|) on every node's output and
router logits, and the port writes each record back bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu import ops as jops
from mpnn_tpu.models.net import Ctx as JCtx
from mpnn_tpu.models.sr import SRNet as JSRNet
from mpnn_tpu.ops import config as jconfig
from mpnn_tpu.ops import layers as J
from mpnn_tpu.utils import serdes as jserdes
from mpnn_tpu_torch.models.net import Ctx as TCtx
from mpnn_tpu_torch.ops import config as tconfig
from mpnn_tpu_torch.utils import serdes as tserdes

from . import tf1_ckpt_gen
from .test_torch_zoo import zoo_chain
from tests.torch_threads import share_cores  # noqa: F401

TOL = 1e-4


@pytest.fixture
def tf1_modes():
    """Both packages under the TF1 grid and MaxPool modes, restored after
    the test."""
    saved = [(c, c.pyramid_tf1, c.maxpool_tf1) for c in (jconfig, tconfig)]
    for c in (jconfig, tconfig):
        c.pyramid_tf1 = c.maxpool_tf1 = True
    yield
    for c, p, m in saved:
        c.pyramid_tf1, c.maxpool_tf1 = p, m


def _forward_both(path, x0_shape, seed=0):
    """Both packages' read_net of `path`, then one eval-mode forward of
    the same batch of 4; returns the two record tables in node order."""
    jnet, jp, js, _ = jserdes.read_net(path)
    tnet, tp, ts, _ = tserdes.read_net(path, device="cpu")
    rng = np.random.RandomState(seed)
    x = rng.rand(4, *x0_shape).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 4)]
    jrecs, _ = jnet.forward(jp, js, jnp.asarray(x), jnp.asarray(y),
                            JCtx(train=False))
    with torch.no_grad():
        trecs, _ = tnet.forward(tp, ts, torch.as_tensor(x),
                                torch.as_tensor(y), TCtx(train=False))
    return ([jrecs[l] for l in jnet.layers],
            [trecs[l] for l in tnet.layers])


def _assert_recs_close(jrecs, trecs):
    assert len(jrecs) == len(trecs)
    for j, t in zip(jrecs, trecs):
        for field in ("x", "router_x"):
            a, b = getattr(t, field), getattr(j, field)
            if b is None:
                assert a is None
                continue
            for ai, bi in zip(a if isinstance(a, list) else [a],
                              b if isinstance(b, list) else [b]):
                ai, bi = ai.double().numpy(), np.asarray(bi, np.float64)
                assert ai.shape == bi.shape
                scale = max(1.0, float(np.abs(bi).max()))
                assert float(np.abs(ai - bi).max()) <= TOL * scale


def _records_equal(a, b):
    """Bit-for-bit equality of two decoded records (arrays by dtype and
    bytes, dict keys in any order)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_records_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_records_equal(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return a == b and type(a) is type(b)


def _write_back(path, tmp_path):
    """The port's read_net then write_net of `path`: the record mpnn_tpu
    writes back of it, bit for bit, holding the original's layers and
    hypers (both packages add their classes' defaults)."""
    written = []
    for pkg, kw in ((tserdes, {"device": "cpu"}), (jserdes, {})):
        net, p, s, extra = pkg.read_net(path, **kw)
        out = str(tmp_path / ("written-%d.npy" % len(written)))
        pkg.write_net(out, net, p, s, extra)
        written.append(np.load(out, allow_pickle=True)[()])
    a = np.load(path, allow_pickle=True)[()]
    assert _records_equal(written[0], written[1])
    assert _same_layers(a["root"], written[0]["root"])
    assert _hypers_kept(a["hypers"], written[0]["hypers"])


def _hypers_kept(orig, written):
    return all(k in written and _records_equal(v, written[k])
               for k, v in orig.items())


def _same_layers(orig, written):
    """The layer records of `orig` in `written`: types, names and params
    bit for bit, every hyper kept (a class default the reference's class
    lacks, CrossEntropyError's ε, may be added)."""
    if orig is None or written is None:
        return orig is written
    return (orig["type"] == written["type"]
            and orig["name"] == written["name"]
            and _records_equal(orig["params"], written["params"])
            and _hypers_kept(orig["hypers"], written["hypers"])
            and all(len(orig[k]) == len(written[k])
                    and all(_same_layers(a, b)
                            for a, b in zip(orig[k], written[k]))
                    for k in ("sinks", "comps"))
            and _same_layers(orig["router"], written["router"]))


def test_reference_record_forward_and_write_back(tmp_path, tf1_modes):
    """The full-width 8-deep actor chain in the reference's exact schema
    (tests/tf1_ckpt_gen.py): the port reads it, its forward equals
    mpnn_tpu's, and it writes the record back as mpnn_tpu does."""
    path = str(tmp_path / "ref.npy")
    tf1_ckpt_gen.write_reference_checkpoint(path, seed=3)
    _assert_recs_close(*_forward_both(path, (32, 32, 3)))
    _write_back(path, tmp_path)


def test_zoo_record_forward_and_write_back(tmp_path, tf1_modes):
    """A record mpnn_tpu writes of a net holding every new layer type (an
    array hyper `w_cls`, `λ`, `α` and `σ` keys included): read by the
    port, the same forward, written back bit for bit."""
    jnet = zoo_chain(J, lam=0.5)
    params, state = jnet.init(jax.random.PRNGKey(4))
    path = str(tmp_path / "zoo.npy")
    jserdes.write_net(path, jnet, params, state)
    _assert_recs_close(*_forward_both(path, (16, 16, 3)))
    _write_back(path, tmp_path)


def test_every_layer_type_reads(tmp_path):
    """The port's reader takes each of mpnn_tpu's 20 concrete layer
    types: the zoo and reference records hold 19 of them between them,
    and a net with the default NoOp root the last."""
    names = set(jops.__all__) - {"config", "Layer", "Aux"}
    assert len(names) == 20 and names == set(tserdes._LAYER_TYPES)

    def types(rec):
        if rec is None:
            return set()
        out = {rec["type"]}
        for r in rec["sinks"] + rec["comps"] + [rec["router"]]:
            out |= types(r)
        return out

    jnet = zoo_chain(J, lam=0.5)
    zoo = jserdes.encode_net(jnet, *jnet.init(jax.random.PRNGKey(0)))
    ref = tf1_ckpt_gen.generate_record()
    bare = JSRNet(x0_shape=(4,), y_shape=(10,))
    path = str(tmp_path / "noop.npy")
    jserdes.write_net(path, bare, *bare.init(jax.random.PRNGKey(0)))
    net, _, _, _ = tserdes.read_net(path, device="cpu")
    assert type(net.root).__name__ == "NoOp"
    assert types(zoo["root"]) | types(ref["root"]) | {"NoOp"} == names
