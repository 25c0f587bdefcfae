"""Checkpoint reading of the PyTorch port (mpnn_tpu_torch.utils.serdes) on the
trained flagship results/nets/hybrid-ac/0004.npy: the same net, arrays and
op counts as mpnn_tpu's read_net, and routed inference of a batch of 8 at
full width in fp32 that agrees with mpnn_tpu's on the CPU."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.models.infer import make_routed_infer_fn as j_infer
from mpnn_tpu.utils.serdes import read_net as j_read_net
from mpnn_tpu_torch.data import synth
from mpnn_tpu_torch.models.infer import chain_stages
from mpnn_tpu_torch.models.infer import make_routed_infer_fn as t_infer
from mpnn_tpu_torch.ops.layers import MultiscaleConvMax
from mpnn_tpu_torch.utils.serdes import read_net as t_read_net
from tests.torch_threads import share_cores  # noqa: F401

CKPT = os.path.join(os.path.dirname(__file__), "..", "results", "nets",
                    "hybrid-ac", "0004.npy")

# MultiscaleConvMax.n_ops of the flagship's eight stages (MACs per image).
STAGE_N_OPS = [1361664, 3907584, 2285568, 3833856, 2064384, 3538944,
               1179648, 2359296]


@pytest.fixture(scope="module")
def both():
    return j_read_net(CKPT), t_read_net(CKPT, "cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


@pytest.mark.parametrize("part", [1, 2], ids=["params", "state"])
def test_read_net_same_arrays(both, part):
    ja, ta = both[0][part], both[1][part]
    jl, tl = list(_leaves(ja)), list(_leaves(ta))
    assert [p for p, _ in jl] == [p for p, _ in tl] and len(jl) > 0
    for (path, a), (_, b) in zip(jl, tl):
        assert isinstance(b, torch.Tensor) and b.device.type == "cpu"
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), str(path))


def test_read_net_same_net(both):
    (jnet, *_), (tnet, *_) = both
    assert type(tnet).__name__ == type(jnet).__name__ == "ActorNet"
    assert vars(tnet.hypers) == vars(jnet.hypers)
    assert tnet.hypers.ε == 1e-6
    assert ([(n.name, n.n_ops, len(n.sinks)) for n in tnet.layers]
            == [(n.name, n.n_ops, len(n.sinks)) for n in jnet.layers])


def test_stage_n_ops(both):
    """n_ops of each MultiscaleConvMax stage, which routed ops add up."""
    tnet = both[1][0]
    mcms = [c for node, _, _ in chain_stages(tnet) for c in node.comps
            if isinstance(c, MultiscaleConvMax)]
    assert [m.n_ops for m in mcms] == STAGE_N_OPS
    assert all(m._kernel_eligible() for m in mcms)
    assert sum(STAGE_N_OPS) == 20530944


def test_serve_checkpoint_matches_jax(both):
    """Batch of 8 through the full-width 8-deep chain, fp32, capacity 1.0
    and 0.5: exits, ops and forced exits equal, probs within 1e-4. (The
    GPU smoke test exempts an example whose deciding router's top-2 margin
    is below 1e-3; here every example is held to equality.)"""
    (jnet, jp, js, _), (tnet, tp, ts, _) = both
    x = synth.make_synthetic(n_tr=8, n_ts=8, seed=1)["x0_ts"]
    for cap in (1.0, 0.5):
        jo = j_infer(jnet, 8, cap)(jp, js, jnp.asarray(x))
        to = t_infer(tnet, 8, cap)(tp, ts, torch.as_tensor(x))
        np.testing.assert_array_equal(to["exit_idx"].numpy(),
                                      np.asarray(jo["exit_idx"]))
        np.testing.assert_array_equal(to["ops"].numpy(),
                                      np.asarray(jo["ops"]))
        np.testing.assert_array_equal(to["forced"].numpy(),
                                      np.asarray(jo["forced"]))
        np.testing.assert_allclose(to["probs"].numpy(),
                                   np.asarray(jo["probs"]), atol=1e-4,
                                   rtol=0)
    assert len(np.unique(to["exit_idx"].numpy())) >= 2


def test_read_net_refuses_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_read_net(CKPT)


# write_compact: the port writes compact archives without ml_dtypes, and
# mpnn_tpu's read_compact reads them.

TREE_COMPACT = os.path.join(os.path.dirname(__file__), "..", "results",
                            "nets", "hybrid-ac-tree-dynkcpt", "net.npy.cz")


def _same_record(a, b):
    """Equal records: the same structure and types, arrays equal bit for
    bit with the same dtype."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_record(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same_record(u, v)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert a == b


def test_write_compact_reads_in_jax_as_jax_writes_it(tmp_path):
    """The flagship checkpoint's record, archived by the port and by
    mpnn_tpu: mpnn_tpu's read_compact returns the same record from both
    (its floats rounded to bfloat16 to nearest even, as ml_dtypes casts),
    and so does the port's."""
    from mpnn_tpu.utils import serdes as jserdes
    from mpnn_tpu_torch.utils import serdes as tserdes
    rec = np.load(CKPT, allow_pickle=True)[()]
    tserdes.write_compact(str(tmp_path / "t"), rec)
    jserdes.write_compact(str(tmp_path / "j"), rec)
    want = jserdes.read_compact(str(tmp_path / "j"))
    _same_record(jserdes.read_compact(str(tmp_path / "t")), want)
    _same_record(tserdes.read_compact(str(tmp_path / "t")), want)
    w = rec["root"]["sinks"][0]["comps"][0]["params"]["w_horz_0"]
    got = tserdes.read_compact(str(tmp_path / "t"))[
        "root"]["sinks"][0]["comps"][0]["params"]["w_horz_0"]
    assert not np.array_equal(got, w)  # rounded ...
    np.testing.assert_allclose(got, w, rtol=2 ** -8, atol=0)  # ... to bf16


def test_write_compact_parts_stale_parts_and_src_sha(tmp_path):
    """Small part_bytes split the archive into parts under that size; a
    rewrite with fewer parts removes the stale ones; compact_src_sha
    returns the sha given, and None where there is no archive."""
    from mpnn_tpu_torch.utils.serdes import (compact_src_sha, read_compact,
                                             write_compact)
    rec = np.load(CKPT, allow_pickle=True)[()]
    d = str(tmp_path / "cz")
    assert compact_src_sha(d) is None
    m = write_compact(d, rec, part_bytes=1 << 20, src_sha="ab12")
    assert len(m["parts"]) >= 3
    assert all(p["bytes"] <= 1 << 20 for p in m["parts"])
    assert sorted(os.listdir(d)) == sorted(
        [p["name"] for p in m["parts"]] + ["MANIFEST.json"])
    assert compact_src_sha(d) == "ab12"
    first = read_compact(d)
    m2 = write_compact(d, rec, src_sha="cd34")
    assert [p["name"] for p in m2["parts"]] == ["part-00"]
    assert sorted(os.listdir(d)) == ["MANIFEST.json", "part-00"]
    assert compact_src_sha(d) == "cd34" and m2["sha256"] == m["sha256"]
    _same_record(read_compact(d), first)


def test_compact_round_trip_of_the_trained_tree_is_exact(tmp_path):
    """The trained adaptive tree's committed archive, read, rewritten by
    the port and read back: every array bit for bit (its floats are
    bfloat16 values already)."""
    from mpnn_tpu_torch.utils.serdes import read_compact, write_compact
    rec = read_compact(TREE_COMPACT)
    write_compact(str(tmp_path / "cz"), rec)
    _same_record(read_compact(str(tmp_path / "cz")), rec)
