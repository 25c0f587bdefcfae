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
