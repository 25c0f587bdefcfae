"""Serving artifacts of the PyTorch port (mpnn_tpu_torch.export) on the CPU:
the 3-stage 16x16 actor chain of test_torch_infer.py, JAX's randomized
params carried over with from_numpy_tree, traced with torch.export,
saved, loaded and served. The artifact's exits, ops and forced counts
equal the live port engine's and mpnn_tpu's make_routed_infer_fn's on the
same params, and its probs agree within 1e-5. Also: the MultiscaleConvMax
operator (mpnn_tpu_torch::mcm_stage) is one graph node per stage call,
carries the compute dtype it was traced under, passes torch.library's
schema and fake checks, and an artifact serves in a process that cannot
import jax, mpnn_tpu or the port's models; the export_net CLI on the
CPU."""

import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.models.infer import make_routed_infer_fn as j_infer
from mpnn_tpu_torch import export as ex
from mpnn_tpu_torch.models.infer import calibrate_capacities
from mpnn_tpu_torch.models.infer import make_routed_infer_fn as t_infer
from mpnn_tpu_torch.ops import config, kernels
from mpnn_tpu_torch.utils.serdes import write_net

from .test_torch_infer import B, _assert_same, _nets
from tests.torch_threads import share_cores  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
KEYS = ("probs", "exit_idx", "ops", "forced")


@pytest.fixture(scope="module")
def nets():
    return _nets()


@pytest.fixture(scope="module")
def batch():
    return np.random.RandomState(1).rand(B, 16, 16, 3).astype(np.float32)


def _np(out):
    return {k: np.asarray(out[k]) for k in KEYS}


def _export(tmp_path, nets, cap, name="net.pt2", **kw):
    _, _, tnet, (tp, ts) = nets
    path = str(tmp_path / name)
    ex.save_artifact(ex.export_infer(tnet, tp, ts, batch_size=B,
                                     capacities=cap, **kw), path)
    return path


def _held(got, nets, x, cap, k_cpt=None):
    """The artifact's outputs against the live port engine (bit for bit)
    and against mpnn_tpu's on the same params (test_torch_infer's
    gates)."""
    jnet, (jp, js), tnet, (tp, ts) = nets
    live = _np(t_infer(tnet, B, cap)(tp, ts, torch.as_tensor(x), k_cpt))
    for k in KEYS:
        np.testing.assert_array_equal(got[k], live[k], k)
    jo = j_infer(jnet, B, cap)(jp, js, jnp.asarray(x), k_cpt)
    _assert_same({k: np.asarray(v) for k, v in jo.items()}, got)


@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["cap0.5", "calibrated"])
def test_artifact_round_trip_matches_engine_and_jax(nets, batch, tmp_path,
                                                    calibrated):
    _, _, tnet, (tp, ts) = nets
    cap = (calibrate_capacities(tnet, tp, ts, torch.as_tensor(batch),
                                margin=1.2) if calibrated else 0.5)
    assert calibrated == isinstance(cap, list)
    got = _np(ex.serve_fn(_export(tmp_path, nets, cap))(
        torch.as_tensor(batch)))
    _held(got, nets, batch, cap)
    assert len(set(got["exit_idx"].tolist())) == 3  # every leaf is used


def test_dyn_k_cpt_artifact_serves_every_price(batch, tmp_path):
    """One dyn_k_cpt artifact, the price a 0-d input: at two prices it
    equals the engine and JAX at that price."""
    nets = _nets(dyn_k_cpt=True, α_cpt=1e8)
    fn = ex.serve_fn(_export(tmp_path, nets, 1.0, dyn_k_cpt=True))
    ops = []
    for k_cpt in (0.0, 1e-7):
        got = _np(fn(torch.as_tensor(batch), torch.tensor(k_cpt)))
        _held(got, nets, batch, 1.0, k_cpt)
        ops.append(got["ops"].mean())
    assert ops[0] != ops[1]  # the price moves the routing


def test_op_is_one_node_per_stage_call_with_its_dtype(nets, batch,
                                                      tmp_path):
    """The traced graph calls mcm_stage once per stage with the compute
    dtype of the trace as an argument: a bf16 artifact served after the
    process went back to fp32 still equals the bf16 engine."""
    _, _, tnet, (tp, ts) = nets
    n_stages = sum(type(c).__name__ == "MultiscaleConvMax"
                   for node in tnet.layers for c in node.comps)
    config.set_compute_dtype(torch.bfloat16)
    try:
        ep = ex.export_infer(tnet, tp, ts, batch_size=B)
        want = _np(t_infer(tnet, B)(tp, ts, torch.as_tensor(batch)))
    finally:
        config.set_compute_dtype(None)
    calls = [n for n in ep.graph.nodes if n.target is kernels.MCM_STAGE]
    assert n_stages == 3 and len(calls) == n_stages
    assert all(n.args[-1] == torch.bfloat16 for n in calls)
    path = str(tmp_path / "bf16.pt2")
    ex.save_artifact(ep, path)
    got = _np(ex.serve_fn(path)(torch.as_tensor(batch)))
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k], k)


def test_artifact_serves_without_jax_or_model_code(nets, batch, tmp_path):
    """A fresh process that cannot import jax, mpnn_tpu, or the port's
    models, utils and experiments loads and serves the artifact (on the
    CPU, moved there by load_artifact)."""
    path = _export(tmp_path, nets, 0.5)
    np.save(tmp_path / "x.npy", batch)
    blocked = ("jax", "mpnn_tpu", "mpnn_tpu_torch.models",
               "mpnn_tpu_torch.utils", "mpnn_tpu_torch.experiments")
    code = ("import sys\n"
            "for m in %r: sys.modules[m] = None\n"
            "import numpy as np, torch\n"
            "from mpnn_tpu_torch.export import serve_fn\n"
            "out = serve_fn(sys.argv[1], 'cpu')("
            "torch.as_tensor(np.load(sys.argv[2])))\n"
            "np.savez(sys.argv[3], **{k: v.numpy() for k, v in out.items()})\n"
            % (blocked,))
    r = subprocess.run([sys.executable, "-c", code, path,
                        str(tmp_path / "x.npy"), str(tmp_path / "out.npz")],
                       cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    _held(dict(np.load(tmp_path / "out.npz")), nets, batch, 0.5)


@pytest.mark.parametrize("n_nets", [0, 2], ids=["one_net", "net_axis"])
def test_opcheck(n_nets):
    """torch.library.opcheck of mcm_stage: its schema, and its fake
    against the real outputs (shapes, dtype, strides), for one net and
    for the net axis (the first input shared, the rest per net)."""
    rng = np.random.RandomState(3)
    lead = (n_nets,) if n_nets else ()

    def arr(*shape, per_net=True):
        return torch.as_tensor(rng.randn(*((lead if per_net else ())
                                           + shape)).astype(np.float32))

    xs = [arr(2, 8, 8, 4, per_net=False), arr(2, 4, 4, 4)]
    whs = [arr(3, 3, 4, 8), arr(3, 3, 4, 12)]
    wvs = [arr(3, 3, 8, 12)]
    bs = [arr(8), arr(12)]
    tensors = xs + whs + wvs + bs
    batched = [bool(n_nets) and i > 0 for i in range(len(tensors))]
    for dtype in (torch.float32, torch.bfloat16):
        args = (tensors, 2, 3, n_nets, batched, dtype)
        torch.library.opcheck(kernels.MCM_STAGE, args,
                              test_utils=("test_schema", "test_faketensor"))
        outs = kernels.MCM_STAGE(*args)
        assert [tuple(o.shape) for o in outs] == [lead + (2, 8, 8, 8),
                                                  lead + (2, 4, 4, 12)]
        assert all(o.dtype == dtype for o in outs)


def test_export_net_cli_on_cpu(nets, tmp_path):
    """`python -m mpnn_tpu_torch.export_net` on the CPU: the record, an
    artifact that --check holds against the direct path, capacities
    calibrated on an archive's train split."""
    from mpnn_tpu_torch import export_net
    from mpnn_tpu_torch.data import synth
    _, _, tnet, (tp, ts) = nets
    ckpt, out = str(tmp_path / "net.npy"), str(tmp_path / "net.pt2")
    write_net(ckpt, tnet, tp, ts)
    data = str(tmp_path / "d.npz")
    np.savez(data, synth.make_synthetic(n_tr=32, n_ts=8, h=16, w=16,
                                        n_cls=10, seed=0))
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = export_net.main([ckpt, out, "--batch-size", "16",
                                  "--calibrate", data, "--check",
                                  "--device", "cpu"])
    finally:
        config.set_compute_dtype(None)
    rec = json.loads(buf.getvalue().splitlines()[-1])
    assert rc == 0 and rec["check"] == "ok"
    assert rec["artifact"] == out and rec["bytes"] == os.path.getsize(out)
    assert rec["batch_size"] == 16 and rec["device"] == "cpu"
    assert isinstance(rec["capacity"], list) and len(rec["capacity"]) == 2
    assert ex.load_artifact(out).example_inputs is None  # not saved
