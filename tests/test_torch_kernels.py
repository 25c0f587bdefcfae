"""The port's MultiscaleConvMax stage (mpnn_tpu_torch.ops.kernels) against
mpnn_tpu's, on the CPU: mcm_ref against mcm_xla and against the Pallas
kernel run in interpret mode (the tests/test_kernels.py fixture, fp32 atol
1e-5), bf16 compute against JAX under bf16, fused_mcm's gradient against
the custom VJP of JAX's fused_mcm, and the wrapper's dispatch: CPU tensors
take mcm_ref, anything else takes the CUDA kernel or raises. The CUDA
kernel itself runs only on a GPU; chip_smoke.py holds it and its gradient
against mcm_ref there."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.ops import config as jconfig
from mpnn_tpu.ops.kernels import _pack_w as j_pack_w
from mpnn_tpu.ops.kernels import fused_mcm as j_fused_mcm
from mpnn_tpu.ops.kernels import fused_mcm_forward, mcm_xla
from mpnn_tpu_torch.ops import _build, kernels
from mpnn_tpu_torch.ops import config as tconfig
from tests.torch_threads import share_cores  # noqa: F401


def _stage(c_in=3, c=8, b=8, seed=0):
    """tests/test_kernels.py's fixture: 16/8/4 pyramid, L=2."""
    rng = np.random.RandomState(seed)
    xs = [rng.rand(b, 16, 16, c_in).astype(np.float32),
          rng.rand(b, 8, 8, c_in).astype(np.float32),
          rng.rand(b, 4, 4, c_in).astype(np.float32)]
    whs = [rng.randn(3, 3, c_in, c).astype(np.float32) * 0.2,
           rng.randn(3, 3, c_in, c).astype(np.float32) * 0.2]
    wvs = [rng.randn(3, 3, c, c).astype(np.float32) * 0.2]
    bs = [rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)]
    return xs, whs, wvs, bs


def _jax(arrs):
    return [jnp.asarray(a) for a in arrs]


def _torch(arrs):
    return [torch.as_tensor(a) for a in arrs]


def _ref(stage):
    return kernels.mcm_ref(*[_torch(a) for a in stage])


def test_mcm_ref_matches_mcm_xla():
    stage = _stage()
    ref = mcm_xla(*[_jax(a) for a in stage])
    out = _ref(stage)
    assert len(out) == 2
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


def test_mcm_ref_matches_pallas_interpret():
    stage = _stage()
    ref = fused_mcm_forward(*[_jax(a) for a in stage], 3, interpret=True)
    for r, o in zip(ref, _ref(stage)):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("c", [64, 128])
def test_mcm_ref_matches_mcm_xla_wide(c):
    """Widths of the flagship's deep stages; fp32 sums over 9*c*2 products,
    so the tolerance is that of tests/test_kernels.py's wide case."""
    rng = np.random.RandomState(1)
    xs = [rng.rand(4, 8, 8, c).astype(np.float32),
          rng.rand(4, 4, 4, c).astype(np.float32)]
    whs = [rng.randn(3, 3, c, c).astype(np.float32) * 0.05 for _ in range(2)]
    wvs = [rng.randn(3, 3, c, c).astype(np.float32) * 0.05]
    bs = [np.zeros(c, np.float32), np.zeros(c, np.float32)]
    ref = mcm_xla(_jax(xs), _jax(whs), _jax(wvs), _jax(bs))
    out = kernels.mcm_ref(_torch(xs), _torch(whs), _torch(wvs), _torch(bs))
    for r, o in zip(ref, out):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=2e-4)


def test_mcm_ref_bf16_matches_jax_bf16():
    """Under the bf16 policy both emit bf16. They round at the same places
    (each conv output, the sum, the bias add), but the convs' internal
    accumulation order differs, so a result may land one bf16 step (2^-8
    relative) away and carry that into the coarser scales: atol is 2e-2 of
    the largest output magnitude."""
    stage = _stage(c_in=8, c=16, seed=3)
    jconfig.set_compute_dtype(jnp.bfloat16)
    tconfig.set_compute_dtype(torch.bfloat16)
    try:
        ref = mcm_xla(*[_jax(a) for a in stage])
        out = _ref(stage)
    finally:
        jconfig.set_compute_dtype(None)
        tconfig.set_compute_dtype(None)
    for r, o in zip(ref, out):
        assert o.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16
        r32 = np.asarray(r, np.float32)
        np.testing.assert_allclose(o.float().numpy(), r32,
                                   atol=2e-2 * np.abs(r32).max(), rtol=0)


def test_pack_w_matches_jax():
    w = np.random.RandomState(2).randn(3, 3, 4, 5).astype(np.float32)
    np.testing.assert_array_equal(kernels._pack_w(torch.as_tensor(w)).numpy(),
                                  np.asarray(j_pack_w(jnp.asarray(w))))


def test_fused_mcm_on_cpu_takes_mcm_ref(monkeypatch):
    """CPU tensors compute the plain version: same result, no kernel
    library loaded, no launch counted."""
    def no_build():
        raise AssertionError("the kernel library was asked for on the CPU")
    monkeypatch.setattr(_build, "load", no_build)
    stage = _stage()
    n0 = kernels.fused_mcm.launches
    out = kernels.fused_mcm(*[_torch(a) for a in stage], 3)
    for r, o in zip(_ref(stage), out):
        assert torch.equal(r, o)
    assert kernels.fused_mcm.launches == n0


def test_fused_mcm_grads_match_jax_vjp():
    """fused_mcm's backward (autograd through mcm_ref) against the custom
    VJP of JAX's fused_mcm with the Pallas forward in interpret mode, on
    the same inputs and cotangents, fp32. The pyramid's unused finest scale
    gets a zero cotangent in JAX and no gradient in the port. Weight
    gradients sum 2,048 products and reach |44|, where one fp32 step is
    3.8e-6, so an rtol of 1e-6 stands beside the atol of 1e-5 (the
    summation orders of the two libraries differ)."""
    stage = _stage()
    rng = np.random.RandomState(5)
    L = len(stage[1])
    ref = _ref(stage)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in ref]

    def f(xs, whs, wvs, bs):
        return j_fused_mcm(xs, whs, wvs, bs, 3, True)

    _, vjp = jax.vjp(f, *[_jax(a) for a in stage])
    gx, gwh, gwv, gb = vjp(_jax(cots))
    np.testing.assert_array_equal(np.asarray(gx[0]), 0.0)

    xs, whs, wvs, bs = [_torch(a) for a in stage]
    leaves = xs[-L:] + whs + wvs + bs
    for t in leaves:
        t.requires_grad_()
    out = kernels.fused_mcm(xs, whs, wvs, bs, 3)
    assert all(o.grad_fn is not None for o in out)
    grads = torch.autograd.grad(out, leaves, _torch(cots))
    for g, j in zip(grads, list(gx[-L:]) + list(gwh) + list(gwv) + list(gb)):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-6)


def test_fused_mcm_gradient_skips_inputs_without_grad():
    """Only the inputs that need a gradient get one; the weights' gradient
    equals autograd through mcm_ref itself."""
    xs, whs, wvs, bs = [_torch(a) for a in _stage()]
    for w in whs:
        w.requires_grad_()
    out = kernels.fused_mcm(xs, whs, wvs, bs, 3)
    loss = sum(o.square().sum() for o in out)
    loss.backward()
    got = [w.grad.clone() for w in whs]
    ref = torch.autograd.grad(
        sum(o.square().sum() for o in kernels.mcm_ref(xs, whs, wvs, bs)),
        whs)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert all(t.grad is None for t in xs + wvs + bs)


def test_fused_mcm_inference_mode_carries_no_graph(monkeypatch):
    """Under torch.inference_mode (the routed engine) the outputs carry no
    graph, equal mcm_ref, and the stage is computed once: nothing is
    recomputed for a backward."""
    stage = _stage()
    ref = _ref(stage)
    xs, whs, wvs, bs = [_torch(a) for a in stage]
    for t in whs + wvs + bs:
        t.requires_grad_()
    calls = []
    plain = kernels.mcm_ref
    monkeypatch.setattr(kernels, "mcm_ref",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    with torch.inference_mode():
        out = kernels.fused_mcm(xs, whs, wvs, bs, 3)
    assert len(calls) == 1
    for o, r in zip(out, ref):
        assert o.grad_fn is None and not o.requires_grad and o.is_inference()
        assert torch.equal(o, r)


def test_fused_mcm_non_cpu_tensors_do_not_fall_back():
    """A tensor that is not on the CPU never computes mcm_ref: it takes the
    CUDA kernel or raises (here: meta tensors, which the kernel refuses)."""
    xs, whs, wvs, bs = [[torch.as_tensor(a).to("meta") for a in arrs]
                        for arrs in _stage()]
    with pytest.raises(ValueError, match="CUDA device"):
        kernels.fused_mcm(xs, whs, wvs, bs, 3)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A failing nvcc raises with its output, and the launch path raises
    with it: no fallback and no launch counted."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fused_mcm.cu(1): error: boom' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*boom"):
        _build.build()
    assert not _build.library_path().exists()
    n0 = kernels.fused_mcm.launches
    with pytest.raises(RuntimeError, match="nvcc failed"):
        kernels._launch(torch.device("cuda", 0), *([0] * 13))
    assert kernels.fused_mcm.launches == n0


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    if _build.os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has nvcc at its default place")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_kernel_source_is_plain_c_interface():
    """Built by nvcc alone: no PyTorch headers, an extern "C" launcher."""
    src = _build.SRC.read_text()
    assert "torch/extension.h" not in src and "#include <torch" not in src
    assert 'extern "C" int mcm_scale_forward' in src
    assert "cpp_extension" not in (_build.SRC.parents[1] / "_build.py"
                                   ).read_text()
    assert "arch=compute_90a,code=sm_90a" in " ".join(_build.NVCC_FLAGS)


def test_kernel_source_bf16_branch_uses_tensor_cores():
    """The bf16 branch is the mma.sync implicit GEMM fed by ldmatrix, and
    bf16 never reaches the FP32-pipe kernel; the plain C launcher stays."""
    src = _build.SRC.read_text()
    bf16 = src[src.index("// " + "-" * 64 + " bf16 ----"):
               src.index("}  // namespace")]
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in bf16
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in bf16
    assert "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16" in bf16
    launcher = src[src.index('extern "C" int mcm_scale_forward'):]
    case_bf16 = launcher[launcher.index("case 1:"):
                         launcher.index("default:")]
    assert "launch_mma<" in case_bf16 and "launch_fp32" not in case_bf16
    assert "mcm_scale_mma" not in launcher.split("case 1:")[0]


def test_layer_takes_fused_path_for_eligible_shapes(monkeypatch):
    """MultiscaleConvMax.apply sends kernel-eligible shapes to fused_mcm
    and the others to mcm_ref; every flagship stage is eligible."""
    from mpnn_tpu_torch.experiments import arch
    from mpnn_tpu_torch.models.net import Ctx
    from mpnn_tpu_torch.ops.layers import MultiscaleConvMax
    shapes = [(32 // 2 ** i, 32 // 2 ** i, 3) for i in range(4)]
    for n_chan in arch:
        mcm = MultiscaleConvMax(n_chan=n_chan, supp=3)
        mcm.build(shapes)
        assert mcm._kernel_eligible(), n_chan
        shapes = mcm.out_shape
    calls = []
    monkeypatch.setattr(kernels, "fused_mcm",
                        lambda *a: calls.append(a) or kernels.mcm_ref(*a[:4]))
    gen = torch.Generator().manual_seed(0)
    for n_chan, shp, fused in (([4, 4], [(8, 8, 3), (4, 4, 3)], True),
                               ([4, 4], [(4, 4, 3), (2, 2, 3)], False)):
        mcm = MultiscaleConvMax(n_chan=n_chan, supp=3)
        mcm.build(shp)
        params = mcm.init(gen, shp)
        x = [torch.rand(2, *s) for s in shp]
        n = len(calls)
        mcm.apply(params, {}, x, None, Ctx())
        assert (len(calls) > n) == fused
