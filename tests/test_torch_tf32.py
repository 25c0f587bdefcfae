"""The arithmetic of the fp32 fused_mcm kernel, 3xTF32 on the tensor cores,
and the bound it is measured against, on the CPU (numpy and torch only).

The kernel splits each fp32 value v into hi = tf32(v) and lo = tf32(v - hi)
(cvt.rna: round to nearest, ties away from zero, at TF32's 10-bit mantissa)
and forms each product as a_lo*b_hi + a_hi*b_lo + a_hi*b_hi. Emulated here
at every K of the flagship's stages (27 to 1,152 taps x channels), that
stays within chip_smoke.py's F64_TOL (1e-5 x max|ref|) of float64, and a
plain TF32 product (a_hi*b_hi) does not: the gate catches that shortcut.
`kernel_bench.bound` reckons fp32 operations at the 3xTF32 rate, and the
kernel source's fp32 branch is that tensor-core kernel."""

import re

import numpy as np
import pytest

from mpnn_tpu_torch import kernel_bench
from mpnn_tpu_torch.experiments import arch
from mpnn_tpu_torch.ops import _build
from tests.torch_threads import share_cores  # noqa: F401

F64_TOL = 1e-5  # chip_smoke.py's gate: fp32 kernel against float64


def tf32(v):
    """v (float32) rounded to TF32 as cvt.rna.tf32.f32 does: the low 13
    mantissa bits dropped, rounding the magnitude half away from zero."""
    bits = np.asarray(v, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split(v):
    """(hi, lo), both TF32, as the kernel splits a value it reads."""
    hi = tf32(v)
    return hi, tf32(v - hi)  # v - hi is exact in float32


def stage_gemms():
    """(K, Cout) of every output scale of the flagship's stages: K = 9 Cin
    taps of the scale's input, plus 9 Cout of the pooled finer scale past
    the first (every scale of a stage has the stage's width)."""
    out, c_in = [], 3
    for n_chan in arch:
        c = n_chan[0]
        out += [(9 * c_in, c)] + [(9 * c_in + 9 * c, c)] * (len(n_chan) > 1)
        c_in = c
    return sorted(set(out))


def operands(k, c_out, seed, m=256):
    """Relu'd inputs and weights at kernel_bench.stage_inputs' scale."""
    rng = np.random.RandomState(seed)
    a = np.maximum(rng.standard_normal((m, k)), 0).astype(np.float32)
    b = (rng.standard_normal((k, c_out)) / 3 / np.sqrt(k / 9)).astype(
        np.float32)
    return a, b


def test_flagship_gemms_span_27_to_1152():
    ks = [k for k, _ in stage_gemms()]
    assert min(ks) == 27 and max(ks) == 1152 and len(stage_gemms()) == 14


def test_split_is_two_tf32_values_within_2_pow_minus_22():
    rng = np.random.RandomState(0)
    v = (rng.standard_normal(100_000)
         * 10.0 ** rng.uniform(-6, 6, 100_000)).astype(np.float32)
    hi, lo = split(v)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    r = v.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64)
    assert (np.abs(r) <= 2.0 ** -22 * np.abs(v.astype(np.float64))).all()
    # Ties round away from zero: 1 + 2^-11 lies halfway between TF32
    # neighbours 1 and 1 + 2^-10.
    t = np.float32(1 + 2.0 ** -11)
    assert tf32(t) == np.float32(1 + 2.0 ** -10)
    assert tf32(-t) == -np.float32(1 + 2.0 ** -10)


@pytest.mark.parametrize("k,c_out", stage_gemms())
def test_3xtf32_product_meets_the_float64_gate_and_1xtf32_does_not(k, c_out):
    a, b = operands(k, c_out, seed=k + c_out)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(ref).max()
    (a_hi, a_lo), (b_hi, b_lo) = split(a), split(b)
    # Products of TF32 values are exact in float32; sums round in float32.
    three = (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi
    one = a_hi @ b_hi
    fp32 = a @ b
    err3 = np.abs(three - ref).max() / scale
    err1 = np.abs(one - ref).max() / scale
    err32 = np.abs(fp32 - ref).max() / scale
    assert three.dtype == one.dtype == np.float32
    assert err3 <= F64_TOL, err3
    assert err3 <= 4 * err32 + 1e-7, (err3, err32)  # fp32's own accuracy
    assert err1 > 10 * F64_TOL, err1  # plain TF32 fails the gate by far


def test_fp32_bound_is_3xtf32_at_495_tflops():
    flops = 4.2e10
    ms, by = kernel_bench.bound(1e3, flops, "fp32")
    assert by == "operations (3xTF32)"
    assert ms == 3 * flops / 495e12 * 1e3
    # Bound by bytes: unchanged.
    n_bytes = 5e11
    ms, by = kernel_bench.bound(n_bytes, flops, "fp32")
    assert by == "bytes" and ms == n_bytes / 3.35e12 * 1e3
    # bf16 keeps its rate of 989 TFLOP/s.
    ms, by = kernel_bench.bound(1e3, flops, "bf16")
    assert by == "operations" and ms == flops / 989e12 * 1e3


def test_flagship_fp32_bound_at_batch_1024():
    """41.06 MFLOP an image over the eight stages: 0.255 ms of 3xTF32
    work at batch 1024, which is what bounds the fp32 stages there."""
    stages = kernel_bench.stage_inputs(arch, 1, 32, seed=0, device="cpu")
    per_image = sum(kernel_bench.stage_cost(xs, whs, wvs, bs, n_ops, 1,
                                            "fp32")[1]
                    for xs, whs, wvs, bs, n_ops in stages)
    assert per_image == pytest.approx(41.06e6, rel=1e-3)
    ms, by = kernel_bench.bound(0, per_image * 1024, "fp32")
    assert by == "operations (3xTF32)"
    assert ms == pytest.approx(0.255, abs=5e-4)


def test_kernel_source_fp32_branch_is_3xtf32_on_a_cp_async_ring():
    """The fp32 launch goes to the 3xTF32 mma.sync kernel (hi and lo by
    cvt.rna, three products a tile), staged by cp.async through a ring of
    at least 3 slots; no FP32-pipe kernel and no library call is left."""
    src = _build.SRC.read_text()
    fp32 = src[src.index("// " + "-" * 64 + " fp32 ----"):
               src.index("}  // namespace")]
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in fp32
    assert fp32.count("cvt.rna.tf32.f32") == 2  # hi, then lo of v - hi
    for terms in ("alo[i], bhi[j][0], bhi[j][1]",
                  "ahi[i], blo[j][0], blo[j][1]",
                  "ahi[i], bhi[j][0], bhi[j][1]"):
        assert "mma_tf32(acc[i][j], %s)" % terms in fp32
    assert "cp.async.cg.shared.global" in fp32
    assert "cp.async.commit_group" in fp32 and "cp.async.wait_group" in fp32
    assert int(re.search(r"constexpr int RING = (\d+);", fp32).group(1)) >= 3
    assert "mcm_scale_kernel" not in src  # PR 4's FP32-pipe kernel
    assert not re.search(r"cublas|cudnn|torch", fp32, re.I)
    launcher = src[src.index('extern "C" int mcm_scale_forward'):]
    case_fp32 = launcher[launcher.index("case 0:"):launcher.index("case 1:")]
    assert "launch_fp32(" in case_fp32
    assert "mcm_scale_tf32<" in fp32
