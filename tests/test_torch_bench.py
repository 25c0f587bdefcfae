"""The port's benchmarks on the CPU: infer_bench reports the median of its
timed windows and each window; kernel_bench's stage shapes and costs are
the flagship's, and the three versions it times compute one stage."""

import json
import statistics

import torch

from mpnn_tpu_torch import infer_bench, kernel_bench
from mpnn_tpu_torch.experiments import arch


def test_infer_bench_reports_median_of_windows(capsys):
    infer_bench.main(["--device", "cpu", "--batch-size", "4",
                      "--n-batches", "1", "--n-windows", "2",
                      "--precision", "fp32"])
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["metric"].split()[1] for r in recs] == ["(dense,", "(routed,"]
    for r in recs:
        assert len(r["window_values"]) == 2 and r["window_batches"] == 1
        assert all(v > 0 for v in r["window_values"])
        assert r["value"] == statistics.median(r["window_values"])


def test_kernel_bench_stage_shapes_and_costs():
    """The eight stages halve the pyramid and widen as experiments.arch
    says; stage 0's bytes and operations by hand (batch 2, bf16): 1360
    pixels a scale set, 3 -> 16 channels over 4 scales."""
    stages = kernel_bench.stage_inputs(arch, 2, 32, seed=1,
                                       device=torch.device("cpu"))
    assert len(stages) == len(arch)
    for n_chan, (xs, whs, wvs, bs, _) in zip(arch, stages):
        assert [w.shape[-1] for w in whs] == list(n_chan)
        assert [x.shape[1] for x in xs] == [4 * 2 ** (len(n_chan) - 1 - j)
                                            for j in range(len(n_chan))]
        assert len(wvs) == len(n_chan) - 1 and len(bs) == len(n_chan)
    xs, whs, wvs, bs, n_ops = stages[0]
    assert n_ops == 1024 * 432 + (256 + 64 + 16) * (432 + 2304)
    n_bytes, flops = kernel_bench.stage_cost(xs, whs, wvs, bs, n_ops, 2,
                                             "bf16")
    n_elems = 2 * 1360 * 3 + 4 * 432 + 3 * 2304 + 2 * 1360 * 16
    assert n_bytes == 2 * n_elems + 4 * 64
    assert flops == 2.0 * n_ops * 2
    ms, by = kernel_bench.bound(n_bytes, flops, "bf16")
    assert by == "bytes" and ms == n_bytes / kernel_bench.PEAK_BYTES_S * 1e3


def test_kernel_bench_timed_versions_compute_one_stage():
    """The three timed versions of a stage compute the same function on
    the CPU: fused_mcm and mcm_ref agree exactly, and the cuDNN conv
    sequence is mcm_ref without its bias (fp32, stage 2: three scales)."""
    xs, whs, wvs, bs, _ = kernel_bench.stage_inputs(
        arch, 2, 32, seed=1, device=torch.device("cpu"))[2]
    fns = kernel_bench.stage_fns(xs, whs, wvs, bs)
    assert sorted(fns) == ["", "cudnn_conv_sequence_", "plain_"]
    ref = fns["plain_"]()
    assert len(ref) == 3
    for o, r in zip(fns[""](), ref):
        assert torch.equal(o, r)
    for o, b, r in zip(fns["cudnn_conv_sequence_"](), bs, ref):
        torch.testing.assert_close(o + b, r, rtol=1e-6, atol=1e-6)
