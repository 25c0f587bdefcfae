"""Per-stage timing of the fused_mcm kernel on one GPU, against its plain
version `mcm_ref` and the cuDNN conv sequence that `mcm_ref` makes; the
helpers of chip_smoke.py's `kernel` phase.

For each of the flagship's MultiscaleConvMax stage shapes (inputs from a
seeded numpy generator), `stage_times` gives, for the kernel (`ms`),
`mcm_ref` (`plain_ms`) and the cuDNN sequence (`cudnn_conv_sequence_ms`):

- the call time (`*ms`): CUDA events around one call from Python, median
  of 25 calls, host work included; where the device's work is shorter
  than the host's, this is the host's time;
- the device time (`*device_ms`): replays of a CUDA graph that holds 10
  calls, between two CUDA events, per call, so no host work is in it;

and `stage_cost` and `bound` give the stage's bound: the larger of its
bytes (each input read once, each output written once) over 3.35 TB/s and
its operations over the type's peak rate on the tensor cores (fp32 as
3xTF32: three TF32 products per product at 495 TFLOP/s).
`sweep_stage_inputs` and `sweep_stage_fns` give the same for a sweep's
stage: every net at once through fused_mcm's net axis, against `mcm_ref`
under the same `torch.func.vmap` (cuDNN's grouped convs).
`sharded_scales` and `scale_fns` give it for the launches of a stage
sharded over a 'model' axis (`fused_mcm_scale`: one scale, a block of
the output channels, from the whole scale before). The timers need a
CUDA GPU."""

import statistics
import subprocess

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, and the FLOP/s of
# the tensor-core instructions that carry each type's products. fp32 runs
# as 3xTF32 (fused_mcm.cu): three TF32 products per product, each at 495
# TFLOP/s, so fp32 work costs PASSES["fp32"] = 3 times its FLOPs at that
# rate. (Outside the tensor cores fp32 runs at 67 TFLOP/s; bounds before
# the 3xTF32 kernel used that rate.)
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"fp32": 495e12, "bf16": 989e12}
PASSES = {"fp32": 3, "bf16": 1}
N_TIMED = 25
GRAPH_CALLS = 10  # calls captured in one timed CUDA graph
GRAPH_REPLAYS = 20


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, n=N_TIMED):
    """Median time of fn() in ms, by CUDA events around each call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn):
    """Device time of fn() in ms: a CUDA graph of GRAPH_CALLS calls,
    replayed GRAPH_REPLAYS times between two events, per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture, as CUDA graphs require
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (GRAPH_REPLAYS * GRAPH_CALLS)


def stage_inputs(arch, B, x_hw, seed, device, c_in=3, first=0):
    """Per stage of `arch` from stage `first` on: (pyramid input, whs, wvs,
    bs, n_ops) at batch B, from a seeded numpy generator. Stage i's input
    pyramid is the shape of stage i-1's output."""
    from .ops.layers import MultiscaleConvMax
    rng = np.random.RandomState(seed)
    shapes = [(x_hw // 2 ** i, x_hw // 2 ** i, c_in)
              for i in range(len(arch[0]))]
    stages = []
    for i, n_chan in enumerate(arch):
        mcm = MultiscaleConvMax(n_chan=n_chan, supp=3)
        mcm.build(shapes)
        if not mcm._kernel_eligible():
            raise ValueError("stage %s is not kernel-eligible" % n_chan)
        kept = shapes[len(shapes) - len(n_chan):]
        if i < first:
            shapes = mcm.out_shape
            continue

        def arr(shape, scale):
            a = (rng.standard_normal(shape) * scale).astype(np.float32)
            return torch.as_tensor(a, device=device)

        xs = [torch.relu(arr((B,) + tuple(s), 1.0)).contiguous()
              for s in kept]
        whs = [arr(s, 1.0 / 3 / np.sqrt(s[2])) for s in mcm._w_horz_shapes]
        wvs = [arr(s, 1.0 / 3 / np.sqrt(s[2])) for s in mcm._w_vert_shapes]
        bs = [arr((c,), 0.1) for c in n_chan]
        stages.append((xs, whs, wvs, bs, mcm.n_ops))
        shapes = mcm.out_shape
    return stages


def sweep_stage_inputs(arch, n_nets, B, x_hw, seed, device, first=0):
    """Per stage of `arch` from stage `first` on, that stage for n_nets
    nets: (xs, whs, wvs, bs, n_ops) with net i's tensors those of
    `stage_inputs` from seed + i, stacked on a leading axis; stage 0's
    input pyramid (made from the shared batch) is net 0's, shared by
    every net."""
    per_net = [stage_inputs(arch, B, x_hw, seed + i, device, first=first)
               for i in range(n_nets)]
    out = []
    for si, stages in enumerate(zip(*per_net), first):
        def stack(k):
            return [torch.stack(ts) for ts in zip(*(st[k] for st in stages))]
        xs = stages[0][0] if si == 0 else stack(0)
        out.append((xs, stack(1), stack(2), stack(3), stages[0][4]))
    return out


def stage_cost(xs, whs, wvs, bs, n_ops, B, dt, n_nets=1):
    """(bytes, flops) the stage must move and compute: each input read once,
    each output written once. With n_nets, whs, wvs and bs (and xs unless
    they are shared) carry the nets on a leading axis."""
    esize = 4 if dt == "fp32" else 2
    n_in = sum(x.numel() for x in xs) + sum(w.numel() for w in whs + wvs)
    n_out = n_nets * sum(x.shape[-4] * x.shape[-3] * x.shape[-2]
                         * w.shape[-1] for x, w in zip(xs, whs))
    n_bytes = esize * (n_in + n_out) + 4 * sum(b.numel() for b in bs)
    return n_bytes, 2.0 * n_ops * B * n_nets


def bound(n_bytes, flops, dt):
    """(bound_ms, bound_by): the least time the card could take, bound by
    "bytes" or by "operations" ("operations (3xTF32)" for fp32)."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = PASSES[dt] * flops / PEAK_FLOPS[dt] * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations (3xTF32)" if dt == "fp32" else "operations"


def conv_sequence(xs, whs, wvs, pooled):
    """The cuDNN conv calls mcm_ref makes (pools precomputed)."""
    from .ops.layers import conv_same
    outs = [conv_same(xs[0], whs[0])]
    for j in range(1, len(whs)):
        outs.append(conv_same(xs[j], whs[j]) + conv_same(pooled[j - 1],
                                                         wvs[j - 1]))
    return outs


def stage_fns(xin, whs, wvs, bs):
    """{prefix: fn} of the three timed versions of one stage, on inputs in
    the compute dtype and weights cast to it once, so the timed calls hold
    compute only."""
    from .ops.kernels import fused_mcm, mcm_ref
    from .ops.layers import _pool2
    dt = xin[0].dtype
    wc = [w.to(dt) for w in whs]
    vc = [w.to(dt) for w in wvs]
    pooled = [_pool2(r) for r in mcm_ref(xin, wc, vc, bs)[:-1]]
    return {"": lambda: fused_mcm(xin, wc, vc, bs, 3),
            "plain_": lambda: mcm_ref(xin, wc, vc, bs),
            "cudnn_conv_sequence_": lambda: conv_sequence(xin, wc, vc,
                                                          pooled)}


def sweep_stage_fns(xin, whs, wvs, bs):
    """{prefix: fn} of a sweep's stage: every net through fused_mcm's net
    axis as `torch.func.vmap` calls it (""), the plain version `mcm_ref`
    on each net's slice ("plain_"), and `mcm_ref` under the same vmap
    ("library_": cuDNN's grouped convs); weights cast to the compute
    dtype once. The inputs are shared when they carry no net axis."""
    from .ops.kernels import fused_mcm, mcm_ref
    dt = xin[0].dtype
    wc = [w.to(dt) for w in whs]
    vc = [w.to(dt) for w in wvs]
    x_dim = 0 if xin[0].dim() == 5 else None

    def vmapped(stage):
        return torch.func.vmap(lambda w, v, b, x: stage(x, w, v, b),
                               in_dims=(0, 0, 0, x_dim))

    def plain():
        return [mcm_ref(xin if x_dim is None else [x[i] for x in xin],
                        [w[i] for w in wc], [w[i] for w in vc],
                        [b[i] for b in bs]) for i in range(bs[0].shape[0])]

    kernel = vmapped(lambda x, w, v, b: fused_mcm(x, w, v, b, 3))
    library = vmapped(mcm_ref)
    return {"": lambda: kernel(wc, vc, bs, xin), "plain_": plain,
            "library_": lambda: library(wc, vc, bs, xin)}


def sharded_scales(stages, n_model, index=0):
    """The launches of `stage_inputs`' stages sharded over a 'model' axis
    of n_model ranks, as rank `index` makes them: per output scale j,
    (x_j, this rank's block of w_horz_j, of b_j and of w_vert_{j-1}, the
    stage's whole output at scale j-1 from `mcm_ref` (None at j = 0), and
    the block of the whole output at scale j that the launch must give,
    its operations per example)."""
    from .ops.kernels import mcm_ref
    out = []
    for xs, whs, wvs, bs, _ in stages:
        L = len(whs)
        whole = mcm_ref(xs, whs, wvs, bs)

        def block(t):
            k = t.shape[-1] // n_model
            return t[..., index * k:(index + 1) * k].contiguous()

        for j in range(L):
            x = xs[len(xs) - L + j]
            prev, wv = (whole[j - 1], block(wvs[j - 1])) if j else (None,
                                                                    None)
            wh = block(whs[j])
            h, w = x.shape[1:3]
            n_ops = h * w * (wh[..., 0].numel() + (0 if wv is None
                                                   else wv[..., 0].numel())
                             ) * wh.shape[-1]
            out.append((x, wh, block(bs[j]), prev, wv, block(whole[j]),
                        float(n_ops)))
    return out


def scale_cost(x, wh, b, prev, wv, n_ops, dt):
    """(bytes, flops) of one sharded launch: x, the weights, prev and the
    bias read once, the output block written once."""
    esize = 4 if dt == "fp32" else 2
    n_in = x.numel() + wh.numel() + (0 if prev is None
                                     else prev.numel() + wv.numel())
    n_out = x.shape[0] * x.shape[1] * x.shape[2] * wh.shape[-1]
    return esize * (n_in + n_out) + 4 * b.numel(), 2.0 * n_ops * x.shape[0]


def scale_fns(x, wh, b, prev, wv):
    """{prefix: fn} of one sharded launch: the kernel (`fused_mcm_scale`),
    its plain version (`mcm_ref` with prev) and the cuDNN conv calls that
    make (the pool precomputed)."""
    from .ops.kernels import fused_mcm_scale, mcm_ref
    from .ops.layers import _pool2, conv_same
    if prev is None:
        return {"": lambda: fused_mcm_scale(x, wh, b),
                "plain_": lambda: mcm_ref([x], [wh], [], [b]),
                "cudnn_conv_sequence_": lambda: conv_same(x, wh)}
    pooled = _pool2(prev)
    return {"": lambda: fused_mcm_scale(x, wh, b, prev, wv),
            "plain_": lambda: mcm_ref([x], [wh], [wv], [b], prev=prev),
            "cudnn_conv_sequence_": lambda: conv_same(x, wh) + conv_same(
                pooled, wv)}


def stage_times(xin, whs, wvs, bs, fns=stage_fns):
    """Call (`*ms`) and device (`*device_ms`) times of the versions of one
    stage that `fns` gives."""
    times = {}
    for name, fn in fns(xin, whs, wvs, bs).items():
        times[name + "ms"] = time_ms(fn)
        times[name + "device_ms"] = device_ms(fn)
    return times
