"""The port's chunked train loop and its resume, on the CPU: the span
layout is `mpnn_tpu`'s `_tiled_scan_loop`'s; `make_train_loop` equals the
presampled step run on the loop's own draws, exactly; `train_one_net` for
6 steps equals 4 steps and then a resume for 2, exactly, files included.
Nets are the 3-stage chains of tests/test_torch_sr_cr.py."""

import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from mpnn_tpu_torch.data.dataset import Dataset
from mpnn_tpu_torch.data.synth import make_synthetic
from mpnn_tpu_torch.models import steps as tsteps
from mpnn_tpu_torch.ops import config as tconfig
from mpnn_tpu_torch.ops import layers as T
from mpnn_tpu_torch.train import train_one_net
from mpnn_tpu_torch.utils.serdes import read_net
from mpnn_tpu_torch.utils.tree import tree_leaves, tree_map
from tests.test_torch_sr_cr import build_chain
from tests.torch_threads import share_cores  # noqa: F401

B = 8
SCHED = dict(lr=lambda t: 0.02, tau=lambda t: 1.0 / 2 ** (t / 4))


def _data():
    arch = make_synthetic(n_tr=48, n_ts=24, h=16, w=16, c=3, n_cls=10,
                          seed=3)
    return Dataset(arch, device="cpu")


def test_spans_follow_jax_tiling():
    """tile = min(sample_tile, n_steps), full tiles, then the remainder,
    each starting at its own t_first."""
    assert tsteps._spans(3, 5, 2) == [(3, 2), (5, 2), (7, 1)]
    assert tsteps._spans(0, 20, 256) == [(0, 20)]
    assert tsteps._spans(40, 266, 256) == [(40, 256), (296, 10)]
    assert tsteps._spans(0, 512, 256) == [(0, 256), (256, 256)]
    with pytest.raises(ValueError, match="n_steps"):
        tsteps._spans(0, 0, 256)


def test_fold_is_a_function_of_integers():
    seeds = {tsteps._fold(1, t) for t in range(100)}
    seeds |= {tsteps._fold(1, tsteps._SAMPLE_STREAM, t) for t in range(100)}
    seeds |= {tsteps._fold(2, t) for t in range(100)}
    assert len(seeds) == 300
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert tsteps._fold(5, 7) == tsteps._fold(5, 7)


@pytest.mark.parametrize("kind", ["ac", "cr"])
def test_train_loop_equals_presampled_steps(kind):
    """5 steps from t0 = 3 with tiles of 2: the loop's params, state, vel
    and losses equal, bit for bit, the presampled step run on gathers
    re-seeded from (seed, 7919, t_first) and augmentations re-seeded from
    (seed, t)."""
    net = build_chain(T, kind)
    x0_tr, y_tr, m_sym = _data().train_arrays
    sched = tsteps.Schedules(**SCHED)
    runs = []
    for use_loop in (True, False):
        p, s, v = tsteps.init_training(net, seed=2, device="cpu")
        if use_loop:
            loop = tsteps.make_train_loop(net, B, sched, sample_tile=2)
            p, s, v, cs = loop(p, s, v, 3, 11, x0_tr, y_tr, m_sym, 5)
        else:
            step = tsteps._train_step_body(net, B, sched, presampled=True)
            gen = torch.Generator()
            sample = tsteps._chunk_sampler(B, x0_tr, y_tr)
            cs = []
            for t_first, n in ((3, 2), (5, 2), (7, 1)):
                xc, yc = sample(gen, 11, t_first, n)
                assert xc.shape == (n, B, 16, 16, 3)
                for i in range(n):
                    gen.manual_seed(tsteps._fold(11, t_first + i))
                    p, s, v, c = step(p, s, v, t_first + i, gen, xc[i],
                                      yc[i], m_sym)
                    cs.append(c)
            cs = torch.stack(cs)
        runs.append((p, s, v, cs))
    (lp, ls, lv, lc), (sp, ss, sv, sc) = runs
    assert lc.shape == (5,) and torch.isfinite(lc).all()
    assert torch.equal(lc, sc)
    for a, b in zip(tree_leaves((lp, ls, lv)), tree_leaves((sp, ss, sv))):
        assert torch.equal(a, b)


def test_sampler_stores_bf16_chunk_under_bf16_policy():
    x0_tr, y_tr, _ = _data().train_arrays
    sample = tsteps._chunk_sampler(B, x0_tr, y_tr)
    tconfig.set_compute_dtype(torch.bfloat16)
    try:
        xc, yc = sample(torch.Generator(), 0, 0, 3)
    finally:
        tconfig.set_compute_dtype(None)
    assert xc.dtype == torch.bfloat16 and yc.dtype == torch.float32
    assert xc.shape == (3, B, 16, 16, 3) and yc.shape == (3, B, 10)
    assert torch.equal(yc.sum(-1), torch.ones(3, B))


def _train(ds, out_dir, n_iter, resume):
    rec, buf = {}, io.StringIO()
    with redirect_stdout(buf):
        out = train_one_net(
            build_chain(T, "ac"), ds, schedules=tsteps.Schedules(**SCHED),
            tau_fn=SCHED["tau"], n_iter=n_iter, t_log=2, batch_size=B,
            out_dir=out_dir, net_index=3, seed=3, resume=resume,
            timings=rec)
    return out, rec, buf.getvalue()


def test_resume_equals_uninterrupted_run(tmp_path):
    """6 steps in one run against 4 steps then --resume for 2: the same
    params, state and momentum bit for bit, the same checkpoint, stats
    files and rendered log."""
    ds = _data()
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    (p1, s1, v1, d1), rec1, _ = _train(ds, one, 6, False)
    _, rec_a, _ = _train(ds, two, 4, False)
    (p2, s2, v2, d2), rec_b, text = _train(ds, two, 6, True)
    assert "[resuming %s/0003.npy at t=4]" % two in text
    assert (rec1["t_start"], rec_a["t_start"], rec_b["t_start"]) == (0, 0, 4)
    assert (rec1["steps"], rec1["evals"]) == (6, 3)
    assert (rec_b["steps"], rec_b["evals"]) == (2, 1)
    same = []
    tree_map(lambda a, b: same.append(torch.equal(a, b)), (p1, s1, v1),
             (p2, s2, v2))
    assert same and all(same)
    assert d1 == d2
    for name in ("0003-stats.npy", "0003-stats/00000002.npy",
                 "0003-stats/00000004.npy", "0003-stats/00000006.npy"):
        a = np.load(os.path.join(one, name), allow_pickle=True)[()]
        b = np.load(os.path.join(two, name), allow_pickle=True)[()]
        assert a == b, name
    with open(os.path.join(one, "0003-log.txt"), encoding="utf-8") as f:
        log1 = f.read().replace(one, "OUT")
    with open(os.path.join(two, "0003-log.txt"), encoding="utf-8") as f:
        log2 = f.read().replace(two, "OUT")
    assert log1 == log2 and log1.count("Epoch") == 3
    _, cp1, _, e1 = read_net(os.path.join(one, "0003.npy"), "cpu")
    _, cp2, _, e2 = read_net(os.path.join(two, "0003.npy"), "cpu")
    assert e1["t"] == e2["t"] == 6
    for a, b in zip(tree_leaves((cp1, e1["vel"])),
                    tree_leaves((cp2, e2["vel"]))):
        assert torch.equal(a, b)
