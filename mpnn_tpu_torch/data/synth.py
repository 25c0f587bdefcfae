"""Deterministic synthetic datasets with the reference `.npz` schema.

The reference's `prep-data` downloads MNIST/CIFAR from the internet
(scripts/prep-data:25-28,71-76); in air-gapped environments that is
impossible, so tests and benchmarks use these synthetic stand-ins. They keep
every schema property the framework depends on: NHWC float images in [0, 1],
one-hot labels, and a per-class `m_sym` flip mask with both symmetric and
asymmetric classes (like the hybrid dataset's `[0]*5 + [1]*5`,
scripts/prep-data:160).

Images are class-conditional Gaussian blobs plus structured noise, so short
training runs produce a real, measurable loss decrease.
"""

import numpy as np


def make_synthetic(n_tr=512, n_ts=256, h=32, w=32, c=3, n_cls=10, seed=0):
    rng = np.random.RandomState(seed)
    protos = rng.rand(n_cls, h, w, c).astype(np.float32)

    def make_split(n):
        ys = rng.randint(0, n_cls, n)
        x = 0.7 * protos[ys] + 0.3 * rng.rand(n, h, w, c).astype(np.float32)
        y = np.eye(n_cls, dtype=np.float32)[ys]
        return np.clip(x, 0, 1).astype(np.float32), y

    x0_tr, y_tr = make_split(n_tr)
    x0_ts, y_ts = make_split(n_ts)
    m_sym = np.array([0] * (n_cls // 2) + [1] * (n_cls - n_cls // 2),
                     np.float32)
    return {"x0_tr": x0_tr, "x0_ts": x0_ts, "y_tr": y_tr, "y_ts": y_ts,
            "m_sym": m_sym,
            "provenance": {"synthetic": True, "generator": "make_synthetic",
                           "seed": int(seed)}}


# Hardness that keeps the depth/accuracy tradeoff alive at the reference's
# FULL 80k-iter budget (measured, v5e: depth-1 SR 23.8% test err vs depth-8
# 8.2%): small low-contrast motifs among many near-duplicate distractors.
# The v1 defaults below saturate (all depths reach 0% err) by 80k iters.
TIERED_V2 = dict(ms=6, motif_alpha=0.35, n_distr=40, n_stamp=6,
                 distr_corr=0.7)


def make_synthetic_tiered(n_tr=50000, n_ts=2000, h=32, w=32, c=3,
                          n_cls=10, seed=0, ms=8, motif_alpha=0.55,
                          n_distr=12, n_stamp=3, distr_corr=0.0):
    """Two-population stand-in for the paper's hybrid MNIST+CIFAR dataset
    (reference scripts/prep-data:140-192): half the classes are EASY
    (global prototype + mild noise -- separable by a shallow head, like
    recolored digits), half are HARD (a shared background texture where the
    class is carried only by a small motif stamped at a random position --
    position-invariant detection needs conv depth, like CIFAR photos).

    This makes accuracy genuinely depth-dependent, so the SR depth ladder
    and the routed nets' accuracy-vs-moc curves show the reference's
    tradeoff shape instead of saturating at 1.0, and dynamic routing has a
    real easy/hard split to exploit (early exit on easy classes, deep
    routes on hard ones). Same `.npz` schema; m_sym marks the hard half
    flip-symmetric like the hybrid's `[0]*5 + [1]*5` mask.

    Hardness knobs (defaults = the original v1 tier, which a depth-1 net
    saturates at the full 80k-iter budget): `ms`/`motif_alpha` size and
    contrast of the class motif; `n_distr`/`n_stamp` distractor pool and
    per-image count; `distr_corr` in [0, 1) makes each distractor a
    perturbed near-duplicate of a class motif, so identification requires
    fine discrimination rather than coarse template detection."""
    rng = np.random.RandomState(seed)
    n_easy = n_cls // 2
    n_hard = n_cls - n_easy
    protos = rng.rand(n_easy, h, w, c).astype(np.float32)
    common = rng.rand(h, w, c).astype(np.float32)
    motifs = rng.rand(n_hard, ms, ms, c).astype(np.float32)
    # Distractor patches with the same statistics as motifs: detection of
    # "some odd patch" is not enough, the net must IDENTIFY which of the
    # n_hard motifs is present among look-alikes. With distr_corr > 0 each
    # look-alike is a noisy copy of a real motif (corrupted twins).
    distractors = rng.rand(n_distr, ms, ms, c).astype(np.float32)
    if distr_corr > 0.0:
        src = motifs[rng.randint(0, n_hard, n_distr)]
        distractors = (distr_corr * src
                       + (1.0 - distr_corr) * distractors).astype(np.float32)

    def stamp(img, patch, u, v, a):
        img[u:u + ms, v:v + ms] = (a * patch
                                   + (1 - a) * img[u:u + ms, v:v + ms])

    def make_split(n):
        ys = rng.randint(0, n_cls, n)
        x = np.empty((n, h, w, c), np.float32)
        easy = ys < n_easy
        n_e = int(easy.sum())
        x[easy] = (0.8 * protos[ys[easy]]
                   + 0.2 * rng.rand(n_e, h, w, c).astype(np.float32))
        idx_hard = np.nonzero(~easy)[0]
        for i in idx_hard:
            k = ys[i] - n_easy
            img = (0.55 * common
                   + 0.45 * rng.rand(h, w, c).astype(np.float32))
            for d in rng.choice(n_distr, n_stamp, replace=False):
                stamp(img, distractors[d], rng.randint(0, h - ms + 1),
                      rng.randint(0, w - ms + 1), motif_alpha)
            # Class motif stamped LAST (never fully occluded), moderate
            # contrast.
            stamp(img, motifs[k], rng.randint(0, h - ms + 1),
                  rng.randint(0, w - ms + 1), motif_alpha)
            x[i] = img
        y = np.eye(n_cls, dtype=np.float32)[ys]
        return np.clip(x, 0, 1).astype(np.float32), y

    x0_tr, y_tr = make_split(n_tr)
    x0_ts, y_ts = make_split(n_ts)
    m_sym = np.array([0] * n_easy + [1] * n_hard, np.float32)
    return {"x0_tr": x0_tr, "x0_ts": x0_ts, "y_tr": y_tr, "y_ts": y_ts,
            "m_sym": m_sym,
            "provenance": {"synthetic": True,
                           "generator": "make_synthetic_tiered",
                           "seed": int(seed)}}


def save_synthetic(path, **kw):
    np.savez_compressed(path, make_synthetic(**kw))
    return path
