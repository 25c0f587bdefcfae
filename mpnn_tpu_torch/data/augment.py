"""Data augmentation on the device (counterpart of
`mpnn_tpu/data/augment.py`):

- shift: move each image by its own (du, dv) in [-r, r], filling vacated
  pixels with that image's per-channel mean: out[i, j] = x[i + du, j + dv]
  where that pixel exists;
- flip: mirror along the width, with probability 1/2, only for examples
  whose class is flip-symmetric (`y @ m_sym` set);
- `augmented_batch`: sample a batch with replacement, then flip and shift.

Each random function draws from an explicit `torch.Generator` on the
batch's device (no host round trip) and hands the draws to a pure half,
`shift_batch(x, du, dv)` or `flip_batch(x, do_flip)`, so tests can feed
the port the draws `mpnn_tpu` made. The streams themselves differ from
JAX's. The shift is an index shift with a validity mask, exact like JAX's
0/1 selection matmuls."""

import torch


def shift_batch(x, du, dv):
    """Shift every image of x (B, H, W, C) by its own (du[b], dv[b]),
    vacated pixels filled with the image's per-channel mean."""
    b, h, w, _ = x.shape
    fill = torch.mean(x, dim=(1, 2), keepdim=True)
    rows = torch.arange(h, device=x.device)[None, :] + du[:, None]  # (B, H)
    cols = torch.arange(w, device=x.device)[None, :] + dv[:, None]  # (B, W)
    row_ok = (rows >= 0) & (rows < h)
    col_ok = (cols >= 0) & (cols < w)
    batch = torch.arange(b, device=x.device)[:, None, None]
    out = x[batch, rows.clamp(0, h - 1)[:, :, None],
            cols.clamp(0, w - 1)[:, None, :]]
    cover = row_ok[:, :, None] & col_ok[:, None, :]
    return torch.where(cover[..., None], out, fill)


def _drawn(x, part):
    """(n, lo): the draws of a batch of n are made, and x takes rows lo
    onwards of them; part = (lo, hi, n) of a data-parallel rank, or None
    (x is the whole batch)."""
    return (x.shape[0], 0) if part is None else (part[2], part[0])


def rand_shift_batch(gen, x, r, part=None):
    """Shift every image by an independent (du, dv) drawn from [-r, r].
    With part = (lo, hi, n), x is rows lo:hi of a batch of n, and the
    draws are the whole batch's, sliced."""
    if r == 0:
        return x
    n, lo = _drawn(x, part)
    duv = torch.randint(-r, r + 1, (n, 2), generator=gen,
                        device=x.device)[lo:lo + x.shape[0]]
    return shift_batch(x, duv[:, 0], duv[:, 1])


def flip_batch(x, do_flip):
    """Mirror the images where do_flip (B,) is set, along the width."""
    return torch.where(do_flip[:, None, None, None], torch.flip(x, (2,)), x)


def rand_flip_batch(gen, x, flip_allowed, part=None):
    """Flip each image with probability 1/2 where flip_allowed (B,) is
    nonzero; part as in `rand_shift_batch`."""
    n, lo = _drawn(x, part)
    coin = torch.rand((n,), generator=gen,
                      device=x.device)[lo:lo + x.shape[0]] < 0.5
    return flip_batch(x, coin & (flip_allowed != 0))


def augment_presampled(gen, xb, yb, m_sym, r_shift=4, part=None):
    """Flip and shift an already sampled batch; with part = (lo, hi, n),
    xb and yb are rows lo:hi of a batch of n, flipped and shifted as the
    whole batch's rows are."""
    # One-hot labels: m_sym[argmax(y)] == y @ m_sym.
    flip_allowed = yb @ m_sym.to(yb.dtype)
    xb = rand_flip_batch(gen, xb, flip_allowed, part)
    return rand_shift_batch(gen, xb, r_shift, part), yb


def sample_indices(gen, n_examples, n, device):
    """n indices drawn uniformly with replacement from range(n_examples)."""
    return torch.randint(0, n_examples, (n,), generator=gen, device=device)


def augmented_batch(gen, x0, y, m_sym, n, r_shift=4, part=None):
    """A training batch of n examples sampled with replacement from
    (x0, y), flipped and shifted; with part = (lo, hi, n), only its rows
    lo:hi (a data-parallel rank's share of the same draws)."""
    idx = sample_indices(gen, x0.shape[0], n, x0.device)
    if part is not None:
        idx = idx[part[0]:part[1]]
    return augment_presampled(gen, x0[idx], y[idx], m_sym, r_shift, part)


def sampled_batch(gen, x0, y, n):
    """A batch of n examples sampled with replacement, not augmented."""
    idx = sample_indices(gen, x0.shape[0], n, x0.device)
    return x0[idx], y[idx]
