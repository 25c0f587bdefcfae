"""Augmentation of the PyTorch port (mpnn_tpu_torch.data.augment) against
mpnn_tpu's on the CPU. torch's random streams are not JAX's, so the pure
halves (shift_batch, flip_batch) are fed the draws JAX made and must give
JAX's images (to 1e-6); the port's own sampling is checked for its ranges:
shifts within [-r, r], indices within the split, flips only where m_sym
allows."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpnn_tpu.data import augment as JA
from mpnn_tpu_torch.data import augment as TA

from .test_augment import np_shift_oracle
from tests.torch_threads import share_cores  # noqa: F401


def _draws_shift(key, b, r):
    return np.array(jax.random.randint(key, (b, 2), -r, r + 1))


@pytest.mark.parametrize("r", [1, 3, 4])
def test_shift_matches_jax_on_its_draws(r):
    rng = np.random.RandomState(0)
    x = rng.rand(24, 10, 8, 3).astype(np.float32)
    key = jax.random.PRNGKey(r)
    jout = np.asarray(JA.rand_shift_batch(key, jnp.asarray(x), r))
    duv = _draws_shift(key, 24, r)
    tout = TA.shift_batch(torch.as_tensor(x), torch.as_tensor(duv[:, 0]),
                          torch.as_tensor(duv[:, 1])).numpy()
    np.testing.assert_allclose(tout, jout, atol=1e-6, rtol=0)
    for i in range(24):  # and the reference's slice bookkeeping
        np.testing.assert_allclose(
            tout[i], np_shift_oracle(x[i], int(duv[i, 0]), int(duv[i, 1])),
            atol=1e-6)


def test_flip_matches_jax_on_its_draws():
    rng = np.random.RandomState(1)
    x = rng.rand(64, 4, 6, 2).astype(np.float32)
    allowed = np.array([0.0, 1.0] * 32, np.float32)
    key = jax.random.PRNGKey(3)
    jout = np.asarray(JA.rand_flip_batch(key, jnp.asarray(x),
                                         jnp.asarray(allowed)))
    coin = np.array(jax.random.bernoulli(key, 0.5, (64,)))
    do_flip = torch.as_tensor(coin) & torch.as_tensor(allowed != 0)
    tout = TA.flip_batch(torch.as_tensor(x), do_flip).numpy()
    np.testing.assert_array_equal(tout, jout)
    assert 0 < do_flip.sum() < 32


def test_augmented_batch_matches_jax_on_its_draws():
    """Sampling, the class-gated flip and the shift together, with JAX's
    key splits: augmented_batch -> (k_idx, k_aug), augment_presampled ->
    (k_flip, k_shift)."""
    rng = np.random.RandomState(2)
    x0 = rng.rand(40, 8, 8, 3).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 40)]
    m_sym = np.array([0] * 5 + [1] * 5, np.float32)
    key = jax.random.PRNGKey(5)
    jx, jy = JA.augmented_batch(key, jnp.asarray(x0), jnp.asarray(y),
                                jnp.asarray(m_sym), 16, 4)
    k_idx, k_aug = jax.random.split(key)
    k_flip, k_shift = jax.random.split(k_aug)
    idx = np.array(jax.random.randint(k_idx, (16,), 0, 40))
    coin = np.array(jax.random.bernoulli(k_flip, 0.5, (16,)))
    duv = _draws_shift(k_shift, 16, 4)
    xb, yb = torch.as_tensor(x0[idx]), torch.as_tensor(y[idx])
    allowed = yb @ torch.as_tensor(m_sym) != 0
    tx = TA.shift_batch(TA.flip_batch(xb, torch.as_tensor(coin) & allowed),
                        torch.as_tensor(duv[:, 0]),
                        torch.as_tensor(duv[:, 1]))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-6)
    np.testing.assert_array_equal(yb.numpy(), np.asarray(jy))


def test_shift_draws_stay_in_range():
    """Every image moves by its own (du, dv) in [-r, r], and every value
    of the range is drawn: read back from an image whose pixels are their
    own positions."""
    h = w = 16
    r = 3
    pos = torch.arange(h * w, dtype=torch.float32).reshape(1, h, w, 1)
    x = pos.repeat(512, 1, 1, 1)
    out = TA.rand_shift_batch(torch.Generator().manual_seed(0), x, r)
    src = out[:, h // 2, w // 2, 0].long()  # the centre is always covered
    du, dv = src // w - h // 2, src % w - w // 2
    for d in (du, dv):
        assert sorted(set(d.tolist())) == list(range(-r, r + 1))
    assert TA.rand_shift_batch(None, x, 0) is x


def test_sampling_stays_in_split_and_flips_only_symmetric_classes():
    """Indices fall in the split (each image is its index), labels follow
    their images, and only classes marked in m_sym are flipped, about half
    of them."""
    n, b = 50, 2048
    h, w = 4, 6
    col = torch.arange(w, dtype=torch.float32)
    x0 = (1000.0 * torch.arange(n, dtype=torch.float32)[:, None, None, None]
          + col[None, None, :, None]).expand(n, h, w, 1).contiguous()
    cls = torch.arange(n) % 10
    y = torch.eye(10)[cls]
    m_sym = torch.tensor([0.0] * 5 + [1.0] * 5)
    gen = torch.Generator().manual_seed(1)
    xb, yb = TA.augmented_batch(gen, x0, y, m_sym, b, r_shift=0)
    idx = (xb[:, 0, 0, 0] // 1000).long()
    assert ((idx >= 0) & (idx < n)).all() and len(set(idx.tolist())) == n
    assert torch.equal(yb, y[idx])
    flipped = xb[:, 0, 0, 0] % 1000 == w - 1
    sym = m_sym[cls[idx]] != 0
    assert not flipped[~sym].any()
    assert 0.4 < flipped[sym].float().mean() < 0.6
    xs, ys = TA.sampled_batch(gen, x0, y, b)
    idx = (xs[:, 0, 0, 0] // 1000).long()
    assert torch.equal(ys, y[idx]) and torch.equal(xs, x0[idx])
