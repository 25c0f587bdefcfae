"""Dataset container with the reference's on-disk `.npz` schema
(counterpart of `mpnn_tpu/data/dataset.py`, without its mesh staging).

An archive holds one pickled dict under `arr_0` with keys
`{x0_tr, x0_ts, y_tr, y_ts, m_sym}` (float images NHWC in [0, 1], one-hot
labels, a per-class horizontal-flip-symmetry mask), and, when this
project's prep wrote it, `provenance`.

The training split is staged on the device once; the train loop samples
and augments batches there. Full-split evaluation reads padded batches of
a fixed shape with a validity mask, memoized per (split, batch size)."""

import os

import numpy as np
import torch

__all__ = ["Dataset"]


def _ceil_to(n, m):
    return -(-n // m) * m


class Dataset:
    """Loads the reference `.npz` schema and stages splits on `device`.

    `Dataset(path)` raises FileNotFoundError naming the prep command when
    the archive is missing; pass `device_put=False` to keep the arrays on
    the host only."""

    # padded_split memo cap: 2 splits x 2 batch sizes; beyond that the
    # least recently used device buffers are dropped.
    PADDED_CACHE_MAX = 4

    def __init__(self, path_or_dict, device="cuda", device_put=True):
        if isinstance(path_or_dict, str):
            if not os.path.exists(path_or_dict):
                raise FileNotFoundError(
                    "dataset archive %r not found; write the synthetic "
                    "stand-ins with `python -m mpnn_tpu_torch.data.prep "
                    "--synthetic --data-dir DIR`" % path_or_dict)
            archive = np.load(path_or_dict, allow_pickle=True)["arr_0"][()]
        else:
            archive = path_or_dict
        self.x0_tr = np.asarray(archive["x0_tr"], np.float32)
        self.x0_ts = np.asarray(archive["x0_ts"], np.float32)
        self.y_tr = np.asarray(archive["y_tr"], np.float32)
        self.y_ts = np.asarray(archive["y_ts"], np.float32)
        self.m_sym = np.asarray(archive["m_sym"], np.float32)
        # {"synthetic": bool, ...} for archives this project's prep wrote;
        # None for archives without the record. Copied into
        # <out>/<expt>/MANIFEST.json by the trainer.
        self.provenance = archive.get("provenance", None)
        if self.provenance is not None:
            self.provenance = dict(self.provenance)
        self.path = path_or_dict if isinstance(path_or_dict, str) else None
        self.device = torch.device(device)
        self._device_arrays = {}
        self._padded_cache = {}
        if device_put:
            self.stage()

    def _put(self, a):
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    @property
    def x0_shape(self):
        return self.x0_tr.shape[1:]

    @property
    def y_shape(self):
        return self.y_tr.shape[1:]

    def stage(self):
        """Copy the training split and the flip mask to the device."""
        self._device_arrays = {
            "x0_tr": self._put(self.x0_tr),
            "y_tr": self._put(self.y_tr),
            "m_sym": self._put(self.m_sym),
        }
        return self

    @property
    def train_arrays(self):
        """(x0_tr, y_tr, m_sym) on the device, for the train loop."""
        if not self._device_arrays:
            self.stage()
        d = self._device_arrays
        return d["x0_tr"], d["y_tr"], d["m_sym"]

    def padded_split(self, split, batch_size):
        """(x0s, ys, masks, count): split "tr" or "ts" padded with zeros to
        a multiple of batch_size and reshaped to (n_batches, batch_size,
        ...), on the device; `masks` is 1.0 for real examples and 0.0 for
        padding, `count` the number of real examples. The eval sums the
        masked per-example stats and divides by count, the reference's
        sum-over-split / count. Memoized per (split, batch_size), at most
        PADDED_CACHE_MAX entries, least recently used dropped first."""
        key = (split, batch_size)
        hit = self._padded_cache.pop(key, None)
        if hit is not None:
            self._padded_cache[key] = hit  # most recently used last
            return hit
        x0 = self.x0_tr if split == "tr" else self.x0_ts
        y = self.y_tr if split == "tr" else self.y_ts
        n = len(x0)
        pad = _ceil_to(n, batch_size) - n
        x0p = np.concatenate([x0, np.zeros((pad,) + x0.shape[1:], x0.dtype)])
        yp = np.concatenate([y, np.zeros((pad,) + y.shape[1:], y.dtype)])
        mask = np.concatenate([np.ones(n, np.float32),
                               np.zeros(pad, np.float32)])
        nb = (n + pad) // batch_size
        out = (self._put(x0p.reshape((nb, batch_size) + x0.shape[1:])),
               self._put(yp.reshape((nb, batch_size) + y.shape[1:])),
               self._put(mask.reshape(nb, batch_size)), n)
        while len(self._padded_cache) >= self.PADDED_CACHE_MAX:
            self._padded_cache.pop(next(iter(self._padded_cache)))
        self._padded_cache[key] = out
        return out

    # Host iterators of numpy batches, as the reference's Dataset has.

    def training_set(self, n=128):
        yield from _full_set(self.x0_tr, self.y_tr, n)

    def test_set(self, n=128):
        yield from _full_set(self.x0_ts, self.y_ts, n)


def _full_set(x0, y, n):
    for i in range(0, len(x0), n):
        yield x0[i:i + n], y[i:i + n]
