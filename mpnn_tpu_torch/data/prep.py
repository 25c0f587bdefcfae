"""Dataset preparation, synthetic path (counterpart of the
`make_synthetic_archives` path of `mpnn_tpu/data/prep.py`).

Writes deterministic stand-ins for every dataset name of the experiment
registry, in the reference's `.npz` schema, with the same seeds and flip
masks as `mpnn_tpu`, so both packages train on the same arrays. The
real-data path (MNIST `.mat`, the CIFAR-10 tarball, the hybrid set) is not
ported.

    python -m mpnn_tpu_torch.data.prep --synthetic [--small] --data-dir data
"""

import os
import zlib
from argparse import ArgumentParser
from os.path import join

import numpy as np

from .synth import TIERED_V2, make_synthetic, make_synthetic_tiered

__all__ = ["save_archive", "synthetic_archive", "make_synthetic_archives",
           "main"]

# The registry's dataset file names and their class counts.
SPECS = {"synth.npz": dict(n_cls=10), "mnist.npz": dict(n_cls=10),
         "cifar-10.npz": dict(n_cls=10), "cifar-5.npz": dict(n_cls=5),
         "cifar-2.npz": dict(n_cls=2), "hybrid.npz": dict(n_cls=10)}


def save_archive(path, archive):
    """np.savez_compressed of the single pickled dict (read back as
    `np.load(path, allow_pickle=True)["arr_0"][()]`)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, archive)


def synthetic_archive(name, small=False):
    """The synthetic stand-in of one registry dataset file name (a key of
    `SPECS`), seeded from the name: with small, 512 train / 256 test
    examples of `make_synthetic`; otherwise the tiered easy/hard set of
    50,000 / 2,000 (MNIST stays the easy generator at 4,096 / 1,024)."""
    spec = SPECS[name]
    # zlib.crc32 is stable across processes (hash() is salted).
    seed = zlib.crc32(name.encode()) % (2 ** 31)
    if name != "mnist.npz" and not small:
        arch = make_synthetic_tiered(
            n_tr=50000, n_ts=2000, h=32, w=32, c=3, n_cls=spec["n_cls"],
            seed=seed, **TIERED_V2)
    else:
        size = dict(n_tr=512, n_ts=256) if small else dict(n_tr=4096,
                                                           n_ts=1024)
        arch = make_synthetic(h=32, w=32, c=3, seed=seed, **spec, **size)
    if name == "mnist.npz":
        arch["m_sym"] = np.zeros(spec["n_cls"])
    elif name == "hybrid.npz":
        arch["m_sym"] = np.array([0] * 5 + [1] * 5)
    return arch


def make_synthetic_archives(data_dir="data", small=False):
    """One synthetic archive per registry dataset name in `data_dir`
    (`synthetic_archive`); returns the sorted file names."""
    os.makedirs(data_dir, exist_ok=True)
    for name in SPECS:
        save_archive(join(data_dir, name), synthetic_archive(name, small))
    return sorted(SPECS)


def main(argv=None):
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--synthetic", action="store_true", required=True,
                        help="write synthetic stand-ins (the only path "
                             "ported)")
    parser.add_argument("--small", action="store_true",
                        help="512 train / 256 test examples per archive")
    parser.add_argument("--data-dir", default="data")
    args = parser.parse_args(argv)
    names = make_synthetic_archives(args.data_dir, small=args.small)
    print("Wrote synthetic archives: %s" % ", ".join(names))


if __name__ == "__main__":
    main()
