"""Dataset preparation (counterpart of `mpnn_tpu/data/prep.py` and
`scripts/prep-data`), numpy and scipy only.

Writes `.npz` archives in the reference's schema `{x0_tr, x0_ts, y_tr,
y_ts, m_sym}`:

- the real datasets from their on-disk formats (`prepare_from_files`):
  MNIST from its scipy `.mat` (resized 28->32 bilinear, scaled to [0, 1],
  m_sym zeros), CIFAR-10 from the `cifar-10-batches-mat` tarball
  (gamma-decoded (v/255)^2.2, m_sym ones), CIFAR-2 / CIFAR-5 as its
  superclass projections, and the hybrid set (MNIST digits 0-4
  recoloured with seeded 2-colour gradients, CIFAR classes 0, 1, 4, 6, 7,
  flip mask [0]*5 + [1]*5); `download_and_prepare` fetches the two files
  first, from any URL urlretrieve takes (file:// included);
- deterministic synthetic stand-ins for every dataset name of the
  experiment registry (`make_synthetic_archives`), with `mpnn_tpu`'s seeds
  and flip masks, so both packages train on the same arrays.

The arrays equal `mpnn_tpu`'s bit for bit.

    python -m mpnn_tpu_torch.data.prep --synthetic [--small] --data-dir data
    python -m mpnn_tpu_torch.data.prep --data-dir data \\
        --mnist-url file:///path/mnist_all.mat \\
        --cifar-url file:///path/cifar-10-matlab.tar.gz
"""

import os
import zlib
from argparse import ArgumentParser
from os.path import join

import numpy as np

from .synth import TIERED_V2, make_synthetic, make_synthetic_tiered

__all__ = ["save_archive", "synthetic_archive", "make_synthetic_archives",
           "format_mnist", "format_cifar10", "project_superclasses",
           "recolor", "make_hybrid", "prepare_from_files",
           "download_and_prepare", "main"]

MNIST_URL = "http://www.cs.nyu.edu/~roweis/data/mnist_all.mat"
CIFAR10_URL = "https://www.cs.toronto.edu/~kriz/cifar-10-matlab.tar.gz"

CIFAR2_CLASSES = np.array([
    [0, 0, 0, 0, 0, 0, 0, 1, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 0, 1, 1]])
CIFAR5_CLASSES = np.array([
    [0, 0, 0, 1, 0, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 1, 0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 0, 0, 1, 0, 0],
    [1, 1, 1, 0, 0, 0, 1, 0, 1, 1]])
# Hybrid keeps MNIST digits 0-4 and CIFAR classes 0, 1, 4, 6, 7 (of the
# 20 classes of MNIST then CIFAR-10).
HYBRID_CLASSES = [0, 1, 2, 3, 4, 10, 11, 14, 16, 17]


def _resize_bilinear(x, h, w):
    """Batch bilinear resize (half-pixel centres) in numpy, for the
    reference's scipy.misc.imresize."""
    n, h0, w0, c = x.shape
    ys = (np.arange(h) + 0.5) * h0 / h - 0.5
    xs = (np.arange(w) + 0.5) * w0 / w - 0.5
    y0 = np.clip(np.floor(ys).astype(int), 0, h0 - 1)
    x0 = np.clip(np.floor(xs).astype(int), 0, w0 - 1)
    y1 = np.clip(y0 + 1, 0, h0 - 1)
    x1 = np.clip(x0 + 1, 0, w0 - 1)
    wy = np.clip(ys - y0, 0, 1)[None, :, None, None]
    wx = np.clip(xs - x0, 0, 1)[None, None, :, None]
    top = x[:, y0][:, :, x0] * (1 - wx) + x[:, y0][:, :, x1] * wx
    bot = x[:, y1][:, :, x0] * (1 - wx) + x[:, y1][:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def format_mnist(mat):
    """mat: dict with train0..train9 / test0..test9 (N, 784) uint8 arrays."""
    def split(prefix):
        xs, ys = [], []
        for i in range(10):
            a = np.reshape(mat[f"{prefix}{i}"], (-1, 28, 28, 1)) / 255.0
            xs.append(_resize_bilinear(a, 32, 32))
            ys.append(np.ones((len(a), 1), "f") * np.identity(10, "f")[i])
        return (np.vstack(xs).astype(np.float32),
                np.vstack(ys).astype(np.float32))

    x0_tr, y_tr = split("train")
    x0_ts, y_ts = split("test")
    return {"m_sym": np.zeros(10), "x0_tr": x0_tr, "x0_ts": x0_ts,
            "y_tr": y_tr, "y_ts": y_ts}


def format_cifar10(train_batches, test_batches):
    """Batches: dicts with 'data' (N, 3072) uint8 and 'labels' (N, 1)."""
    def fmt_x(batch):
        return np.float32(np.transpose(
            np.reshape(np.float64(batch["data"]) ** 2.2, (-1, 3, 32, 32)),
            (0, 2, 3, 1)) / 255 ** 2.2)

    def fmt_y(batch):
        return np.float32(np.asarray(batch["labels"]).reshape(-1, 1)
                          == np.arange(10))

    return {
        "m_sym": np.ones(10),
        "x0_tr": np.vstack([fmt_x(b) for b in train_batches]),
        "x0_ts": np.vstack([fmt_x(b) for b in test_batches]),
        "y_tr": np.vstack([fmt_y(b) for b in train_batches]),
        "y_ts": np.vstack([fmt_y(b) for b in test_batches])}


def project_superclasses(cifar10, w_cls):
    n = len(w_cls)
    return {"m_sym": np.ones(n),
            "x0_tr": cifar10["x0_tr"], "x0_ts": cifar10["x0_ts"],
            "y_tr": np.dot(cifar10["y_tr"], w_cls.T),
            "y_ts": np.dot(cifar10["y_ts"], w_cls.T)}


def recolor(x, rand, d_min=0.3):
    """Random 2-colour gradient recolouring of grayscale images: draw c0,
    c1 in [0,1]^3 with ||c1-c0|| >= d_min, map v -> c0 + (c1-c0)*v. The
    draws come in the reference's order, so a seed gives its colours."""
    out = []
    for x_i in x:
        c0 = np.float32(rand.rand(3))
        c1 = np.float32(rand.rand(3))
        while np.sqrt(np.sum(np.square(c1 - c0))) < d_min:
            c1 = np.float32(rand.rand(3))
        out.append(c0 + (c1 - c0) * x_i)
    return np.array(out, np.float32)


def make_hybrid(mnist, cifar10, seed=0):
    """Recoloured-MNIST + CIFAR hybrid with 10 kept classes, grouped by
    class in kept-class order."""
    rand = np.random.RandomState(seed)
    x0_tr = np.vstack([recolor(mnist["x0_tr"], rand), cifar10["x0_tr"]])
    x0_ts = np.vstack([recolor(mnist["x0_ts"], rand), cifar10["x0_ts"]])
    y_tr = np.vstack([
        np.hstack([mnist["y_tr"], np.zeros_like(mnist["y_tr"])]),
        np.hstack([np.zeros_like(cifar10["y_tr"]), cifar10["y_tr"]])])
    y_ts = np.vstack([
        np.hstack([mnist["y_ts"], np.zeros_like(mnist["y_ts"])]),
        np.hstack([np.zeros_like(cifar10["y_ts"]), cifar10["y_ts"]])])

    def keep(x0, y):
        masks = [np.argmax(y, 1) == c for c in HYBRID_CLASSES]
        x0_out = np.vstack([x0[m] for m in masks])
        y_out = np.vstack([
            np.float32(np.ones((np.sum(m), 1))
                       * (np.arange(len(HYBRID_CLASSES)) == c))
            for c, m in enumerate(masks)])
        return x0_out, y_out

    x0_tr, y_tr = keep(x0_tr, y_tr)
    x0_ts, y_ts = keep(x0_ts, y_ts)
    return {"m_sym": np.array([0] * 5 + [1] * 5),
            "x0_tr": x0_tr, "x0_ts": x0_ts, "y_tr": y_tr, "y_ts": y_ts}


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


def prepare_from_files(data_dir, mnist_mat_path, cifar_tgz_path,
                       verbose=True):
    """Untar, loadmat, format and combine: the five real archives
    (mnist, cifar-10, cifar-2, cifar-5, hybrid) in `data_dir` from the
    MNIST `.mat` and the CIFAR-10 batches tarball, each with its
    provenance. Needs no network. Returns the sorted file names."""
    from tempfile import TemporaryDirectory
    from shutil import unpack_archive
    import scipy.io as io

    os.makedirs(data_dir, exist_ok=True)
    mnist = format_mnist(io.loadmat(mnist_mat_path))
    mnist["provenance"] = {"synthetic": False, "source": MNIST_URL}
    save_archive(join(data_dir, "mnist.npz"), mnist)

    with TemporaryDirectory() as tmp:
        unpack_archive(cifar_tgz_path, tmp, format="gztar")
        base = join(tmp, "cifar-10-batches-mat")
        tr = [io.loadmat(join(base, "data_batch_%i.mat" % i))
              for i in range(1, 6)]
        ts = [io.loadmat(join(base, "test_batch.mat"))]
    cifar10 = format_cifar10(tr, ts)
    cifar10["provenance"] = {"synthetic": False, "source": CIFAR10_URL}
    save_archive(join(data_dir, "cifar-10.npz"), cifar10)
    for name, classes in (("cifar-2.npz", CIFAR2_CLASSES),
                          ("cifar-5.npz", CIFAR5_CLASSES)):
        arch = project_superclasses(cifar10, classes)
        arch["provenance"] = {"synthetic": False, "source": CIFAR10_URL}
        save_archive(join(data_dir, name), arch)

    if verbose:
        print("Combining MNIST and CIFAR-10...", flush=True)
    hybrid = make_hybrid(mnist, cifar10, seed=0)
    hybrid["provenance"] = {"synthetic": False,
                            "source": [MNIST_URL, CIFAR10_URL]}
    save_archive(join(data_dir, "hybrid.npz"), hybrid)
    return sorted(["mnist.npz", "cifar-10.npz", "cifar-2.npz",
                   "cifar-5.npz", "hybrid.npz"])


def download_and_prepare(data_dir="data", mnist_url=None, cifar_url=None):
    """Fetch the MNIST `.mat` and the CIFAR-10 tarball, then
    `prepare_from_files`. `mnist_url` / `cifar_url` take any URL that
    urlretrieve takes, file:// included (the reference's sources by
    default, which need the network)."""
    from tempfile import TemporaryDirectory
    from urllib.request import urlretrieve

    mnist_url = mnist_url or MNIST_URL
    cifar_url = cifar_url or CIFAR10_URL
    with TemporaryDirectory() as tmp:
        print(f"Downloading MNIST ({mnist_url})...", flush=True)
        urlretrieve(mnist_url, join(tmp, "mnist.mat"))
        print(f"Downloading CIFAR-10 ({cifar_url})...", flush=True)
        urlretrieve(cifar_url, join(tmp, "cifar10.tar.gz"))
        return prepare_from_files(data_dir, join(tmp, "mnist.mat"),
                                  join(tmp, "cifar10.tar.gz"))


def main(argv=None):
    parser = ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--synthetic", action="store_true",
                        help="write synthetic stand-ins (no network)")
    parser.add_argument("--small", action="store_true",
                        help="with --synthetic: 512 train / 256 test "
                             "examples per archive")
    parser.add_argument("--data-dir", default="data")
    parser.add_argument("--mnist-url", default=None,
                        help="the MNIST .mat's source (any urlretrieve "
                             "URL, file:// for a local file)")
    parser.add_argument("--cifar-url", default=None,
                        help="the CIFAR-10 tarball's source (any "
                             "urlretrieve URL, file:// included)")
    args = parser.parse_args(argv)
    if args.synthetic:
        names = make_synthetic_archives(args.data_dir, small=args.small)
        print("Wrote synthetic archives: %s" % ", ".join(names))
    else:
        download_and_prepare(args.data_dir, mnist_url=args.mnist_url,
                             cifar_url=args.cifar_url)
        print("Done.")


if __name__ == "__main__":
    main()
