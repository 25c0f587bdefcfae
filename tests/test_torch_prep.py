"""The PyTorch port's real-data prep (mpnn_tpu_torch.data.prep) against
mpnn_tpu's on the fixtures of tests/test_prep.py: every function, the
archives `prepare_from_files` and `download_and_prepare` (file:// URLs)
write, and the prep CLI's, equal mpnn_tpu's bit for bit."""

import os
import tarfile

import numpy as np
import pytest

from mpnn_tpu.data import prep as jprep
from mpnn_tpu_torch.data import prep as tprep

from .test_prep import _fake_cifar_batches, _fake_mnist_mat
from tests.torch_threads import share_cores  # noqa: F401

ARCHIVES = ["cifar-10.npz", "cifar-2.npz", "cifar-5.npz", "hybrid.npz",
            "mnist.npz"]


def _equal(a, b):
    """Bit-for-bit equality of archives (dicts of arrays and provenance)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_equal(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return a == b


def _load(path):
    return np.load(path, allow_pickle=True)["arr_0"][()]


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    """A scipy .mat of MNIST's train0..9 / test0..9 rows and the CIFAR-10
    batches tarball, in their real on-disk formats."""
    import scipy.io as io
    d = tmp_path_factory.mktemp("prep-fixtures")
    mat = d / "mnist.mat"
    io.savemat(str(mat), _fake_mnist_mat())
    rng = np.random.RandomState(7)
    batch_dir = d / "cifar-10-batches-mat"
    batch_dir.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        io.savemat(str(batch_dir / f"{name}.mat"),
                   {"data": (rng.rand(6, 3072) * 255).astype(np.uint8),
                    "labels": rng.randint(0, 10, (6, 1))})
    tgz = d / "cifar10.tar.gz"
    with tarfile.open(str(tgz), "w:gz") as tar:
        tar.add(str(batch_dir), arcname="cifar-10-batches-mat")
    return mat, tgz


def test_constants_match():
    for name in ("MNIST_URL", "CIFAR10_URL", "CIFAR2_CLASSES",
                 "CIFAR5_CLASSES", "HYBRID_CLASSES"):
        assert _equal(np.asarray(getattr(tprep, name)),
                      np.asarray(getattr(jprep, name))), name


def test_functions_match_jax():
    """format_mnist, format_cifar10, project_superclasses, recolor,
    make_hybrid and _resize_bilinear, each on the same inputs."""
    mat = _fake_mnist_mat()
    tr, ts = _fake_cifar_batches(16)
    m = tprep.format_mnist(mat)
    assert _equal(m, jprep.format_mnist(mat))
    c = tprep.format_cifar10(tr, ts)
    assert _equal(c, jprep.format_cifar10(tr, ts))
    for w in (tprep.CIFAR2_CLASSES, tprep.CIFAR5_CLASSES):
        assert _equal(tprep.project_superclasses(c, w),
                      jprep.project_superclasses(c, w))
    x = np.random.RandomState(2).rand(5, 8, 8, 1).astype(np.float32)
    assert _equal(tprep.recolor(x, np.random.RandomState(0)),
                  jprep.recolor(x, np.random.RandomState(0)))
    assert _equal(tprep.make_hybrid(m, c, seed=0),
                  jprep.make_hybrid(m, c, seed=0))
    assert _equal(tprep._resize_bilinear(x, 13, 5),
                  jprep._resize_bilinear(x, 13, 5))


def test_prepare_from_files_matches_jax(tmp_path, fixture_files):
    mat, tgz = fixture_files
    names = tprep.prepare_from_files(str(tmp_path / "t"), str(mat),
                                     str(tgz), verbose=False)
    assert names == jprep.prepare_from_files(str(tmp_path / "j"), str(mat),
                                             str(tgz), verbose=False)
    assert names == ARCHIVES
    for name in names:
        assert _equal(_load(tmp_path / "t" / name),
                      _load(tmp_path / "j" / name)), name


def test_download_and_prepare_file_urls_and_cli(tmp_path, fixture_files):
    """download_and_prepare from file:// URLs, and the CLI with
    --mnist-url / --cifar-url, write mpnn_tpu's archives."""
    mat, tgz = fixture_files
    urls = dict(mnist_url=mat.as_uri(), cifar_url=tgz.as_uri())
    assert tprep.download_and_prepare(str(tmp_path / "t"), **urls) \
        == ARCHIVES
    jprep.download_and_prepare(str(tmp_path / "j"), **urls)
    tprep.main(["--data-dir", str(tmp_path / "cli"), "--mnist-url",
                urls["mnist_url"], "--cifar-url", urls["cifar_url"]])
    assert sorted(os.listdir(tmp_path / "cli")) == ARCHIVES
    for name in ARCHIVES:
        want = _load(tmp_path / "j" / name)
        assert _equal(_load(tmp_path / "t" / name), want), name
        assert _equal(_load(tmp_path / "cli" / name), want), name
