"""The port's data modules against mpnn_tpu on the CPU: the small synthetic
archives equal JAX's array for array (provenance and flip masks too),
`Dataset.padded_split` equals JAX's exactly, and the host iterators, the
padded-split memo and the missing-archive error behave as documented."""

import os

import numpy as np
import pytest
import torch

from mpnn_tpu.data import prep as jprep
from mpnn_tpu.data.dataset import Dataset as JDataset
from mpnn_tpu_torch.data import prep as tprep
from mpnn_tpu_torch.data.dataset import Dataset as TDataset
from tests.torch_threads import share_cores  # noqa: F401


@pytest.fixture(scope="module")
def archives(tmp_path_factory):
    jdir = str(tmp_path_factory.mktemp("jax"))
    tdir = str(tmp_path_factory.mktemp("port"))
    names = jprep.make_synthetic_archives(jdir, small=True)
    tprep.main(["--synthetic", "--small", "--data-dir", tdir])
    return names, jdir, tdir


def _load(path):
    return np.load(path, allow_pickle=True)["arr_0"][()]


def test_small_synthetic_archives_equal_jax(archives):
    names, jdir, tdir = archives
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == names
    assert len(names) == 6
    for name in names:
        j, t = _load(os.path.join(jdir, name)), _load(os.path.join(tdir, name))
        assert list(t) == list(j), name
        for k in j:
            if k == "provenance":
                assert t[k] == j[k], name
            else:
                assert t[k].dtype == j[k].dtype, (name, k)
                np.testing.assert_array_equal(t[k], j[k], err_msg=name)
    hybrid = _load(os.path.join(tdir, "hybrid.npz"))
    assert hybrid["m_sym"].tolist() == [0] * 5 + [1] * 5
    assert not _load(os.path.join(tdir, "mnist.npz"))["m_sym"].any()
    assert _load(os.path.join(tdir, "cifar-2.npz"))["y_tr"].shape == (512, 2)


@pytest.mark.parametrize("split,batch_size", [("tr", 128), ("ts", 100),
                                              ("ts", 256)])
def test_padded_split_equals_jax(archives, split, batch_size):
    _, jdir, tdir = archives
    j = JDataset(os.path.join(jdir, "cifar-5.npz"))
    t = TDataset(os.path.join(tdir, "cifar-5.npz"), device="cpu")
    assert t.x0_shape == j.x0_shape and t.y_shape == j.y_shape
    assert t.provenance == j.provenance and t.provenance["synthetic"]
    jout, tout = j.padded_split(split, batch_size), t.padded_split(
        split, batch_size)
    assert tout[3] == jout[3]
    for a, b in zip(tout[:3], jout[:3]):
        assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(t.train_arrays, j.train_arrays):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_padded_split_memo_is_lru_capped(archives):
    _, _, tdir = archives
    t = TDataset(os.path.join(tdir, "synth.npz"), device="cpu",
                 device_put=False)
    assert t._device_arrays == {}
    first = t.padded_split("tr", 64)
    assert t.padded_split("tr", 64) is first
    for b in (32, 16, 8):
        t.padded_split("ts", b)
    t.padded_split("tr", 64)  # refresh: now the most recently used
    t.padded_split("ts", 4)  # evicts ("ts", 32), the least recent
    assert len(t._padded_cache) == t.PADDED_CACHE_MAX == 4
    assert ("ts", 32) not in t._padded_cache
    assert t._padded_cache[("tr", 64)] is first
    x0s, ys, masks, count = t.padded_split("ts", 100)
    assert x0s.shape == (3, 100, 32, 32, 3) and count == 256
    assert float(masks.sum()) == 256 and not masks[2, 56:].any()
    assert not ys[2, 56:].any()


def test_host_iterators_equal_jax(archives):
    _, jdir, tdir = archives
    j = JDataset(os.path.join(jdir, "mnist.npz"), device_put=False)
    t = TDataset(os.path.join(tdir, "mnist.npz"), device_put=False)
    for jit, tit in ((j.training_set(200), t.training_set(200)),
                     (j.test_set(100), t.test_set(100))):
        jb, tb = list(jit), list(tit)
        assert len(tb) == len(jb) == 3
        for (tx, ty), (jx, jy) in zip(tb, jb):
            np.testing.assert_array_equal(tx, jx)
            np.testing.assert_array_equal(ty, jy)


def test_missing_archive_names_the_prep_command(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match=r"python -m mpnn_tpu_torch\.data\.prep "
                             r"--synthetic"):
        TDataset(str(tmp_path / "data" / "synth.npz"), device="cpu")
