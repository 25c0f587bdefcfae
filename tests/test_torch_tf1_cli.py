"""`python -m mpnn_tpu_torch.train --pyramid-tf1 --maxpool-tf1` against
mpnn_tpu's trainer under the same modes (what `scripts/train-nets` sets
for those flags), on the CPU at the size of tests/test_torch_cli.py: the
flags set the port's config before the net is built, and the run writes
JAX's files in JAX's schema, for a small SR net whose output each mode
changes (a 2-scale pyramid, a MaxPool)."""

import json
import os
from types import SimpleNamespace as Ns

import numpy as np
import jax

from mpnn_tpu import experiments as jcfg
from mpnn_tpu.data.prep import save_archive
from mpnn_tpu.data.synth import make_synthetic
from mpnn_tpu.ops import config as jconfig
from mpnn_tpu.ops import layers as J
from mpnn_tpu.train import train_experiment as j_train_experiment
from mpnn_tpu_torch import experiments as tcfg
from mpnn_tpu_torch import train as ttrain
from mpnn_tpu_torch.ops import config as tconfig
from mpnn_tpu_torch.ops import layers as T

from .test_torch_cli import _files, _schema
from .test_torch_zoo import W_CLS, modes  # noqa: F401 (fixture)
from tests.torch_threads import share_cores  # noqa: F401


def _tiny_net(L):
    """ToPyramid(2) -> Select -> Conv -> Rect -> MaxPool -> Dropout ->
    GlobalMaxPool -> LinTrans -> Softmax -> SuperclassCrossEntropyError,
    an SR net on 16x16x3."""
    from mpnn_tpu.models.sr import SRNet as JSRNet
    from mpnn_tpu_torch.models.sr import SRNet as TSRNet
    leaf = L.Chain(name="Leaf", comps=[
        L.Select(i=-1), L.Conv(n_chan=4, supp=3, k_l2=1e-4), L.Rect(),
        L.MaxPool(supp=3, stride=2), L.Dropout(λ=0.5), L.GlobalMaxPool(),
        L.LinTrans(n_chan=2, k_l2=1e-4), L.Softmax(),
        L.SuperclassCrossEntropyError(w_cls=W_CLS)])
    root = L.Chain(name="ToPyramid", sinks=[leaf],
                   comps=[L.ToPyramid(n_scales=2)])
    Net = JSRNet if L is J else TSRNet
    return Net(x0_shape=(16, 16, 3), y_shape=(10,), root=root)


def _zoo_registry(L, seen):
    def ctor(x0_shape, y_shape):
        # The modes as the net is built.
        seen.append((tconfig.pyramid_tf1, tconfig.maxpool_tf1))
        return _tiny_net(L)
    return lambda: {"tiny-zoo": Ns(dataset="data/tiny.npz", tau=None,
                                   nets=[ctor])}


def test_tf1_flags_set_modes_and_write_jax_files(tmp_path, monkeypatch,
                                                 modes):  # noqa: F811
    arch = make_synthetic(n_tr=40, n_ts=24, h=16, w=16, c=3, n_cls=10,
                          seed=1)
    save_archive(str(tmp_path / "data" / "tiny.npz"), arch)
    seen = []
    monkeypatch.setattr(jcfg, "make_experiments", _zoo_registry(J, []))
    monkeypatch.setattr(tcfg, "make_experiments", _zoo_registry(T, seen))
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    jconfig.set_pyramid_tf1(True)
    jconfig.set_maxpool_tf1(True)
    j_train_experiment("tiny-zoo", n_iter=2, t_log=2, batch_size=8,
                       data_root=str(tmp_path), out_root=jout,
                       verbose=False)
    ttrain.main(["tiny-zoo", "--n-iter", "2", "--t-log", "2",
                 "--batch-size", "8", "--pyramid-tf1", "--maxpool-tf1",
                 "--device", "cpu", "--data-root", str(tmp_path),
                 "--out-root", tout])
    assert seen == [(True, True)]
    files = _files(jout)
    assert _files(tout) == files and "tiny-zoo/0000.npy" in files
    with open(os.path.join(jout, "tiny-zoo/MANIFEST.json")) as f:
        jman = json.load(f)
    with open(os.path.join(tout, "tiny-zoo/MANIFEST.json")) as f:
        assert json.load(f) == jman
    for name in files:
        if not name.endswith(".npy"):
            continue
        j = np.load(os.path.join(jout, name), allow_pickle=True)[()]
        t = np.load(os.path.join(tout, name), allow_pickle=True)[()]
        if name.endswith("0000.npy"):
            # Same structure, hypers (w_cls and λ included), dtypes and
            # shapes; values differ (the packages draw different inits).
            j, t = (jax.tree.map(lambda a: (a.dtype.str, a.shape)
                                 if isinstance(a, np.ndarray) else a, r)
                    for r in (j, t))
            assert t == j
        assert _schema(t) == _schema(j), name
