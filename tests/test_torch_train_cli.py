"""The port's prep and training CLIs at the flagship's full width and
depth on the CPU (8 stages, 32x32x3, 10 classes), with jax blocked in
their process: `synth-ac` net 4 for 4 iterations at batch 16, t_log 2,
writes JAX's file set; `mpnn_tpu`'s read_net reads the checkpoint; a
resume continues from t = 4."""

import os
import subprocess
import sys

import jax

from mpnn_tpu.utils.serdes import read_net as j_read_net
from mpnn_tpu_torch.utils.serdes import read_net as t_read_net
from tests.torch_threads import child_env, share_cores  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_BLOCK_JAX = ("import sys; sys.modules['jax'] = None; "
              "sys.modules['mpnn_tpu'] = None; ")


def _run(code):
    env = child_env(PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _BLOCK_JAX + code], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


def test_full_width_cli_run_and_resume(tmp_path):
    d = str(tmp_path)
    train = ("from mpnn_tpu_torch import train; train.main(['synth-ac', "
             "'--net', '4', '--n-iter', '%d', '--t-log', '2', "
             "'--batch-size', '16', '--device', 'cpu', '--data-root', %r, "
             "'--out-root', %r%s]); ")
    out = _run("from mpnn_tpu_torch.data import prep; prep.main(["
               "'--synthetic', '--small', '--data-dir', %r]); "
               % os.path.join(d, "data")
               + train % (4, d, os.path.join(d, "nets"), ""))
    assert "[4 iters in" in out and out.count("Epoch") == 2
    root = os.path.join(d, "nets", "synth-ac")
    assert sorted(os.listdir(root)) == [
        "0004-log.txt", "0004-stats", "0004-stats.npy", "0004.npy",
        "MANIFEST.json"]
    assert sorted(os.listdir(os.path.join(root, "0004-stats"))) == [
        "00000002.npy", "00000004.npy"]
    net, params, state, extra = j_read_net(os.path.join(root, "0004.npy"))
    assert type(net).__name__ == "ActorNet" and int(extra["t"]) == 4
    assert sum(l.name == "ReConvMax" for l in net.layers) == 8
    assert net.hypers.x0_shape == (32, 32, 3)
    assert len(jax.tree.leaves(extra["vel"])) == len(jax.tree.leaves(params))
    out = _run(train % (5, d, os.path.join(d, "nets"), ", '--resume'"))
    assert "[resuming %s/0004.npy at t=4]" % root in out
    assert "[1 iters in" in out
    assert os.path.exists(os.path.join(root, "0004-stats", "00000005.npy"))
    assert t_read_net(os.path.join(root, "0004.npy"), "cpu")[3]["t"] == 5
