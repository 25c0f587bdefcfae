"""The port's multi-rank dry run (`python -m mpnn_tpu_torch.dryrun N
--device cpu`, the counterpart of `__graft_entry__.dryrun_multichip`) on
the CPU: 2 and 4 gloo ranks run the reduced-depth flagship's step (on
a 2x1 and a 2x2 ('data', 'model') mesh) and the sweep mesh's step, in
a process with jax and mpnn_tpu blocked, and print mpnn_tpu's OK lines
with the device."""

import os
import subprocess
import sys

import pytest

from tests.torch_threads import share_cores  # noqa: F401

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['mpnn_tpu'] = None; "
            "from mpnn_tpu_torch.dryrun import main; "
            "main(['%d', '--device', 'cpu'])" % n)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       env=dict(os.environ, PYTHONPATH=REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.splitlines()
    where = " device=cpu backend=gloo OK"
    # mpnn_tpu's rule: a dp x tp mesh of (n/2) x 2 from 4 ranks on.
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    assert ("dryrun_multichip(%d): mesh={'data': %d, 'model': %d} batch=%d"
            % (n, n // n_model, n_model, 8 * n)) in lines[0]
    assert lines[0].endswith(where)
    assert lines[1] == ("dryrun_multichip(%d): sweep mesh={'sweep': %d, "
                        "'data': 1} %d-net step%s" % (n, n, n, where))
    assert lines[2].startswith("dryrun_multichip(%d): done in" % n)
    assert " on cpu " in lines[2]
