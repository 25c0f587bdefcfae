"""A fixture for the port's heavy test files: under pytest-xdist, torch's
intra-op threads of a worker are the host's cores shared out among the
workers (at least 1), so six workers on eight cores do not run 48 threads
that wait on one another; alone, torch keeps its default. Import it into
a test module (`from tests.torch_threads import share_cores`) to apply it
to that module's tests; `child_env()` is the environment for a process
that a test starts."""

import os

import pytest
import torch


def _share():
    """This worker's share of the host's cores, or None outside xdist."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0") or 0)
    if workers < 2:
        return None
    return max(1, (os.cpu_count() or 1) // workers)


@pytest.fixture(scope="module", autouse=True)
def share_cores():
    n, before = _share(), torch.get_num_threads()
    if n is not None:
        torch.set_num_threads(n)
    yield
    torch.set_num_threads(before)


def child_env(**extra):
    """os.environ with `extra`, and OMP_NUM_THREADS at this worker's share
    of the cores under xdist."""
    env = dict(os.environ, **extra)
    n = _share()
    if n is not None:
        env["OMP_NUM_THREADS"] = str(n)
    return env
