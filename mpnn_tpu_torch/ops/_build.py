"""Build and load the CUDA kernels of the port: nvcc into a plain C shared
library, bound with ctypes.

The library is built on first use into `mpnn_tpu_torch/_build/` (listed in
.gitignore), named by a hash of its source and flags, so an edited source
builds anew and an unchanged one loads from the cache. No PyTorch headers
are compiled: a build takes seconds."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "csrc" / "fused_mcm.cu"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lib = None


def find_nvcc():
    """nvcc from $CUDA_HOME, else PATH, else the toolkit's default place."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, PATH and "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def library_path(src=None, build_dir=None):
    """Where the library for this source and these flags lives."""
    src, build_dir = src or SRC, build_dir or BUILD_DIR
    h = hashlib.sha256(Path(src).read_bytes()
                       + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return Path(build_dir) / ("lib%s-%s.so" % (Path(src).stem, h))


def build(src=None, build_dir=None):
    """Compile `src` (default: the fused_mcm source) into `build_dir`
    unless its library is cached; returns the .so path. Raises
    RuntimeError with nvcc's output if the build fails."""
    src = src or SRC
    out = library_path(src, build_dir)
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (exit %d) building %s:\n%s%s"
                               % (proc.returncode, src, proc.stdout,
                                  proc.stderr))
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load():
    """The bound kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        # Declare every signature: ctypes would otherwise pass each pointer
        # as a 32-bit int.
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mcm_scale_forward.argtypes = [p, p, p, p, p, p,
                                          i, i, i, i, i, i, i, p]
        lib.mcm_scale_forward.restype = i
        lib.mcm_error_string.argtypes = [i]
        lib.mcm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib
