"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for Hopper (sm_90a) into a shared
library with a plain C interface, which is loaded with ctypes.  The build
runs at first use, into `fastp_tpu_torch/_build/` (listed in .gitignore),
and is redone whenever the source's hash changes.  `build_logs[name]`
keeps what nvcc printed (`-Xptxas -v`: registers, shared memory and spills
of each kernel) when this process built the library.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of fastp_tpu_torch "
                       "build only where the CUDA toolkit is installed")


def library_path(name: str, source: str = None) -> str:
    """Path of the built library for the current source of `name`
    (`csrc/<name>.cu` unless `source` names another file)."""
    with open(source or os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, digest.hexdigest()[:16]))


def load(name: str, source: str = None) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if its library is missing or stale; load it.
    `source` builds another file under the key `name` (a kernel's earlier
    version beside the current one, for a timing of both)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        source = source or os.path.join(CSRC, name + ".cu")
        path = library_path(name, source)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, source]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError("nvcc failed for %s:\n%s"
                                       % (source, res.stderr[-4000:]))
                build_logs[name] = res.stderr
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(path)
        _libs[name] = lib
        return lib
