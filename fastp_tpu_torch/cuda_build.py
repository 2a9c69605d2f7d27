"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for Hopper (sm_90a) into a shared
library with a plain C interface, which is loaded with ctypes.  The build
runs at first use, into `fastp_tpu_torch/_build/` (listed in .gitignore),
and is redone whenever the source's hash changes.
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
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of fastp_tpu_torch "
                       "build only where the CUDA toolkit is installed")


def library_path(name: str) -> str:
    """Path of the built library for the current source of `name`."""
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so" % (name, digest.hexdigest()[:16]))


def load(name: str) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if its library is missing or stale; load it."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                       os.path.join(CSRC, name + ".cu")]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError("nvcc failed for %s.cu:\n%s"
                                       % (name, res.stderr[-4000:]))
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(path)
        _libs[name] = lib
        return lib
