"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` compiles with nvcc for Hopper (sm_90a) into a shared
library with a plain C interface, which is loaded with ctypes.  The build
runs at first use, into `fastp_tpu_torch/_build/` (listed in .gitignore),
and is redone whenever the source's hash changes; `build_all` starts one
nvcc for each library at once.
`build_logs[name]` keeps what nvcc printed (`-Xptxas -v`: registers, shared
memory and spills of each kernel) when this process built the library, and
`loaded` lists the libraries this process loaded, in order: what a job that
found them loaded already did not pay for.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# the port's kernel libraries: csrc/<name>.cu, each with a C entry point
# <name> (overlap_sweep.cu also with overlap_gap_sweep, its gapped variant)
KERNEL_LIBS = ("overlap_sweep", "stat_batch", "adapter_match")

_lock = threading.Lock()
_libs: dict = {}
_fns: dict = {}
build_logs: dict = {}
loaded: list = []


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


def _build(sources: dict) -> dict:
    """nvcc for each {name: source}, all started at once; each library goes
    to its `library_path` through a temporary file.  Returns {name: seconds
    until its nvcc was seen to end}; raises the first failure once all have
    ended."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for name, source in sources.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((name, source, tmp, proc))
    seconds, failures = {}, []
    for name, source, tmp, proc in jobs:
        _, err = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode == 0:
            build_logs[name] = err
            os.replace(tmp, library_path(name, source))
        else:
            failures.append("nvcc failed for %s:\n%s" % (source, err[-4000:]))
        if os.path.exists(tmp):
            os.unlink(tmp)
    if failures:
        raise RuntimeError(failures[0])
    return seconds


def load(name: str, source: str = None) -> ctypes.CDLL:
    """Build `csrc/<name>.cu` if its library is missing or stale; load it.
    `source` builds another file under the key `name` (a kernel's earlier
    version beside the current one, for a timing of both)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            source = source or os.path.join(CSRC, name + ".cu")
            path = library_path(name, source)
            if not os.path.exists(path):
                _build({name: source})
            lib = _libs[name] = ctypes.CDLL(path)
            loaded.append(name)
        return lib


def function(name: str, argtypes, lib: str = None):
    """The C entry point `name` of library `lib` (default: `name`), its
    argument types set and its result an int (the CUDA error of the
    launch): built and loaded at the first call, the same object after
    that."""
    with _lock:
        fn = _fns.get(name)
    if fn is None:
        fn = getattr(load(lib or name), name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        with _lock:
            fn = _fns.setdefault(name, fn)
    return fn


def build_all(names=KERNEL_LIBS) -> dict:
    """Build the missing or stale libraries of `names` at once, an nvcc
    each (nvcc takes seconds per file), and load all of them.  Returns
    {name: seconds} (0.0 for a library that needed no build)."""
    with _lock:
        stale = {n: os.path.join(CSRC, n + ".cu") for n in names
                 if n not in _libs and not os.path.exists(library_path(n))}
        seconds = _build(stale) if stale else {}
    for name in names:
        load(name)
    return {name: seconds.get(name, 0.0) for name in names}
