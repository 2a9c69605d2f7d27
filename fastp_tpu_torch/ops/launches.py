"""Launch counts of the port's hand-written CUDA kernels, one tally for all.

Each wrapper -- ops/overlap_cuda.py (overlap_sweep and its gapped variant
overlap_gap_sweep, two C functions of csrc/overlap_sweep.cu),
ops/stats_cuda.py (stat_batch) and ops/adapter_cuda.py (trim_by_sequence)
-- calls `count(name)` once where it launches its kernel, and nowhere
else.  The counts are a plain dict, `counts`, keyed by kernel; launches
come from worker threads, so it changes under a lock.

A step captured as a CUDA graph (pipeline/device.py:_Graph) calls the
wrappers during its warm-up runs and its capture, which are no batch: it
runs them inside `uncounted()`, which tallies this thread's launches per
kernel for the graph instead of counting them, and every replay of the
graph then counts what the capture tallied with `count_replayed`.
"""
from __future__ import annotations

import contextlib
import threading

KERNELS = ("overlap_sweep", "overlap_gap_sweep", "stat_batch",
           "trim_by_sequence")

counts = dict.fromkeys(KERNELS, 0)
_lock = threading.Lock()
_local = threading.local()


def zero_tally() -> dict:
    return dict.fromkeys(KERNELS, 0)


@contextlib.contextmanager
def uncounted():
    """Launches by this thread inside the block are tallied in the dict
    yielded ({kernel: n}) and not counted: a CUDA graph's warm-up runs and
    its capture."""
    tally = zero_tally()
    outer = getattr(_local, "tally", None)
    _local.tally = tally
    try:
        yield tally
    finally:
        _local.tally = outer


def count(name: str):
    """One launch of kernel `name`: counted, or tallied for the graph that
    this thread is capturing (see uncounted)."""
    tally = getattr(_local, "tally", None)
    if tally is not None:
        tally[name] += 1
        return
    with _lock:
        counts[name] += 1


def count_replayed(tally: dict):
    """Count the launches a CUDA graph's replay makes ({kernel: n})."""
    if any(tally.values()):
        with _lock:
            for name, n in tally.items():
                counts[name] += n


def snapshot() -> dict:
    with _lock:
        return dict(counts)


def since(before: dict) -> dict:
    """The launches of each kernel after the snapshot `before`."""
    now = snapshot()
    return {name: now[name] - before.get(name, 0) for name in KERNELS}


def reset():
    with _lock:
        for name in KERNELS:
            counts[name] = 0
