"""Wrapper of the hand-written CUDA overlap kernel (csrc/overlap_sweep.cu).

Replaces the TPU kernel fastp_tpu/ops/overlap_pallas.py:_mm_kernel and its
consumer fastp_tpu/ops/overlap.py:_select_first_accept with one fused
launch per batch: the offset sweep and the first-accept selection, so no
[B, n_off] mismatch matrix is written to device memory.

A batch is a few megabytes, so the card bounds the kernel by operations
(byte compares), not by bytes moved.  The design spends as few
instructions per compare as it can: a warp owns a pair row and each lane
one offset, so 32 offsets are tested at once with no reduction between
them; the strings sit in shared memory as 32-bit words and four bytes are
compared per operation; and because the accept test depends only on the
first 50 positions of an overlap, the sweep reads no more than those (and
stops a round once every lane's count has passed diff_limit), the full
mismatch count being taken once, at the winning offset (the source's header
note has the argument, the details and the measured times).

`sweep_select` runs the kernel for CUDA tensors and the plain PyTorch
version (ops/overlap.py:sweep_select_plain) only for CPU tensors.  It
launches on the calling thread's current stream (the batch loop's dispatch
worker enters the run's side stream) and counts its launches as
"overlap_sweep" in the tally the port's three kernels share
(ops/launches.py), which also says how a CUDA graph's replays count them.
"""
from __future__ import annotations

import ctypes

import torch

from . import launches
from .common import check_arg
from .overlap import sweep_select_plain

_SMEM_BUDGET = 48 * 1024  # default dynamic shared memory per block
MAX_ROWS_PER_BLOCK = 8     # one warp per pair row


def _kernel():
    """The library's launcher, built and loaded at the first launch (the
    first launch of a run comes from its dispatch worker; the shards of two
    jobs may get here together: one of them builds, the others wait)."""
    from ..cuda_build import function
    p, i = ctypes.c_void_p, ctypes.c_int
    return function("overlap_sweep", [p, p, p, p, i, i, i, i, ctypes.c_float,
                                      p, p, p, p, i, p])


def padded_row_bytes(L: int) -> int:
    """Bytes of one staged string in shared memory (csrc/overlap_sweep.cu:
    row_stride): L rounded up to 16, plus 16 for the words read past the
    string's end."""
    return -(-L // 16) * 16 + 16


def rows_per_block(L: int) -> int:
    """Pair rows (warps) a block takes at width L: two staged strings per
    row within the default shared-memory budget, 8 at most; 0 when not
    even one row fits."""
    if L <= 0:
        return 0
    return min(MAX_ROWS_PER_BLOCK, _SMEM_BUDGET // (2 * padded_row_bytes(L)))


def sweep_select(seq1, rc2, len1, len2, diff_limit: int, overlap_require: int,
                 diff_pct: float):
    """First accepted overlap offset per pair row.

    seq1, rc2 (the reverse complement of read 2): uint8[B, L], contiguous;
    len1, len2: int32[B] in [0, L].  Returns (overlapped bool[B],
    offset int32[B], overlap_len int32[B], diff int32[B]); rows without an
    accepted offset hold 0 in the three int fields."""
    if seq1.device.type == "cpu":
        return sweep_select_plain(seq1, rc2, len1, len2, diff_limit,
                                  overlap_require, diff_pct)
    if seq1.device.type != "cuda":
        raise ValueError("sweep_select runs on cpu or cuda, not %s"
                         % seq1.device)
    B, L = seq1.shape
    dev = seq1.device
    check_arg("seq1", seq1, torch.uint8, (B, L), dev)
    check_arg("rc2", rc2, torch.uint8, (B, L), dev)
    check_arg("len1", len1, torch.int32, (B,), dev)
    check_arg("len2", len2, torch.int32, (B,), dev)
    warps = rows_per_block(L)
    if warps < 1:
        raise ValueError("read width %d is outside the kernel's shared-memory "
                         "row budget" % L)
    found = torch.empty(B, dtype=torch.bool, device=dev)
    offset = torch.empty(B, dtype=torch.int32, device=dev)
    overlap_len = torch.empty(B, dtype=torch.int32, device=dev)
    diff = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return found, offset, overlap_len, diff  # nothing to launch
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(seq1.data_ptr(), rc2.data_ptr(), len1.data_ptr(),
                 len2.data_ptr(), B, L, int(diff_limit), int(overlap_require),
                 float(diff_pct), found.data_ptr(), offset.data_ptr(),
                 overlap_len.data_ptr(), diff.data_ptr(), warps, stream)
    if err != 0:
        raise RuntimeError("overlap_sweep launch failed: CUDA error %d" % err)
    launches.count("overlap_sweep")
    return found, offset, overlap_len, diff
