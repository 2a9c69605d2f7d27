"""Wrapper of the hand-written CUDA overlap kernel (csrc/overlap_sweep.cu).

Replaces the TPU kernel fastp_tpu/ops/overlap_pallas.py:_mm_kernel and its
consumer fastp_tpu/ops/overlap.py:_select_first_accept with one fused
launch per batch: the offset sweep and the first-accept selection, so no
[B, n_off] mismatch matrix is written to device memory.  The same source's
gapped variant (C function overlap_gap_sweep) also replaces the allow_gap
branch of fastp_tpu/ops/overlap.py:_analyze_loop (the one-insertion pass,
`gap_diff`, :255-318): a row that no ungapped offset accepts goes on, in
the same launch, to the gapped offsets.

A batch is a few megabytes, so the card bounds the kernel by operations
(byte compares), not by bytes moved.  The design spends as few
instructions per compare as it can: a warp owns a pair row and each lane
one offset, so 32 offsets are tested at once with no reduction between
them; the strings sit in shared memory as 32-bit words and four bytes are
compared per operation; and because the accept test depends only on the
first 50 positions of an overlap, the sweep reads no more than those (and
stops a round once every lane's count has passed diff_limit), the full
mismatch count being taken once, at the winning offset (the source's header
note has the argument, the details and the measured times).  The gapped
accept test likewise needs only the mismatch count before the overlap's
last two positions and two byte compares; since a row gets to it only with
every ungapped offset rejected, it can pass only where the overlap is at
most 51, so it is taken inside the ungapped rounds that reach such
overlaps, from the counts they have just made, and needs no rounds of its
own; the one-insertion difference itself is taken once, at the winning
offset.

`sweep_select` and `gap_sweep_select` run the kernel for CUDA tensors and
the plain PyTorch versions (ops/overlap.py:sweep_select_plain,
gap_sweep_select_plain) only for CPU tensors.  They launch on the calling
thread's current stream (the batch loop's dispatch worker enters the run's
side stream) and count their launches as "overlap_sweep" and
"overlap_gap_sweep" in the tally the port's kernels share
(ops/launches.py), which also says how a CUDA graph's replays count them.
"""
from __future__ import annotations

import ctypes

import torch

from . import launches
from .common import check_arg
from .overlap import gap_sweep_select_plain, sweep_select_plain

_SMEM_BUDGET = 48 * 1024  # default dynamic shared memory per block
MAX_ROWS_PER_BLOCK = 8     # one warp per pair row


def _kernel(gap: bool = False):
    """The library's launcher (overlap_sweep, or overlap_gap_sweep with its
    has_gap output), built and loaded at the first launch (the first launch
    of a run comes from its dispatch worker; the shards of two jobs may get
    here together: one of them builds, the others wait)."""
    from ..cuda_build import function
    p, i = ctypes.c_void_p, ctypes.c_int
    outs = [p] * (5 if gap else 4)
    return function("overlap_gap_sweep" if gap else "overlap_sweep",
                    [p, p, p, p, i, i, i, i, ctypes.c_float, *outs, i, p],
                    lib="overlap_sweep")


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


def _launch(gap: bool, seq1, rc2, len1, len2, diff_limit: int,
            overlap_require: int, diff_pct: float):
    """One launch of the kernel (gapped or not) on CUDA tensors; returns its
    outputs, allocated here with torch.empty.  Waits for nothing on the
    host, so a CUDA graph can capture it."""
    if seq1.device.type != "cuda":
        raise ValueError("the overlap kernel runs on cpu or cuda tensors, "
                         "not %s" % seq1.device)
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
    outs = [torch.empty(B, dtype=torch.bool, device=dev),
            *(torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))]
    if gap:
        outs.append(torch.empty(B, dtype=torch.bool, device=dev))
    if B == 0:
        return tuple(outs)  # nothing to launch
    name = "overlap_gap_sweep" if gap else "overlap_sweep"
    fn = _kernel(gap)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(seq1.data_ptr(), rc2.data_ptr(), len1.data_ptr(),
                 len2.data_ptr(), B, L, int(diff_limit), int(overlap_require),
                 float(diff_pct), *(o.data_ptr() for o in outs), warps,
                 stream)
    if err != 0:
        raise RuntimeError("%s launch failed: CUDA error %d" % (name, err))
    launches.count(name)
    return tuple(outs)


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
    return _launch(False, seq1, rc2, len1, len2, diff_limit, overlap_require,
                   diff_pct)


def gap_sweep_select(seq1, rc2, len1, len2, diff_limit: int,
                     overlap_require: int, diff_pct: float):
    """sweep_select, then, for the rows it leaves unaccepted, the first
    offset (forward ones before backward ones) whose one-insertion
    difference passes the limit (--allow_gap_overlap_trimming).  Same
    arguments; returns (overlapped, offset, overlap_len, diff, has_gap
    bool[B]), has_gap true only for the rows the gapped pass accepted."""
    if seq1.device.type == "cpu":
        return gap_sweep_select_plain(seq1, rc2, len1, len2, diff_limit,
                                      overlap_require, diff_pct)
    return _launch(True, seq1, rc2, len1, len2, diff_limit, overlap_require,
                   diff_pct)
