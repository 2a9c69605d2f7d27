"""Wrapper of the hand-written CUDA kernel of stat_batch (csrc/stat_batch.cu).

Replaces fastp_tpu/ops/stats.py:26 stat_batch (XLA reductions and a bf16
one-hot matmul there, not a Pallas kernel) with one launch that reads the
batch's bases and qualities once and returns the plain version's dict
(ops/stats.py:stat_batch_plain): the same keys, shapes and int64 values.
The source's header note has what bounds the kernel and what its design
does about it.

`stat_batch_cuda` checks its arguments, allocates the zeroed int64 output
on the current stream, launches on `torch.cuda.current_stream(dev)`,
raises on a non-zero return and counts the launch as "stat_batch" in
ops/launches.py.  It waits for nothing, so a CUDA graph captures it: the
lengths and the include mask are converted on the device.
"""
from __future__ import annotations

import ctypes

import torch

from . import launches
from .common import check_arg, check_lengths

WARPS = 8                  # warps of a block (csrc/stat_batch.cu: kWarps)
TILE = 32                  # cycle columns of a block
MAX_ROWS_PER_BLOCK = 1023 * WARPS   # a thread's counts are 10-bit fields
TARGET_BLOCKS = 264        # about two blocks per SM of the H100's 132
MAX_CHUNKS = 65535         # the grid's second dimension
COLUMN_VALUES = 34         # 8 slots x 4 channels + the two totals
QUAL_BINS = 128
KMER_BINS = 2048


def geometry(B: int, L: int, rows_per_block: int = None):
    """(column tiles, row chunks, rows per chunk) of a launch: enough chunks
    for about TARGET_BLOCKS blocks in all, each chunk under
    MAX_ROWS_PER_BLOCK rows.  `rows_per_block` forces the chunk size (the
    tests' model of the kernel takes small ones)."""
    tiles = max(1, -(-L // TILE))
    if rows_per_block is None:
        chunks = max(1, min(-(-B // WARPS), TARGET_BLOCKS // tiles))
        rows_per_block = -(-B // chunks)
    rows_per_block = max(1, min(rows_per_block, MAX_ROWS_PER_BLOCK))
    chunks = max(1, -(-B // rows_per_block))
    if chunks > MAX_CHUNKS:
        raise ValueError("a batch of %d rows needs %d chunks of %d rows, more "
                         "than a grid holds" % (B, chunks, rows_per_block))
    return tiles, chunks, rows_per_block


def out_size(L: int) -> int:
    """int64 values of the kernel's output buffer at width L."""
    return COLUMN_VALUES * L + QUAL_BINS + KMER_BINS + 2


def split_output(buf, L: int) -> dict:
    """The plain version's dict as views of the kernel's output buffer
    (csrc/stat_batch.cu: value j of cycle column p at j * L + p, then the
    quality histogram, the 5-mer histogram, reads and length_sum)."""
    cyc = buf[:32 * L].view(4, 8, L)
    tail = COLUMN_VALUES * L
    return {
        "cycle_q20": cyc[1],
        "cycle_q30": cyc[2],
        "cycle_content": cyc[0],
        "cycle_qual": cyc[3],
        "cycle_total_base": buf[32 * L:33 * L],
        "cycle_total_qual": buf[33 * L:tail],
        "qual_hist": buf[tail:tail + QUAL_BINS],
        "kmer": buf[tail + QUAL_BINS:tail + QUAL_BINS + KMER_BINS],
        "reads": buf[tail + QUAL_BINS + KMER_BINS],
        "length_sum": buf[tail + QUAL_BINS + KMER_BINS + 1],
    }


def kernel_inputs(bases, quals, lengths, include):
    """The kernel's arguments, checked: bases and quals contiguous uint8
    [B, L] on one device, lengths of an integer type and include bool, both
    [B] there.  Returns (bases, quals, lengths as int32, include), the last
    two converted on the device; raises on anything else."""
    if bases.dim() != 2:
        raise ValueError("bases has shape %s, expected [B, L]"
                         % (tuple(bases.shape),))
    B, L = bases.shape
    dev = bases.device
    check_arg("bases", bases, torch.uint8, (B, L), dev)
    check_arg("quals", quals, torch.uint8, (B, L), dev)
    check_lengths(lengths, B, dev)
    if include.dtype != torch.bool:
        raise TypeError("include has dtype %s, expected torch.bool"
                        % include.dtype)
    if tuple(include.shape) != (B,) or include.device != dev:
        raise ValueError("include: %s on %s, expected [%d] on %s"
                         % (tuple(include.shape), include.device, B, dev))
    return (bases, quals, lengths.to(torch.int32).contiguous(),
            include.contiguous())


def _kernel():
    from ..cuda_build import function
    p, i = ctypes.c_void_p, ctypes.c_int
    return function("stat_batch", [p, p, p, p, i, i, i, i, p, p])


def stat_batch_cuda(bases, quals, lengths, include):
    """stat_batch on the card: one launch of csrc/stat_batch.cu."""
    if bases.device.type != "cuda":
        raise ValueError("stat_batch_cuda takes CUDA tensors, not %s"
                         % bases.device)
    bases, quals, lengths, include = kernel_inputs(bases, quals, lengths,
                                                   include)
    B, L = bases.shape
    dev = bases.device
    _, chunks, rows = geometry(B, L)
    with torch.cuda.device(dev):
        out = torch.zeros(out_size(L), dtype=torch.int64, device=dev)
        if B == 0:
            return split_output(out, L)   # nothing to launch
        fn = _kernel()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bases.data_ptr(), quals.data_ptr(), lengths.data_ptr(),
                 include.data_ptr(), B, L, rows, chunks, out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError("stat_batch launch failed: CUDA error %d" % err)
    launches.count("stat_batch")
    return split_output(out, L)
