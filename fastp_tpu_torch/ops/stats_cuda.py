"""Wrapper of the hand-written CUDA kernel of stat_batch (csrc/stat_batch.cu).

Replaces fastp_tpu/ops/stats.py:26 stat_batch (XLA reductions and a bf16
one-hot matmul there, not a Pallas kernel) with one launch that reads the
batch's bases and qualities once and returns the plain version's dict
(ops/stats.py:stat_batch_plain): the same keys, shapes and int64 values.
The source's header note has what bounds the kernel (the 2.6 MB it reads at
the main path's shape: 0.81 us on an H100 SXM at 3.35 TB/s) and what its
design does about it: every load of a block's chunk in flight at once,
column sums in registers, 5-mer keys rolling along staged rows, and a flush
that sums each thread block cluster's sums in slices and adds them to an
accumulator, with no zeroing node.

`stat_batch_cuda` checks its arguments, allocates the output (every value
of which the kernel writes) on the current stream, launches on
`torch.cuda.current_stream(dev)`, raises on a non-zero return and counts
the launch as "stat_batch" in ops/launches.py.  It waits for nothing, so a
CUDA graph captures it: the lengths and the include mask are converted on
the device.  The kernel's int64 accumulator and ticket (`accumulator`) are
made once per device, stream and width, zeroed on that stream, and every
launch leaves them zero: a graph that captured a launch keeps using its
stream's accumulator, and work on one stream never overlaps, so such a
graph must replay on the stream it was captured on (pipeline/device.py's
Step.run raises otherwise).  The first call on a stream must come before
any capture on it (a graph's warm-up runs are such calls).
"""
from __future__ import annotations

import ctypes
import threading

import torch

from . import launches
from .common import check_arg, check_lengths

THREADS = 256              # threads of a block (csrc/stat_batch.cu: kThreads)
WARPS = THREADS // 32
TILE = 32                  # cycle columns of a block
MAX_ROWS = 128             # rows of a chunk: a block's counts are 10-bit fields
CLUSTER = 8                # chunks of one tile summed together (a block
                           # cluster): 8 was fastest of 1, 2, 4 and 8
TARGET_BLOCKS = 264        # about two blocks per SM of the H100's 132
MAX_CHUNKS = 65535         # the grid's second dimension
SLOT_VALUES = 32           # 8 slots x (content, q20, q30, qual)
COLUMN_VALUES = 34         # the slot values and the two totals
QUAL_BINS = 128
KMER_KEYS = 1024
KMER_BINS = 2048
# a block's int32 partials: slot values x tile columns, the quality bins,
# the 5-mer keys, reads and length_sum
PARTIALS = SLOT_VALUES * TILE + QUAL_BINS + KMER_KEYS + 2


def geometry(B: int, L: int, cluster: int = CLUSTER,
             rows_per_block: int = None):
    """(column tiles, row chunks, rows per chunk) of a launch: chunks of at
    most MAX_ROWS rows, about TARGET_BLOCKS blocks in all, the count of
    chunks a multiple of `cluster` (the chunks past the batch count
    nothing).  `rows_per_block` forces the chunk size (the tests' model of
    the kernel takes small ones)."""
    if not 1 <= cluster <= 8:
        raise ValueError("a cluster of %d blocks: 1 to 8" % cluster)
    tiles = max(1, -(-L // TILE))
    if rows_per_block is None:
        rows_per_block = max(WARPS, -(-B * tiles // TARGET_BLOCKS))
    rows = max(1, min(rows_per_block, MAX_ROWS))
    chunks = -(-max(-(-B // rows), 1) // cluster) * cluster
    if chunks > MAX_CHUNKS:
        raise ValueError("a batch of %d rows needs %d chunks of %d rows, more "
                         "than a grid holds" % (B, chunks, rows))
    return tiles, chunks, rows


def acc_size(L: int) -> int:
    """int64 values of the kernel's accumulator at width L: the slot
    values of each column, the quality bins, the 5-mer keys, reads,
    length_sum and the ticket."""
    return SLOT_VALUES * L + QUAL_BINS + KMER_KEYS + 3


_accumulators: dict = {}
_acc_lock = threading.Lock()


def accumulator(dev, stream, L: int):
    """The kernel's accumulator for launches on `stream` at width L: made
    zero on that stream at the first call, kept for the life of the
    process (a captured graph holds its address)."""
    key = (dev.index, stream.cuda_stream, L)
    with _acc_lock:
        buf = _accumulators.get(key)
        if buf is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "stat_batch's accumulator for this stream and width is "
                    "made by a call outside a CUDA graph capture: run the "
                    "call once on the capturing stream first")
            buf = _accumulators[key] = torch.zeros(
                acc_size(L), dtype=torch.int64, device=dev)
    return buf


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
    return function("stat_batch", [p, p, p, p, i, i, i, i, i, p, p, p])


def stat_batch_cuda(bases, quals, lengths, include):
    """stat_batch on the card: one launch of csrc/stat_batch.cu, in
    clusters of CLUSTER blocks."""
    if bases.device.type != "cuda":
        raise ValueError("stat_batch_cuda takes CUDA tensors, not %s"
                         % bases.device)
    bases, quals, lengths, include = kernel_inputs(bases, quals, lengths,
                                                   include)
    B, L = bases.shape
    dev = bases.device
    _, chunks, rows = geometry(B, L)
    with torch.cuda.device(dev):
        if B == 0:   # nothing to launch
            return split_output(torch.zeros(out_size(L), dtype=torch.int64,
                                            device=dev), L)
        stream = torch.cuda.current_stream(dev)
        acc = accumulator(dev, stream, L)
        out = torch.empty(out_size(L), dtype=torch.int64, device=dev)
        fn = _kernel()
        err = fn(bases.data_ptr(), quals.data_ptr(), lengths.data_ptr(),
                 include.data_ptr(), B, L, rows, chunks, CLUSTER,
                 acc.data_ptr(), out.data_ptr(), stream.cuda_stream)
    if err != 0:
        raise RuntimeError("stat_batch launch failed: CUDA error %d" % err)
    launches.count("stat_batch")
    return split_output(out, L)
