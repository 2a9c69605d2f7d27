"""Wrapper of the hand-written CUDA kernel of trim_by_sequence
(csrc/adapter_match.cu).

Replaces fastp_tpu/ops/adapter.py:57 trim_by_sequence and its
_match_with_one_insertion_static tables (:26) -- an unrolled Hamming scan
and one static table per candidate length, not a Pallas kernel -- with one
launch per call: a warp per read stages the read in shared memory once,
finds the first Hamming match four bytes a compare, and only a read without
one runs the insertion and deletion fallbacks, each one prefix pass and
then a few operations per candidate length.  The result is the plain
version's (ops/adapter.py:trim_by_sequence_plain): (new_len int32, found
bool, pos int32) per read, every value written by the kernel.  The
source's header note has what bounds the kernel and what its design does
about it.

`trim_by_sequence_cuda` checks its arguments, allocates its outputs on the
current stream, launches on `torch.cuda.current_stream(dev)`, raises on a
non-zero return and counts the launch as "trim_by_sequence" in
ops/launches.py.  The adapter is the uint8 tensor the step uploaded once
(pipeline/device.py:StepIO); each block copies it from where it lies, so a CUDA
graph that captured the call keeps reading that tensor, which the memo
entry holds for as long as its graphs live.  `geometry` sizes each block's
workspace; one that does not fit SHARED_BYTES of shared memory at one warp
(an adapter or a read of many kilobytes) lies in a scratch buffer the
wrapper allocates on the current stream.
"""
from __future__ import annotations

import ctypes

import torch

from . import launches
from .common import check_arg, check_lengths

MAX_WARPS = 8              # warps of a block, a read each (kMaxWarps)
SHARED_BYTES = 48 * 1024   # dynamic shared memory without an opt-in
PAD = 16                   # zero bytes before a staged read (kPad)
SCRATCH_BYTES = 256 << 20  # the scratch buffer's size the blocks fit in


def _round(x: int, m: int) -> int:
    return -(-x // m) * m


def geometry(B: int, L: int, alen: int) -> dict:
    """A launch's geometry: the block's copy of the adapter (`ad_bytes`,
    zero-padded), each warp's staged read (`row_bytes`: the pad, L bytes,
    zeros for the word compares past L) and its five int tables of `table`
    values (the mismatch ranks, then D1 and the running minimum of each
    role); the warps of a block, the blocks, each block's workspace
    (`block_bytes`: the adapter, then the warps') and whether it is shared
    memory (`staged`) or scratch."""
    ad_bytes = _round(alen + 8, 16)
    row_bytes = _round(PAD + L + alen + 56, 16)
    table = _round(alen + 2, 4)
    per_warp = row_bytes + 20 * table
    warps = min(MAX_WARPS, (SHARED_BYTES - ad_bytes) // per_warp)
    staged = warps >= 1
    if not staged:
        warps = MAX_WARPS
    block_bytes = ad_bytes + warps * per_warp
    blocks = max(1, -(-B // warps))
    if not staged:
        blocks = max(1, min(blocks, SCRATCH_BYTES // block_bytes))
    return {"ad_bytes": ad_bytes, "row_bytes": row_bytes, "table": table,
            "warps": warps, "blocks": blocks, "block_bytes": block_bytes,
            "staged": staged}


def kernel_inputs(bases, lengths, adapter):
    """The kernel's arguments, checked: bases contiguous uint8 [B, L], the
    adapter a contiguous uint8 vector and lengths [B] of an integer type,
    all on one device.  Returns (bases, lengths as int32, adapter), the
    lengths converted on the device; raises on anything else."""
    if bases.dim() != 2:
        raise ValueError("bases has shape %s, expected [B, L]"
                         % (tuple(bases.shape),))
    B, L = bases.shape
    dev = bases.device
    check_arg("bases", bases, torch.uint8, (B, L), dev)
    if adapter.dim() != 1:
        raise ValueError("adapter has shape %s, expected [alen]"
                         % (tuple(adapter.shape),))
    check_arg("adapter", adapter, torch.uint8, adapter.shape, dev)
    check_lengths(lengths, B, dev)
    return bases, lengths.to(torch.int32).contiguous(), adapter


def _kernel():
    from ..cuda_build import function
    p, i = ctypes.c_void_p, ctypes.c_int
    return function("adapter_match", [p, p, p, i, i, i, i, i, i, i, i, i, i,
                                      i, p, p, p, p, p])


def trim_by_sequence_cuda(bases, lengths, adapter, match_req: int = 4):
    """trim_by_sequence on the card: one launch of csrc/adapter_match.cu,
    none when the adapter is shorter than match_req (nothing can match)."""
    if bases.device.type != "cuda":
        raise ValueError("trim_by_sequence_cuda takes CUDA tensors, not %s"
                         % bases.device)
    bases, rlen, adapter = kernel_inputs(bases, lengths, adapter)
    B, L = bases.shape
    dev = bases.device
    alen = int(adapter.shape[0])
    if alen < match_req or B == 0:
        # as the plain version: nothing to launch
        return (rlen, torch.zeros(B, dtype=torch.bool, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev))
    g = geometry(B, L, alen)
    with torch.cuda.device(dev):
        new_len = torch.empty(B, dtype=torch.int32, device=dev)
        found = torch.empty(B, dtype=torch.bool, device=dev)
        pos = torch.empty(B, dtype=torch.int32, device=dev)
        scratch = None if g["staged"] else torch.empty(
            g["blocks"] * g["block_bytes"], dtype=torch.uint8, device=dev)
        fn = _kernel()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bases.data_ptr(), rlen.data_ptr(), adapter.data_ptr(), B, L,
                 alen, int(match_req), g["warps"], g["blocks"],
                 int(g["staged"]), g["ad_bytes"], g["row_bytes"], g["table"],
                 g["block_bytes"], 0 if scratch is None else scratch.data_ptr(),
                 new_len.data_ptr(), found.data_ptr(), pos.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("adapter_match launch failed: CUDA error %d" % err)
    launches.count("trim_by_sequence")
    return new_len, found, pos
