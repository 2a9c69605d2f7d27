"""Wrapper of the hand-written CUDA kernel of trim_by_sequence
(csrc/adapter_match.cu).

Replaces fastp_tpu/ops/adapter.py:57 trim_by_sequence and its
_match_with_one_insertion_static tables (:26) -- an unrolled Hamming scan
and one static table per candidate length, not a Pallas kernel -- with one
launch per call: a warp per read finds the first Hamming match, and only a
read without one runs the insertion and deletion fallbacks.  The result is
the plain version's (ops/adapter.py:trim_by_sequence_plain): (new_len int32,
found bool, pos int32) per read.  The source's header note has what bounds
the kernel and what its design does about it.

`trim_by_sequence_cuda` checks its arguments, allocates its outputs on the
current stream, launches on `torch.cuda.current_stream(dev)`, raises on a
non-zero return and counts the launch as "trim_by_sequence" in
ops/launches.py.  The adapter is the uint8 tensor the step uploaded once
(pipeline/device.py:StepIO); the kernel reads it where it lies, so a CUDA
graph that captured the call keeps reading that tensor, which the memo
entry holds for as long as its graphs live.
"""
from __future__ import annotations

import ctypes

import torch

from . import launches
from .common import check_arg, check_lengths

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
    return function("adapter_match", [p, p, p, i, i, i, i, p, p, p, p])


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
    found = torch.zeros(B, dtype=torch.bool, device=dev)
    pos = torch.zeros(B, dtype=torch.int32, device=dev)
    if alen < match_req or B == 0:
        return rlen, found, pos   # as the plain version: nothing to launch
    new_len = torch.empty(B, dtype=torch.int32, device=dev)
    fn = _kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(bases.data_ptr(), rlen.data_ptr(), adapter.data_ptr(), B, L,
                 alen, int(match_req), new_len.data_ptr(), found.data_ptr(),
                 pos.data_ptr(), stream)
    if err != 0:
        raise RuntimeError("adapter_match launch failed: CUDA error %d" % err)
    launches.count("trim_by_sequence")
    return new_len, found, pos
