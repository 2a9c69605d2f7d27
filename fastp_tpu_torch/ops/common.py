"""Shared helpers for batched read ops (counterpart of fastp_tpu/ops/common.py).

All ops take fixed-width padded tensors on one device:
  bases: uint8[B, L] raw ASCII, 0 beyond `lengths`
  quals: uint8[B, L] raw phred+33 ASCII, 0 beyond `lengths`
  lengths: int32[B]

Reads are "windowed": the live read occupies positions [0, len) of its row.
Every integer intermediate is int32 (JAX's default int), never torch's
default int64, unless a wider type is needed for an index.
"""
from __future__ import annotations

import threading

import torch

A, T, C, G, N = 65, 84, 67, 71, 78  # ASCII codes

I32 = torch.int32


def pos_iota(B: int, L: int, device):
    """int32 [B, L] column index (a broadcast view, not a materialised copy)."""
    return torch.arange(L, dtype=I32, device=device).expand(B, L)


def _shift_gather(arr, src):
    """out[b, j] = arr[b, src[b, j]] where 0 <= src < L, else 0."""
    L = arr.shape[1]
    ok = (src >= 0) & (src < L)
    got = torch.gather(arr, 1, src.clamp(0, L - 1).long())
    return torch.where(ok, got, torch.zeros((), dtype=arr.dtype,
                                            device=arr.device))


def roll_front(arr, front):
    """Shift each row left by `front[b]`, filling with 0 (erase(0, front))."""
    B, L = arr.shape
    f = front.to(I32).clamp(0, L)
    return _shift_gather(arr, pos_iota(B, L, arr.device) + f[:, None])


def roll_back(arr, shift):
    """Shift each row right by `shift[b]` >= 0, filling with 0."""
    B, L = arr.shape
    f = shift.to(I32).clamp(0, L)
    return _shift_gather(arr, pos_iota(B, L, arr.device) - f[:, None])


_TABLES = {}
_tables_lock = threading.Lock()


def device_table(name: str, device, make):
    """The constant lookup table `name` on `device`: make() builds it on the
    host, and it is copied to the device once per process.  A copy from
    pageable host memory waits for the device, which a CUDA graph's capture
    may not do: a captured step finds its tables made by the eager warm-up
    run before the capture (pipeline/device.py:_Graph)."""
    key = (name, torch.device(device))
    with _tables_lock:
        table = _TABLES.get(key)
        if table is None:
            table = _TABLES[key] = make().to(device)
        return table


def _complement_table():
    lut = torch.full((256,), N, dtype=torch.uint8)
    for a, b in ((A, T), (T, A), (C, G), (G, C)):
        lut[a] = b
        lut[a + 32] = b  # lowercase maps to the uppercase complement
    return lut


def _complement_lut(device):
    return device_table("complement", device, _complement_table)


def complement(bases):
    """Complement of ASCII bases; anything not ATCG (upper/lower) -> 'N'.

    reference: src/util.h:16-33
    """
    return _complement_lut(bases.device)[bases.long()]


def reverse_rows(arr, lengths):
    """Reverse each row's first `lengths[b]` elements; pad stays 0."""
    L = arr.shape[1]
    return roll_front(arr.flip(1), L - lengths.to(I32))


def rc(bases, lengths):
    """Reverse complement (reference: src/sequence.cpp:23-50)."""
    rev = reverse_rows(bases, lengths)
    return torch.where(rev > 0, complement(rev),
                       torch.zeros((), dtype=bases.dtype, device=bases.device))


def first_true_index(mask, default):
    """Index of the first True along axis 1; `default` (scalar or [B]) if none.

    A masked min over the column index, so ties cannot pick another index."""
    B, L = mask.shape
    idx = torch.where(mask, pos_iota(B, L, mask.device), L).amin(1)
    return torch.where(mask.any(1), idx, _as_i32(default, mask.device))


def last_true_index(mask, default):
    """Index of the last True along axis 1; `default` if none."""
    B, L = mask.shape
    idx = torch.where(mask, pos_iota(B, L, mask.device), -1).amax(1)
    return torch.where(mask.any(1), idx, _as_i32(default, mask.device))


def _as_i32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(I32)
    return torch.full((), x, dtype=I32, device=device)


def base_slot(bases):
    """base & 0x07 (reference stats slot, src/stats.cpp:249)."""
    return (bases & 0x07).to(I32)


def _base2val_table():
    lut = torch.full((256,), -1, dtype=I32)
    for v, b in enumerate((A, T, C, G)):
        lut[b] = v
    return lut


def base2val(bases):
    """A=0 T=1 C=2 G=3, else -1 (reference: src/stats.cpp:334-347)."""
    return device_table("base2val", bases.device,
                        _base2val_table)[bases.long()]


def scatter_count(idx, n: int, *weights):
    """Exact integer histograms over one index: out[c, k] = sum of
    weights[c][idx == k] for k < n (int64 [len(weights), n]).

    Indices outside [0, n) land in a dump bin that is cut off, the
    counterpart of JAX's out-of-range `.at[].add`."""
    idx = idx.reshape(-1).long()
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    w = torch.stack([x.reshape(-1).to(torch.int64) for x in weights], 1)
    out = torch.zeros((n + 1, len(weights)), dtype=torch.int64,
                      device=idx.device)
    out.index_add_(0, idx, w)
    return out[:n].T
