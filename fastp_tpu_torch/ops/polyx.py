"""PolyG / polyX tail trimming (reference: src/polyx.cpp:16-116).

Counterpart of fastp_tpu/ops/polyx.py: both scan from the 3' end with <=1
mismatch per 8 bases and max 5 mismatches, replicated with suffix-order
cumulative counts and first-break selection.
"""
from __future__ import annotations

import torch

from .common import (I32, pos_iota, first_true_index, last_true_index,
                     reverse_rows, device_table, A, T, C, G, N)

ALLOW_ONE_MISMATCH_FOR_EACH = 8
MAX_MISMATCH = 5


def trim_polyg(bases, lengths, compare_req: int):
    """reference: src/polyx.cpp:16-42. Returns new lengths."""
    B, L = bases.shape
    rlen = lengths.to(I32)
    tail = reverse_rows(bases, rlen)  # tail[b, i] = bases[b, rlen-1-i]
    i = pos_iota(B, L, bases.device)
    in_read = i < rlen[:, None]
    is_g = (tail == G) & in_read
    mism = (~is_g & in_read).to(I32).cumsum(1, dtype=I32)
    allowed = (i + 1) // ALLOW_ONE_MISMATCH_FOR_EACH
    brk = ((mism > MAX_MISMATCH) | ((mism > allowed) & (i >= compare_req - 1))) \
        & in_read
    i_final = first_true_index(brk, default=rlen)
    # firstGPos: last G seen at iteration <= i_final, position rlen-1-i
    g_upto = is_g & (i <= i_final[:, None])
    first_g_pos = torch.where(g_upto.any(1),
                              rlen - 1 - last_true_index(g_upto, 0), rlen - 1)
    do_trim = i_final >= compare_req
    # Read::resize ignores len > length or < 0 (src/read.cpp:62-67)
    return torch.where(do_trim & (first_g_pos >= 0) & (first_g_pos <= rlen),
                       first_g_pos, rlen)


def trim_polyx(bases, lengths, compare_req: int):
    """reference: src/polyx.cpp:49-116.

    Returns (new_lengths, trimmed_mask, poly_base_idx, trimmed_bases) where
    poly_base_idx is 0..3 for A/T/C/G (valid when trimmed_mask) and
    trimmed_bases = pos+1 recorded by FilterResult::addPolyXTrimmed.
    """
    B, L = bases.shape
    dev = bases.device
    rlen = lengths.to(I32)
    tail = reverse_rows(bases, rlen)
    i = pos_iota(B, L, dev)
    in_read = i < rlen[:, None]

    cnt = torch.stack([(((tail == b) | (tail == N)) & in_read).to(I32)
                       .cumsum(1, dtype=I32) for b in (A, T, C, G)])  # [4, B, L]

    cmp = i + 1
    allowed = (cmp // ALLOW_ONE_MISMATCH_FOR_EACH).clamp(max=MAX_MISMATCH)
    need_break = ~(cmp - cnt <= allowed).any(0)
    brk = need_break & ((i >= ALLOW_ONE_MISMATCH_FOR_EACH) |
                        (cmp >= compare_req - 1)) & in_read
    pos_final = first_true_index(brk, default=rlen)
    has_poly = pos_final + 1 >= compare_req

    # counters at iteration pos_final (cumsum is flat past the read end)
    idx = pos_final.clamp(0, L - 1).long()[None, :, None].expand(4, B, 1)
    at_break = torch.gather(cnt, 2, idx)[:, :, 0].T  # [B, 4]
    # first max wins (strict > updates): the lowest index among the maxima
    best = at_break.amax(1, keepdim=True)
    poly = first_true_index(at_break == best, default=0)
    poly_ascii = device_table("atcg", dev, lambda: torch.tensor(
        [A, T, C, G], dtype=torch.uint8))[poly.long()]

    # while(data[rlen-pos-1] != polyBase && pos>=0) pos--
    match = (tail == poly_ascii[:, None]) & (i <= pos_final[:, None]) & in_read
    pos2 = last_true_index(match, default=-1)

    new_len = torch.where(has_poly, rlen - pos2 - 1, rlen)
    new_len = torch.where((new_len >= 0) & (new_len <= rlen), new_len, rlen)
    trimmed_bases = torch.where(has_poly, pos2 + 1, 0)
    return new_len, has_poly, poly, trimmed_bases
