"""Adapter trimming (reference: src/adaptertrimmer.cpp:16-170).

Counterpart of fastp_tpu/ops/adapter.py.  trim_by_sequence reproduces
AdapterTrimmer::trimBySequence:
  * Hamming scan from a negative start (A-tailing dimers) with
    1-mismatch-per-8bp allowance; the first matching pos wins.
  * insertion/deletion fallbacks: the reference calls
    Matcher::matchWithOneInsertion on the read from index 0 whatever pos
    is (src/adaptertrimmer.cpp:120-147), so the result depends on pos only
    through cmplen: the match is evaluated once per possible cmplen and
    the first matching pos is derived from the largest matching cmplen.
trim_by_overlap reproduces trimByOverlapAnalysis (negative-offset clipping).
The adapter bytes come in as a uint8 tensor on the batch's device
(uploaded once when the step is built).
"""
from __future__ import annotations

import torch

from .common import I32, pos_iota, first_true_index

ALLOW_ONE_MISMATCH_FOR_EACH = 8


def _match_with_one_insertion_static(ins, norm, cmplen: int, limit: int):
    """Matcher::matchWithOneInsertion (src/matcher.cpp:10-54) with static
    cmplen/limit.  ins: uint8[B, >=cmplen+1], norm: uint8[B, >=cmplen].
    Returns bool[B].

    Insertion points i in [1, cmplen) are scanned ascending: false at the
    first i with accLeft[i-1]+accRight[cmplen-1] > limit, true at the first
    i with accLeft[i-1]+accRight[i] <= limit (the fail check runs first)."""
    B = ins.shape[0]
    if cmplen < 2 or limit < 0:
        # cmplen == 1: the loop range [1, 1) is empty
        return torch.zeros(B, dtype=torch.bool, device=ins.device)
    acc_l = (ins[:, :cmplen] != norm[:, :cmplen]).to(I32).cumsum(1, dtype=I32)
    mm_r = (ins[:, 1:cmplen + 1] != norm[:, :cmplen]).to(I32)
    acc_r = mm_r.flip(1).cumsum(1, dtype=I32).flip(1)  # accRight[i]
    accl_prev = acc_l[:, :cmplen - 1]
    fail_here = (accl_prev + acc_r[:, cmplen - 1:cmplen]) > limit
    succ_here = (accl_prev + acc_r[:, 1:cmplen]) <= limit
    stop = fail_here | succ_here
    first_stop = first_true_index(stop, default=0)
    failed = torch.gather(fail_here, 1, first_stop.long()[:, None])[:, 0]
    return stop.any(1) & ~failed


def trim_by_sequence(bases, lengths, adapter, match_req: int = 4):
    """adapter: uint8[alen] tensor on the batch's device.

    Returns (new_len[B], found[B], pos[B]) -- pos may be negative.  When
    found & pos < 0 the read is emptied; the recorded adapter is
    adapter[:alen+pos].  When pos >= 0 the recorded adapter is the read
    suffix seq[pos:old_len] (the host extracts the bytes)."""
    B, L = bases.shape
    dev = bases.device
    alen = int(adapter.shape[0])
    rlen = lengths.to(I32)

    if alen < match_req:
        return (rlen, torch.zeros(B, dtype=torch.bool, device=dev),
                torch.zeros(B, dtype=I32, device=dev))

    start = 0
    if alen >= 16:
        start = -4
    elif alen >= 12:
        start = -3
    elif alen >= 8:
        start = -2

    # --- phase 1: Hamming scan over positions p = start + pp, pp < n_p ---
    n_p = L - match_req - start
    ppos = pos_iota(B, n_p, dev) + start
    bpad = torch.cat([torch.zeros((B, 4), dtype=torch.uint8, device=dev), bases,
                      torch.zeros((B, alen + 4), dtype=torch.uint8, device=dev)], 1)
    cmplen = (rlen[:, None] - ppos).clamp(max=alen)
    mism = torch.zeros((B, n_p), dtype=I32, device=dev)
    for i in range(alen):
        col = bpad[:, 4 + start + i: 4 + start + i + n_p]
        valid = (ppos + i >= 0) & (ppos + i < rlen[:, None]) & (i < cmplen)
        mism += ((col != adapter[i]) & valid).to(I32)
    matched = (mism <= cmplen // ALLOW_ONE_MISMATCH_FOR_EACH) & \
        (ppos < (rlen[:, None] - match_req))
    found_h = matched.any(1)
    pos_h = torch.where(found_h, first_true_index(matched, 0) + start, 0)

    # --- phases 2+3: insertion / deletion fallback tables ---
    # reads are compared from index 0 (reference quirk); both sides are
    # padded to width alen+1 so any cmplen <= alen slices safely
    W = alen + 1
    a_b = torch.cat([adapter, torch.zeros(1, dtype=torch.uint8, device=dev)]) \
        .expand(B, W)
    if L >= W:
        b_cut = bases[:, :W]
    else:
        b_cut = torch.cat([bases, torch.zeros((B, W - L), dtype=torch.uint8,
                                              device=dev)], 1)

    ins_tbl = {}
    del_tbl = {}
    for cl in range(1, alen + 1):
        lim = cl // ALLOW_ONE_MISMATCH_FOR_EACH - 1
        if lim < 0:
            continue  # never matches: leave the entry out
        ins_tbl[cl] = _match_with_one_insertion_static(b_cut, a_b, cl, lim)
        if cl <= alen - 1:
            del_tbl[cl] = _match_with_one_insertion_static(a_b, b_cut, cl, lim)

    def first_match_from_table(tbl, cl_of_p0, p_of_cl, p_limit):
        """cmplen descends from cl_of_p0 as p ascends: pick the largest
        matching cmplen <= cl_of_p0."""
        best_cl = torch.full((B,), -1, dtype=I32, device=dev)
        for cl, m in tbl.items():
            best_cl = torch.where(m & (cl <= cl_of_p0) & (cl > best_cl),
                                  cl, best_cl)
        p = torch.where(best_cl == cl_of_p0, 0, p_of_cl(best_cl))
        valid = (best_cl >= 0) & (p >= 0) & (p < p_limit) & (p_limit > 0)
        return valid, torch.where(valid, p, 0)

    # insertion: cmplen(p) = min(rlen-p-1, alen); p in [0, rlen-match_req-1)
    f_ins, p_ins = first_match_from_table(
        ins_tbl, (rlen - 1).clamp(max=alen), lambda cl: rlen - 1 - cl,
        rlen - match_req - 1)
    # deletion: cmplen(p) = min(rlen-p, alen-1); p in [0, rlen-match_req)
    f_del, p_del = first_match_from_table(
        del_tbl, rlen.clamp(max=alen - 1), lambda cl: rlen - cl,
        rlen - match_req)

    found = found_h | f_ins | f_del
    fpos = torch.where(found_h, pos_h, torch.where(f_ins, p_ins, p_del))
    new_len = torch.where(found & (fpos < 0), 0,
                          torch.where(found, torch.minimum(fpos.clamp(min=0), rlen),
                                      rlen))
    return new_len, found, fpos


def trim_by_overlap(len1, len2, ov_overlapped, ov_offset, ov_overlap_len,
                    front_trimmed1, front_trimmed2):
    """AdapterTrimmer::trimByOverlapAnalysis (src/adaptertrimmer.cpp:16-45).

    When overlapped & offset < 0:
      new_len1 = min(len1, ol + frontTrimmed2); new_len2 = min(len2, ol + frontTrimmed1)
    Returns (new_len1, new_len2, trimmed[B])."""
    do = ov_overlapped & (ov_offset < 0)
    nl1 = torch.minimum(len1, ov_overlap_len + front_trimmed2)
    nl2 = torch.minimum(len2, ov_overlap_len + front_trimmed1)
    return torch.where(do, nl1, len1), torch.where(do, nl2, len2), do
