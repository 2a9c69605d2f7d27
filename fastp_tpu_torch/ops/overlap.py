"""PE overlap analysis (reference: src/overlapanalysis.cpp:16-183).

Counterpart of fastp_tpu/ops/overlap.py.  The reference scans offsets per
pair and accepts the first offset whose Hamming test passes.  Acceptance
is equivalent to
    accept  <=>  prefix50 <= limit  AND  (total <= limit  OR  olen > 50)
with limit = min(diff_limit, int(float32(olen) * float32(diff_pct)))
(proof in tests/test_overlap_equiv.py).  All forward offsets are tried
before the backward ones.

On a CUDA tensor the sweep and the first-accept selection run fused in one
hand-written kernel (ops/overlap_cuda.py); `sweep_select_plain` below is its
plain PyTorch version, used for CPU tensors and as the kernel's reference.
With `allow_gap` the rows left unaccepted then go through the reference's
one-insertion pass (Matcher::diffWithOneInsertion), forward offsets before
backward: on a CUDA tensor in the same kernel's gapped variant, whose plain
version is `gap_sweep_select_plain` (`sweep_select_plain`, then
`_gap_pass`), for CPU tensors and as that variant's reference.
"""
from __future__ import annotations

import torch

from .common import I32, pos_iota, rc

COMPLETE_COMPARE_REQUIRE = 50


def diff_limit_of(olen, diff_limit: int, diff_pct: float):
    """min(diff_limit, int(float32(max(olen, 0)) * float32(diff_pct))).

    The product is taken in float32, as JAX computes it, and truncated."""
    pct = torch.full((), diff_pct, dtype=torch.float32, device=olen.device)
    lim = (olen.clamp(min=0).to(torch.float32) * pct).to(I32)
    return lim.clamp(max=diff_limit)


def _mm_sweep(a, b, la, lb, n_off: int):
    """mm[r, t] = #{i : a[r, t+i] != b[r, i], i < lb[r], t+i < la[r]} and
    the same count limited to i < 50 (the TPU kernel's two matrices)."""
    B, L = a.shape
    i = pos_iota(B, L, a.device)
    ap = torch.cat([a, torch.zeros_like(a)], 1)
    mm = torch.empty((B, n_off), dtype=I32, device=a.device)
    mm50 = torch.empty_like(mm)
    for t in range(n_off):
        m = (ap[:, t:t + L] != b) & (i < lb[:, None]) & (i + t < la[:, None])
        mm[:, t] = m.sum(1, dtype=I32)
        mm50[:, t] = (m & (i < COMPLETE_COMPARE_REQUIRE)).sum(1, dtype=I32)
    return mm, mm50


def _select_first_accept(mm_f, mm50_f, mm_b, mm50_b, len1, len2,
                         diff_limit: int, overlap_require: int,
                         diff_pct: float, n_off: int):
    """First accepted offset over all forward, then all backward offsets."""
    B = len1.shape[0]
    offs = pos_iota(B, n_off, len1.device)

    def judge(mm, mm50, olen, active):
        limit = diff_limit_of(olen, diff_limit, diff_pct)
        return active & (mm50 <= limit) & \
            ((mm <= limit) | (olen.clamp(min=0) > COMPLETE_COMPARE_REQUIRE))

    olen_f = torch.minimum(len1[:, None] - offs, len2[:, None])
    acc_f = judge(mm_f, mm50_f, olen_f,
                  offs < (len1 - overlap_require)[:, None])
    olen_b = torch.minimum(len1[:, None], len2[:, None] - offs)
    acc_b = judge(mm_b, mm50_b, olen_b,
                  offs < (len2 - overlap_require)[:, None])

    accept = torch.cat([acc_f, acc_b], 1)
    found = accept.any(1)
    idx = torch.where(accept, pos_iota(B, 2 * n_off, len1.device),
                      2 * n_off).amin(1).clamp(max=2 * n_off - 1)
    pick = idx.long()[:, None]
    offset = torch.where(idx < n_off, idx, -(idx - n_off))
    ol = torch.gather(torch.cat([olen_f, olen_b], 1), 1, pick)[:, 0]
    diff = torch.gather(torch.cat([mm_f, mm_b], 1), 1, pick)[:, 0]
    return (found, torch.where(found, offset, 0), torch.where(found, ol, 0),
            torch.where(found, diff, 0))


def sweep_select_plain(seq1, rc2, len1, len2, diff_limit: int,
                       overlap_require: int, diff_pct: float):
    """Plain PyTorch version of the fused CUDA kernel, same signature.

    seq1, rc2: uint8[B, L]; len1, len2: int32[B].  Returns (overlapped
    bool[B], offset, overlap_len, diff int32[B])."""
    L = seq1.shape[1]
    n_off = max(L - overlap_require, 1)
    mm_f, mm50_f = _mm_sweep(seq1, rc2, len1, len2, n_off)
    mm_b, mm50_b = _mm_sweep(rc2, seq1, len2, len1, n_off)
    return _select_first_accept(mm_f, mm50_f, mm_b, mm50_b, len1, len2,
                                diff_limit, overlap_require, diff_pct, n_off)


def _gap_diff(ins, norm, cmplen, limit):
    """Matcher::diffWithOneInsertion (src/matcher.cpp:56-101) per row.

    ins/norm: uint8[B, L] (ins compared at i and i+1, norm at i);
    cmplen/limit: int32[B].  Returns the least diff over the insertion
    points, or -1 where none is allowed (cmplen < 2, or over the limit)."""
    B, L = ins.shape
    i = pos_iota(B, L, ins.device)
    in_cmp = i < cmplen[:, None]
    ins_sh = torch.cat([ins[:, 1:], torch.zeros_like(ins[:, :1])], 1)
    mm_l = (ins != norm).to(I32)
    acc_l = (mm_l * in_cmp).cumsum(1, dtype=I32)           # accLeft[i]
    mm_r = ((ins_sh != norm) & in_cmp).to(I32)
    acc_r = mm_r.flip(1).cumsum(1, dtype=I32).flip(1)      # accRight[i]
    accl_prev = torch.cat([torch.zeros_like(acc_l[:, :1]), acc_l[:, :-1]], 1)
    valid = (i >= 1) & in_cmp
    min_diff = torch.where(valid, accl_prev + acc_r, 10 ** 8).amin(1)
    # accLeft[cmplen-2]: accLeft[cmplen-1] less its last in-range term
    last = (cmplen - 1).clamp(0, L - 1).long()[:, None]
    accl_cm2 = acc_l[:, -1] - torch.gather(mm_l, 1, last)[:, 0]
    accr_last = torch.gather(mm_r, 1, last)[:, 0]          # accRight[cmplen-1]
    over = (accl_cm2 + accr_last) > limit
    return torch.where(over | ~valid.any(1), -1, min_diff)


def _gap_pass(seq1, rc2, len1, len2, diff_limit: int, overlap_require: int,
              diff_pct: float, found, offset, ol, diff):
    """The allow_gap loops of fastp_tpu/ops/overlap.py:_analyze_loop over
    every forward, then every backward offset: a row not yet accepted takes
    the first offset where the one-insertion diff passes the limit, and is
    marked has_gap.  Returns (found, offset, overlap_len, diff, has_gap).
    Half of the gapped kernel's plain version (gap_sweep_select_plain): the
    card runs it only there, as the kernel's reference."""
    B, L = seq1.shape
    n_off = L - overlap_require if L > overlap_require else 0
    z = torch.zeros_like(seq1)
    seq1p = torch.cat([seq1, z], 1)
    rc2p = torch.cat([rc2, z], 1)
    has_gap = torch.zeros_like(found)

    def one_offset(a, b, olen, active, off):
        nonlocal found, offset, ol, diff, has_gap
        limit = diff_limit_of(olen, diff_limit, diff_pct)
        cl = olen - 1
        d1 = _gap_diff(a, b, cl, limit)
        d2 = _gap_diff(b, a, cl, limit)
        dd = torch.where((d1 < 0) | (d1 > limit), d2, d1)
        new = (dd <= limit) & (dd >= 0) & active & ~found
        found = found | new
        offset = torch.where(new, off, offset)
        ol = torch.where(new, olen, ol)
        diff = torch.where(new, dd, diff)
        has_gap = has_gap | new

    for off in range(n_off):
        one_offset(seq1p[:, off:off + L], rc2, torch.minimum(len1 - off, len2),
                   off < len1 - overlap_require, off)
    for k in range(n_off):
        one_offset(seq1, rc2p[:, k:k + L], torch.minimum(len1, len2 - k),
                   k < len2 - overlap_require, -k)
    return found, offset, ol, diff, has_gap


def gap_sweep_select_plain(seq1, rc2, len1, len2, diff_limit: int,
                           overlap_require: int, diff_pct: float):
    """Plain PyTorch version of the gapped CUDA kernel, same signature: the
    ungapped sweep and selection, then the one-insertion pass over the rows
    left unaccepted.  Returns (overlapped bool[B], offset, overlap_len,
    diff int32[B], has_gap bool[B])."""
    found, offset, ol, diff = sweep_select_plain(
        seq1, rc2, len1, len2, diff_limit, overlap_require, diff_pct)
    return _gap_pass(seq1, rc2, len1, len2, diff_limit, overlap_require,
                     diff_pct, found, offset, ol, diff)


def analyze(seq1, len1, seq2, len2, diff_limit: int, overlap_require: int,
            diff_pct: float, allow_gap: bool = False):
    """Batched OverlapAnalysis::analyze.

    seq1/seq2: uint8[B, L] windowed reads; len1/len2: int32[B].
    Returns dict(overlapped bool[B], offset int32[B], overlap_len int32[B],
                 diff int32[B], has_gap bool[B]).  On the card one launch
    of the overlap kernel, of its gapped variant with `allow_gap` (the
    one-insertion pass over the rows the ungapped pass left)."""
    from .overlap_cuda import gap_sweep_select, sweep_select
    len1 = len1.to(I32).contiguous()
    len2 = len2.to(I32).contiguous()
    seq1 = seq1.contiguous()
    rc2 = rc(seq2, len2).contiguous()
    if allow_gap:
        found, offset, ol, diff, has_gap = gap_sweep_select(
            seq1, rc2, len1, len2, diff_limit, overlap_require, diff_pct)
    else:
        found, offset, ol, diff = sweep_select(
            seq1, rc2, len1, len2, diff_limit, overlap_require, diff_pct)
        has_gap = torch.zeros_like(found)
    return {"overlapped": found, "offset": offset, "overlap_len": ol,
            "diff": diff, "has_gap": has_gap}
