"""PE overlap analysis (reference: src/overlapanalysis.cpp:16-183).

Counterpart of fastp_tpu/ops/overlap.py for `allow_gap=False`.  The
reference scans offsets per pair and accepts the first offset whose
Hamming test passes.  Acceptance is equivalent to
    accept  <=>  prefix50 <= limit  AND  (total <= limit  OR  olen > 50)
with limit = min(diff_limit, int(float32(olen) * float32(diff_pct)))
(proof in tests/test_overlap_equiv.py).  All forward offsets are tried
before the backward ones.

On a CUDA tensor the sweep and the first-accept selection run fused in one
hand-written kernel (ops/overlap_cuda.py); `sweep_select_plain` below is its
plain PyTorch version, used for CPU tensors and as the kernel's reference.
"""
from __future__ import annotations

import torch

from .common import I32, pos_iota, rc

COMPLETE_COMPARE_REQUIRE = 50


def diff_limit_of(olen, diff_limit: int, diff_pct: float):
    """min(diff_limit, int(float32(max(olen, 0)) * float32(diff_pct))).

    The product is taken in float32, as JAX computes it, and truncated."""
    pct = torch.tensor(diff_pct, dtype=torch.float32, device=olen.device)
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


def analyze(seq1, len1, seq2, len2, diff_limit: int, overlap_require: int,
            diff_pct: float, allow_gap: bool = False):
    """Batched OverlapAnalysis::analyze (ungapped).

    seq1/seq2: uint8[B, L] windowed reads; len1/len2: int32[B].
    Returns dict(overlapped bool[B], offset int32[B], overlap_len int32[B],
                 diff int32[B], has_gap bool[B])."""
    if allow_gap:
        raise NotImplementedError(
            "--allow_gap_overlap_trimming is not ported yet "
            "(ROADMAP Queue 1 item 11)")
    from .overlap_cuda import sweep_select
    len1 = len1.to(I32).contiguous()
    len2 = len2.to(I32).contiguous()
    rc2 = rc(seq2, len2).contiguous()
    found, offset, ol, diff = sweep_select(
        seq1.contiguous(), rc2, len1, len2, diff_limit, overlap_require,
        diff_pct)
    return {"overlapped": found, "offset": offset, "overlap_len": ol,
            "diff": diff, "has_gap": torch.zeros_like(found)}
