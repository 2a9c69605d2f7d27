"""PE base correction in overlapped regions (reference: src/basecorrector.cpp:16-83).

Counterpart of fastp_tpu/ops/correct.py.  For each overlap position i:
p1 = start1 + i, p2 = start2 - i with start1 = max(0, offset),
start2 = len2 - max(0, -offset) - 1.  Where seq1[p1] != complement(seq2[p2]),
the Q30/Q14 asymmetry decides which mate is overwritten.  Both mappings are
affine, so the opposite mate is read reversed at p2 = (start1 + start2) - j.
"""
from __future__ import annotations

import torch

from .common import I32, pos_iota, complement, scatter_count

GOOD_QUAL = 30 + 33  # num2qual(30) = '?'
BAD_QUAL = 14 + 33   # num2qual(14) = '/'


def _reverse_at(arr, c):
    """out[:, j] = arr[:, c[b] - j] (0 where out of range)."""
    B, L = arr.shape
    src = c.to(I32)[:, None] - pos_iota(B, L, arr.device)
    ok = (src >= 0) & (src < L)
    got = torch.gather(arr, 1, src.clamp(0, L - 1).long())
    return torch.where(ok, got, torch.zeros((), dtype=arr.dtype, device=arr.device))


def correct_by_overlap(seq1, qual1, len1, seq2, qual2, len2,
                       ov_overlapped, ov_offset, ov_overlap_len, ov_diff):
    """Returns (seq1', qual1', seq2', qual2', corr_matrix[64] int64,
    corrected[B], r1_corrected[B], r2_corrected[B], masks).

    corr_matrix is indexed (from & 7) * 8 + (to & 7), as
    FilterResult::addCorrection counts it."""
    B, L = seq1.shape
    j = pos_iota(B, L, seq1.device)
    do = ov_overlapped & (ov_diff != 0)
    start1 = ov_offset.clamp(min=0)
    start2 = len2 - (-ov_offset).clamp(min=0) - 1
    ol = ov_overlap_len[:, None]
    c12 = start1 + start2

    # r1-side view: row position j = p1, i = j - start1
    i1 = j - start1[:, None]
    in_ov1 = (i1 >= 0) & (i1 < ol) & do[:, None]
    s2g = _reverse_at(seq2, c12)
    q2g = _reverse_at(qual2, c12)
    comp_s2g = complement(s2g)
    mismatch1 = in_ov1 & (seq1 != comp_s2g)
    use_r1 = mismatch1 & (qual1 >= GOOD_QUAL) & (q2g <= BAD_QUAL)  # overwrite r2
    use_r2 = mismatch1 & ~use_r1 & (q2g >= GOOD_QUAL) & (qual1 <= BAD_QUAL)

    new_seq1 = torch.where(use_r2, comp_s2g, seq1)
    new_qual1 = torch.where(use_r2, q2g, qual1)

    # r2-side view: row position k = p2, i = start2 - k
    i2 = start2[:, None] - j
    in_ov2 = (i2 >= 0) & (i2 < ol) & do[:, None]
    s1g = _reverse_at(seq1, c12)
    q1g = _reverse_at(qual1, c12)
    mismatch2 = in_ov2 & (s1g != complement(seq2))
    use_r1_2 = mismatch2 & (q1g >= GOOD_QUAL) & (qual2 <= BAD_QUAL)

    new_seq2 = torch.where(use_r1_2, complement(s1g), seq2)
    new_qual2 = torch.where(use_r1_2, q1g, qual2)

    # counters over the r1-side view, one event per overlap position:
    # addCorrection(from=seq2[p2], to=complement(seq1[p1])) for use_r1,
    # addCorrection(from=seq1[p1], to=complement(seq2[p2])) for use_r2
    from1 = (s2g & 7).to(I32) * 8 + (complement(seq1) & 7).to(I32)
    from2 = (seq1 & 7).to(I32) * 8 + (comp_s2g & 7).to(I32)
    used = use_r1 | use_r2
    idx = torch.where(use_r1, from1, torch.where(use_r2, from2, 64))
    corr_matrix = scatter_count(idx, 64, used)[0]

    corrected = used.sum(1, dtype=I32)
    r2_corrected = use_r1.any(1)
    r1_corrected = use_r2.any(1)
    return (new_seq1, new_qual1, new_seq2, new_qual2, corr_matrix,
            corrected, r1_corrected, r2_corrected,
            {"mask1": use_r2, "mask2": use_r1_2})


def extract_deltas_sparse(mask, seq_new, qual_new, C: int):
    """Batch-level sparse (row, pos, base, qual) correction list.

    Slots follow the row-major order of `mask`; unused slots hold row B
    (the sentinel), pos 0 and the base/qual at flat index B*L-1, as
    jnp.nonzero(size=C, fill_value=B*L) gives them.  When more than C
    positions are set, the first C are kept and `count` tells the host to
    recompute the batch.  Returns (rows[C] i32, pos[C] i32, base[C] u8,
    qual[C] u8, count i32 scalar).

    The compaction is a cumsum rank plus a scatter, so nothing here waits
    for the device (torch.nonzero would)."""
    B, L = mask.shape
    dev = mask.device
    flat = mask.reshape(-1)
    rank = flat.to(torch.int64).cumsum(0) - 1  # slot of each set position
    keep = flat & (rank < C)
    slot = torch.where(keep, rank, C)
    idx = torch.full((C + 1,), B * L, dtype=torch.int64, device=dev)
    idx.scatter_(0, slot, torch.arange(B * L, dtype=torch.int64, device=dev))
    idx = idx[:C]
    rows = (idx // L).to(I32)
    pos = (idx - rows.to(torch.int64) * L).to(I32)
    safe = idx.clamp(max=B * L - 1)
    return (rows, pos, seq_new.reshape(-1)[safe], qual_new.reshape(-1)[safe],
            flat.sum(dtype=I32))


def extract_deltas(mask, seq_new, qual_new, K: int):
    """Up to K (position, base, qual) correction deltas per read, in
    ascending position (fastp_tpu/ops/correct.py:extract_deltas).

    The per-row form of the list above: nothing in it looks across rows, so
    a batch split over several devices extracts its shards' deltas where
    they are.  Rows with more than K set positions keep the first K, and
    `count` tells the host to recompute those rows.  The first set position
    is a masked minimum of the column index, never argmax.  Returns
    (pos[B, K] int32 with L as the sentinel, base[B, K] u8, qual[B, K] u8,
    count[B] int32); a sentinel slot holds the base and qual of column L-1.
    """
    B, L = mask.shape
    jpos = pos_iota(B, L, mask.device)
    count = mask.sum(1, dtype=I32)
    m = mask
    poss, bass, quls = [], [], []
    for _ in range(K):
        idx = torch.where(m, jpos, L).min(1).values.to(I32)
        safe = idx.clamp(0, L - 1)[:, None].long()
        poss.append(idx)
        bass.append(torch.gather(seq_new, 1, safe)[:, 0])
        quls.append(torch.gather(qual_new, 1, safe)[:, 0])
        m = m & (jpos != idx[:, None])
    return (torch.stack(poss, 1), torch.stack(bass, 1), torch.stack(quls, 1),
            count)
