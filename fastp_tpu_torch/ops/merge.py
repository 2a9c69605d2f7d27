"""PE merging (reference: src/overlapanalysis.cpp:152-183).

Counterpart of fastp_tpu/ops/merge.py:
merged = r1[0:len1_m] + (offset > 0 ? rc(r2)[ol : ol+len2_m] : "")
  len1_m = ol + max(0, offset); len2_m = (offset > 0) ? r2.len - ol : 0
The quality is concatenated the same way; the reversed r2 quality rides
along with the reverse complement.  The host appends the
" merged_<len1>_<len2>" name tag.
"""
from __future__ import annotations

import torch

from .common import pos_iota, rc, reverse_rows, roll_back


def _pad_to(a, width: int):
    """[B, L] -> [B, width]: zero-padded on the right, or cut."""
    B, L = a.shape
    if width > L:
        return torch.cat([a, torch.zeros((B, width - L), dtype=a.dtype,
                                         device=a.device)], 1)
    return a[:, :width]


def merge_pairs(seq1, qual1, len1, seq2, qual2, len2,
                ov_overlapped, ov_offset, ov_overlap_len, out_width: int):
    """Returns (m_seq[B, out_width], m_qual[B, out_width], m_len[B],
    len1_m[B], len2_m[B]).  Rows that did not overlap have length 0."""
    B = seq1.shape[0]
    ol = ov_overlap_len
    shift = ov_offset.clamp(min=0)
    len1_m = ol + shift
    len2_m = torch.where(ov_offset > 0, len2 - ol, 0)
    m_len = torch.where(ov_overlapped, len1_m + len2_m, 0)

    # part 1: j < len1_m -> r1[j]; part 2: rc2[ol + (j - len1_m)], which is
    # rc2[j - max(0, offset)]: rc(r2) rolled back by max(0, offset)
    take2_s = roll_back(_pad_to(rc(seq2, len2), out_width), shift)
    take2_q = roll_back(_pad_to(reverse_rows(qual2, len2), out_width), shift)
    j = pos_iota(B, out_width, seq1.device)
    in1 = j < len1_m[:, None]
    in2 = (j >= len1_m[:, None]) & (j < m_len[:, None])
    zero = torch.zeros((), dtype=seq1.dtype, device=seq1.device)
    m_seq = torch.where(in1, _pad_to(seq1, out_width),
                        torch.where(in2, take2_s, zero))
    m_qual = torch.where(in1, _pad_to(qual1, out_width),
                         torch.where(in2, take2_q, zero))
    return m_seq, m_qual, m_len, len1_m, len2_m
