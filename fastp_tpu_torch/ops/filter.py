"""Read filtering verdicts (reference: src/filter.cpp:14-81, 224-258).

Counterpart of fastp_tpu/ops/filter.py: Filter::passFilter exactly,
including the quirk that low-quality / N counting only happens when
quality OR length filtering is enabled, and the integer average-quality
division.
"""
from __future__ import annotations

import torch

from ..config import (PASS_FILTER, FAIL_N_BASE, FAIL_LENGTH,
                              FAIL_TOO_LONG, FAIL_QUALITY, FAIL_COMPLEXITY)

from .common import I32, pos_iota, N


def pass_filter(bases, quals, lengths, alive, cfg):
    """Returns int32[B] filter result codes.

    `alive=False` (reference NULL read) or an empty read -> FAIL_LENGTH.
    cfg: qualfilter_enabled, qualifiedQual, unqualifiedPercentLimit,
    avgQualReq, nBaseLimit, lengthFilter_enabled, requiredLength, maxLength,
    complexity_enabled, complexity_threshold_percent."""
    B, L = bases.shape
    dev = bases.device
    rlen = lengths.to(I32)
    pos = pos_iota(B, L, dev)
    in_read = pos < rlen[:, None]
    q = quals.to(I32)

    result = torch.full((B,), PASS_FILTER, dtype=I32, device=dev)

    def mark(cond, code):
        return torch.where(cond & (result == PASS_FILTER), code, result)

    if cfg.qualfilter_enabled:
        total_qual = torch.where(in_read, q - 33, 0).sum(1, dtype=I32)
        low_qual = (in_read & (q < cfg.qualifiedQual)).sum(1, dtype=I32)
        n_base = (in_read & (bases == N)).sum(1, dtype=I32)
        # lowQualNum > limit*rlen/100.0, exact as an integer compare
        fail_q = low_qual * 100 > cfg.unqualifiedPercentLimit * rlen
        if cfg.avgQualReq > 0:
            fail_q = fail_q | (total_qual // rlen.clamp(min=1) < cfg.avgQualReq)
        fail_n = ~fail_q & (n_base > cfg.nBaseLimit)
        result = mark(fail_q, FAIL_QUALITY)
        result = mark(fail_n, FAIL_N_BASE)

    if cfg.lengthFilter_enabled:
        result = mark(rlen < cfg.requiredLength, FAIL_LENGTH)
        if cfg.maxLength > 0:
            result = mark(rlen > cfg.maxLength, FAIL_TOO_LONG)

    if cfg.complexity_enabled:
        nxt = torch.cat([bases[:, 1:],
                         torch.zeros((B, 1), dtype=bases.dtype, device=dev)], 1)
        diff = ((pos < (rlen - 1)[:, None]) & (bases != nxt)).sum(1, dtype=I32)
        # passLowComplexityFilter: length <= 1 fails; diff/(len-1) >= k/100
        # compared exactly in integers
        passed = (rlen > 1) & (diff * 100 >= cfg.complexity_threshold_percent
                               * (rlen - 1))
        result = mark(~passed, FAIL_COMPLEXITY)

    # a NULL read or zero length dominates everything
    return torch.where(~alive | (rlen == 0), FAIL_LENGTH, result).to(I32)
