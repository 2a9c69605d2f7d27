"""Vectorized PE output routing (native fast path).

Replaces the per-pair Python routing loop in pe_runner with mask algebra
plus one native emit call per output stream (native/route_native.cpp),
reproducing the reference's routing switch exactly
(reference: src/peprocessor.cpp:488-579).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np

from ..config import PASS_FILTER, FAILED_TYPES
from ..io import native as native_mod

_PAIRED_TAG_ID = len(FAILED_TYPES)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.int32)


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.uint8)


_tag_cache = None


def _tag_table():
    """(blob u8, off i64, len i32) for FAILED_TYPES + paired_read_is_failing."""
    global _tag_cache
    if _tag_cache is None:
        tags = [t.encode() for t in FAILED_TYPES] + [b"paired_read_is_failing"]
        lens = np.array([len(t) for t in tags], np.int32)
        offs = np.zeros(len(tags), np.int64)
        np.cumsum(lens[:-1], out=offs[1:])
        _tag_cache = (np.frombuffer(b"".join(tags), np.uint8), offs, lens)
    return _tag_cache


class _Side:
    """Per-batch native emit inputs for one read end."""

    def __init__(self, batch, tf, rlen, pre_trim):
        self.nb, self.noff, self.nlen = batch.name_buffers()
        self.sb, self.soff, self.slen = batch.strand_buffers()
        self.bases = np.ascontiguousarray(batch.bases)
        self.quals = np.ascontiguousarray(batch.quals)
        self.tf = _i32(tf)
        self.rlen = _i32(rlen)
        self.pre = _i32(pre_trim)
        self.lraw = _i32(batch.lengths)
        self.noff = np.ascontiguousarray(self.noff, np.int64)
        self.nlen = _i32(self.nlen)
        self.soff = np.ascontiguousarray(self.soff, np.int64)
        self.slen = _i32(self.slen)


def _emit_routed(lib, s1: _Side, s2: _Side, B: int, W: int,
                 emitA, tagA, emitB, tagB) -> bytes:
    blob, toff, tlen = _tag_table()
    cap = (int(s1.nlen.sum()) + int(s2.nlen.sum())
           + int(s1.slen.sum()) + int(s2.slen.sum())
           + 4 * W * B + 80 * B + 64)
    out = np.empty(cap, np.uint8)
    w = lib.fq_emit_routed(
        s1.nb, s1.noff, s1.nlen, s1.sb, s1.soff, s1.slen,
        s1.bases, s1.quals, s1.tf, s1.rlen, s1.pre, s1.lraw,
        s2.nb, s2.noff, s2.nlen, s2.sb, s2.soff, s2.slen,
        s2.bases, s2.quals, s2.tf, s2.rlen, s2.pre, s2.lraw,
        B, W, _u8(emitA), _i32(tagA), _u8(emitB), _i32(tagB),
        blob, toff, tlen, out)
    return out[:int(w)].tobytes()


def _emit_merged(lib, s1: _Side, s2: _Side, B: int, W: int,
                 m_emit, m_len1, m_len2, m_ol, umA, umB) -> bytes:
    cap = (int(s1.nlen.sum()) + int(s2.nlen.sum())
           + int(s1.slen.sum()) + int(s2.slen.sum())
           + 8 * W * B + 160 * B + 64)
    out = np.empty(cap, np.uint8)
    w = lib.fq_emit_merged(
        s1.nb, s1.noff, s1.nlen, s1.sb, s1.soff, s1.slen,
        s1.bases, s1.quals, s1.tf, s1.rlen,
        s2.nb, s2.noff, s2.nlen, s2.sb, s2.soff, s2.slen,
        s2.bases, s2.quals, s2.tf, s2.rlen,
        B, W, _u8(m_emit), _i32(m_len1), _i32(m_len2), _i32(m_ol),
        _u8(umA), _u8(umB), out)
    return out[:int(w)].tobytes()


def route_pe(proc, out: Dict, batch1, batch2, B: int,
             index_drop, pre_trim1, pre_trim2, dedup_out):
    """Route one PE batch into output stream blobs.

    Returns (parts: {stream: bytes}, read_passed, merged_count) and applies
    filter-result counting + post-ORA sampling as the per-row loop would.
    Corrections are patched into the batch arrays before ANY stream is
    emitted: the reference's trimAndCut/BaseCorrector mutate the one Read
    object in place, so even --failed_out carries the processed window for
    reads that survived trimming (only trim-killed reads keep pristine
    bytes, and both-fail pairs emit nothing; src/peprocessor.cpp:551-577).
    """
    lib = native_mod.get_lib()
    opt = proc.opt
    fr = proc.filter_result
    merge_on = opt.merge.enabled
    include_unmerged = opt.merge.includeUnmerged

    rlen1 = out["rlen1"][:B]
    rlen2 = out["rlen2"][:B]
    # lean mode ships no per-read result/alive arrays: they only feed the
    # merge / --failed_out branches (excluded by lean) and the counting
    # histogram, which the device already reduced (result_hist)
    lean = "result1" not in out
    if not lean:
        result1 = np.asarray(out["result1"][:B], np.int32)
        result2 = np.asarray(out["result2"][:B], np.int32)
        alive1 = np.asarray(out["alive1"][:B], bool)
        alive2 = np.asarray(out["alive2"][:B], bool)
    pass1 = np.asarray(out["pass1"][:B], bool)
    pass2 = np.asarray(out["pass2"][:B], bool)
    index_drop = np.asarray(index_drop[:B], bool)
    dedup_out = np.asarray(dedup_out[:B], bool)
    active = ~index_drop

    s1 = _Side(batch1, out["total_front1"][:B], rlen1, pre_trim1)
    s2 = _Side(batch2, out["total_front2"][:B], rlen2, pre_trim2)
    W = batch1.width
    zeros_u8 = np.zeros(B, np.uint8)
    neg1 = np.full(B, -1, np.int32)
    parts: Dict[str, bytes] = {}
    read_passed = 0
    merged_count = 0

    if merge_on and lean:
        # the device already classified every row (merged / unmerged-
        # survivor / normal), counted results into result_hist, and
        # applied the index/valid masks (merged_ok embeds alive1&alive2)
        m_emit = np.asarray(out["m_emit"][:B], bool)
        normal = np.asarray(out["normal"][:B], bool)
        merged_count = int(m_emit.sum())
        read_passed += merged_count
        umA = umB = zeros_u8
        if include_unmerged:
            umA = np.asarray(out["um_emit1"][:B], bool)
            umB = np.asarray(out["um_emit2"][:B], bool)
            read_passed += int(out["um_both_pass"][0])
    elif merge_on:
        m_ok = np.asarray(out["merged_ok"][:B], bool)
        m_res = np.asarray(out["m_result"][:B], np.int32)
        mm = m_ok & active
        # the reference's merge block requires BOTH mates alive
        # (src/peprocessor.cpp:491 `if(... && r1 && r2)`): dead-mate rows
        # fall through to normal routing even with --include_unmerged
        both_alive = alive1 & alive2
        um = ((~m_ok) & active & both_alive if include_unmerged
              else np.zeros(B, bool))
        normal = active & ~(mm | um)
        fr.add_filter_result_array(m_res[mm], 2)
        m_emit = mm & (m_res == PASS_FILTER)
        merged_count = int(m_emit.sum())
        read_passed += merged_count
        umA = umB = zeros_u8
        if include_unmerged:
            fr.add_filter_result_array(result1[um], 1)
            fr.add_filter_result_array(result2[um], 1)
            r1ok = alive1 & (result1 == PASS_FILTER)
            r2ok = alive2 & (result2 == PASS_FILTER)
            umA = um & r1ok & ~dedup_out
            umB = um & r2ok & ~dedup_out
            read_passed += int((um & r1ok & r2ok).sum())
    else:
        normal = active
        m_emit = umA = umB = zeros_u8

    # --- non-merged routing (reference: src/peprocessor.cpp:525-579) ------
    if not lean:  # lean: the device-side result_hist carries these counts
        fr.add_filter_result_array(
            np.maximum(result1, result2)[normal], 2)
    live = normal & ~dedup_out
    pair_emit = live & pass1 & pass2
    p1only = live & pass1 & ~pass2
    p2only = live & pass2 & ~pass1
    n_pairs = int(pair_emit.sum())

    has_up1 = bool(opt.unpaired1) and not opt.split.enabled
    has_up2 = (bool(opt.unpaired2) and opt.unpaired2 != opt.unpaired1
               and not opt.split.enabled)
    has_failed = bool(opt.failedOut) and not opt.split.enabled

    # corrections land in the arrays now: every stream below carries the
    # processed content.  The reference's trimAndCut/correction mutate the
    # one Read object in place, so even --failed_out shows the processed
    # window for reads that survived trimming; only a trim-killed read
    # (r == NULL) keeps its pristine bytes (src/filter.cpp:83-222,
    # src/peprocessor.cpp:551-577)
    if opt.correction.enabled:
        proc._patch_corrections(batch1, batch2, out, B)

    if has_failed:
        # NOTE the reference writes NOTHING to --failed_out when both
        # mates fail (there is no both-fail branch in
        # src/peprocessor.cpp:551-577); only single-fail pairs emit
        emitA = np.zeros(B, np.uint8)
        emitB = np.zeros(B, np.uint8)
        tagA = neg1.copy()
        tagB = neg1.copy()
        # r1 passed alone: r2 failed-out (window if it survived trimming,
        # pristine bytes if trim killed it); r1 joins as
        # "paired_read_is_failing" only when it has no unpaired home
        emitB[p1only] = np.where(alive2[p1only], 1, 2)
        tagB[p1only] = result2[p1only]
        if not has_up1:
            emitA[p1only] = 1  # the passing mate is alive by definition
            tagA[p1only] = _PAIRED_TAG_ID
        # r2 passed alone: symmetric
        emitA[p2only] = np.where(alive1[p2only], 1, 2)
        tagA[p2only] = result1[p2only]
        if not (has_up2 or has_up1):
            emitB[p2only] = 1
            tagB[p2only] = _PAIRED_TAG_ID
        if emitA.any() or emitB.any():
            parts["failed"] = _emit_routed(
                lib, s1, s2, B, W, emitA, tagA, emitB, tagB)

    if merge_on and (m_emit.any() or umA.any() or umB.any()):
        parts["merged"] = _emit_merged(
            lib, s1, s2, B, W, m_emit,
            out["m_len1"][:B], out["m_len2"][:B], out["ovm_olen"][:B],
            umA, umB)

    if n_pairs:
        if opt.outputToSTDOUT and not merge_on:
            parts["single"] = _emit_routed(
                lib, s1, s2, B, W, pair_emit, neg1, pair_emit, neg1)
        else:
            emitp = _u8(pair_emit)
            parts["out1"] = native_mod.serialize(
                s1.nb, s1.noff, s1.nlen, s1.sb, s1.soff, s1.slen,
                s1.bases, s1.quals, s1.tf, s1.rlen, emitp, W)
            parts["out2"] = native_mod.serialize(
                s2.nb, s2.noff, s2.nlen, s2.sb, s2.soff, s2.slen,
                s2.bases, s2.quals, s2.tf, s2.rlen, emitp, W)

    if has_up1 and (p1only.any() or (not has_up2 and p2only.any())):
        # r2-only survivors fall back to unpaired1 when unpaired2 is absent
        # (reference: src/peprocessor.cpp:566-568)
        emitB = p2only if not has_up2 else np.zeros(B, bool)
        parts["unpaired1"] = _emit_routed(
            lib, s1, s2, B, W, p1only, neg1, emitB, neg1)
    if has_up2 and p2only.any():
        parts["unpaired2"] = _emit_routed(
            lib, s1, s2, B, W, zeros_u8, neg1, p2only, neg1)

    # overlapped_out stream (reference quirk: portion AFTER the overlap;
    # src/peprocessor.cpp:461-468 — not gated on index/dedup drops)
    if opt.overlappedOut and "ov0_ok" in out:
        ov0 = np.asarray(out["ov0_ok"][:B], bool)
        if ov0.any():
            off = np.maximum(np.asarray(out["ov0_offset"][:B], np.int32), 0)
            ol = np.asarray(out["ov0_len"][:B], np.int32)
            start = s1.tf + off + ol
            ln = np.maximum(np.asarray(rlen1, np.int32) - off - ol, 0)
            parts["overlapped"] = native_mod.serialize(
                s1.nb, s1.noff, s1.nlen, s1.sb, s1.soff, s1.slen,
                s1.bases, s1.quals, start, ln, _u8(ov0), W)

    # post-filtering overrepresentation sampling on emitted pairs
    if proc.overrep_post1.enabled and not merge_on and n_pairs:
        samp = proc.overrep_post1.sampling
        rows = np.flatnonzero(pair_emit)
        # ordinal restarts per batch, matching the per-row fallback loop
        ords = np.arange(rows.size)
        sel = rows[(ords % samp) == 0].astype(np.int32)
        proc.overrep_post1.stat_rows(s1.bases, s1.tf, s1.rlen, sel)
        proc.overrep_post2.stat_rows(s2.bases, s2.tf, s2.rlen, sel)

    read_passed += n_pairs
    return parts, read_passed, merged_count
