"""Frozen, hashable view of Options for device-side (jitted) code.

Everything the device pipeline branches on must be static at trace time;
this dataclass is derived once per run from Options.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..config import Options


@dataclass(frozen=True)
class DeviceCfg:
    paired: bool
    # global trim
    front1: int
    tail1: int
    front2: int
    tail2: int
    maxLen1: int
    maxLen2: int
    # quality cutting
    enabledFront: bool
    enabledTail: bool
    enabledRight: bool
    windowSizeFront: int
    qualityFront: int
    windowSizeTail: int
    qualityTail: int
    windowSizeRight: int
    qualityRight: int
    # polyG/X
    polyg_enabled: bool
    polyg_min_len: int
    polyx_enabled: bool
    polyx_min_len: int
    # adapters
    adapter_enabled: bool
    adapter_seq1: bytes
    adapter_seq2: bytes
    has_seq1: bool
    has_seq2: bool
    fasta_adapters: Tuple[bytes, ...]
    allow_gap_overlap: bool
    # overlap analysis
    overlap_require: int
    overlap_diff_limit: int
    overlap_diff_pct: float
    insert_size_max: int
    correction_enabled: bool
    # filters
    qualfilter_enabled: bool
    qualifiedQual: int
    unqualifiedPercentLimit: int
    avgQualReq: int
    nBaseLimit: int
    lengthFilter_enabled: bool
    requiredLength: int
    maxLength: int
    complexity_enabled: bool
    complexity_threshold_percent: int
    # merge
    merge_enabled: bool
    merge_include_unmerged: bool
    # misc
    overlapped_out: bool
    # per-batch aux-arg presence (statically known per run): when a mask
    # is dead by configuration — no UMI pre-trims, no index filter, no
    # --dedup — the step synthesizes zeros at trace time and the [B]
    # array is never uploaded.  Default True =
    # full signature (external constructors keep the general case).
    has_pretrim: bool = True
    has_index_drop: bool = True
    has_dedup: bool = True
    # lean D2H: per-read result codes reduce to a device-side histogram and
    # routing-only flags (alive/emit_pair) drop from the transfer.  Legal
    # only when no consumer needs per-read codes: the native routed path is
    # available and neither --failed_out (per-read failure tags) nor merge
    # (include_unmerged re-routing) is active.  Every per-read byte fetched
    # from the device costs wall time.
    lean: bool = False


def _lean_ok(opt: Options) -> bool:
    """Per-read result codes can stay on device (histogram only) iff the
    native routed emitter handles output (the pure-Python fallback loop
    reads codes per row) and no stream needs per-read failure reasons.
    Merge mode is lean-capable: the device ships m_emit /
    um_emit bits + a result histogram covering route_pe's three merge row
    classes instead of the wide per-read merge fields."""
    import os
    if os.environ.get("FASTP_TPU_NO_LEAN"):
        return False
    if opt.failedOut:
        return False
    from ..io import native as native_mod
    return native_mod.get_lib() is not None


def device_cfg_from_options(opt: Options) -> DeviceCfg:
    fasta = tuple(s.encode() for s in opt.adapter.seqsInFasta)
    # threshold stored as float percent/100; recover the integer percent
    thr_pct = int(round(opt.complexityFilter.threshold * 100))
    return DeviceCfg(
        paired=opt.isPaired(),
        front1=opt.trim.front1, tail1=opt.trim.tail1,
        front2=opt.trim.front2, tail2=opt.trim.tail2,
        maxLen1=opt.trim.maxLen1, maxLen2=opt.trim.maxLen2,
        enabledFront=opt.qualityCut.enabledFront,
        enabledTail=opt.qualityCut.enabledTail,
        enabledRight=opt.qualityCut.enabledRight,
        windowSizeFront=opt.qualityCut.windowSizeFront,
        qualityFront=opt.qualityCut.qualityFront,
        windowSizeTail=opt.qualityCut.windowSizeTail,
        qualityTail=opt.qualityCut.qualityTail,
        windowSizeRight=opt.qualityCut.windowSizeRight,
        qualityRight=opt.qualityCut.qualityRight,
        polyg_enabled=opt.polyGTrim.enabled,
        polyg_min_len=opt.polyGTrim.minLen,
        polyx_enabled=opt.polyXTrim.enabled,
        polyx_min_len=opt.polyXTrim.minLen,
        adapter_enabled=opt.adapter.enabled,
        adapter_seq1=opt.adapter.sequence.encode() if opt.adapter.hasSeqR1 else b"",
        adapter_seq2=opt.adapter.sequenceR2.encode() if opt.adapter.hasSeqR2 else b"",
        has_seq1=opt.adapter.hasSeqR1,
        has_seq2=opt.adapter.hasSeqR2,
        fasta_adapters=fasta if opt.adapter.hasFasta else (),
        allow_gap_overlap=opt.adapter.allowGapOverlapTrimming,
        overlap_require=opt.overlapRequire,
        overlap_diff_limit=opt.overlapDiffLimit,
        overlap_diff_pct=opt.overlapDiffPercentLimit / 100.0,
        insert_size_max=opt.insertSizeMax,
        correction_enabled=opt.correction.enabled,
        qualfilter_enabled=opt.qualfilter.enabled,
        qualifiedQual=opt.qualfilter.qualifiedQual,
        unqualifiedPercentLimit=opt.qualfilter.unqualifiedPercentLimit,
        avgQualReq=opt.qualfilter.avgQualReq,
        nBaseLimit=opt.qualfilter.nBaseLimit,
        lengthFilter_enabled=opt.lengthFilter.enabled,
        requiredLength=opt.lengthFilter.requiredLength,
        maxLength=opt.lengthFilter.maxLength,
        complexity_enabled=opt.complexityFilter.enabled,
        complexity_threshold_percent=thr_pct,
        merge_enabled=opt.merge.enabled,
        merge_include_unmerged=opt.merge.includeUnmerged,
        overlapped_out=bool(opt.overlappedOut),
        has_pretrim=opt.umi.enabled,
        has_index_drop=opt.indexFilter.enabled,
        has_dedup=opt.duplicate.dedup,
        lean=_lean_ok(opt),
    )
