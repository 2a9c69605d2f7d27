"""Host-side helpers of the streaming processors, free of JAX.

JAX-free copies of what the PE path uses from fastp_tpu/pipeline/runner.py
(that module imports the JAX step at import time): width rounding, the
index blacklist match, grouped adapter-slice recording, the
overrepresented-sequence counter, and a BaseProcessor that keeps the host
state, batch padding and the index-drop masks.  The JAX staging, fetch
pools, on-device accumulator and input packers are not carried over.
"""
from __future__ import annotations

import sys
from typing import List

import numpy as np

from fastp_tpu.config import Options, PASS_FILTER
from fastp_tpu.duplicate import Duplicate
from fastp_tpu.report.stats_model import Stats, cpp_num
from fastp_tpu.umi import UmiProcessor
from fastp_tpu.utils.readname import first_index, last_index
from fastp_tpu.pipeline.static_cfg import device_cfg_from_options


def _round_width(n: int) -> int:
    return max(32, -(-n // 32) * 32)


def _index_match(blacklist: List[str], target: bytes, threshold: int) -> bool:
    """reference: src/filter.cpp:242-258"""
    t = target.decode("latin-1")
    for item in blacklist:
        diff = 0
        ok = True
        for s in range(min(len(item), len(t))):
            if item[s] != t[s]:
                diff += 1
                if diff > threshold:
                    ok = False
                    break
        if ok and diff <= threshold:
            return True
    return False


def _padded_slice_matrix(ba: np.ndarray, rows: np.ndarray,
                         lo: np.ndarray, hi: np.ndarray):
    """(mat [n, maxL] u8 zero-padded, L [n]) for slices ba[rows, lo:hi]."""
    W = ba.shape[1]
    L = np.maximum(hi - lo, 0).astype(np.int64)
    maxL = int(L.max()) if L.size else 0
    if maxL == 0:
        return np.zeros((len(rows), 0), np.uint8), L
    j = np.arange(maxL)
    idx = np.clip(lo.astype(np.int64)[:, None] + j[None, :], 0, W - 1)
    mat = np.where(j[None, :] < L[:, None], ba[rows[:, None], idx], 0)
    return mat.astype(np.uint8, copy=False), L


def _unique_rows(mat: np.ndarray):
    """np.unique over whole rows via a void view; returns
    (first_indices, counts)."""
    m = np.ascontiguousarray(mat)
    if m.shape[1] == 0:
        return (np.zeros(1 if len(m) else 0, np.int64),
                np.array([len(m)] if len(m) else [], np.int64))
    v = m.view(np.dtype((np.void, m.shape[1]))).reshape(-1)
    _, first, counts = np.unique(v, return_index=True, return_counts=True)
    return first.astype(np.int64), counts.astype(np.int64)


def group_slices(ba: np.ndarray, rows: np.ndarray,
                 lo: np.ndarray, hi: np.ndarray):
    """Group the variable-length row slices ba[rows[k], lo[k]:hi[k]].

    Returns [(pos, bytes, count)] in first-occurrence order (pos = index
    within `rows`), so count-aware FilterResult adds replay the exact
    sequential insertion order (the slice length rides in the key header,
    so zero padding cannot alias across lengths)."""
    mat, L = _padded_slice_matrix(ba, rows, lo, hi)
    hdr = L.astype("<u2")[:, None].view(np.uint8).reshape(len(rows), 2)
    first, counts = _unique_rows(np.hstack([hdr, mat]))
    out = [(int(f), mat[f, :int(L[f])].tobytes(), int(c))
           for f, c in zip(first, counts)]
    out.sort(key=lambda t: t[0])
    return out


def group_pair_slices(ba1, lo1, hi1, ba2, lo2, hi2, rows):
    """Pair variant of group_slices: groups by the concatenated
    (slice1, slice2) content.  Returns [(pos, bytes1, bytes2, count)] in
    first-occurrence order."""
    m1, L1 = _padded_slice_matrix(ba1, rows, lo1, hi1)
    m2, L2 = _padded_slice_matrix(ba2, rows, lo2, hi2)
    hdr = np.stack([L1, L2], axis=1).astype("<u2").view(np.uint8) \
        .reshape(len(rows), 4)
    first, counts = _unique_rows(np.hstack([hdr, m1, m2]))
    out = [(int(f), m1[f, :int(L1[f])].tobytes(),
            m2[f, :int(L2[f])].tobytes(), int(c))
           for f, c in zip(first, counts)]
    out.sort(key=lambda t: t[0])
    return out


class _OverRepCounter:
    """Overrepresented-sequence counting on sampled reads
    (reference: src/stats.cpp:312-329).  Scanning runs in the native
    library when available; accumulated counts fold back into the Stats
    dicts via flush()."""

    def __init__(self, stats: Stats, opt: Options):
        self.stats = stats
        self.sampling = opt.overRepAnalysis.sampling
        self.enabled = opt.overRepAnalysis.enabled and len(stats.overrep) > 0
        self.eval_len = stats.evaluated_seq_len
        self._h = None
        if self.enabled:
            from fastp_tpu.io import native as native_mod
            lib = native_mod.get_lib()
            if lib is not None:
                self._lib = lib
                self._keys = [k.encode("latin-1") for k in stats.overrep]
                lens = np.array([len(k) for k in self._keys], np.int32)
                offs = np.zeros(len(self._keys), np.int64)
                np.cumsum(lens[:-1], out=offs[1:])
                blob = np.frombuffer(b"".join(self._keys), np.uint8)
                steps = np.array([10, 20, 40, 100,
                                  min(150, self.eval_len - 2)], np.int32)
                self._h = lib.ora_create(blob, offs, lens, len(self._keys),
                                         self.eval_len, steps, len(steps))
                self._counts = np.zeros(len(self._keys), np.int64)
                self._dist = np.zeros((len(self._keys), self.eval_len), np.int64)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ora_destroy(self._h)
            self._h = None

    def _scan(self, seq: bytes):
        """Pure-Python scan of one read (fallback path)."""
        st = self.stats
        rlen = len(seq)
        steps = (10, 20, 40, 100, min(150, self.eval_len - 2))
        for step in steps:
            i = 0
            while i < rlen - step:
                k = seq[i:i + step].decode("latin-1")
                if k in st.overrep:
                    st.overrep[k] += 1
                    dist = st.overrep_dist[k]
                    for p in range(i, min(i + step, self.eval_len)):
                        dist[p] += 1
                    i += step
                i += 1

    def stat_rows(self, bases: np.ndarray, start, rlen, rows: np.ndarray):
        """Scan the selected (already sampled) rows of a padded batch."""
        if not self.enabled or rows.size == 0:
            return
        if self._h is not None:
            self._lib.ora_stat_batch(
                self._h, np.ascontiguousarray(bases), bases.shape[1],
                np.ascontiguousarray(start, np.int32),
                np.ascontiguousarray(rlen, np.int32),
                np.ascontiguousarray(rows, np.int32), rows.size,
                self._counts, self._dist)
        else:
            for i in rows.tolist():
                s0 = int(start[i])
                self._scan(bases[i, s0:s0 + int(rlen[i])].tobytes())

    def flush(self):
        """Fold native accumulators into the Stats dicts (idempotent)."""
        if self._h is None or not self.enabled:
            return
        st = self.stats
        for ki, key in enumerate(self._keys):
            c = int(self._counts[ki])
            if c:
                k = key.decode("latin-1")
                st.overrep[k] += c
                st.overrep_dist[k] += self._dist[ki]
        self._counts[:] = 0
        self._dist[:] = 0


class BaseProcessor:
    """Host state shared by the processors: options, the static device
    config, UMI and duplicate handlers, and the torch device."""

    def __init__(self, opt: Options, device):
        self.opt = opt
        self.cfg = device_cfg_from_options(opt)
        self.device = device
        self.umi = UmiProcessor(opt)
        self.duplicate = Duplicate(opt) if opt.duplicate.enabled else None
        self.width = _round_width(max(opt.seqLen1, opt.seqLen2, 32))

    def _pad_batch(self, arrays, B, target=None):
        """Pad batch-major arrays to a fixed row count and return them with
        the valid mask.  On the card every batch pads to the batch size, so
        every launch sees one shape; on the CPU small inputs pad to a bucket
        ladder instead, as fastp_tpu does there."""
        tgt = max(B, target or B)
        if self.device.type == "cpu":
            for bucket in (256, 1024, 4096):
                if B <= bucket:
                    tgt = bucket
                    break
        pad = tgt - B
        if pad == 0:
            return arrays, np.ones(B, bool)
        out = [np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) for a in arrays]
        valid = np.zeros(tgt, bool)
        valid[:B] = True
        return out, valid

    def _index_drop_mask(self, names1, names2=None) -> np.ndarray:
        n = len(names1)
        mask = np.zeros(n, bool)
        if not self.opt.indexFilter.enabled:
            return mask
        th = self.opt.indexFilter.threshold
        bl1 = self.opt.indexFilter.blacklist1
        bl2 = self.opt.indexFilter.blacklist2
        for i in range(n):
            if _index_match(bl1, first_index(names1[i]), th):
                mask[i] = True
            elif names2 is not None and _index_match(bl2, last_index(names2[i]), th):
                mask[i] = True
        return mask

    @staticmethod
    def _blacklist_blob(items):
        lens = np.array([len(s) for s in items], np.int32)
        offs = np.zeros(len(items), np.int64)
        if len(items) > 1:
            np.cumsum(lens[:-1], out=offs[1:])
        blob = np.frombuffer(b"".join(s.encode("latin-1") for s in items)
                             or b"\0", np.uint8)
        return blob, offs, lens

    def _index_drop_mask_batches(self, batch1, batch2=None) -> np.ndarray:
        """Native batched index-blacklist filter over the raw name buffers
        (reference: src/filter.cpp:224-258); Python fallback per name."""
        B = batch1.n
        if not self.opt.indexFilter.enabled:
            return np.zeros(B, bool)
        import ctypes
        from fastp_tpu.io import native as native_mod
        lib = native_mod.get_lib()
        if lib is None:
            return self._index_drop_mask(
                batch1.names, batch2.names if batch2 is not None else None)
        if not hasattr(self, "_bl_cache"):
            self._bl_cache = (
                self._blacklist_blob(self.opt.indexFilter.blacklist1),
                self._blacklist_blob(self.opt.indexFilter.blacklist2))
        (b1b, b1o, b1l), (b2b, b2o, b2l) = self._bl_cache
        nb1, noff1, nlen1 = batch1.name_buffers()
        drop = np.zeros(B, np.uint8)
        if batch2 is not None:
            nb2, noff2, nlen2 = batch2.name_buffers()
            nb2c = np.ascontiguousarray(nb2)
            noff2c = np.ascontiguousarray(noff2[:B], np.int64)
            nlen2c = np.ascontiguousarray(nlen2[:B], np.int32)
            p2 = (nb2c.ctypes.data_as(ctypes.c_void_p),
                  noff2c.ctypes.data_as(ctypes.c_void_p),
                  nlen2c.ctypes.data_as(ctypes.c_void_p))
        else:
            p2 = (None, None, None)
        lib.index_filter(
            np.ascontiguousarray(nb1),
            np.ascontiguousarray(noff1[:B], np.int64),
            np.ascontiguousarray(nlen1[:B], np.int32),
            p2[0], p2[1], p2[2],
            b1b, b1o, b1l, len(b1l), b2b, b2o, b2l, len(b2l),
            self.opt.indexFilter.threshold, B, drop)
        return drop.astype(bool)

    def _print_stats(self, st: Stats):
        st.summarize()
        sys.stderr.write("total reads: %d\n" % st.reads)
        sys.stderr.write("total bases: %d\n" % st.bases)
        for name, n in (("Q20", st.q20_total), ("Q30", st.q30_total),
                        ("Q40", st.q40_total)):
            sys.stderr.write("%s bases: %d(%s%%)\n" % (
                name, n, cpp_num(n * 100.0 / st.bases if st.bases
                                 else float("nan"))))

    def _print_filter_result(self):
        fr = self.filter_result
        opt = self.opt
        from fastp_tpu.config import (FAIL_QUALITY, FAIL_N_BASE, FAIL_LENGTH,
                                      FAIL_TOO_LONG, FAIL_COMPLEXITY)
        w = sys.stderr.write
        w("reads passed filter: %d\n" % fr.filter_read_stats[PASS_FILTER])
        w("reads failed due to low quality: %d\n" % fr.filter_read_stats[FAIL_QUALITY])
        w("reads failed due to too many N: %d\n" % fr.filter_read_stats[FAIL_N_BASE])
        if opt.lengthFilter.enabled:
            w("reads failed due to too short: %d\n" % fr.filter_read_stats[FAIL_LENGTH])
            if opt.lengthFilter.maxLength > 0:
                w("reads failed due to too long: %d\n" % fr.filter_read_stats[FAIL_TOO_LONG])
        if opt.complexityFilter.enabled:
            w("reads failed due to low complexity: %d\n" % fr.filter_read_stats[FAIL_COMPLEXITY])
        if opt.adapter.enabled:
            w("reads with adapter trimmed: %d\n" % fr.trimmed_adapter_reads)
            w("bases trimmed due to adapters: %d\n" % fr.trimmed_adapter_bases)
        if opt.polyXTrim.enabled:
            w("reads with polyX in 3' end: %d\n" % fr.get_total_polyx_trimmed_reads())
            w("bases trimmed in polyX tail: %d\n" % fr.get_total_polyx_trimmed_bases())
        if opt.correction.enabled:
            w("reads corrected by overlap analysis: %d\n" % fr.corrected_reads)
            w("bases corrected by overlap analysis: %d\n" % fr.get_total_corrected_bases())
