"""Streaming SE processor and the host helpers both processors share.

The port's counterpart of fastp_tpu/pipeline/runner.py: width rounding,
the index blacklist match, grouped adapter-slice recording (one function
for the SE and the PE processor), the overrepresented-sequence counter, a
BaseProcessor that keeps the host state, batch padding, the index-drop
masks and the stat printers, the single-end processor and the split-output
writer set.  The JAX staging, fetch pools, on-device accumulator and input
packers are not carried over: the batch loop is synchronous.
"""
from __future__ import annotations

import ctypes
import os
import sys
from typing import Dict, List

import numpy as np

from ..config import (Options, PASS_FILTER, FAILED_TYPES, FAIL_QUALITY,
                      FAIL_N_BASE, FAIL_LENGTH, FAIL_TOO_LONG, FAIL_COMPLEXITY)
from ..duplicate import Duplicate
from ..io import native as native_mod
from ..io.fastq import OutputWriter, open_batch_reader
from ..parallel import multihost
from ..report.filter_model import FilterResult
from ..report.htmlreport import HtmlReporter
from ..report.jsonreport import JsonReporter
from ..report.stats_model import Stats, cpp_num
from ..umi import UmiProcessor
from ..utils.log import loginfo
from ..utils.readname import first_index, fix_mgi, last_index
from .static_cfg import device_cfg_from_options

from .device import build_se_step, make_aux


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


def record_adapter_hits(fr: FilterResult, bases: np.ndarray, frows, ps, lo, hi,
                        aseq: bytes, is_r2: bool, explicit=()):
    """By-sequence adapter recording (FilterResult::addAdapterTrimmed) for
    the rows `frows` of one mate, in row order.

    ps: the hit position per row (negative: the adapter is clipped at the
    read start, and the recorded string is the adapter's own prefix);
    lo/hi: the recorded slice of `bases` per row otherwise; `explicit`:
    (index into frows, string) for rows whose string the caller made
    itself.  The other rows are grouped by slice content (group_slices), or
    streamed to the native recorder in bulk between the explicit strings."""
    entries = []  # explicit strings: (idx, str, count)
    neg = ps < 0
    negrows = np.flatnonzero(neg)
    if negrows.size:  # adapter clipped at the read start
        uniq, first, counts = np.unique(ps[negrows], return_index=True,
                                        return_counts=True)
        for k in range(uniq.size):
            entries.append((int(negrows[first[k]]),
                            aseq[:len(aseq) + int(uniq[k])].decode(),
                            int(counts[k])))
    own = neg.copy()
    for j, text in explicit:
        entries.append((j, text, 1))
        own[j] = True
    nrm = np.flatnonzero(~own)
    entries.sort(key=lambda t: t[0])
    if fr._adrec is not None:
        # merged walk in row order: normal segments go to the native
        # recorder in bulk, explicit strings one by one
        start = 0
        for idx, text, c in entries + [(frows.size + 1, "", 0)]:
            seg = nrm[(nrm >= start) & (nrm < idx)]
            if seg.size:
                fr.add_adapter_trimmed_rows_bulk(
                    bases, frows[seg], lo[seg], hi[seg], is_r2)
            if text:
                fr.add_adapter_trimmed(text, is_r2, count=c)
            start = idx
    else:
        if nrm.size:
            for p0, bb, c in group_slices(bases, frows[nrm], lo[nrm], hi[nrm]):
                entries.append((int(nrm[p0]), bb.decode("latin-1"), c))
        entries.sort(key=lambda t: t[0])
        for _, text, c in entries:
            fr.add_adapter_trimmed(text, is_r2, count=c)


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

    def stat_read(self, seq: bytes, read_index: int):
        if not self.enabled or read_index % self.sampling != 0:
            return
        if self._h is not None:
            b = np.frombuffer(seq, np.uint8).reshape(1, -1)
            self._lib.ora_stat_batch(
                self._h, np.ascontiguousarray(b), b.shape[1],
                np.zeros(1, np.int32), np.array([len(seq)], np.int32),
                np.zeros(1, np.int32), 1, self._counts, self._dist)
        else:
            self._scan(seq)

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
        self.duplicate = None
        if opt.duplicate.enabled:
            # a shard of a sharded job replays verdicts resolved across all
            # shards (first occurrence by global record index)
            pre = (multihost.exact_dedup_verdicts(opt)
                   if multihost.active() else None)
            self.duplicate = Duplicate(opt, precomputed=pre)
        self.width = _round_width(max(opt.seqLen1, opt.seqLen2, 32))

    def _abandon(self, open_things):
        """A run that dies between batches: end the writers' threads and
        give the Bloom buffers back, so that a resident server keeps
        neither after a failed job."""
        for thing in open_things:
            try:
                thing.close()
            except Exception:
                pass
        if self.duplicate is not None:
            self.duplicate.release()

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


class SingleEndProcessor(BaseProcessor):
    """reference: src/seprocessor.cpp:196-315"""

    def __init__(self, opt: Options, device):
        super().__init__(opt, device)
        self.step = build_se_step(self.cfg, device)
        self.pre_stats = Stats(opt, False, self.width)
        self.post_stats = Stats(opt, False, self.width)
        self.filter_result = FilterResult(opt, False)
        self.overrep_pre = _OverRepCounter(self.pre_stats, opt)
        self.overrep_post = _OverRepCounter(self.post_stats, opt)
        self.batches = 0

    def process(self) -> Dict:
        opt = self.opt
        reader = open_batch_reader(opt.in1, opt.phred64,
                                   getattr(opt, "shardRange1", None),
                                   getattr(opt, "shardRecRange", None))
        out_writer = failed_writer = split = None
        if opt.split.enabled:
            split = SplitWriterSet(opt)
        else:
            if opt.out1 or opt.outputToSTDOUT:
                out_writer = OutputWriter(opt.out1, opt.compression,
                                          opt.outputToSTDOUT,
                                          opt.writerBufferSize)
            if opt.failedOut:
                failed_writer = OutputWriter(opt.failedOut, opt.compression,
                                             buffer_size=opt.writerBufferSize)
        reads_seen = 0
        last_reported = 0
        try:
            while True:
                n = opt.batchSize
                if opt.readsToProcess > 0:
                    n = min(n, opt.readsToProcess - reads_seen)
                    if n <= 0:
                        break
                batch = reader.read_batch(n, self.width)
                if batch is None:
                    break
                blob, failed, post_count = self._process_batch(batch,
                                                               reads_seen)
                if split is not None:
                    split.write1(blob, post_count if opt.split.byFileLines
                                 else batch.n)
                elif out_writer is not None:
                    out_writer.write(blob)
                if failed_writer is not None:
                    failed_writer.write(failed)
                reads_seen += batch.n
                self.batches += 1
                if opt.verbose and reads_seen >= last_reported + 1000000:
                    last_reported = reads_seen
                    loginfo("loaded %dM reads" % (reads_seen // 1000000))
        except BaseException:
            self._abandon([reader] + [w for w in (out_writer, failed_writer,
                                                  split) if w is not None])
            raise
        if opt.verbose:
            loginfo("batch loop done (%d reads)" % reads_seen)
        reader.close()
        for wtr in (out_writer, failed_writer, split):
            if wtr is not None:
                wtr.close()
        return self._finish()

    def _process_batch(self, batch, reads_seen: int):
        """Host pre-ops, the step, counting, adapter recording and
        serialization of one batch.  Returns (passing reads' FASTQ,
        --failed_out FASTQ, number of passing reads)."""
        opt = self.opt
        B = batch.n
        self.width = batch.width
        index_drop = self._index_drop_mask_batches(batch)
        if opt.fixMGI:
            batch.set_names([fix_mgi(nm)[0] for nm in batch.names])
        if opt.umi.enabled:
            res = self.umi.process_batch_arrays(batch)
            if res is not None:
                pre_trim = res[0]
            else:
                names_u, _, pre_trim, _ = self.umi.process_batch(
                    batch.names, batch.seqs())
                batch.set_names(names_u)
                pre_trim = np.asarray(pre_trim, np.int32)
        else:
            pre_trim = np.zeros(B, np.int32)
        bases, quals, lengths = batch.bases, batch.quals, batch.lengths
        dedup_out = np.zeros(B, bool)
        if self.duplicate is not None:
            dup = self.duplicate.check_batch_se(bases, lengths)
            if opt.duplicate.dedup:
                dedup_out = dup

        (bp, qp, lp, ptp, idxp, dedp), valid = self._pad_batch(
            [bases, quals, lengths, pre_trim, index_drop, dedup_out], B,
            target=opt.batchSize)
        out = self.step(bp, qp, lp, *make_aux(self.cfg, valid, ptp, None,
                                              idxp, dedp))
        # lean steps drop total_front when no front trim/cut can move the
        # window start on device: it is exactly the host pre-trim
        out.setdefault("total_front", pre_trim)

        self.pre_stats.add_batch(out["pre"])
        self.post_stats.add_batch(out["post"])
        self.filter_result.add_polyx_trimmed(out["polyx_reads"],
                                             out["polyx_bases"])
        # filter result counting (index-dropped and pad rows excluded); in
        # lean mode the device histogram carries the same counts
        if "result" in out:
            self.filter_result.add_filter_result_array(
                out["result"][:B][~index_drop], 1)
        else:
            self.filter_result.filter_read_stats += \
                out["result_hist"].astype(np.int64)
        if "ad_found" in out and out["ad_found"].any():
            self._record_adapters(out, bases)

        # overrepresentation sampling (pre on original, post on emitted)
        if self.overrep_pre.enabled:
            samp = self.overrep_pre.sampling
            rows = np.arange((-reads_seen) % samp, B, samp, dtype=np.int32)
            self.overrep_pre.stat_rows(bases, np.zeros(B, np.int32), lengths,
                                       rows)
        tf = out["total_front"]
        rlen = out["rlen"]
        emit = out["emit"][:B]
        if native_mod.get_lib() is not None:
            nbuf, noff, nlen = batch.name_buffers()
            sbuf, soff, slen = batch.strand_buffers()
            blob = native_mod.serialize(nbuf, noff, nlen, sbuf, soff, slen,
                                        bases, quals, tf[:B], rlen[:B], emit,
                                        batch.width)
        else:
            parts = []
            for i in np.flatnonzero(emit):
                s0 = int(tf[i])
                s1 = s0 + int(rlen[i])
                parts += [batch.name(i), b"\n", bases[i, s0:s1].tobytes(),
                          b"\n", batch.strand(i), b"\n",
                          quals[i, s0:s1].tobytes(), b"\n"]
            blob = b"".join(parts)
        if self.overrep_post.enabled:
            rows = np.flatnonzero(emit)
            sel = rows[np.arange(rows.size) % self.overrep_post.sampling == 0]
            self.overrep_post.stat_rows(bases, tf[:B], rlen[:B],
                                        sel.astype(np.int32))
        failed = []
        if opt.failedOut and not opt.split.enabled:
            # failed reads show the processed window when they survived
            # trimming, pristine bytes when trim killed them (the reference
            # mutates the Read in place: src/seprocessor.cpp:273)
            result, alive = out["result"], out["alive"]
            for i in np.flatnonzero(~emit & ~index_drop & ~dedup_out):
                if alive[i]:
                    s0 = int(tf[i])
                    s1 = s0 + int(rlen[i])
                else:
                    s0, s1 = int(pre_trim[i]), int(lengths[i])
                failed += [batch.name(i) + b" "
                           + FAILED_TYPES[int(result[i])].encode(), b"\n",
                           bases[i, s0:s1].tobytes(), b"\n", batch.strand(i),
                           b"\n", quals[i, s0:s1].tobytes(), b"\n"]
        return blob, b"".join(failed), int(emit.sum())

    def _record_adapters(self, out, bases: np.ndarray):
        """Adapter recording in row order (see record_adapter_hits)."""
        frows = np.flatnonzero(out["ad_found"])
        tfs = out["total_front"][frows].astype(np.int64)
        record_adapter_hits(
            self.filter_result, bases, frows,
            out["ad_pos"][frows].astype(np.int64),
            tfs + out["rlen_post_adapter"][frows].astype(np.int64),
            tfs + out["rlen_pre_adapter"][frows].astype(np.int64),
            self.cfg.adapter_seq1, False)

    def _finish(self) -> Dict:
        opt = self.opt
        self.overrep_pre.flush()
        self.overrep_post.flush()
        if multihost.active():
            # gather every shard's accumulators; only shard 0 reports
            if not multihost.merge_processor_stats(self, is_pe=False):
                if self.duplicate is not None:
                    self.duplicate.release()
                return {"pre": self.pre_stats, "post": self.post_stats,
                        "filter": self.filter_result, "dup_rate": 0.0,
                        "batches": self.batches}
        sys.stderr.write("Read1 before filtering:\n")
        self._print_stats(self.pre_stats)
        sys.stderr.write("\nRead1 after filtering:\n")
        self._print_stats(self.post_stats)
        sys.stderr.write("\nFiltering result:\n")
        self._print_filter_result()
        dup_rate = 0.0
        if opt.duplicate.enabled:
            dup_rate = self.duplicate.get_dup_rate()
            sys.stderr.write("\nDuplication rate (may be overestimated since "
                             "this is SE data): %s%%\n"
                             % cpp_num(dup_rate * 100.0))
        jr = JsonReporter(opt)
        jr.set_dup(dup_rate)
        jr.report(self.filter_result, self.pre_stats, self.post_stats)
        hr = HtmlReporter(opt)
        hr.set_dup(dup_rate)
        hr.report(self.filter_result, self.pre_stats, self.post_stats)
        if self.duplicate is not None:
            self.duplicate.release()
        return {"pre": self.pre_stats, "post": self.post_stats,
                "filter": self.filter_result, "dup_rate": dup_rate,
                "batches": self.batches}


class SplitWriterSet:
    """Split-output rotation (reference: src/threadconfig.cpp:106-157).

    Emulates the reference's per-worker round-robin file numbering with
    `thread` virtual workers: worker t owns file numbers t+1, t+1+T, ...
    """

    def __init__(self, opt: Options, paired: bool = False):
        self.opt = opt
        self.paired = paired
        self.T = opt.thread
        self.next_worker = 0
        self.worker_split = list(range(1, self.T + 1))  # current file number per worker
        self.worker_count = [0] * self.T
        self._writers1 = [None] * self.T
        self._writers2 = [None] * self.T
        self.finished = [False] * self.T

    def _filename(self, number: int, base: str) -> str:
        num = str(number)
        if self.opt.split.digits > 0:
            num = num.zfill(self.opt.split.digits)
        dirname, fname = os.path.split(base)
        return os.path.join(dirname, "%s.%s" % (num, fname))

    def _open(self, t: int):
        opt = self.opt
        if opt.out1:
            self._writers1[t] = OutputWriter(
                self._filename(self.worker_split[t], opt.out1),
                opt.compression, buffer_size=opt.writerBufferSize)
        if self.paired and opt.out2:
            self._writers2[t] = OutputWriter(
                self._filename(self.worker_split[t], opt.out2),
                opt.compression, buffer_size=opt.writerBufferSize)

    def write1(self, blob: bytes, processed: int, blob2: bytes = None):
        t = self.next_worker
        self.next_worker = (self.next_worker + 1) % self.T
        if self.finished[t]:
            return
        if self._writers1[t] is None and self.opt.out1:
            self._open(t)
        if self._writers1[t] is not None:
            self._writers1[t].write(blob)
        if blob2 is not None and self._writers2[t] is not None:
            self._writers2[t].write(blob2)
        self._mark(t, processed)

    def _mark(self, t: int, count: int):
        """reference: src/threadconfig.cpp:127-147 (markProcessed): rotate
        to the worker's next file number, except in by-file-number mode
        when the quota is reached -- then the current (last) file keeps
        absorbing reads, and workers beyond number%T stop consuming (their
        reads are dropped, as the reference's stopped threads leave their
        remaining packs unconsumed)."""
        opt = self.opt
        self.worker_count[t] += count
        if self.worker_count[t] >= opt.split.size:
            if (opt.split.byFileLines
                    or (self.worker_split[t] - 1) + self.T < opt.split.number):
                self.worker_count[t] = 0
                self.worker_split[t] += self.T
                for writers in (self._writers1, self._writers2):
                    if writers[t]:
                        writers[t].close()
                        writers[t] = None
            elif (opt.split.number % self.T > 0
                    and t >= opt.split.number % self.T):
                self.finished[t] = True

    def close(self):
        for writers in (self._writers1, self._writers2):
            for w in writers:
                if w:
                    w.close()
        # fill the quota with empty files (reference: threadconfig.cpp:151-157)
        if self.opt.split.byFileNumber:
            for num in range(1, self.opt.split.number + 1):
                names = [self.opt.out1] if self.opt.out1 else []
                if self.paired and self.opt.out2:
                    names.append(self.opt.out2)
                for base in names:
                    f = self._filename(num, base)
                    if not os.path.exists(f):
                        open(f, "wb").close()
