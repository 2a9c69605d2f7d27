"""Paired-end streaming processor (reference: src/peprocessor.cpp:361-711).

Counterpart of fastp_tpu/pipeline/pe_runner.py, lean or not: two input
files or one interleaved stream, merging, unpaired/failed/overlapped/split
outputs and interleaved or merged stdout.  The batch loop is the pipeline
of pipeline/runner.py:_run_batches: produce() (read -> host pre-ops -> pad
-> submit) runs ahead on the prep worker, _dispatch_pe packs the inputs and
queues the torch step (on one device or split over several) on the
dispatch worker, the fetch workers unpack the per-read outputs (the batch's
sums stay on the device until the end of the run), and the calling thread
counts, routes and writes the batches in input order.  Routing is route_pe
(pipeline/pe_route.py) where the native library loaded, else the per-row
loop below, as in fastp_tpu.
"""
from __future__ import annotations

import sys
import time
from types import SimpleNamespace
from typing import Dict

import numpy as np

from ..config import Options, FAILED_TYPES, PASS_FILTER
from ..io import native as native_mod
from ..io.fastq import ArrayBatch, OutputWriter, open_batch_reader
from ..parallel import multihost
from ..report.filter_model import FilterResult
from ..report.htmlreport import HtmlReporter
from ..report.jsonreport import JsonReporter
from ..report.stats_model import Stats, cpp_num
from ..utils.log import loginfo
from ..utils.readname import fix_mgi
from .hostview import (PairWindowView, host_analyze_overlap,
                                         host_correct_pair)
from .pe_route import route_pe

from .device import build_pe_step, make_aux
from .runner import (BaseProcessor, SplitWriterSet, _OverRepCounter,
                     _round_width, group_pair_slices, record_adapter_hits)

# the PE path's file streams, in the order fastp_tpu writes them; --stdout
# takes "merged" with --merge, else "single", the interleaved pairs
_STREAMS = ("out1", "out2", "unpaired1", "unpaired2", "merged", "failed",
            "overlapped")


class _SeqView:
    """List-like adapter exposing an ArrayBatch's per-row seq/qual bytes."""

    def __init__(self, batch: ArrayBatch, quals: bool = False):
        self.batch = batch
        self.quals = quals

    def __getitem__(self, i: int) -> bytes:
        return (self.batch.qual_bytes(i) if self.quals
                else self.batch.seq_bytes(i))

    def __len__(self):
        return self.batch.n


def _split_interleaved(batch: ArrayBatch):
    """De-interleave a batch into (left, right) halves (even/odd rows)."""
    def half(sel):
        return ArrayBatch(
            len(sel), batch.width,
            np.ascontiguousarray(batch.bases[sel]),
            np.ascontiguousarray(batch.quals[sel]),
            np.ascontiguousarray(batch.lengths[sel]), chunk=batch.chunk,
            name_off=batch.name_off[sel] if batch.name_off is not None else None,
            name_len=batch.name_len[sel] if batch.name_len is not None else None,
            strand_off=batch.strand_off[sel] if batch.strand_off is not None else None,
            strand_len=batch.strand_len[sel] if batch.strand_len is not None else None,
            names=([batch.names[i] for i in sel] if batch.name_off is None else None),
            strands=([batch.strands[i] for i in sel] if batch.strand_off is None else None))
    n2 = batch.n // 2
    even = np.arange(0, 2 * n2, 2)
    odd = even + 1
    return half(even), half(odd)


class _InterleavedPairSource:
    """Pairs from one interleaved stream: 2n records, split even/odd."""

    def __init__(self, reader):
        self.reader = reader

    def read_pair_batch(self, n: int, width: int):
        batch = self.reader.read_batch(2 * n, width)
        if batch is None or batch.n < 2:
            return None, None
        return _split_interleaved(batch)

    def close(self):
        self.reader.close()


class _TwoFilePairSource:
    """Pairs from two files, batch by batch."""

    def __init__(self, reader1, reader2):
        self.readers = (reader1, reader2)

    def read_pair_batch(self, n: int, width: int):
        return tuple(r.read_batch(n, width) for r in self.readers)

    def close(self):
        for r in self.readers:
            r.close()


class PairEndProcessor(BaseProcessor):
    def __init__(self, opt: Options, devices):
        super().__init__(opt, devices)
        self.step = self._wrap_step(build_pe_step)
        self.pre_stats1 = Stats(opt, False, self.width)
        self.post_stats1 = Stats(opt, False, self.width * 2)
        self.pre_stats2 = Stats(opt, True, self.width)
        self.post_stats2 = Stats(opt, True, self.width)
        self.filter_result = FilterResult(opt, True)
        self.insert_hist = np.zeros(opt.insertSizeMax + 1, np.int64)
        self.overrep_pre1 = _OverRepCounter(self.pre_stats1, opt)
        self.overrep_pre2 = _OverRepCounter(self.pre_stats2, opt)
        self.overrep_post1 = _OverRepCounter(self.post_stats1, opt)
        self.overrep_post2 = _OverRepCounter(self.post_stats2, opt)
        # batches whose corrections overflowed their slots (the step's
        # sparse list, or a row's K of a split step) and were recomputed on
        # the host; returned with the result
        self.corr_overflow_batches = 0

    def _process_inner(self) -> Dict:
        opt = self.opt
        if opt.interleavedInput:
            source = _InterleavedPairSource(open_batch_reader(
                opt.in1, opt.phred64, getattr(opt, "shardRange1", None),
                getattr(opt, "shardRecRange", None)))
        else:
            source = _TwoFilePairSource(
                open_batch_reader(opt.in1, opt.phred64,
                                  getattr(opt, "shardRange1", None),
                                  getattr(opt, "shardRecRange", None)),
                open_batch_reader(opt.in2, opt.phred64,
                                  getattr(opt, "shardRange2", None),
                                  getattr(opt, "shardRecRange", None)))
        writers = {}
        split = None
        if opt.split.enabled:
            split = SplitWriterSet(opt, paired=True)
        else:
            for key, path in (("out1", opt.out1), ("out2", opt.out2),
                              ("unpaired1", opt.unpaired1),
                              ("merged", opt.merge.out),
                              ("failed", opt.failedOut),
                              ("overlapped", opt.overlappedOut)):
                if path:
                    writers[key] = OutputWriter(path, opt.compression,
                                                buffer_size=opt.writerBufferSize)
            if opt.unpaired2 and opt.unpaired2 != opt.unpaired1:
                writers["unpaired2"] = OutputWriter(
                    opt.unpaired2, opt.compression,
                    buffer_size=opt.writerBufferSize)
            if opt.outputToSTDOUT:
                writers["stdout"] = OutputWriter("", opt.compression,
                                                 to_stdout=True)
        to_stdout = (("merged" if opt.merge.enabled else "single")
                     if opt.outputToSTDOUT else None)
        self._last_reported = 0
        state = SimpleNamespace(eof=False, read=0)

        def produce(timer):
            """Read one batch of pairs, run the host pre-ops and submit it;
            called ahead of the loop, on the prep worker, for batch k+1
            before batch k's outputs are fetched.  The item carries the
            batch's starting pair index and its width: this function runs
            ahead of whoever consumes the item."""
            if state.eof:
                return None
            n = opt.batchSize
            if opt.readsToProcess > 0:
                n = min(n, opt.readsToProcess - state.read)
                if n <= 0:
                    state.eof = True
                    return None
            t0 = time.monotonic()
            batch1, batch2 = source.read_pair_batch(n, self.width)
            timer.add("read", t0)
            if batch1 is None or batch2 is None:
                state.eof = True
                return None
            if batch1.n != batch2.n:
                sys.stderr.write("\nWARNNIG: different read numbers of the input files\n"
                                 "Read1 count: %d\nRead2 count: %d\n"
                                 "Ignore the unmatched reads\n\n" % (batch1.n, batch2.n))
                m = min(batch1.n, batch2.n)
                batch1 = batch1.head(m)
                batch2 = batch2.head(m)
            B = batch1.n
            if batch1.width != batch2.width:
                w = max(batch1.width, batch2.width)
                batch1 = batch1.widen(w)
                batch2 = batch2.widen(w)
            self.width = batch1.width

            index_drop = self._index_drop_mask_batches(batch1, batch2)
            if opt.fixMGI:
                batch1.set_names([fix_mgi(nm)[0] for nm in batch1.names])
                batch2.set_names([fix_mgi(nm)[0] for nm in batch2.names])
            if opt.umi.enabled:
                res = self.umi.process_batch_arrays(batch1, batch2)
                if res is not None:
                    pre_trim1, pre_trim2 = res
                else:
                    names1u, names2u, pre_trim1, pre_trim2 = self.umi.process_batch(
                        batch1.names, _SeqView(batch1), batch2.names, _SeqView(batch2))
                    batch1.set_names(names1u)
                    batch2.set_names(names2u)
                    pre_trim1 = np.asarray(pre_trim1, np.int32)
                    pre_trim2 = np.asarray(pre_trim2, np.int32)
            else:
                pre_trim1 = np.zeros(B, np.int32)
                pre_trim2 = np.zeros(B, np.int32)

            b1, q1, l1 = batch1.bases, batch1.quals, batch1.lengths
            b2, q2, l2 = batch2.bases, batch2.quals, batch2.lengths
            dedup_out = np.zeros(B, bool)
            if self.duplicate is not None:
                t0 = time.monotonic()
                dup = self.duplicate.check_batch_pe(b1, l1, b2, l2)
                timer.add("dup", t0)
                if opt.duplicate.dedup:
                    dedup_out = dup

            t0 = time.monotonic()
            padded, valid = self._pad_batch(
                [b1, q1, l1, b2, q2, l2, pre_trim1, pre_trim2, index_drop,
                 dedup_out], B, target=opt.batchSize)
            t0 = timer.add("pad", t0)
            pending = self._submit_batch(self._dispatch_pe, *padded, valid)
            timer.add("submit", t0)
            item = SimpleNamespace(
                pending=pending, out=None, batch1=batch1, batch2=batch2, B=B,
                start=state.read, index_drop=index_drop, pre_trim1=pre_trim1,
                pre_trim2=pre_trim2, dedup_out=dedup_out)
            state.read += B
            return item

        def flush(item, routed):
            parts, read_passed = routed
            if split is not None:
                split.write1(parts.get("out1", b""),
                             read_passed if opt.split.byFileLines else item.B,
                             parts.get("out2", b""))
                return
            if to_stdout:
                writers["stdout"].write(parts.get(to_stdout, b""))
            for key in _STREAMS:
                if key in writers and key != to_stdout and parts.get(key):
                    writers[key].write(parts[key])

        open_things = [source, *writers.values()] + (
            [split] if split is not None else [])
        pairs_seen = self._run_batches(produce, flush, open_things, "pairs")
        if opt.verbose:
            loginfo("batch loop done (%d pairs)" % pairs_seen)
        for thing in open_things:
            thing.close()
        return self._finish()

    def _log_progress(self, seen: int):
        if self.opt.verbose and seen >= self._last_reported + 1000000:
            self._last_reported = seen
            for read in ("Read1", "Read2"):
                loginfo("%s: loaded %dM reads" % (read, seen // 1000000))

    def _dispatch_pe(self, b1p, q1p, l1p, b2p, q2p, l2p, pt1p, pt2p,
                     idxp, dedp, valid):
        """Pack, upload and queue the step for one padded batch of pairs
        (on the dispatch worker).  Returns the pending fetch."""
        aux = make_aux(self.cfg, valid, pt1p, pt2p, idxp, dedp)
        return self._dispatch_mates([(b1p, q1p), (b2p, q2p)], [l1p, l2p], aux)

    def _add_sums(self, vals, routed: bool = True):
        """Add a dict of batch-reduced sums to the host's stats: a batch's
        output dict, or in accumulate mode the run's, at its end (merging
        accumulates only on the routed path).  `routed`: the native routing
        emits the unmerged survivors, so their post stats come from the
        device (the per-row loop counts them itself, read by read)."""
        opt = self.opt
        self.pre_stats1.add_batch(vals["pre1"])
        self.pre_stats2.add_batch(vals["pre2"])
        if opt.merge.enabled:
            # the merged stream's stats stand in for the per-mate post stats
            self.post_stats1.add_batch(vals["post_merged"])
            if opt.merge.includeUnmerged and routed:
                self.post_stats1.add_batch(vals["post_um1"])
                self.post_stats1.add_batch(vals["post_um2"])
        else:
            self.post_stats1.add_batch(vals["post1"])
            self.post_stats2.add_batch(vals["post2"])
        self.insert_hist[:len(vals["isize_hist"])] += vals["isize_hist"]
        self.filter_result.add_polyx_trimmed(vals["polyx_reads"],
                                             vals["polyx_bases"])
        if opt.correction.enabled:
            self.filter_result.add_correction_matrix(vals["corr_matrix"])
        if "result_hist" in vals:
            # lean: the device histogram replaces the per-row counting
            self.filter_result.filter_read_stats += \
                vals["result_hist"].astype(np.int64)

    def _process_batch(self, item):
        """The consuming half of one batch, in input order on the calling
        thread: counting, adapter recording, overrepresentation sampling and
        routing of the fetched outputs (item.out).  Returns
        ({stream: FASTQ bytes}, pairs passed)."""
        opt = self.opt
        batch1, batch2, B, out = item.batch1, item.batch2, item.B, item.out
        index_drop, dedup_out = item.index_drop, item.dedup_out
        pre_trim1, pre_trim2 = item.pre_trim1, item.pre_trim2
        pairs_seen = item.start
        # lean steps drop total_front when no front trim/cut can move the
        # window start on device: it is exactly the host-known pre-trim
        out.setdefault("total_front1", pre_trim1)
        out.setdefault("total_front2", pre_trim2)

        routed = native_mod.get_lib() is not None
        if not self._accum:
            self._add_sums(out, routed)
        if opt.correction.enabled:
            # stays per batch, with the correction lists it belongs to
            self.filter_result.inc_corrected_reads(int(out["corrected_reads"]))
            if "c1k_cnt" in out:
                K = out["c1k_pos"].shape[0]
                over = bool((out["c1k_cnt"][:B] > K).any()
                            or (out["c2k_cnt"][:B] > K).any())
            else:
                C = out["c1_rows"].shape[0]
                over = int(out["c1_count"]) > C or int(out["c2_count"]) > C
            self.corr_overflow_batches += over

        view = PairWindowView(_SeqView(batch1), _SeqView(batch1, True),
                              _SeqView(batch2), _SeqView(batch2, True),
                              out, opt.correction.enabled, batch1.width,
                              ov_params=(opt.overlapDiffLimit,
                                         opt.overlapRequire,
                                         opt.overlapDiffPercentLimit / 100.0))
        if opt.adapter.enabled:
            self._record_adapters(out, batch1, batch2, view)

        if self.overrep_pre1.enabled:
            samp = self.overrep_pre1.sampling
            rows = np.arange((-pairs_seen) % samp, B, samp, dtype=np.int32)
            zeros = np.zeros(B, np.int32)
            self.overrep_pre1.stat_rows(batch1.bases, zeros, batch1.lengths, rows)
            self.overrep_pre2.stat_rows(batch2.bases, zeros, batch2.lengths, rows)

        if routed:
            parts, read_passed, merged_count = route_pe(
                self, out, batch1, batch2, B, index_drop, pre_trim1,
                pre_trim2, dedup_out)
        else:
            parts, read_passed, merged_count = self._route_rows(
                out, view, batch1, batch2, B, index_drop, pre_trim1,
                pre_trim2, dedup_out)
        if opt.merge.enabled:
            self.filter_result.add_merged_pairs(merged_count)
        return parts, read_passed

    def _route_rows(self, out, view: PairWindowView, batch1: ArrayBatch,
                    batch2: ArrayBatch, B: int, index_drop, pre_trim1,
                    pre_trim2, dedup_out):
        """Per-row routing where the native library is missing (the
        fallback loop of fastp_tpu/pipeline/pe_runner.py:443-594).
        Corrections come from the window view, not from patched arrays.
        Returns ({stream: bytes}, pairs passed, pairs merged)."""
        opt = self.opt
        parts = {k: [] for k in _STREAMS + ("single",)}
        rlen1, rlen2 = out["rlen1"], out["rlen2"]
        result1, result2 = out["result1"], out["result2"]
        pass1, pass2 = out["pass1"], out["pass2"]
        merge_on = opt.merge.enabled
        pairs_key = ("single", "single") if (opt.outputToSTDOUT
                                            and not merge_on) else ("out1", "out2")
        read_passed = 0
        merged_count = 0

        def record(key, batch, i, win):
            seq, qual = win
            parts[key] += [batch.name(i), b"\n", seq, b"\n",
                           batch.strand(i), b"\n", qual, b"\n"]

        if opt.overlappedOut:
            for i in np.flatnonzero(out["ov0_ok"][:B]):
                off = max(0, int(out["ov0_offset"][i]))
                ol = int(out["ov0_len"][i])
                # reference quirk (src/peprocessor.cpp:464): the
                # string(str, pos) ctor keeps the portion AFTER the overlap
                s1w, q1w = view.r1(i, int(rlen1[i]))
                record("overlapped", batch1, i, (s1w[off:][ol:], q1w[off:][ol:]))

        up2 = opt.unpaired2 and opt.unpaired2 != opt.unpaired1
        for i in range(B):
            if index_drop[i]:
                continue
            if merge_on and out["merged_ok"][i]:
                m_res = int(out["m_result"][i])
                self.filter_result.add_filter_result(m_res, 2)
                if m_res == PASS_FILTER:
                    m_len1, m_len2 = int(out["m_len1"][i]), int(out["m_len2"][i])
                    tag = b" merged_%d_%d" % (m_len1, m_len2)
                    strand = batch1.strand(i)
                    if strand != b"+":
                        strand = strand + tag
                    ms, mq = view.merged(i, int(rlen1[i]), int(rlen2[i]),
                                         int(out["ovm_olen"][i]), m_len1,
                                         m_len2)
                    parts["merged"] += [batch1.name(i) + tag, b"\n", ms, b"\n",
                                        strand, b"\n", mq, b"\n"]
                    read_passed += 1
                    merged_count += 1
                continue
            if (merge_on and opt.merge.includeUnmerged and out["alive1"][i]
                    and out["alive2"][i]):
                # the reference's merge block requires both mates alive
                # (src/peprocessor.cpp:491); dead-mate rows fall through
                for batch, res, rlen, win in ((batch1, result1, rlen1, view.r1),
                                              (batch2, result2, rlen2, view.r2)):
                    self.filter_result.add_filter_result(int(res[i]), 1)
                    if res[i] == PASS_FILTER and not dedup_out[i]:
                        sw, qw = win(i, int(rlen[i]))
                        record("merged", batch, i, (sw, qw))
                        self._stat_post1_read(sw, qw)
                if result1[i] == PASS_FILTER and result2[i] == PASS_FILTER:
                    read_passed += 1
                continue
            self.filter_result.add_filter_result(
                max(int(result1[i]), int(result2[i])), 2)
            if dedup_out[i]:
                continue
            if pass1[i] and pass2[i]:
                s1, qq1 = view.r1(i, int(rlen1[i]))
                s2, qq2 = view.r2(i, int(rlen2[i]))
                record(pairs_key[0], batch1, i, (s1, qq1))
                record(pairs_key[1], batch2, i, (s2, qq2))
                if self.overrep_post1.enabled and not merge_on:
                    self.overrep_post1.stat_read(s1, read_passed)
                    self.overrep_post2.stat_read(s2, read_passed)
                read_passed += 1
            elif pass1[i]:
                fail2 = (view.r2(i, int(rlen2[i]))
                         if out["alive2"][i] else None)
                if opt.unpaired1:
                    record("unpaired1", batch1, i, view.r1(i, int(rlen1[i])))
                elif opt.failedOut:
                    self._failed_row(parts, batch1, i, pre_trim1[i],
                                     "paired_read_is_failing",
                                     win=view.r1(i, int(rlen1[i])))
                if opt.failedOut:
                    self._failed_row(parts, batch2, i, pre_trim2[i],
                                     FAILED_TYPES[int(result2[i])], win=fail2)
            elif pass2[i]:
                fail1 = (view.r1(i, int(rlen1[i]))
                         if out["alive1"][i] else None)
                target = ("unpaired2" if up2
                          else "unpaired1" if opt.unpaired1 else None)
                if target:
                    record(target, batch2, i, view.r2(i, int(rlen2[i])))
                if opt.failedOut:
                    self._failed_row(parts, batch1, i, pre_trim1[i],
                                     FAILED_TYPES[int(result1[i])], win=fail1)
                    if not target:
                        self._failed_row(parts, batch2, i, pre_trim2[i],
                                         "paired_read_is_failing",
                                         win=view.r2(i, int(rlen2[i])))
            # both-fail pairs write NOTHING to --failed_out
            # (no such branch in src/peprocessor.cpp:551-577)
        return ({k: b"".join(v) for k, v in parts.items() if v}, read_passed,
                merged_count)

    def _stat_post1_read(self, seq: bytes, qual: bytes):
        """Single-read post-stats accumulation for --include_unmerged rows
        of the per-row loop (fastp_tpu/pipeline/pe_runner.py:766-800)."""
        st = self.post_stats1
        n = len(seq)
        if n > st.buf_len:
            st._grow(_round_width(n))
        s = np.frombuffer(seq, np.uint8)
        q = np.frombuffer(qual, np.uint8).astype(np.int64)
        slot = s & 7
        st.reads += 1
        st.length_sum += n
        pos = np.arange(n)
        np.add.at(st.cycle_content, (slot, pos), 1)
        np.add.at(st.cycle_qual, (slot, pos), q - 33)
        np.add.at(st.cycle_q20, (slot[q >= ord('5')], pos[q >= ord('5')]), 1)
        np.add.at(st.cycle_q30, (slot[q >= ord('?')], pos[q >= ord('?')]), 1)
        st.cycle_total_base[:n] += 1
        st.cycle_total_qual[:n] += q - 33
        np.add.at(st.qual_hist, np.clip(q, 0, 127), 1)
        # 5-mer keys over the read's ACGT runs
        v = np.full(n, -1, np.int64)
        v[s == 65] = 0
        v[s == 84] = 1
        v[s == 67] = 2
        v[s == 71] = 3
        if n >= 5:
            keys = np.zeros(n - 4, np.int64)
            ok = np.ones(n - 4, bool)
            for k in range(5):
                chunk = v[k:k + n - 4]
                keys = (keys << 2) | np.maximum(chunk, 0)
                ok &= chunk >= 0
            np.add.at(st.kmer, keys[ok] & 0x3FF, 1)
        st._summarized = False

    @staticmethod
    def _failed_row(parts, batch: ArrayBatch, i: int, pre_trim, tag,
                    win=None):
        """win = (seq, qual) processed-window bytes for a read that survived
        trimming (the reference mutates the Read in place, so failed output
        shows the processed content); None = trim-killed, pristine bytes."""
        if win is not None:
            seq, qual = win
        else:
            p0 = int(pre_trim)
            ln = int(batch.lengths[i])
            seq = batch.bases[i, p0:ln].tobytes()
            qual = batch.quals[i, p0:ln].tobytes()
        parts["failed"] += [batch.name(i) + b" " + tag.encode(), b"\n", seq,
                            b"\n", batch.strand(i), b"\n", qual, b"\n"]

    def _record_adapters(self, out, batch1: ArrayBatch, batch2: ArrayBatch,
                         view: PairWindowView):
        """Adapter recording (FilterResult::addAdapterTrimmed) in row order:
        overlap-clipped pairs, then by-sequence hits per mate."""
        opt = self.opt
        # corrections never land in the overlap-clipped region, so
        # ov-trimmed adapters slice the raw arrays; rows with corrections
        # use the correction-aware view for the by-sequence case
        hc = view.has_corr if opt.correction.enabled else None
        tf1a = out["total_front1"]
        tf2a = out["total_front2"]
        ba1, ba2 = batch1.bases, batch2.bases
        fr = self.filter_result
        rows = np.flatnonzero(out["ov_trimmed"])
        if rows.size:
            s01 = tf1a[rows].astype(np.int64)
            s02 = tf2a[rows].astype(np.int64)
            lo1 = s01 + out["rlen1_pre_adapter"][rows]
            hi1 = s01 + out["rlen1_pre_ovtrim"][rows]
            lo2 = s02 + out["rlen2_pre_adapter"][rows]
            hi2 = s02 + out["rlen2_pre_ovtrim"][rows]
            if not fr.add_adapter_trimmed_pairs_bulk(
                    ba1, lo1, hi1, ba2, lo2, hi2, rows):
                for _, b1b, b2b, c in group_pair_slices(
                        ba1, lo1, hi1, ba2, lo2, hi2, rows):
                    fr.add_adapter_trimmed_pair(
                        b1b.decode("latin-1"), b2b.decode("latin-1"), count=c)
        for found_key, pos_key, pre_key, slicer, tfa, ba, aseq, is_r2 in (
                ("ad_found1", "ad_pos1", "rlen1_pre_adapter",
                 view.r1_slice, tf1a, ba1, self.cfg.adapter_seq1, False),
                ("ad_found2", "ad_pos2", "rlen2_pre_adapter",
                 view.r2_slice, tf2a, ba2, self.cfg.adapter_seq2, True)):
            found = out[found_key]
            if not found.any():
                continue
            frows = np.flatnonzero(found)
            ps = out[pos_key][frows].astype(np.int64)
            pres = out[pre_key][frows].astype(np.int64)
            tfs = tfa[frows].astype(np.int64)
            hcs = hc[frows] if hc is not None else np.zeros(frows.size, bool)
            # rows with corrections inside the adapter region need the
            # correction-aware per-row view
            explicit = [(j, slicer(int(frows[j]), int(ps[j]),
                                   int(pres[j])).decode("latin-1"))
                        for j in np.flatnonzero((ps >= 0) & hcs).tolist()]
            record_adapter_hits(fr, ba, frows, ps, tfs + ps, tfs + pres, aseq,
                                is_r2, explicit)

    def _patch_corrections(self, batch1: ArrayBatch, batch2: ArrayBatch,
                           out, B: int):
        """Apply the step's sparse correction deltas in place to the padded
        arrays so the native serializer emits corrected content.  Batches
        whose count exceeds the slot capacity are recomputed exactly on the
        host (reference: src/basecorrector.cpp:16-83)."""
        if "c1k_pos" in out:  # a split step: per-row top-K deltas
            return self._patch_corrections_rowwise(batch1, batch2, out, B)
        C = out["c1_rows"].shape[0]  # slot capacity of the step
        n1 = int(out["c1_count"])
        n2 = int(out["c2_count"])
        if n1 == 0 and n2 == 0:
            return
        if n1 > C or n2 > C:
            self._host_correct_all(batch1, batch2, out, B)
            return
        tf1 = out["total_front1"]
        tf2 = out["total_front2"]
        for bt, tf, rows_k, pos_k, base_k, qual_k, cnt in (
                (batch1, tf1, "c1_rows", "c1_pos", "c1_base", "c1_qual", n1),
                (batch2, tf2, "c2_rows", "c2_pos", "c2_base", "c2_qual", n2)):
            if cnt == 0:
                continue
            rows = out[rows_k][:cnt]
            apos = tf[rows] + out[pos_k][:cnt]
            ok = apos < bt.lengths[rows]
            rows, apos = rows[ok], apos[ok]
            bt.bases[rows, apos] = out[base_k][:cnt][ok]
            bt.quals[rows, apos] = out[qual_k][:cnt][ok]

    def _patch_corrections_rowwise(self, batch1: ArrayBatch,
                                   batch2: ArrayBatch, out, B: int):
        """The split step's twin of _patch_corrections: per-row [K, B] delta
        matrices (ops/correct.py:extract_deltas) instead of the batch-level
        sparse lists; rows whose count exceeds K are recomputed exactly on
        the host."""
        K = out["c1k_pos"].shape[0]
        cnt1 = np.asarray(out["c1k_cnt"][:B], np.int64)
        cnt2 = np.asarray(out["c2k_cnt"][:B], np.int64)
        if not (cnt1.any() or cnt2.any()):
            return
        over = (cnt1 > K) | (cnt2 > K)
        ks = np.arange(K)
        for bt, tf_k, pos_k, u8_k, cnt in (
                (batch1, "total_front1", "c1k_pos", "c1k_u8", cnt1),
                (batch2, "total_front2", "c2k_pos", "c2k_u8", cnt2)):
            posm = np.asarray(out[pos_k][:, :B], np.int64)      # [K, B]
            u8 = out[u8_k][:, :B]                               # [2K, B]
            valid = (ks[:, None] < np.minimum(cnt, K)[None, :]) & ~over[None, :]
            kk, rows = np.nonzero(valid)
            if rows.size == 0:
                continue
            tf = np.asarray(out[tf_k], np.int64)
            apos = tf[rows] + posm[kk, rows]
            ok = apos < bt.lengths[rows]
            rows, apos, kk = rows[ok], apos[ok], kk[ok]
            bt.bases[rows, apos] = u8[kk, rows]
            bt.quals[rows, apos] = u8[K + kk, rows]
        if over.any():
            self._host_correct_all(batch1, batch2, out, B,
                                   rows=np.flatnonzero(over))

    def _host_correct_all(self, batch1: ArrayBatch, batch2: ArrayBatch,
                          out, B: int, rows=None):
        """Exact host recomputation of every correctable row (sparse-list
        overflow path); `rows` restricts it to the given row indices (the
        rowwise path's per-row overflows).  A lean step ships only the
        corr_able bit, and the overlap is then re-derived per row on the
        host from the exact device window."""
        if "ov_ok" in out:
            do = (out["ov_ok"][:B] & ~out["ov_hasgap"][:B]
                  & (out["ov_diff"][:B] != 0))
        else:
            do = out["corr_able"][:B]
        if rows is not None:
            m = np.zeros(B, bool)
            m[rows] = True
            do = do & m
        opt = self.opt
        ovp = (opt.overlapDiffLimit, opt.overlapRequire,
               opt.overlapDiffPercentLimit / 100.0)
        tf1, tf2 = out["total_front1"], out["total_front2"]
        b1, q1 = batch1.bases, batch1.quals
        b2, q2 = batch2.bases, batch2.quals
        for i in np.flatnonzero(do):
            s01, s02 = int(tf1[i]), int(tf2[i])
            e1, e2 = int(batch1.lengths[i]), int(batch2.lengths[i])
            s1 = bytearray(b1[i, s01:e1].tobytes())
            qq1 = bytearray(q1[i, s01:e1].tobytes())
            s2 = bytearray(b2[i, s02:e2].tobytes())
            qq2 = bytearray(q2[i, s02:e2].tobytes())
            p2 = int(out["rlen2_pre_ovtrim"][i])
            if "ov_offset" in out:
                off, ol = int(out["ov_offset"][i]), int(out["ov_olen"][i])
            else:
                p1 = int(out["rlen1_pre_ovtrim"][i])
                _, off, ol, _ = host_analyze_overlap(
                    b1[i, s01:s01 + p1], b2[i, s02:s02 + p2], *ovp)
            host_correct_pair(s1, qq1, s2, qq2, p2, off, ol)
            b1[i, s01:e1] = np.frombuffer(bytes(s1), np.uint8)
            q1[i, s01:e1] = np.frombuffer(bytes(qq1), np.uint8)
            b2[i, s02:e2] = np.frombuffer(bytes(s2), np.uint8)
            q2[i, s02:e2] = np.frombuffer(bytes(qq2), np.uint8)

    def _finish(self) -> Dict:
        opt = self.opt
        for c in (self.overrep_pre1, self.overrep_pre2,
                  self.overrep_post1, self.overrep_post2):
            c.flush()
        if multihost.active():
            # gather every shard's accumulators; only shard 0 reports
            if not multihost.merge_processor_stats(self, is_pe=True):
                if self.duplicate is not None:
                    self.duplicate.release()
                return {"pre1": self.pre_stats1, "post1": self.post_stats1,
                        "pre2": self.pre_stats2, "post2": self.post_stats2,
                        "filter": self.filter_result, "dup_rate": 0.0,
                        "insert_peak": 0, "batches": self.batches,
                        "input_kinds": dict(self.input_kinds),
                        "corr_overflow_batches": self.corr_overflow_batches}
        sys.stderr.write("Read1 before filtering:\n")
        self._print_stats(self.pre_stats1)
        sys.stderr.write("\nRead2 before filtering:\n")
        self._print_stats(self.pre_stats2)
        if not opt.merge.enabled:
            sys.stderr.write("\nRead1 after filtering:\n")
            self._print_stats(self.post_stats1)
            sys.stderr.write("\nRead2 after filtering:\n")
            self._print_stats(self.post_stats2)
        else:
            sys.stderr.write("\nMerged and filtered:\n")
            self._print_stats(self.post_stats1)
        sys.stderr.write("\nFiltering result:\n")
        self._print_filter_result()

        dup_rate = 0.0
        if opt.duplicate.enabled:
            dup_rate = self.duplicate.get_dup_rate()
            sys.stderr.write("\nDuplication rate: %s%%\n" % cpp_num(dup_rate * 100.0))

        peak = self._peak_insert_size()
        sys.stderr.write("\nInsert size peak (evaluated by paired-end reads): %d\n" % peak)
        if opt.merge.enabled:
            fr = self.filter_result
            sys.stderr.write("\nRead pairs merged: %d\n" % fr.merged_pairs)
            if self.post_stats1.get_reads() > 0:
                post_pct = 100.0 * fr.merged_pairs / self.post_stats1.get_reads()
                pre_pct = 100.0 * fr.merged_pairs / self.pre_stats1.get_reads()
                sys.stderr.write("%% of original read pairs: %s%%\n"
                                 % cpp_num(pre_pct))
                sys.stderr.write("%% in reads after filtering: %s%%\n"
                                 % cpp_num(post_pct))
            sys.stderr.write("\n")

        jr = JsonReporter(opt)
        jr.set_dup(dup_rate)
        jr.set_insert_hist(self.insert_hist, peak)
        jr.report(self.filter_result, self.pre_stats1, self.post_stats1,
                  self.pre_stats2, self.post_stats2)
        hr = HtmlReporter(opt)
        hr.set_dup(dup_rate)
        hr.set_insert_hist(self.insert_hist, peak)
        hr.report(self.filter_result, self.pre_stats1, self.post_stats1,
                  self.pre_stats2, self.post_stats2)
        if self.duplicate is not None:
            self.duplicate.release()
        return {"pre1": self.pre_stats1, "post1": self.post_stats1,
                "pre2": self.pre_stats2, "post2": self.post_stats2,
                "filter": self.filter_result, "dup_rate": dup_rate,
                "insert_peak": peak, "batches": self.batches,
                "input_kinds": dict(self.input_kinds),
                "corr_overflow_batches": self.corr_overflow_batches}

    def _peak_insert_size(self) -> int:
        """reference: src/peprocessor.cpp:337-347"""
        peak = 0
        max_count = -1
        for i in range(self.opt.insertSizeMax):
            if self.insert_hist[i] > max_count:
                peak = i
                max_count = int(self.insert_hist[i])
        return peak
