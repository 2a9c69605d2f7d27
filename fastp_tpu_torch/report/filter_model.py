"""Host-side FilterResult accumulator
(reference: src/filterresult.cpp:10-329)."""
from __future__ import annotations

import numpy as np

from ..config import (Options, FILTER_RESULT_TYPES, PASS_FILTER, FAIL_QUALITY,
                      FAIL_N_BASE, FAIL_LENGTH, FAIL_TOO_LONG, FAIL_COMPLEXITY,
                      ATCG_BASES)

MAX_ADAPTER_REC = 20000
LOW_COMPLEXITY_SKIP = 5000


def _is_low_complexity(adapter: str) -> bool:
    """reference: src/filterresult.cpp:115-122"""
    b = np.frombuffer(adapter.encode("latin-1"), np.uint8)
    diff = int((b[1:] != b[:-1]).sum()) if b.size > 1 else 0
    return diff < len(adapter) // 2


class FilterResult:
    def __init__(self, opt: Options, paired: bool):
        self.opt = opt
        self.paired = paired
        self.filter_read_stats = np.zeros(FILTER_RESULT_TYPES, np.int64)
        self.trimmed_adapter_reads = 0
        self.trimmed_adapter_bases = 0
        self.merged_pairs = 0
        self._adapter1 = {}
        self._adapter2 = {}
        # native recorder (fastq_native.cpp adrec_*): keeps the adapter
        # count maps in C++ so per-row PE read-through recording costs no
        # Python (~30s per 2M pairs measured in the dict path); exported
        # to plain dicts on first read (reports/state_dict).
        self._adrec = None
        try:
            from ..io import native as _native_mod
            if _native_mod.get_lib() is not None:
                self._adrec = _native_mod.AdapterRecorder()
        except Exception:
            self._adrec = None
        self.correction_matrix = np.zeros(64, np.int64)
        self.corrected_reads = 0
        self.polyx_trimmed_reads = np.zeros(4, np.int64)
        self.polyx_trimmed_bases = np.zeros(4, np.int64)

    # -- accumulation ------------------------------------------------------
    def add_filter_result_array(self, results: np.ndarray, read_num: int):
        """Vector version of addFilterResult over a batch of result codes."""
        binc = np.bincount(results, minlength=FILTER_RESULT_TYPES)
        self.filter_read_stats += binc[:FILTER_RESULT_TYPES].astype(np.int64) * read_num

    def add_filter_result(self, result: int, read_num: int):
        if PASS_FILTER <= result < FILTER_RESULT_TYPES:
            self.filter_read_stats[result] += read_num

    def add_merged_pairs(self, pairs: int):
        self.merged_pairs += pairs

    def add_adapter_trimmed(self, adapter: str, is_r2: bool = False,
                            inc_trimmed_counter: bool = True,
                            count: int = 1):
        """reference: src/filterresult.cpp:124-153.

        `count` adds `count` identical records at once (the runner groups
        per-batch duplicates); exactly equivalent to `count` sequential
        calls, including the insertion caps (cap checks only run on NEW
        keys, and grouped repeats of an existing key are increments)."""
        if not adapter:
            return
        if inc_trimmed_counter:
            self.trimmed_adapter_reads += count
        self.trimmed_adapter_bases += len(adapter) * count
        if self._adrec is not None:
            self._adrec.add_one(adapter.encode("latin-1"), is_r2, count)
            return
        m = self._adapter2 if is_r2 else self._adapter1
        if adapter in m:
            m[adapter] += count
        else:
            if len(m) > MAX_ADAPTER_REC or (len(m) > LOW_COMPLEXITY_SKIP
                                            and _is_low_complexity(adapter)):
                return
            m[adapter] = count

    def add_adapter_trimmed_pair(self, adapter1: str, adapter2: str,
                                 count: int = 1):
        """reference: src/filterresult.cpp:155-183 (note the early return on a
        capped adapter1 also skips recording adapter2, replicated here)."""
        self.trimmed_adapter_reads += 2 * count
        self.trimmed_adapter_bases += (len(adapter1) + len(adapter2)) * count
        if self._adrec is not None:
            self._adrec.add_pair_strs(adapter1.encode("latin-1"),
                                      adapter2.encode("latin-1"), count)
            return
        if adapter1:
            if adapter1 in self._adapter1:
                self._adapter1[adapter1] += count
            else:
                if len(self._adapter1) > MAX_ADAPTER_REC or (
                        len(self._adapter1) > LOW_COMPLEXITY_SKIP and _is_low_complexity(adapter1)):
                    return
                self._adapter1[adapter1] = count
        if adapter2:
            if adapter2 in self._adapter2:
                self._adapter2[adapter2] += count
            else:
                if len(self._adapter2) > MAX_ADAPTER_REC or (
                        len(self._adapter2) > LOW_COMPLEXITY_SKIP and _is_low_complexity(adapter2)):
                    return
                self._adapter2[adapter2] = count

    def add_adapter_trimmed_pairs_bulk(self, ba1, lo1, hi1, ba2, lo2, hi2,
                                       rows):
        """Bulk PE overlap-trim recording: slices ba1[rows[k], lo1:hi1] /
        ba2[rows[k], lo2:hi2] in row order.  Counters vectorize here;
        the map updates run natively (exact cap/order semantics).
        Callers without the native lib use the grouped Python path."""
        n = len(rows)
        if n == 0:
            return False
        if self._adrec is None:
            return False
        L1 = np.maximum(hi1 - lo1, 0)
        L2 = np.maximum(hi2 - lo2, 0)
        self.trimmed_adapter_reads += 2 * n
        self.trimmed_adapter_bases += int(L1.sum()) + int(L2.sum())
        self._adrec.add_pairs(ba1, lo1, hi1, ba2, lo2, hi2, rows)
        return True

    def add_adapter_trimmed_rows_bulk(self, ba, rows, lo, hi, is_r2):
        """Bulk single-side recording of ba[rows[k], lo:hi] in row order
        (count 1 each, inc_trimmed_counter semantics).  Returns False
        without the native recorder (caller replays through the dict
        path)."""
        if self._adrec is None:
            return False
        n = len(rows)
        if n == 0:
            return True
        L = np.maximum(hi - lo, 0)
        nz = int((L > 0).sum())
        self.trimmed_adapter_reads += nz
        self.trimmed_adapter_bases += int(L.sum())
        self._adrec.add_rows(ba, rows, lo, hi, is_r2)
        return True

    # -- exported views (materialized from the native recorder) -------------
    @property
    def adapter1(self):
        if self._adrec is not None:
            return self._adrec.export(False)
        return self._adapter1

    @property
    def adapter2(self):
        if self._adrec is not None:
            return self._adrec.export(True)
        return self._adapter2

    def _materialize(self):
        """Switch to plain-dict mode (used before cross-host merging,
        which mutates the dicts without cap semantics, like the
        reference's FilterResult::merge)."""
        if self._adrec is not None:
            self._adapter1 = self._adrec.export(False)
            self._adapter2 = self._adrec.export(True)
            self._adrec = None

    # -- cross-host merge (reference: FilterResult::merge,
    #    src/filterresult.cpp:38-89) ----------------------------------------
    def state_dict(self) -> dict:
        return {
            "filter_read_stats": self.filter_read_stats,
            "trimmed_adapter_reads": self.trimmed_adapter_reads,
            "trimmed_adapter_bases": self.trimmed_adapter_bases,
            "merged_pairs": self.merged_pairs,
            "adapter1": self.adapter1, "adapter2": self.adapter2,
            "correction_matrix": self.correction_matrix,
            "corrected_reads": self.corrected_reads,
            "polyx_trimmed_reads": self.polyx_trimmed_reads,
            "polyx_trimmed_bases": self.polyx_trimmed_bases,
        }

    def merge_state(self, st: dict):
        self._materialize()
        self.filter_read_stats += st["filter_read_stats"]
        self.trimmed_adapter_reads += st["trimmed_adapter_reads"]
        self.trimmed_adapter_bases += st["trimmed_adapter_bases"]
        self.merged_pairs += st["merged_pairs"]
        for key, m in (("adapter1", self._adapter1), ("adapter2", self._adapter2)):
            for k, v in st[key].items():
                m[k] = m.get(k, 0) + v
        self.correction_matrix += st["correction_matrix"]
        self.corrected_reads += st["corrected_reads"]
        self.polyx_trimmed_reads += st["polyx_trimmed_reads"]
        self.polyx_trimmed_bases += st["polyx_trimmed_bases"]

    def add_correction_matrix(self, matrix64: np.ndarray):
        self.correction_matrix += matrix64.astype(np.int64)

    def inc_corrected_reads(self, count: int):
        self.corrected_reads += count

    def add_polyx_trimmed(self, base_counts: np.ndarray, base_bases: np.ndarray):
        self.polyx_trimmed_reads += base_counts.astype(np.int64)
        self.polyx_trimmed_bases += base_bases.astype(np.int64)

    def get_total_corrected_bases(self):
        return int(self.correction_matrix.sum())

    def get_total_polyx_trimmed_reads(self):
        return int(self.polyx_trimmed_reads.sum())

    def get_total_polyx_trimmed_bases(self):
        return int(self.polyx_trimmed_bases.sum())

    # -- JSON (reference: src/filterresult.cpp:231-329) ---------------------
    def report_json(self, out, padding: str):
        w = out.write
        w("{\n")
        w('%s\t"passed_filter_reads": %d,\n' % (padding, self.filter_read_stats[PASS_FILTER]))
        if self.opt.correction.enabled:
            w('%s\t"corrected_reads": %d,\n' % (padding, self.corrected_reads))
            w('%s\t"corrected_bases": %d,\n' % (padding, self.get_total_corrected_bases()))
        w('%s\t"low_quality_reads": %d,\n' % (padding, self.filter_read_stats[FAIL_QUALITY]))
        w('%s\t"too_many_N_reads": %d,\n' % (padding, self.filter_read_stats[FAIL_N_BASE]))
        if self.opt.complexityFilter.enabled:
            w('%s\t"low_complexity_reads": %d,\n' % (padding, self.filter_read_stats[FAIL_COMPLEXITY]))
        w('%s\t"too_short_reads": %d,\n' % (padding, self.filter_read_stats[FAIL_LENGTH]))
        w('%s\t"too_long_reads": %d\n' % (padding, self.filter_read_stats[FAIL_TOO_LONG]))
        w("%s},\n" % padding)

    def _output_adapters_json(self, out, counts: dict):
        """reference: src/filterresult.cpp:249-284"""
        w = out.write
        total = sum(counts.values())
        if total == 0:
            return
        report_threshold = 0.01
        first = True
        reported = 0
        for seq in sorted(counts):
            count = counts[seq]
            if count / total < report_threshold:
                continue
            if not first:
                w(", ")
            else:
                first = False
            w('"%s":%d' % (seq, count))
            reported += count
        unreported = total - reported
        if unreported > 0:
            if not first:
                w(", ")
            w('"others":%d' % unreported)

    def report_adapter_json(self, out, padding: str):
        """reference: src/filterresult.cpp:286-310"""
        w = out.write
        w("{\n")
        w('%s\t"adapter_trimmed_reads": %d,\n' % (padding, self.trimmed_adapter_reads))
        w('%s\t"adapter_trimmed_bases": %d,\n' % (padding, self.trimmed_adapter_bases))
        w('%s\t"read1_adapter_sequence": "%s",\n' % (padding, self.opt.getAdapter1()))
        if self.opt.isPaired():
            w('%s\t"read2_adapter_sequence": "%s",\n' % (padding, self.opt.getAdapter2()))
        w('%s\t"read1_adapter_counts": {' % padding)
        self._output_adapters_json(out, self.adapter1)
        w("}")
        if self.opt.isPaired():
            w(",")
        w("\n")
        if self.opt.isPaired():
            w('%s\t"read2_adapter_counts": {' % padding)
            self._output_adapters_json(out, self.adapter2)
            w("}\n")
        w("%s},\n" % padding)

    def report_polyx_json(self, out, padding: str):
        """reference: src/filterresult.cpp:312-329"""
        w = out.write
        w("%s{\n" % padding)
        for key, total, counts, tail in (
                ("polyx_trimmed_reads", self.get_total_polyx_trimmed_reads(),
                 self.polyx_trimmed_reads, ",\n"),
                ("polyx_trimmed_bases", self.get_total_polyx_trimmed_bases(),
                 self.polyx_trimmed_bases, "\n%s},\n" % padding)):
            w('%s\t"total_%s": %d,\n' % (padding, key, total))
            w('%s\t"%s":{' % (padding, key))
            w(", ".join('"%s": %d' % (ATCG_BASES[b], counts[b]) for b in range(4)))
            w("}")
            w(tail)
