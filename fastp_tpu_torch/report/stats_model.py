"""Host-side statistics model.

Accumulates the per-batch device tensors from ops/stats.py and reproduces
Stats::summarize / Stats::reportJson (reference: src/stats.cpp:143-223,
406-495) including curve math, k-mer table ordering, and the
overrepresented-sequence filters.
"""
from __future__ import annotations

import numpy as np

from ..config import Options

KMER_LEN = 5
KMER_BUFLEN = 2 << (KMER_LEN * 2)  # 2048


def cpp_num(x) -> str:
    """Format like C++ ostream operator<< for double (6 sig digits, %g)."""
    if isinstance(x, (int, np.integer)):
        return str(int(x))
    x = float(x)
    if np.isnan(x):
        return "-nan" if np.signbit(x) else "nan"
    if np.isinf(x):
        return "-inf" if x < 0 else "inf"
    return "%.6g" % x


def kmer3(val: int) -> str:
    bases = "ATCG"
    return bases[(val & 0x30) >> 4] + bases[(val & 0x0C) >> 2] + bases[val & 0x03]


def kmer2(val: int) -> str:
    bases = "ATCG"
    return bases[(val & 0x0C) >> 2] + bases[val & 0x03]


class Stats:
    """One (read-end, pre/post) stats accumulator."""

    def __init__(self, opt: Options, is_read2: bool, buf_len: int):
        self.opt = opt
        self.is_read2 = is_read2
        self.evaluated_seq_len = opt.seqLen2 if is_read2 else opt.seqLen1
        self.buf_len = buf_len
        self.reads = 0
        self.length_sum = 0
        self.cycle_q20 = np.zeros((8, buf_len), np.int64)
        self.cycle_q30 = np.zeros((8, buf_len), np.int64)
        self.cycle_content = np.zeros((8, buf_len), np.int64)
        self.cycle_qual = np.zeros((8, buf_len), np.int64)
        self.cycle_total_base = np.zeros(buf_len, np.int64)
        self.cycle_total_qual = np.zeros(buf_len, np.int64)
        self.qual_hist = np.zeros(128, np.int64)
        self.kmer = np.zeros(KMER_BUFLEN, np.int64)
        # overrepresented sequences
        self.overrep = {}
        self.overrep_dist = {}
        src = opt.overRepSeqs2 if is_read2 else opt.overRepSeqs1
        for seq in src:
            self.overrep[seq] = 0
            self.overrep_dist[seq] = np.zeros(self.evaluated_seq_len, np.int64)
        self._summarized = False

    # -- accumulation -----------------------------------------------------
    def add_batch(self, batch: dict):
        """batch: dict of numpy arrays from ops.stats.stat_batch."""
        L = batch["cycle_content"].shape[1]
        if L > self.buf_len:
            self._grow(L)
        self.cycle_q20[:, :L] += batch["cycle_q20"]
        self.cycle_q30[:, :L] += batch["cycle_q30"]
        self.cycle_content[:, :L] += batch["cycle_content"]
        self.cycle_qual[:, :L] += batch["cycle_qual"]
        self.cycle_total_base[:L] += batch["cycle_total_base"]
        self.cycle_total_qual[:L] += batch["cycle_total_qual"]
        self.qual_hist += batch["qual_hist"]
        self.kmer[:batch["kmer"].shape[0]] += batch["kmer"]
        self.reads += int(batch["reads"])
        self.length_sum += int(batch["length_sum"])
        self._summarized = False

    def _grow(self, new_len: int):
        pad = new_len - self.buf_len
        self.cycle_q20 = np.pad(self.cycle_q20, ((0, 0), (0, pad)))
        self.cycle_q30 = np.pad(self.cycle_q30, ((0, 0), (0, pad)))
        self.cycle_content = np.pad(self.cycle_content, ((0, 0), (0, pad)))
        self.cycle_qual = np.pad(self.cycle_qual, ((0, 0), (0, pad)))
        self.cycle_total_base = np.pad(self.cycle_total_base, (0, pad))
        self.cycle_total_qual = np.pad(self.cycle_total_qual, (0, pad))
        self.buf_len = new_len

    def add_overrep(self, seq: str, count: int = 1):
        self.overrep[seq] = self.overrep.get(seq, 0) + count

    # -- cross-host merge (reference: Stats::merge, src/stats.cpp:902-965) --
    def state_dict(self) -> dict:
        """Picklable accumulator snapshot for cross-process stat merging."""
        return {
            "reads": self.reads, "length_sum": self.length_sum,
            "buf_len": self.buf_len,
            "cycle_q20": self.cycle_q20, "cycle_q30": self.cycle_q30,
            "cycle_content": self.cycle_content, "cycle_qual": self.cycle_qual,
            "cycle_total_base": self.cycle_total_base,
            "cycle_total_qual": self.cycle_total_qual,
            "qual_hist": self.qual_hist, "kmer": self.kmer,
            "overrep": self.overrep, "overrep_dist": self.overrep_dist,
        }

    def merge_state(self, st: dict):
        """Add another process's accumulator snapshot into this one."""
        L = st["buf_len"]
        if L > self.buf_len:
            self._grow(L)
        self.cycle_q20[:, :L] += st["cycle_q20"]
        self.cycle_q30[:, :L] += st["cycle_q30"]
        self.cycle_content[:, :L] += st["cycle_content"]
        self.cycle_qual[:, :L] += st["cycle_qual"]
        self.cycle_total_base[:L] += st["cycle_total_base"]
        self.cycle_total_qual[:L] += st["cycle_total_qual"]
        self.qual_hist += st["qual_hist"]
        self.kmer += st["kmer"]
        self.reads += st["reads"]
        self.length_sum += st["length_sum"]
        for k, v in st["overrep"].items():
            self.overrep[k] = self.overrep.get(k, 0) + v
        for k, v in st["overrep_dist"].items():
            if k in self.overrep_dist:
                d = self.overrep_dist[k]
                d[:len(v)] += v[:len(d)]
            else:
                self.overrep_dist[k] = v
        self._summarized = False

    # -- summarize (reference: src/stats.cpp:143-223) ---------------------
    def summarize(self, forced: bool = False):
        if self._summarized and not forced:
            return
        tb = self.cycle_total_base
        nz = np.nonzero(tb == 0)[0]
        if len(nz) > 0:
            self.cycles = int(nz[0])
            self.bases = int(tb[:self.cycles].sum())
        else:
            self.cycles = self.buf_len
            self.bases = int(tb.sum())
        if self.buf_len > 0 and tb[self.buf_len - 1] > 0:
            self.cycles = self.buf_len

        c = self.cycles
        self.q20_bases = self.cycle_q20[:, :c].sum(axis=1)
        self.q30_bases = self.cycle_q30[:, :c].sum(axis=1)
        self.base_contents = self.cycle_content[:, :c].sum(axis=1)
        self.q20_total = int(self.q20_bases.sum())
        self.q30_total = int(self.q30_bases.sum())
        self.q40_total = int(self.qual_hist[40 + 33:127].sum())

        with np.errstate(divide="ignore", invalid="ignore"):
            mean_qual = self.cycle_total_qual[:c] / self.cycle_total_base[:c]
        self.quality_curves = {"mean": mean_qual}
        self.content_curves = {}
        for base in "ATCGN":
            b = ord(base) & 0x07
            contents = self.cycle_content[b, :c]
            with np.errstate(divide="ignore", invalid="ignore"):
                qc = np.where(contents == 0, mean_qual,
                              self.cycle_qual[b, :c] / np.maximum(contents, 1))
                cc = contents / self.cycle_total_base[:c]
            self.quality_curves[base] = qc
            self.content_curves[base] = cc
        gB, cB = ord("G") & 7, ord("C") & 7
        with np.errstate(divide="ignore", invalid="ignore"):
            self.content_curves["GC"] = ((self.cycle_content[gB, :c] + self.cycle_content[cB, :c])
                                         / self.cycle_total_base[:c])
        self.kmer_min = int(self.kmer.min())
        self.kmer_max = int(self.kmer.max())
        self._summarized = True

    # -- accessors mirroring the reference --------------------------------
    def get_cycles(self):
        self.summarize()
        return self.cycles

    def get_reads(self):
        self.summarize()
        return self.reads

    def get_bases(self):
        self.summarize()
        return self.bases

    def get_q20(self):
        self.summarize()
        return self.q20_total

    def get_q30(self):
        self.summarize()
        return self.q30_total

    def get_q40(self):
        self.summarize()
        return self.q40_total

    def get_gc_number(self):
        self.summarize()
        return int(self.base_contents[ord("G") & 7] + self.base_contents[ord("C") & 7])

    def get_mean_length(self):
        if self.reads == 0:
            return 0
        return self.length_sum // self.reads

    def is_long_read(self):
        self.summarize()
        return self.cycles > 300

    def overrep_passed(self, seq: str, count: int) -> bool:
        """reference: src/stats.cpp:551-565"""
        s = self.opt.overRepAnalysis.sampling
        n = len(seq)
        if n == 10:
            return s * count > 500
        if n == 20:
            return s * count > 200
        if n == 40:
            return s * count > 100
        if n == 100:
            return s * count > 50
        return s * count > 20

    # -- JSON (reference: src/stats.cpp:406-495) --------------------------
    def report_json(self, out, padding: str):
        self.summarize()
        w = out.write
        w("{\n")
        w('%s\t"total_reads": %d,\n' % (padding, self.reads))
        w('%s\t"total_bases": %d,\n' % (padding, self.bases))
        w('%s\t"q20_bases": %d,\n' % (padding, self.q20_total))
        w('%s\t"q30_bases": %d,\n' % (padding, self.q30_total))
        w('%s\t"q40_bases": %d,\n' % (padding, self.q40_total))
        w('%s\t"total_cycles": %d,\n' % (padding, self.cycles))

        w('%s\t"quality_curves": {\n' % padding)
        names = ["A", "T", "C", "G", "mean"]
        for i, name in enumerate(names):
            curve = self.quality_curves[name]
            w('%s\t\t"%s":[%s]' % (padding, name,
                                   ",".join(cpp_num(v) for v in curve)))
            if i != len(names) - 1:
                w(",")
            w("\n")
        w('%s\t},\n' % padding)

        w('%s\t"content_curves": {\n' % padding)
        names = ["A", "T", "C", "G", "N", "GC"]
        for i, name in enumerate(names):
            curve = self.content_curves[name]
            w('%s\t\t"%s":[%s]' % (padding, name,
                                   ",".join(cpp_num(v) for v in curve)))
            if i != len(names) - 1:
                w(",")
            w("\n")
        w('%s\t},\n' % padding)

        w('%s\t"kmer_count": {\n' % padding)
        for i in range(64):
            first = kmer3(i)
            row = []
            for j in range(16):
                target = (i << 4) + j
                row.append('%s\t\t"%s%s":%d' % (padding, first, kmer2(j),
                                                int(self.kmer[target])))
            w(",".join(row))
            if i != 63:
                w(",\n")
            else:
                w("\n")
        w('%s\t},\n' % padding)

        w('%s\t"overrepresented_sequences": {\n' % padding)
        firstitem = True
        for seq in sorted(self.overrep):
            count = self.overrep[seq]
            if not self.overrep_passed(seq, count):
                continue
            if not firstitem:
                w(",\n")
            else:
                firstitem = False
            w('%s\t\t"%s":%d' % (padding, seq, count))
        w('%s\t}\n' % padding)
        w("%s},\n" % padding)
