"""JSON report emitter, byte-matched to the reference
(reference: src/jsonreporter.cpp:22-172)."""
from __future__ import annotations

import numpy as np

from ..config import Options, FASTP_TPU_VER
from .stats_model import Stats, cpp_num
from .filter_model import FilterResult


class JsonReporter:
    def __init__(self, opt: Options):
        self.opt = opt
        self.dup_rate = 0.0
        self.insert_hist = None
        self.insert_size_peak = 0

    def set_dup(self, dup_rate: float):
        self.dup_rate = dup_rate

    def set_insert_hist(self, hist: np.ndarray, peak: int):
        self.insert_hist = hist
        self.insert_size_peak = peak

    def report(self, result: FilterResult, pre1: Stats, post1: Stats,
               pre2: Stats = None, post2: Stats = None):
        opt = self.opt
        with open(opt.jsonFile, "w") as ofs:
            w = ofs.write
            w("{\n")

            if opt.isPaired():
                seq_info = "paired end (%d cycles + %d cycles)" % (
                    pre1.get_cycles(), pre2.get_cycles())
            else:
                seq_info = "single end (%d cycles)" % pre1.get_cycles()

            def tot(fn1, s2):
                v = fn1()
                if s2 is not None:
                    v += getattr(s2, fn1.__name__)()
                return v

            pre_reads = pre1.get_reads() + (pre2.get_reads() if pre2 else 0)
            pre_bases = pre1.get_bases() + (pre2.get_bases() if pre2 else 0)
            pre_q20 = pre1.get_q20() + (pre2.get_q20() if pre2 else 0)
            pre_q30 = pre1.get_q30() + (pre2.get_q30() if pre2 else 0)
            pre_gc = pre1.get_gc_number() + (pre2.get_gc_number() if pre2 else 0)
            post_reads = post1.get_reads() + (post2.get_reads() if post2 else 0)
            post_bases = post1.get_bases() + (post2.get_bases() if post2 else 0)
            post_q20 = post1.get_q20() + (post2.get_q20() if post2 else 0)
            post_q30 = post1.get_q30() + (post2.get_q30() if post2 else 0)
            post_gc = post1.get_gc_number() + (post2.get_gc_number() if post2 else 0)

            w('\t"summary": {\n')
            w('\t\t"fastp_version": "%s",\n' % FASTP_TPU_VER)
            w('\t\t"sequencing": "%s",\n' % seq_info)
            w('\t\t"before_filtering": {\n')
            w('\t\t\t"total_reads":%d,\n' % pre_reads)
            w('\t\t\t"total_bases":%d,\n' % pre_bases)
            w('\t\t\t"q20_bases":%d,\n' % pre_q20)
            w('\t\t\t"q30_bases":%d,\n' % pre_q30)
            w('\t\t\t"q20_rate":%s,\n' % cpp_num(0.0 if pre_bases == 0 else pre_q20 / pre_bases))
            w('\t\t\t"q30_rate":%s,\n' % cpp_num(0.0 if pre_bases == 0 else pre_q30 / pre_bases))
            w('\t\t\t"read1_mean_length":%d,\n' % pre1.get_mean_length())
            if opt.isPaired():
                w('\t\t\t"read2_mean_length":%d,\n' % pre2.get_mean_length())
            w('\t\t\t"gc_content":%s\n' % cpp_num(0.0 if pre_bases == 0 else pre_gc / pre_bases))
            w('\t\t},\n')

            w('\t\t"after_filtering": {\n')
            w('\t\t\t"total_reads":%d,\n' % post_reads)
            w('\t\t\t"total_bases":%d,\n' % post_bases)
            w('\t\t\t"q20_bases":%d,\n' % post_q20)
            w('\t\t\t"q30_bases":%d,\n' % post_q30)
            w('\t\t\t"q20_rate":%s,\n' % cpp_num(0.0 if post_bases == 0 else post_q20 / post_bases))
            w('\t\t\t"q30_rate":%s,\n' % cpp_num(0.0 if post_bases == 0 else post_q30 / post_bases))
            w('\t\t\t"read1_mean_length":%d,\n' % post1.get_mean_length())
            if opt.isPaired() and not opt.merge.enabled:
                w('\t\t\t"read2_mean_length":%d,\n' % post2.get_mean_length())
            w('\t\t\t"gc_content":%s\n' % cpp_num(0.0 if post_bases == 0 else post_gc / post_bases))
            w('\t\t}')
            w('\n')
            w('\t},\n')

            if result is not None:
                w('\t"filtering_result": ')
                result.report_json(ofs, "\t")

            if opt.duplicate.enabled:
                w('\t"duplication": {\n')
                w('\t\t"rate": %s\n' % cpp_num(self.dup_rate))
                w('\t}')
                w(',\n')

            if opt.isPaired():
                w('\t"insert_size": {\n')
                w('\t\t"peak": %d,\n' % self.insert_size_peak)
                w('\t\t"unknown": %d,\n' % int(self.insert_hist[opt.insertSizeMax]))
                w('\t\t"histogram": [')
                w(",".join(str(int(self.insert_hist[d])) for d in range(opt.insertSizeMax)))
                w(']\n')
                w('\t}')
                w(',\n')

            if result is not None and opt.adapterCuttingEnabled():
                w('\t"adapter_cutting": ')
                result.report_adapter_json(ofs, "\t")

            if result is not None and opt.polyXTrimmingEnabled():
                w('\t"polyx_trimming": ')
                result.report_polyx_json(ofs, "\t")

            if pre1 is not None:
                w('\t"read1_before_filtering": ')
                pre1.report_json(ofs, "\t")
            if pre2 is not None:
                w('\t"read2_before_filtering": ')
                pre2.report_json(ofs, "\t")
            if post1 is not None:
                name = "read1_after_filtering"
                if opt.merge.enabled:
                    name = "merged_and_filtered"
                w('\t"%s": ' % name)
                post1.report_json(ofs, "\t")
            if post2 is not None and not opt.merge.enabled:
                w('\t"read2_after_filtering": ')
                post2.report_json(ofs, "\t")

            w('\t"command": "%s"\n' % opt.command)
            w("}")
