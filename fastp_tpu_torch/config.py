"""Option model for fastp_tpu.

Mirrors the reference option surface (reference: src/options.h:20-387,
src/options.cpp:8-520) so that every CLI flag, default, and cross-option
validation behaves identically, while the implementation is a clean
Python dataclass tree designed to be hashed into static JIT configs.
"""
from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

FASTP_TPU_VER = "1.0.1"

# UMI locations (reference: src/options.h:12-18)
UMI_LOC_NONE = 0
UMI_LOC_INDEX1 = 1
UMI_LOC_INDEX2 = 2
UMI_LOC_READ1 = 3
UMI_LOC_READ2 = 4
UMI_LOC_PER_INDEX = 5
UMI_LOC_PER_READ = 6

# Filter result codes (reference: src/common.h:45-66)
PASS_FILTER = 0
FAIL_POLY_X = 4
FAIL_OVERLAP = 8
FAIL_N_BASE = 12
FAIL_LENGTH = 16
FAIL_TOO_LONG = 17
FAIL_QUALITY = 20
FAIL_COMPLEXITY = 24
FILTER_RESULT_TYPES = 32

FAILED_TYPES = [
    "passed", "", "", "",
    "failed_polyx_filter", "", "", "",
    "failed_bad_overlap", "", "", "",
    "failed_too_many_n_bases", "", "", "",
    "failed_too_short", "failed_too_long", "", "",
    "failed_quality_filter", "", "", "",
    "failed_low_complexity", "", "", "",
    "", "", "", "",
]

ATCG_BASES = ("A", "T", "C", "G")


def error_exit(msg: str):
    sys.stderr.write("ERROR: " + msg + "\n")
    sys.exit(-1)


def num2qual(num: int) -> int:
    """reference: src/util.h:260-268"""
    num = min(num, 127 - 33)
    num = max(num, 0)
    return num + 33


@dataclass
class MergeOptions:
    enabled: bool = False
    includeUnmerged: bool = False
    out: str = ""


@dataclass
class DuplicationOptions:
    enabled: bool = True
    histSize: int = 32
    dedup: bool = False
    accuracyLevel: int = 1


@dataclass
class IndexFilterOptions:
    blacklist1: List[str] = field(default_factory=list)
    blacklist2: List[str] = field(default_factory=list)
    enabled: bool = False
    threshold: int = 0


@dataclass
class LowComplexityFilterOptions:
    enabled: bool = False
    threshold: float = 0.3


@dataclass
class OverRepOptions:
    enabled: bool = False
    sampling: int = 20


@dataclass
class PolyGTrimmerOptions:
    enabled: bool = False
    minLen: int = 10


@dataclass
class PolyXTrimmerOptions:
    enabled: bool = False
    minLen: int = 10


@dataclass
class UMIOptions:
    enabled: bool = False
    location: int = UMI_LOC_NONE
    length: int = 0
    skip: int = 0
    prefix: str = ""
    separator: str = ""
    delimiter: str = ":"


@dataclass
class CorrectionOptions:
    enabled: bool = False


@dataclass
class QualityCutOptions:
    enabledFront: bool = False
    enabledTail: bool = False
    enabledRight: bool = False
    windowSizeShared: int = 4
    qualityShared: int = 20
    windowSizeFront: int = 4
    qualityFront: int = 20
    windowSizeTail: int = 4
    qualityTail: int = 20
    windowSizeRight: int = 4
    qualityRight: int = 20


@dataclass
class SplitOptions:
    enabled: bool = False
    number: int = 0
    size: int = 0
    digits: int = 4
    needEvaluation: bool = False
    byFileNumber: bool = False
    byFileLines: bool = False


@dataclass
class AdapterOptions:
    enabled: bool = True
    sequence: str = ""
    sequenceR2: str = ""
    detectedAdapter1: str = ""
    detectedAdapter2: str = ""
    seqsInFasta: List[str] = field(default_factory=list)
    fastaFile: str = ""
    hasSeqR1: bool = False
    hasSeqR2: bool = False
    hasFasta: bool = False
    detectAdapterForPE: bool = False
    allowGapOverlapTrimming: bool = False


@dataclass
class TrimmingOptions:
    front1: int = 0
    tail1: int = 0
    front2: int = 0
    tail2: int = 0
    maxLen1: int = 0
    maxLen2: int = 0


@dataclass
class QualityFilteringOptions:
    enabled: bool = True
    qualifiedQual: int = ord("0")  # '0' = Q15 (phred+33)
    unqualifiedPercentLimit: int = 40
    nBaseLimit: int = 5
    avgQualReq: int = 0


@dataclass
class LengthFilteringOptions:
    enabled: bool = False
    requiredLength: int = 15
    maxLength: int = 0


@dataclass
class Options:
    """Top-level options (reference: src/options.h:284-385, defaults src/options.cpp:8-31)."""
    in1: str = ""
    in2: str = ""
    out1: str = ""
    out2: str = ""
    unpaired1: str = ""
    unpaired2: str = ""
    failedOut: str = ""
    overlappedOut: str = ""
    jsonFile: str = "fastp.json"
    htmlFile: str = "fastp.html"
    reportTitle: str = "fastp report"
    compression: int = 4
    phred64: bool = False
    dontOverwrite: bool = False
    inputFromSTDIN: bool = False
    outputToSTDOUT: bool = False
    interleavedInput: bool = False
    readsToProcess: int = 0
    fixMGI: bool = False
    thread: int = 3
    trim: TrimmingOptions = field(default_factory=TrimmingOptions)
    qualfilter: QualityFilteringOptions = field(default_factory=QualityFilteringOptions)
    lengthFilter: LengthFilteringOptions = field(default_factory=LengthFilteringOptions)
    adapter: AdapterOptions = field(default_factory=AdapterOptions)
    split: SplitOptions = field(default_factory=SplitOptions)
    qualityCut: QualityCutOptions = field(default_factory=QualityCutOptions)
    correction: CorrectionOptions = field(default_factory=CorrectionOptions)
    umi: UMIOptions = field(default_factory=UMIOptions)
    polyGTrim: PolyGTrimmerOptions = field(default_factory=PolyGTrimmerOptions)
    polyXTrim: PolyXTrimmerOptions = field(default_factory=PolyXTrimmerOptions)
    overRepAnalysis: OverRepOptions = field(default_factory=OverRepOptions)
    overRepSeqs1: Dict[str, int] = field(default_factory=dict)
    overRepSeqs2: Dict[str, int] = field(default_factory=dict)
    seqLen1: int = 151
    seqLen2: int = 151
    complexityFilter: LowComplexityFilterOptions = field(default_factory=LowComplexityFilterOptions)
    indexFilter: IndexFilterOptions = field(default_factory=IndexFilterOptions)
    duplicate: DuplicationOptions = field(default_factory=DuplicationOptions)
    insertSizeMax: int = 512
    overlapRequire: int = 30
    overlapDiffLimit: int = 5
    overlapDiffPercentLimit: int = 20
    verbose: bool = False
    merge: MergeOptions = field(default_factory=MergeOptions)
    writerBufferSize: int = 1 << 22
    command: str = ""
    # fastp_tpu extensions
    batchSize: int = 8192      # reads per device batch
    maxReadLen: int = 0        # 0 = derive from evaluated seq len
    deviceCount: int = 0       # 0 = all local devices (data-parallel shards)

    def isPaired(self) -> bool:
        return len(self.in2) > 0 or self.interleavedInput

    def adapterCuttingEnabled(self) -> bool:
        """reference: src/options.cpp:40-46"""
        if self.adapter.enabled:
            if self.isPaired() or self.adapter.sequence:
                return True
        return False

    def polyXTrimmingEnabled(self) -> bool:
        return self.polyXTrim.enabled

    def getAdapter1(self) -> str:
        if self.adapter.sequence in ("", "auto"):
            return "unspecified"
        return self.adapter.sequence

    def getAdapter2(self) -> str:
        if self.adapter.sequenceR2 in ("", "auto"):
            return "unspecified"
        return self.adapter.sequenceR2

    def shallDetectAdapter(self, isR2: bool = False) -> bool:
        """reference: src/options.cpp:443-455"""
        if not self.adapter.enabled:
            return False
        if isR2:
            return self.isPaired() and self.adapter.detectAdapterForPE and self.adapter.sequenceR2 == "auto"
        if self.isPaired():
            return self.adapter.detectAdapterForPE and self.adapter.sequence == "auto"
        return self.adapter.sequence == "auto"

    def loadFastaAdapters(self):
        """reference: src/options.cpp:52-79"""
        if not self.adapter.fastaFile:
            self.adapter.hasFasta = False
            return
        check_file_valid(self.adapter.fastaFile)
        from .io.fasta import read_fasta
        contigs = read_fasta(self.adapter.fastaFile)
        for _name in sorted(contigs):
            seq = contigs[_name]
            if len(seq) >= 6:
                self.adapter.seqsInFasta.append(seq)
            else:
                sys.stderr.write(
                    "skip too short adapter sequence in %s (6bp required): %s\n"
                    % (self.adapter.fastaFile, seq))
        self.adapter.hasFasta = len(self.adapter.seqsInFasta) > 0

    def initIndexFiltering(self, blacklistFile1: str, blacklistFile2: str, threshold: int = 0):
        """reference: src/options.cpp:457-476"""
        if not blacklistFile1 and not blacklistFile2:
            return
        if blacklistFile1:
            check_file_valid(blacklistFile1)
            self.indexFilter.blacklist1 = make_list_from_file_by_line(blacklistFile1)
        if blacklistFile2:
            check_file_valid(blacklistFile2)
            self.indexFilter.blacklist2 = make_list_from_file_by_line(blacklistFile2)
        if not self.indexFilter.blacklist1 and not self.indexFilter.blacklist2:
            return
        self.indexFilter.enabled = True
        self.indexFilter.threshold = threshold

    def validate(self) -> bool:
        """Cross-option validation (reference: src/options.cpp:81-441)."""
        if not self.in1:
            if self.in2:
                error_exit("read2 input is specified by <in2>, but read1 input is not specified by <in1>")
            if self.inputFromSTDIN:
                self.in1 = "/dev/stdin"
            else:
                error_exit("read1 input should be specified by --in1, or enable --stdin if you want to read STDIN")
        else:
            check_file_valid(self.in1)

        if self.in2:
            check_file_valid(self.in2)

        if self.outputToSTDOUT:
            if self.out1:
                sys.stderr.write("In STDOUT mode, ignore the out1 filename %s\n" % self.out1)
                self.out1 = ""
            if self.out2:
                sys.stderr.write("In STDOUT mode, ignore the out2 filename %s\n" % self.out2)
                self.out2 = ""

        if self.merge.enabled:
            if self.split.enabled:
                error_exit("splitting mode cannot work with merging mode")
            if not self.in2 and not self.interleavedInput:
                error_exit("read2 input should be specified by --in2 for merging mode")
            if not self.correction.enabled:
                self.correction.enabled = True
            if not self.merge.out and not self.outputToSTDOUT and self.out1 and not self.out2:
                sys.stderr.write(
                    "You specified --out1, but haven't specified --merged_out in merging mode."
                    " Using --out1 to store the merged reads to be compatible with fastp 0.19.8\n\n")
                self.merge.out = self.out1
                self.out1 = ""
            if self.merge.includeUnmerged:
                if self.out1:
                    sys.stderr.write("You specified --include_unmerged in merging mode. Ignoring argument --out1 = %s\n" % self.out1)
                    self.out1 = ""
                if self.out2:
                    sys.stderr.write("You specified --include_unmerged in merging mode. Ignoring argument --out2 = %s\n" % self.out2)
                    self.out2 = ""
                if self.unpaired1:
                    sys.stderr.write("You specified --include_unmerged in merging mode. Ignoring argument --unpaired1 = %s\n" % self.unpaired1)
                    self.unpaired1 = ""
                if self.unpaired2:
                    sys.stderr.write("You specified --include_unmerged in merging mode. Ignoring argument --unpaired1 = %s\n" % self.unpaired2)
                    self.unpaired2 = ""
            if not self.merge.out and not self.outputToSTDOUT:
                error_exit("In merging mode, you should either specify --merged_out or enable --stdout")
            if self.merge.out:
                if self.merge.out == self.out1:
                    error_exit("--merged_out and --out1 shouldn't have same file name")
                if self.merge.out == self.out2:
                    error_exit("--merged_out and --out2 shouldn't have same file name")
                if self.merge.out == self.unpaired1:
                    error_exit("--merged_out and --unpaired1 shouldn't have same file name")
                if self.merge.out == self.unpaired2:
                    error_exit("--merged_out and --unpaired2 shouldn't have same file name")
        else:
            if self.merge.out:
                sys.stderr.write("You haven't enabled merging mode (-m/--merge), ignoring argument --merged_out = %s\n" % self.merge.out)
                self.merge.out = ""

        if self.outputToSTDOUT:
            if self.split.enabled:
                error_exit("splitting mode cannot work with stdout mode")
            msg = "Streaming uncompressed "
            if self.merge.enabled:
                msg += "merged"
            elif self.isPaired():
                msg += "interleaved"
            sys.stderr.write(msg + " reads to STDOUT...\n")
            if self.isPaired() and not self.merge.enabled:
                sys.stderr.write("Enable interleaved output mode for paired-end input.\n")
            sys.stderr.write("\n")

        if not self.in2 and not self.interleavedInput and self.out2:
            error_exit("read2 output is specified (--out2), but neighter read2 input is not specified (--in2), nor read1 is interleaved.")

        if self.in2 or self.interleavedInput:
            if self.out1 and not self.out2:
                error_exit("paired-end input, read1 output should be specified together with read2 output (--out2 needed) ")
            if not self.out1 and self.out2:
                if not self.merge.enabled:
                    error_exit("paired-end input, read1 output should be specified (--out1 needed) together with read2 output ")

        if self.in2 and self.interleavedInput:
            error_exit("<in2> is not allowed when <in1> is specified as interleaved mode by (--interleaved_in)")

        if self.out1:
            if self.out1 == self.out2:
                error_exit("read1 output (--out1) and read2 output (--out2) should be different")
            if self.dontOverwrite and os.path.exists(self.out1):
                error_exit(self.out1 + " already exists and you have set to not rewrite output files by --dont_overwrite")
        if self.out2:
            if self.dontOverwrite and os.path.exists(self.out2):
                error_exit(self.out2 + " already exists and you have set to not rewrite output files by --dont_overwrite")
        if self.overlappedOut:
            if self.dontOverwrite and os.path.exists(self.overlappedOut):
                error_exit(self.overlappedOut + " already exists and you have set to not rewrite output files by --dont_overwrite")

        if not self.isPaired():
            if self.unpaired1:
                sys.stderr.write("Not paired-end mode. Ignoring argument --unpaired1 = %s\n" % self.unpaired1)
                self.unpaired1 = ""
            if self.unpaired2:
                sys.stderr.write("Not paired-end mode. Ignoring argument --unpaired2 = %s\n" % self.unpaired2)
                self.unpaired2 = ""
            if self.overlappedOut:
                sys.stderr.write("Not paired-end mode. Ignoring argument --overlapped_out = %s\n" % self.overlappedOut)
                self.overlappedOut = ""

        if self.split.enabled:
            if self.unpaired1:
                sys.stderr.write("Outputing unpaired reads is not supported in splitting mode. Ignoring argument --unpaired1 = %s\n" % self.unpaired1)
                self.unpaired1 = ""
            if self.unpaired2:
                sys.stderr.write("Outputing unpaired reads is not supported in splitting mode. Ignoring argument --unpaired2 = %s\n" % self.unpaired2)
                self.unpaired2 = ""

        if self.unpaired1:
            if self.dontOverwrite and os.path.exists(self.unpaired1):
                error_exit(self.unpaired1 + " already exists and you have set to not rewrite output files by --dont_overwrite")
            if self.unpaired1 == self.out1:
                error_exit("--unpaired1 and --out1 shouldn't have same file name")
            if self.unpaired1 == self.out2:
                error_exit("--unpaired1 and --out2 shouldn't have same file name")
        if self.unpaired2:
            if self.dontOverwrite and os.path.exists(self.unpaired2):
                error_exit(self.unpaired2 + " already exists and you have set to not rewrite output files by --dont_overwrite")
            if self.unpaired2 == self.out1:
                error_exit("--unpaired2 and --out1 shouldn't have same file name")
            if self.unpaired2 == self.out2:
                error_exit("--unpaired2 and --out2 shouldn't have same file name")
        if self.failedOut:
            if self.dontOverwrite and os.path.exists(self.failedOut):
                error_exit(self.failedOut + " already exists and you have set to not rewrite output files by --dont_overwrite")
            if self.failedOut == self.out1:
                error_exit("--failed_out and --out1 shouldn't have same file name")
            if self.failedOut == self.out2:
                error_exit("--failed_out and --out2 shouldn't have same file name")
            if self.failedOut == self.unpaired1:
                error_exit("--failed_out and --unpaired1 shouldn't have same file name")
            if self.failedOut == self.unpaired2:
                error_exit("--failed_out and --unpaired2 shouldn't have same file name")
            if self.failedOut == self.merge.out:
                error_exit("--failed_out and --merged_out shouldn't have same file name")

        if self.dontOverwrite:
            if os.path.exists(self.jsonFile):
                error_exit(self.jsonFile + " already exists and you have set to not rewrite output files by --dont_overwrite")
            if os.path.exists(self.htmlFile):
                error_exit(self.htmlFile + " already exists and you have set to not rewrite output files by --dont_overwrite")

        if self.compression < 1 or self.compression > 9:
            error_exit("compression level (--compression) should be between 1 ~ 9, 1 for fastest, 9 for smallest")

        if self.readsToProcess < 0:
            error_exit("the number of reads to process (--reads_to_process) cannot be negative")

        if self.thread < 1:
            self.thread = 1
        elif self.thread > 64:
            sys.stderr.write("WARNING: fastp uses up to 64 threads although you specified %d\n" % self.thread)
            self.thread = 64

        if self.trim.front1 < 0 or self.trim.front1 > 30:
            error_exit("trim_front1 (--trim_front1) should be 0 ~ 30, suggest 0 ~ 4")
        if self.trim.tail1 < 0 or self.trim.tail1 > 100:
            error_exit("trim_tail1 (--trim_tail1) should be 0 ~ 100, suggest 0 ~ 4")
        if self.trim.front2 < 0 or self.trim.front2 > 30:
            error_exit("trim_front2 (--trim_front2) should be 0 ~ 30, suggest 0 ~ 4")
        if self.trim.tail2 < 0 or self.trim.tail2 > 100:
            error_exit("trim_tail2 (--trim_tail2) should be 0 ~ 100, suggest 0 ~ 4")

        if self.qualfilter.qualifiedQual - 33 < 0 or self.qualfilter.qualifiedQual - 33 > 93:
            error_exit("qualitified phred (--qualified_quality_phred) should be 0 ~ 93, suggest 10 ~ 20")
        if self.qualfilter.avgQualReq < 0 or self.qualfilter.avgQualReq > 93:
            error_exit("average quality score requirement (--average_qual) should be 0 ~ 93, suggest 20 ~ 30")
        if self.qualfilter.unqualifiedPercentLimit < 0 or self.qualfilter.unqualifiedPercentLimit > 100:
            error_exit("unqualified percent limit (--unqualified_percent_limit) should be 0 ~ 100, suggest 20 ~ 60")
        if self.qualfilter.nBaseLimit < 0 or self.qualfilter.nBaseLimit > 50:
            error_exit("N base limit (--n_base_limit) should be 0 ~ 50, suggest 3 ~ 10")
        if self.lengthFilter.requiredLength < 0:
            error_exit("length requirement (--length_required) should be >0, suggest 15 ~ 100")
        if self.overlapDiffPercentLimit < 0 or self.overlapDiffPercentLimit > 100:
            error_exit("the maximum percentage of mismatched bases to detect overlapped region (--overlap_diff_percent_limit) should be 0 ~ 100, suggest 20 ~ 60")

        if self.split.enabled:
            if self.split.digits < 0 or self.split.digits > 10:
                error_exit("you have enabled splitting output to multiple files, the digits number of file name prefix (--split_prefix_digits) should be 0 ~ 10.")
            if self.split.byFileNumber:
                if self.split.number < 2 or self.split.number >= 1000:
                    error_exit("you have enabled splitting output by file number, the number of files (--split) should be 2 ~ 999.")
                if self.thread > self.split.number:
                    self.thread = self.split.number
            if self.split.byFileLines:
                if self.split.size < 1000 // 4:
                    error_exit("you have enabled splitting output by file lines, the file lines (--split_by_lines) should be >= 1000.")

        if self.qualityCut.enabledFront or self.qualityCut.enabledTail or self.qualityCut.enabledRight:
            qc = self.qualityCut
            if qc.windowSizeShared < 1 or qc.windowSizeShared > 1000:
                error_exit("the sliding window size for cutting by quality (--cut_window_size) should be between 1~1000.")
            if qc.qualityShared < 1 or qc.qualityShared > 30:
                error_exit("the mean quality requirement for cutting by quality (--cut_mean_quality) should be 1 ~ 30, suggest 15 ~ 20.")
            if qc.windowSizeFront < 1 or qc.windowSizeFront > 1000:
                error_exit("the sliding window size for cutting by quality (--cut_front_window_size) should be between 1~1000.")
            if qc.qualityFront < 1 or qc.qualityFront > 30:
                error_exit("the mean quality requirement for cutting by quality (--cut_front_mean_quality) should be 1 ~ 30, suggest 15 ~ 20.")
            if qc.windowSizeTail < 1 or qc.windowSizeTail > 1000:
                error_exit("the sliding window size for cutting by quality (--cut_tail_window_size) should be between 1~1000.")
            if qc.qualityTail < 1 or qc.qualityTail > 30:
                error_exit("the mean quality requirement for cutting by quality (--cut_tail_mean_quality) should be 1 ~ 30, suggest 13 ~ 20.")
            if qc.windowSizeRight < 1 or qc.windowSizeRight > 1000:
                error_exit("the sliding window size for cutting by quality (--cut_right_window_size) should be between 1~1000.")
            if qc.qualityRight < 1 or qc.qualityRight > 30:
                error_exit("the mean quality requirement for cutting by quality (--cut_right_mean_quality) should be 1 ~ 30, suggest 15 ~ 20.")

        if self.adapter.sequence != "auto" and self.adapter.sequence:
            if len(self.adapter.sequence) <= 3:
                error_exit("the sequence of <adapter_sequence> should be longer than 3")
            for c in self.adapter.sequence:
                if c not in "ATCG":
                    error_exit("the adapter <adapter_sequence> can only have bases in {A, T, C, G}, but the given sequence is: " + self.adapter.sequence)
            self.adapter.hasSeqR1 = True

        if self.adapter.sequenceR2 != "auto" and self.adapter.sequenceR2:
            if len(self.adapter.sequenceR2) <= 3:
                error_exit("the sequence of <adapter_sequence_r2> should be longer than 3")
            for c in self.adapter.sequenceR2:
                if c not in "ATCG":
                    error_exit("the adapter <adapter_sequence_r2> can only have bases in {A, T, C, G}, but the given sequenceR2 is: " + self.adapter.sequenceR2)
            self.adapter.hasSeqR2 = True

        if self.correction.enabled and not self.isPaired():
            sys.stderr.write("WARNING: base correction is only appliable for paired end data, ignoring -c/--correction\n")
            self.correction.enabled = False

        if self.umi.enabled:
            u = self.umi
            if u.location in (UMI_LOC_READ1, UMI_LOC_READ2, UMI_LOC_PER_READ):
                if u.length < 1 or u.length > 100:
                    error_exit("UMI length should be 1~100")
                if u.skip < 0 or u.skip > 100:
                    error_exit("The base number to skip after UMI <umi_skip> should be 0~100")
            else:
                if u.skip > 0:
                    error_exit("Only if the UMI location is in read1/read2/per_read, you can skip bases after UMI")
                if u.length > 0:
                    error_exit("Only if the UMI location is in read1/read2/per_read, you can set the UMI length")
            if u.prefix:
                if len(u.prefix) >= 10:
                    error_exit("UMI prefix should be shorter than 10")
                for c in u.prefix:
                    if not (c.isalpha() or c.isdigit()):
                        error_exit("UMI prefix can only have characters and numbers, but the given is: " + u.prefix)
            if u.separator:
                if len(u.separator) > 10:
                    error_exit("UMI separator cannot be longer than 10 base pairs")
                for c in u.separator:
                    if c not in "ATCG":
                        error_exit("UMI separator can only have bases in {A, T, C, G}, but the given sequence is: " + u.separator)

        if self.overRepAnalysis.sampling < 1 or self.overRepAnalysis.sampling > 10000:
            error_exit("overrepresentation_sampling should be 1~10000")

        return True


def check_file_valid(path: str):
    """reference: src/util.h:185-194"""
    if not (path and os.path.exists(path)):
        sys.stderr.write("ERROR: file '%s' doesn't exist, quit now\n" % path)
        sys.exit(-1)
    if os.path.isdir(path):
        sys.stderr.write("ERROR: '%s' is a folder, not a file, quit now\n" % path)
        sys.exit(-1)


def make_list_from_file_by_line(filename: str) -> List[str]:
    """reference: src/options.cpp:478-506"""
    ret = []
    sys.stderr.write("filter by index, loading %s\n" % filename)
    with open(filename, "r") as f:
        for line in f:
            line = line.rstrip("\r\n")
            for c in line:
                if c not in "ATCG":
                    error_exit("processing " + filename + ", each line should be one barcode, which can only contain A/T/C/G")
            sys.stderr.write(line + "\n")
            ret.append(line)
    sys.stderr.write("\n")
    return ret
