"""Command-line interface of the PyTorch port.

Follows fastp_tpu/cli.py:main with its own copy of the parser and of the
options mapping, the early input check, the evaluator pre-pass (sequence
length, adapter detection, validation, the split size, the two-colour
polyG switch; all skipped for STDIN input), the choice of the SE or PE
processor and the report lines on stderr.  The device is CUDA; the CPU is
taken only when the caller asks for it (`device="cpu"`, or
FASTP_TPU_TORCH_DEVICE=cpu in the environment), and a run without a card
and without that request fails at once.  `--devices N` splits every batch
over N devices (parallel/mesh.py:make_mesh has the rule, and what 0 means),
and with the four torch.distributed variables set the run is one shard of a
job on several hosts (parallel/mesh.py:init_distributed).  The run names its
devices on stderr.  The launcher of `--local_processes N` imports no torch,
as fastp_tpu's launcher imports no JAX: its children do, each for itself.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time

from .config import (Options, error_exit, num2qual, check_file_valid,
                     FASTP_TPU_VER, UMI_LOC_INDEX1, UMI_LOC_INDEX2,
                     UMI_LOC_READ1, UMI_LOC_READ2, UMI_LOC_PER_INDEX,
                     UMI_LOC_PER_READ)
from .evaluator import Evaluator

DEVICE_ENV = "FASTP_TPU_TORCH_DEVICE"


def resolve_devices(device=None) -> list:
    """The device request of a run as a list of torch.devices: CUDA, unless
    the caller asks for the CPU.

    `device` (from Python) or, when that is None, the environment variable
    FASTP_TPU_TORCH_DEVICE names it: `cpu`, `cuda`, `cuda:N`, or a comma
    list such as `cuda:0,cuda:1`, which names the devices of a split
    outright and may repeat one (parallel/mesh.py:make_mesh).  With neither
    the request is `cuda`.  A CUDA device that torch cannot see raises: the
    run never carries on on the CPU unasked."""
    devs = [_resolve_one(name) for name in _asked(device)]
    if len({d.type for d in devs}) > 1:
        raise ValueError("%s: a list of devices is all cpu or all cuda"
                         % ",".join(str(d) for d in devs))
    return devs


def _asked(device) -> list:
    """The names of the device request (see resolve_devices), None for
    `cuda`: strings or torch.devices as the caller gave them."""
    asked = device if device is not None else os.environ.get(DEVICE_ENV) or None
    if isinstance(asked, str):
        return [s.strip() for s in asked.split(",") if s.strip()] or [None]
    if isinstance(asked, (list, tuple)):
        return list(asked)
    return [asked]


def resolve_device(device=None) -> torch.device:
    """The (first) device of the request: see resolve_devices."""
    return resolve_devices(device)[0]


def _resolve_one(asked) -> torch.device:
    import torch
    dev = torch.device(asked if asked is not None else "cuda")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("%s: fastp_tpu_torch runs on cpu, cuda or cuda:N "
                         "(given by the caller or by %s)" % (dev, DEVICE_ENV))
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "fastp_tpu_torch runs on a CUDA device and torch sees none; "
                "set %s=cpu (or pass device=\"cpu\") to run on the CPU"
                % DEVICE_ENV)
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError("%s: torch sees %d CUDA device(s)"
                               % (dev, torch.cuda.device_count()))
    return dev


_DEVICE_NAME = re.compile(r"(cpu|cuda)(?::(\d+))?")


def cuda_card_count() -> int:
    """The CUDA devices a child process will see: torch's count where this
    process has imported torch already (asking costs nothing then), else
    what the CUDA driver reports, asked through libcuda without creating a
    context (CUDA_VISIBLE_DEVICES applies to both); 0 where there is no
    driver."""
    torch = sys.modules.get("torch")
    if torch is not None:
        return torch.cuda.device_count() if torch.cuda.is_available() else 0
    import ctypes
    try:
        lib = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return 0
    lib.cuInit.argtypes = [ctypes.c_uint]
    lib.cuInit.restype = ctypes.c_int
    lib.cuDeviceGetCount.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.cuDeviceGetCount.restype = ctypes.c_int
    count = ctypes.c_int(0)
    if lib.cuInit(0) != 0 or lib.cuDeviceGetCount(ctypes.byref(count)) != 0:
        return 0
    return count.value


def launcher_devices(device=None):
    """The device request of a --local_processes launcher, as resolve_devices
    reads it, but without importing torch: (the names, cuda_card_count(),
    0 for the CPU).  Raises where resolve_devices would: a name
    that is no device, a list of both kinds, no card for a CUDA request, an
    index above the count."""
    names = ["cuda" if n is None else str(n) for n in _asked(device)]
    kinds = set()
    for name in names:
        if not _DEVICE_NAME.fullmatch(name):
            raise ValueError("%s: fastp_tpu_torch runs on cpu, cuda or cuda:N "
                             "(given by the caller or by %s)"
                             % (name, DEVICE_ENV))
        kinds.add(name.split(":")[0])
    if len(kinds) > 1:
        raise ValueError("%s: a list of devices is all cpu or all cuda"
                         % ",".join(names))
    if kinds == {"cpu"}:
        return names, 0
    count = cuda_card_count()
    if count == 0:
        raise RuntimeError(
            "fastp_tpu_torch runs on a CUDA device and finds none; set %s=cpu "
            "(or pass device=\"cpu\") to run on the CPU" % DEVICE_ENV)
    for name in names:
        if ":" in name and int(name.split(":")[1]) >= count:
            raise RuntimeError("%s: the host has %d CUDA device(s)"
                               % (name, count))
    return names, count


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fastp_tpu_torch", add_help=True,
        description="fastp_tpu_torch: fastp, the all-in-one FASTQ "
                    "preprocessor, on PyTorch/CUDA")
    a = p.add_argument
    # I/O
    a("-i", "--in1", default="", help="read1 input file name")
    a("-o", "--out1", default="", help="read1 output file name")
    a("-I", "--in2", default="", help="read2 input file name")
    a("-O", "--out2", default="", help="read2 output file name")
    a("--unpaired1", default="")
    a("--unpaired2", default="")
    a("--overlapped_out", default="")
    a("--failed_out", default="")
    a("-m", "--merge", action="store_true")
    a("--merged_out", default="")
    a("--include_unmerged", action="store_true")
    a("-6", "--phred64", action="store_true")
    a("-z", "--compression", type=int, default=4)
    a("--stdin", action="store_true")
    a("--stdout", action="store_true")
    a("--interleaved_in", action="store_true")
    a("--reads_to_process", type=int, default=0)
    a("--dont_overwrite", action="store_true")
    a("--fix_mgi_id", action="store_true")
    a("-V", "--verbose", action="store_true")
    # adapter
    a("-A", "--disable_adapter_trimming", action="store_true")
    a("-a", "--adapter_sequence", default="auto")
    a("--adapter_sequence_r2", default="auto")
    a("--adapter_fasta", default="")
    a("-2", "--detect_adapter_for_pe", action="store_true")
    a("--allow_gap_overlap_trimming", action="store_true")
    # trimming
    a("-f", "--trim_front1", type=int, default=0)
    a("-t", "--trim_tail1", type=int, default=0)
    a("-b", "--max_len1", type=int, default=0)
    a("-F", "--trim_front2", type=int, default=None)
    a("-T", "--trim_tail2", type=int, default=None)
    a("-B", "--max_len2", type=int, default=None)
    # dedup
    a("-D", "--dedup", action="store_true")
    a("--dup_calc_accuracy", type=int, default=None)
    a("--dont_eval_duplication", action="store_true")
    # polyG
    a("-g", "--trim_poly_g", action="store_true")
    a("--poly_g_min_len", type=int, default=10)
    a("-G", "--disable_trim_poly_g", action="store_true")
    # polyX
    a("-x", "--trim_poly_x", action="store_true")
    a("--poly_x_min_len", type=int, default=10)
    # quality cutting
    a("-5", "--cut_front", action="store_true")
    a("-3", "--cut_tail", action="store_true")
    a("-r", "--cut_right", action="store_true")
    a("-W", "--cut_window_size", type=int, default=4)
    a("-M", "--cut_mean_quality", type=int, default=20)
    a("--cut_front_window_size", type=int, default=None)
    a("--cut_front_mean_quality", type=int, default=None)
    a("--cut_tail_window_size", type=int, default=None)
    a("--cut_tail_mean_quality", type=int, default=None)
    a("--cut_right_window_size", type=int, default=None)
    a("--cut_right_mean_quality", type=int, default=None)
    # quality filtering
    a("-Q", "--disable_quality_filtering", action="store_true")
    a("-q", "--qualified_quality_phred", type=int, default=15)
    a("-u", "--unqualified_percent_limit", type=int, default=40)
    a("-n", "--n_base_limit", type=int, default=5)
    a("-e", "--average_qual", type=int, default=0)
    # length filtering
    a("-L", "--disable_length_filtering", action="store_true")
    a("-l", "--length_required", type=int, default=15)
    a("--length_limit", type=int, default=0)
    # low complexity
    a("-y", "--low_complexity_filter", action="store_true")
    a("-Y", "--complexity_threshold", type=int, default=30)
    # index filtering
    a("--filter_by_index1", default="")
    a("--filter_by_index2", default="")
    a("--filter_by_index_threshold", type=int, default=0)
    # correction / overlap
    a("-c", "--correction", action="store_true")
    a("--overlap_len_require", type=int, default=30)
    a("--overlap_diff_limit", type=int, default=5)
    a("--overlap_diff_percent_limit", type=int, default=20)
    # umi
    a("-U", "--umi", action="store_true")
    a("--umi_loc", default="")
    a("--umi_len", type=int, default=0)
    a("--umi_prefix", default="")
    a("--umi_skip", type=int, default=0)
    a("--umi_delim", default=":")
    # overrepresentation
    a("-p", "--overrepresentation_analysis", action="store_true")
    a("-P", "--overrepresentation_sampling", type=int, default=20)
    # reporting
    a("-j", "--json", default="fastp.json")
    a("-h2", "--html", default="fastp.html")
    a("-R", "--report_title", default="fastp report")
    # threading
    a("-w", "--thread", type=int, default=3)
    # splitting
    a("-s", "--split", type=int, default=0)
    a("-S", "--split_by_lines", type=int, default=0)
    a("-d", "--split_prefix_digits", type=int, default=4)
    # deprecated
    a("--cut_by_quality5", action="store_true")
    a("--cut_by_quality3", action="store_true")
    a("--cut_by_quality_aggressive", action="store_true")
    a("--discard_unmerged", action="store_true")
    # fastp_tpu extensions
    a("--batch_size", type=int, default=8192,
      help="reads per device batch (fastp_tpu extension)")
    a("--devices", type=int, default=0,
      help="data-parallel device shards; 0 = all local devices")
    a("--local_processes", type=int, default=0,
      help="self-spawn N record-range-sharded processes on this host "
           "(one per chip on a multi-chip host; merged single report)")
    return p


def options_from_args(args, argv) -> Options:
    opt = Options()
    opt.in1 = args.in1
    opt.in2 = args.in2
    opt.out1 = args.out1
    opt.out2 = args.out2
    opt.unpaired1 = args.unpaired1
    opt.unpaired2 = args.unpaired2
    opt.failedOut = args.failed_out
    opt.overlappedOut = args.overlapped_out
    if not opt.unpaired2:
        opt.unpaired2 = opt.unpaired1
    opt.compression = args.compression
    opt.readsToProcess = args.reads_to_process
    opt.phred64 = args.phred64
    opt.dontOverwrite = args.dont_overwrite
    opt.inputFromSTDIN = args.stdin
    opt.outputToSTDOUT = args.stdout
    opt.interleavedInput = args.interleaved_in
    opt.verbose = args.verbose
    opt.fixMGI = args.fix_mgi_id

    opt.duplicate.dedup = args.dedup
    opt.duplicate.enabled = (not args.dont_eval_duplication) or args.dedup
    if args.dup_calc_accuracy is None:
        opt.duplicate.accuracyLevel = 3 if opt.duplicate.dedup else 1
    else:
        opt.duplicate.accuracyLevel = min(6, max(1, args.dup_calc_accuracy))

    opt.merge.enabled = args.merge
    opt.merge.out = args.merged_out
    opt.merge.includeUnmerged = args.include_unmerged

    opt.adapter.enabled = not args.disable_adapter_trimming
    opt.adapter.detectAdapterForPE = args.detect_adapter_for_pe
    opt.adapter.allowGapOverlapTrimming = args.allow_gap_overlap_trimming
    opt.adapter.sequence = args.adapter_sequence
    opt.adapter.sequenceR2 = args.adapter_sequence_r2
    opt.adapter.fastaFile = args.adapter_fasta
    if (opt.adapter.sequenceR2 == "auto" and not opt.adapter.detectAdapterForPE
            and opt.adapter.sequence != "auto"):
        opt.adapter.sequenceR2 = opt.adapter.sequence
    if opt.adapter.fastaFile:
        opt.loadFastaAdapters()

    opt.trim.front1 = args.trim_front1
    opt.trim.tail1 = args.trim_tail1
    opt.trim.maxLen1 = args.max_len1
    opt.trim.front2 = args.trim_front2 if args.trim_front2 is not None else opt.trim.front1
    opt.trim.tail2 = args.trim_tail2 if args.trim_tail2 is not None else opt.trim.tail1
    opt.trim.maxLen2 = args.max_len2 if args.max_len2 is not None else opt.trim.maxLen1

    if args.trim_poly_g and args.disable_trim_poly_g:
        error_exit("You cannot enabled both trim_poly_g and disable_trim_poly_g")
    elif args.trim_poly_g:
        opt.polyGTrim.enabled = True
    elif args.disable_trim_poly_g:
        opt.polyGTrim.enabled = False
    opt.polyGTrim.minLen = args.poly_g_min_len

    if args.trim_poly_x:
        opt.polyXTrim.enabled = True
    opt.polyXTrim.minLen = args.poly_x_min_len

    opt.qualityCut.enabledFront = args.cut_front or args.cut_by_quality5
    opt.qualityCut.enabledTail = args.cut_tail or args.cut_by_quality3
    opt.qualityCut.enabledRight = args.cut_right or args.cut_by_quality_aggressive
    opt.qualityCut.windowSizeShared = args.cut_window_size
    opt.qualityCut.qualityShared = args.cut_mean_quality
    opt.qualityCut.windowSizeFront = (args.cut_front_window_size
                                      if args.cut_front_window_size is not None
                                      else opt.qualityCut.windowSizeShared)
    opt.qualityCut.qualityFront = (args.cut_front_mean_quality
                                   if args.cut_front_mean_quality is not None
                                   else opt.qualityCut.qualityShared)
    opt.qualityCut.windowSizeTail = (args.cut_tail_window_size
                                     if args.cut_tail_window_size is not None
                                     else opt.qualityCut.windowSizeShared)
    opt.qualityCut.qualityTail = (args.cut_tail_mean_quality
                                  if args.cut_tail_mean_quality is not None
                                  else opt.qualityCut.qualityShared)
    opt.qualityCut.windowSizeRight = (args.cut_right_window_size
                                      if args.cut_right_window_size is not None
                                      else opt.qualityCut.windowSizeShared)
    opt.qualityCut.qualityRight = (args.cut_right_mean_quality
                                   if args.cut_right_mean_quality is not None
                                   else opt.qualityCut.qualityShared)

    opt.qualfilter.enabled = not args.disable_quality_filtering
    opt.qualfilter.qualifiedQual = num2qual(args.qualified_quality_phred)
    opt.qualfilter.unqualifiedPercentLimit = args.unqualified_percent_limit
    opt.qualfilter.avgQualReq = args.average_qual
    opt.qualfilter.nBaseLimit = args.n_base_limit

    opt.lengthFilter.enabled = not args.disable_length_filtering
    opt.lengthFilter.requiredLength = args.length_required
    opt.lengthFilter.maxLength = args.length_limit

    opt.complexityFilter.enabled = args.low_complexity_filter
    opt.complexityFilter.threshold = min(100, max(0, args.complexity_threshold)) / 100.0

    opt.correction.enabled = args.correction
    opt.overlapRequire = args.overlap_len_require
    opt.overlapDiffLimit = args.overlap_diff_limit
    opt.overlapDiffPercentLimit = args.overlap_diff_percent_limit

    opt.thread = args.thread
    opt.jsonFile = args.json
    opt.htmlFile = args.html
    opt.reportTitle = args.report_title

    opt.split.enabled = args.split > 0 or args.split_by_lines > 0
    opt.split.digits = args.split_prefix_digits
    if args.split > 0 and args.split_by_lines > 0:
        error_exit("You cannot set both splitting by file number (--split) and splitting by file lines (--split_by_lines), please choose either.")
    if args.split > 0:
        opt.split.number = args.split
        opt.split.needEvaluation = True
        opt.split.byFileNumber = True
    if args.split_by_lines > 0:
        lines = args.split_by_lines
        if lines % 4 != 0:
            error_exit("Line number (--split_by_lines) should be a multiple of 4")
        opt.split.size = lines // 4
        opt.split.needEvaluation = False
        opt.split.byFileLines = True
    if opt.inputFromSTDIN or opt.in1 == "/dev/stdin":
        if opt.split.needEvaluation:
            error_exit("Splitting by file number is not supported in STDIN mode")

    opt.umi.enabled = args.umi
    opt.umi.length = args.umi_len
    opt.umi.prefix = args.umi_prefix
    opt.umi.skip = args.umi_skip
    opt.umi.delimiter = args.umi_delim
    if opt.umi.enabled:
        umi_loc = args.umi_loc.lower()
        if not umi_loc:
            error_exit("You've enabled UMI by (--umi), you should specify the UMI location by (--umi_loc)")
        if umi_loc not in ("index1", "index2", "read1", "read2", "per_index", "per_read"):
            error_exit("UMI location can only be index1/index2/read1/read2/per_index/per_read")
        if not opt.isPaired() and umi_loc in ("index2", "read2"):
            error_exit("You specified the UMI location as " + umi_loc + ", but the input data is not paired end.")
        if opt.umi.length == 0 and umi_loc in ("read1", "read2", "per_read"):
            error_exit("You specified the UMI location as " + umi_loc + ", but the length is not specified (--umi_len).")
        opt.umi.location = {
            "index1": UMI_LOC_INDEX1, "index2": UMI_LOC_INDEX2,
            "read1": UMI_LOC_READ1, "read2": UMI_LOC_READ2,
            "per_index": UMI_LOC_PER_INDEX, "per_read": UMI_LOC_PER_READ,
        }[umi_loc]

    opt.overRepAnalysis.enabled = args.overrepresentation_analysis
    opt.overRepAnalysis.sampling = args.overrepresentation_sampling

    opt.initIndexFiltering(args.filter_by_index1, args.filter_by_index2,
                           args.filter_by_index_threshold)

    opt.batchSize = args.batch_size
    # FASTP_TPU_DEVICES supplies the default shard count when --devices is
    # left at 0 (operator knob, as in fastp_tpu)
    opt.deviceCount = args.devices or int(os.environ.get(
        "FASTP_TPU_DEVICES", "0"))

    opt.command = " ".join(argv) + " "
    return opt


def describe_device(device: torch.device) -> str:
    if device.type == "cuda":
        import torch
        return "%s (%s)" % (device, torch.cuda.get_device_name(device))
    return device.type


def describe_devices(devices) -> str:
    """What the run says on stderr: its device, or the shards of a split."""
    if len(devices) == 1:
        return describe_device(devices[0])
    return "%d shards of every batch: %s" % (
        len(devices), ", ".join(describe_device(d) for d in devices))


def parse_options(argv):
    """Parse argv (argv[0] is the program); returns (args, Options)."""
    # fastp uses -h for the html report, argparse for help
    args = build_parser().parse_args(["-h2" if a == "-h" else a
                                      for a in argv[1:]])
    if args.discard_unmerged:
        sys.stderr.write("DEPRECATED: --discard_unmerged has no effect now, "
                         "see the introduction for merging.\n")
    return args, options_from_args(args, argv)


def local_process_count(args) -> int:
    """N when this process is the launcher of `--local_processes N` (or
    FASTP_TPU_LOCAL_PROCESSES=N); 0 for a plain run and for a shard that a
    launcher started."""
    n = args.local_processes or int(os.environ.get(
        "FASTP_TPU_LOCAL_PROCESSES", "0"))
    if n > 1 and not os.environ.get("FASTP_TPU_SHARD_COUNT"):
        return n
    return 0


def _clear_exchange_files(directory: str):
    """Remove what the shards' file exchange (parallel/multihost.py) left
    in `directory`: after a job that died, its files would be taken for
    those of the next job's first round."""
    if not os.path.isdir(directory):
        return
    for name in os.listdir(directory):
        if name.startswith((".fastp_shard.", ".fastp_shard_done.")):
            try:
                os.unlink(os.path.join(directory, name))
            except OSError:
                pass


def _spawn_local_shards(argv, n: int, opt, devices, cards: int) -> int:
    """Same-host scale-out: run the job as N record-range-sharded processes
    of the port and merge their stats into one report.

    The reference scales one process with -w N worker threads
    (reference: src/peprocessor.cpp:750-754, src/options.cpp:14).  The
    port's batch loop spends most of a batch in host stages under one
    interpreter lock, so N processes give N of them; on a host with one
    card they share it.  Children use parallel/multihost.py: record-aligned
    input shards, per-shard "0001."-prefixed outputs, exact cross-shard
    dedup, and a single merged JSON/HTML report from shard 0 through files
    next to the report.

    Device assignment: every child runs on the launcher's device request
    (`devices`: names, from launcher_devices), so on a host with one card
    all share `cuda:0`.  A request of `cuda` with no index goes to the
    children as `cuda:0`: left as it is, every child would split its batches
    over every card of the host (make_mesh).  A comma list goes to them as
    it is.  FASTP_TPU_ASSIGN_CHIPS=1 gives child k `cuda:(k mod cards)`
    instead (`cards`: cuda_card_count()), and
    FASTP_TPU_SERVERS=sock0,sock1,... routes child k to resident server
    k mod len (one server per card).  The launcher imports no torch and
    creates no CUDA context of its own."""
    import subprocess
    if opt.split.enabled:
        error_exit("--split cannot be combined with --local_processes "
                   "(outputs are already sharded per process)")
    if opt.inputFromSTDIN or opt.in1 in ("/dev/stdin", "-"):
        error_exit("--local_processes does not support STDIN input")
    child_args = []
    i = 1
    while i < len(argv):
        if argv[i] == "--local_processes":
            i += 2
            continue
        if argv[i].startswith("--local_processes="):
            i += 1
            continue
        child_args.append(argv[i])
        i += 1
    servers = [s for s in os.environ.get("FASTP_TPU_SERVERS", "").split(",")
               if s]
    assign = (devices[0].startswith("cuda")
              and bool(os.environ.get("FASTP_TPU_ASSIGN_CHIPS")))
    if devices == ["cuda"]:
        devices = ["cuda:0"]
    child_request = ",".join(devices)
    log_dir = os.path.dirname(os.path.abspath(opt.jsonFile)) or "."
    _clear_exchange_files(log_dir)   # of an earlier job that died there
    procs = []
    logs = []
    for k in range(n):
        env = dict(os.environ)
        env["FASTP_TPU_SHARD_INDEX"] = str(k)
        env["FASTP_TPU_SHARD_COUNT"] = str(n)
        env.pop("FASTP_TPU_LOCAL_PROCESSES", None)
        env[DEVICE_ENV] = "cuda:%d" % (k % cards) if assign else child_request
        if servers:
            env["FASTP_TPU_SERVER"] = servers[k % len(servers)]
        # shard 0 keeps the console (it prints the merged summary); other
        # shards log to files that surface only on failure
        if k == 0:
            errdst = None
        else:
            logs.append(os.path.join(log_dir, ".fastp_shard_log.%d" % k))
            errdst = open(logs[-1], "wb")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fastp_tpu_torch"] + child_args,
            env=env, stderr=errdst))
        if errdst is not None:
            errdst.close()
    # wait for all of them; when one fails, end the others, which would
    # wait for its exchange files (parallel/multihost.py) until they time out
    rcs = [None] * n
    failed = []
    while None in rcs:
        for k, p in enumerate(procs):
            if rcs[k] is None:
                rcs[k] = p.poll()
                if rcs[k] and not failed:
                    failed.append(k)
                    for q in procs:
                        if q.poll() is None:
                            q.terminate()
        time.sleep(0.02)
    rc = rcs[failed[0]] if failed else 0
    for k in failed:
        sys.stderr.write("fastp_tpu_torch: shard %d/%d exited with %d; the "
                         "other shards were ended\n" % (k, n, rc))
        if k > 0:
            try:
                with open(logs[k - 1], "rb") as f:
                    tail = f.read()[-4000:]
                sys.stderr.write(tail.decode("utf-8", "replace"))
            except OSError:
                pass
    if rc != 0:
        _clear_exchange_files(log_dir)   # the logs stay, for whoever looks
    else:
        for pth in logs:
            try:
                os.unlink(pth)
            except OSError:
                pass
    return rc


def prepare_options(argv, parsed=None):
    """Parse argv (argv[0] is the program) and run the evaluator pre-pass,
    in the order of fastp_tpu/cli.py:main.  `parsed` is parse_options'
    result where the caller has it already.  Returns the Options."""
    args, opt = parsed or parse_options(argv)
    # a stream cannot be read twice: no early check, pre-pass or evaluation
    evaluate = not opt.inputFromSTDIN and opt.in1 != "/dev/stdin"
    if opt.in1 and evaluate:
        check_file_valid(opt.in1)
    if opt.in2:
        check_file_valid(opt.in2)
    eva = Evaluator(opt)
    if evaluate:
        eva.evaluate_seq_len()
        if opt.overRepAnalysis.enabled:
            eva.evaluate_overrep_seqs()
    read_num = 0
    for is_r2 in (False, True):
        if not opt.shallDetectAdapter(is_r2):
            continue
        if not evaluate:
            sys.stderr.write("Adapter auto-detection is disabled for STDIN "
                             "mode\n")
            continue
        read = "read2" if is_r2 else "read1"
        sys.stderr.write("Detecting adapter sequence for %s...\n" % read)
        adapt, read_num = eva.eval_adapter_and_read_num(is_r2)
        if len(adapt) > 60:
            adapt = ""  # reference quirk: resize(0, 60) empties >60bp detections
        if adapt:
            if is_r2:
                opt.adapter.sequenceR2 = adapt
                opt.adapter.detectedAdapter2 = adapt
            else:
                opt.adapter.sequence = adapt
                opt.adapter.detectedAdapter1 = adapt
        else:
            sys.stderr.write("No adapter detected for %s\n" % read)
            if is_r2:
                opt.adapter.sequenceR2 = ""
            else:
                opt.adapter.sequence = ""
        sys.stderr.write("\n")
    # reference order: validate runs after adapter detection (main.cpp:485)
    opt.validate()
    if opt.split.needEvaluation and evaluate:
        if read_num == 0:
            read_num = eva.evaluate_read_num()
        opt.split.size = read_num // opt.split.number
        if opt.split.size <= 0:
            opt.split.size = 1
            sys.stderr.write("WARNING: the input file has less reads than "
                             "the number of files to split\n")
    if (not args.trim_poly_g and not args.disable_trim_poly_g and evaluate
            and eva.is_two_color_system()):
        opt.polyGTrim.enabled = True
    return opt


LAUNCH_LOG_ENV = "FASTP_TPU_TORCH_LAUNCH_LOG"


def _kernel_launches():
    """(the launches of each kernel so far, the libraries loaded so far)."""
    from . import cuda_build
    from .ops import launches
    return launches.snapshot(), len(cuda_build.loaded)


def _log_launches(argv, before):
    """With FASTP_TPU_TORCH_LAUNCH_LOG naming a file, append one JSON line
    with each kernel's launches during this job (a key per kernel of
    ops/launches.py) and the kernel libraries it loaded (`loaded`; none for
    a job that found them loaded, as a warm server's jobs do): how a caller
    counts the launches of a job that ran in another process (a resident
    server, a shard of --local_processes).  `before` is what
    _kernel_launches gave at the job's start."""
    path = os.environ.get(LAUNCH_LOG_ENV)
    if path:
        from . import cuda_build
        from .ops import launches
        counts, n_loaded = before
        line = dict({"pid": os.getpid(), "argv": list(argv[1:])},
                    **launches.since(counts),
                    loaded=cuda_build.loaded[n_loaded:])
        with open(path, "a") as fh:
            fh.write(json.dumps(line) + "\n")


# the window of batches that FASTP_TPU_PROFILE traces: a whole run of a
# million pairs is several hundred thousand kernel events, more than a
# trace viewer opens
PROFILE_SKIP_BATCHES = 1
PROFILE_BATCHES = 6


@contextlib.contextmanager
def _trace_window(processor):
    """With FASTP_TPU_PROFILE=<dir>, a torch.profiler trace (the card's
    kernels and copies, whichever thread queued them, and the calling
    thread's host calls; the workers' host calls are not in it:
    FASTP_TPU_TIMING=1 has their wall split) of PROFILE_BATCHES batches
    after the first PROFILE_SKIP_BATCHES, written to the directory as a
    Chrome trace when the window closes or the run ends; the processor's
    on_batch hook steps the window.  A run that ends inside the window
    leaves what it had; one of PROFILE_SKIP_BATCHES batches or fewer leaves
    no trace."""
    prof_dir = os.environ.get("FASTP_TPU_PROFILE")
    if not prof_dir:
        yield
        return
    from torch import profiler
    os.makedirs(prof_dir, exist_ok=True)
    sys.stderr.write("Writing a torch.profiler trace of batches %d-%d to %s\n"
                     % (PROFILE_SKIP_BATCHES + 1,
                        PROFILE_SKIP_BATCHES + PROFILE_BATCHES, prof_dir))
    written = []

    def write(prof):
        path = os.path.join(prof_dir, "fastp_tpu_torch.%d.%d.trace.json"
                            % (os.getpid(), len(written)))
        prof.export_chrome_trace(path)
        written.append(path)

    acts = [profiler.ProfilerActivity.CPU]
    if any(d.type == "cuda" for d in processor.devices):
        acts.append(profiler.ProfilerActivity.CUDA)
    prof = profiler.profile(
        activities=acts, on_trace_ready=write,
        schedule=profiler.schedule(wait=PROFILE_SKIP_BATCHES - 1, warmup=1,
                                   active=PROFILE_BATCHES, repeat=1))
    processor.on_batch = prof.step
    with prof:
        yield


def run(argv, device=None) -> dict:
    """Run one job on `device` (see resolve_devices); returns the
    processor's result dict (stats, filter result, and the number of
    batches).  As the launcher of --local_processes it starts the shards
    instead and returns {"rc": their exit code, "local_processes": N}."""
    t1 = time.time()
    parsed = parse_options(argv)
    n_local = local_process_count(parsed[0])
    if n_local:
        # before torch (the children import it, each for itself) and the
        # pre-pass (every shard runs its own), and after the device request
        # is checked, so that a launcher without a card fails once
        names, cards = launcher_devices(device)
        rc = _spawn_local_shards(argv, n_local, parsed[1], names, cards)
        return {"rc": rc, "local_processes": n_local}
    from .parallel.mesh import (init_distributed, make_mesh,
                                shutdown_distributed)
    requested = resolve_devices(device)
    # the devices of the split, before anything is read or written
    devices = make_mesh(parsed[1].deviceCount, requested)
    opt = prepare_options(argv, parsed)
    init_distributed()  # a no-op unless the torch.distributed variables are set
    try:
        result = _run_processor(argv, opt, devices, t1)
    except BaseException:
        shutdown_distributed(barrier=False)   # a failed rank leaves at once
        raise
    shutdown_distributed()   # a no-op without a group
    return result


def _run_processor(argv, opt, devices, t1):
    """The run proper, once the devices are known and any process group
    has started: shard options, the processor, the logs."""
    from .parallel import multihost
    from .pipeline.pe_runner import PairEndProcessor
    from .pipeline.runner import SingleEndProcessor
    if multihost.active():
        # this process's byte ranges of the input and its output names
        multihost.shard_options(opt)
    sys.stderr.write("fastp_tpu_torch: running on %s\n"
                     % describe_devices(devices))
    launches = _kernel_launches()
    processor = (PairEndProcessor if opt.isPaired()
                 else SingleEndProcessor)(opt, devices)
    with _trace_window(processor):
        res = processor.process()
    _log_launches(argv, launches)
    sys.stderr.write("\nJSON report: %s\n" % opt.jsonFile)
    sys.stderr.write("HTML report: %s\n" % opt.htmlFile)
    sys.stderr.write("\n%s\n" % opt.command)
    sys.stderr.write("fastp v%s (fastp_tpu_torch), time used: %d seconds\n"
                     % (FASTP_TPU_VER, int(time.time() - t1)))
    return res


def main(argv=None, device=None) -> int:
    if argv is None:
        argv = sys.argv
    if len(argv) == 1:
        sys.stderr.write("fastp_tpu_torch: fastp on PyTorch/CUDA, "
                         "version %s\n" % FASTP_TPU_VER)
        build_parser().print_usage(sys.stderr)
        sys.stderr.write(
            "also: fastp_tpu_torch test                # built-in self tests\n"
            "      fastp_tpu_torch serve --socket PATH # resident server "
            "(point jobs at it with FASTP_TPU_SERVER=PATH)\n")
        return 0
    if len(argv) == 2 and argv[1] == "test":
        from .selftest import run_self_tests
        device = resolve_device(device)
        launches = _kernel_launches()
        ok = run_self_tests(device)
        _log_launches(argv, launches)
        return 0 if ok else 1
    if len(argv) == 2 and argv[1] in ("-v", "--version"):
        print("fastp %s" % FASTP_TPU_VER)
        return 0
    return int(run(argv, device).get("rc", 0))
