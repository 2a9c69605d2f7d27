"""Command-line interface of the PyTorch port.

Follows fastp_tpu/cli.py:main with the same parser, options, early input
check, evaluator pre-pass (sequence length, adapter detection, validation,
the split size, the two-colour polyG switch; all skipped for STDIN input),
the choice of the SE or PE processor and the report lines on stderr.  The
device is CUDA when torch sees a card, else the CPU; the run names it on
stderr.
"""
from __future__ import annotations

import sys
import time

import torch

from fastp_tpu.cli import build_parser, options_from_args
from fastp_tpu.config import FASTP_TPU_VER, check_file_valid
from fastp_tpu.evaluator import Evaluator


def default_device() -> torch.device:
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def describe_device(device: torch.device) -> str:
    if device.type == "cuda":
        return "cuda (%s)" % torch.cuda.get_device_name(device)
    return device.type


def _not_ported(what: str, item: int):
    raise NotImplementedError("fastp_tpu_torch does not support %s yet "
                              "(ROADMAP Queue 1 item %d)" % (what, item))


def prepare_options(argv):
    """Parse argv (argv[0] is the program) and run the evaluator pre-pass,
    in the order of fastp_tpu/cli.py:main.  Returns the Options."""
    if len(argv) >= 2 and argv[1] == "serve":
        _not_ported("the resident server", 12)
    if len(argv) >= 2 and argv[1] == "test":
        _not_ported("the built-in self-test", 14)
    # fastp uses -h for the html report, argparse for help
    args = build_parser().parse_args(["-h2" if a == "-h" else a
                                      for a in argv[1:]])
    if args.discard_unmerged:
        sys.stderr.write("DEPRECATED: --discard_unmerged has no effect now, "
                         "see the introduction for merging.\n")
    if args.local_processes > 1:
        _not_ported("--local_processes", 13)
    if args.devices > 1:
        _not_ported("--devices > 1", 13)
    opt = options_from_args(args, argv)
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


def run(argv) -> dict:
    """Run one job; returns the processor's result dict (stats, filter
    result, and the number of batches)."""
    from .pipeline.pe_runner import PairEndProcessor
    from .pipeline.runner import SingleEndProcessor
    device = default_device()
    t1 = time.time()
    opt = prepare_options(argv)
    sys.stderr.write("fastp_tpu_torch: running on %s\n" % describe_device(device))
    processor = PairEndProcessor if opt.isPaired() else SingleEndProcessor
    res = processor(opt, device).process()
    sys.stderr.write("\nJSON report: %s\n" % opt.jsonFile)
    sys.stderr.write("HTML report: %s\n" % opt.htmlFile)
    sys.stderr.write("\n%s\n" % opt.command)
    sys.stderr.write("fastp v%s (fastp_tpu_torch), time used: %d seconds\n"
                     % (FASTP_TPU_VER, int(time.time() - t1)))
    return res


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv
    if len(argv) == 1:
        sys.stderr.write("fastp_tpu_torch: fastp on PyTorch/CUDA, "
                         "version %s\n" % FASTP_TPU_VER)
        build_parser().print_usage(sys.stderr)
        return 0
    if len(argv) == 2 and argv[1] in ("-v", "--version"):
        print("fastp %s" % FASTP_TPU_VER)
        return 0
    run(argv)
    return 0
