"""Smoke run of the PyTorch port (fastp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints one line, and any failure exits non-zero:
  1. device   -- requires CUDA; prints the card's name and power limit
  2. build    -- builds the kernels' three libraries from
                 fastp_tpu_torch/csrc (overlap_sweep with its gapped variant
                 overlap_gap_sweep, stat_batch, adapter_match: one nvcc each),
                 the launch floor's empty kernel (launch_floor) and the
                 host library from fastp_tpu_torch/native (g++), all at
                 once; prints what ptxas reports for each kernel
  3. kernel   -- the CUDA overlap kernel against its plain PyTorch version
                 at B=8192, L=160 on bench-like and adversarial rows
                 (exact) at three overlap settings, diff_pct = 0 (the
                 --overlapped_out re-analysis) among them; on adversarial
                 rows at L=256 (the PE251 width) and at row counts that are
                 no multiple of the rows a block takes (8192 + 5, 3); the
                 byte compares the bench rows need and from them the
                 kernel's bound; CUDA-event timings of the kernel and of the
                 plain version; the bench rows once more launched from a
                 worker thread on a side stream, as the batch loop does.
                 Then stat_batch and trim_by_sequence against their plain
                 versions, bit-equal: the bench reads of both mates, and
                 adversarial rows (every byte value as a base, qualities
                 below 33 and at or above 128, lengths 0 and L, include all
                 false; widths 32, 160, 320 and 1,056, B = 1 and row counts
                 that are no multiple of a block's rows; adapters of 6, 8,
                 12, 16, 33 and 80 bases at match_req 4, 5 and 6 on rows
                 built to reach the insertion and the deletion fallback);
                 the scratch workspace of trim_by_sequence (reads of 50,000
                 bases, an adapter of 2,400), stat_batch at 2 L on the two
                 mates side by side;
                 at B=8192, L=160 the kernel's device time per launch from
                 CUDA-graph replays, one call between two events, the plain
                 chain captured as a graph the same way, the bound, and the
                 launch floor (csrc/launch_floor.cu's empty kernel at the
                 kernel's grid, timed the same way).  Then the overlap
                 kernel's gapped variant (--allow_gap_overlap_trimming)
                 against its plain version, bit-equal on all five outputs:
                 bench rows, planted one-base insertions and deletions at
                 forward and backward offsets (gap_rows) and the bench rows
                 with one indel planted in read 2 inside every overlap
                 (indel151_rows) at B=8192, L=160, adversarial rows at the
                 same further shapes, three overlap settings, with the rows
                 each leaves to the gapped pass and accepts there; the
                 planted rows must give gapped accepts both ways; timed on
                 the three row sets as the others, beside the plain
                 version as a graph (on the bench rows also eager, and the
                 chain the step ran before the gapped kernel: the ungapped
                 kernel, then the plain gapped pass, as a graph)
  4. golden   -- `python -m fastp_tpu_torch` on the golden inputs of cfg1
                 (single-end), cfg3, cfg5 (--merge, dedup, overrepresented
                 sequences), cfg6 (--failed_out, unpaired), cfg7 (split)
                 and cfg8 (--failed_out, --overlapped_out): every FASTQ
                 file of each golden and fastp.json
  5. main     -- a 1,000,000-pair PE151 corpus through cli.run with the
                 bench flags; each kernel must launch as often as the step
                 builders say (PER_BATCH: overlap_sweep 1, stat_batch 4,
                 trim_by_sequence 2 a batch); the run accumulates (the batch's sums stay on the card until
                 the end of the run)
  6. se       -- R1 of that corpus as single-end input with cfg1's flags
  7. failed   -- the corpus with cfg8's flags; the overlap kernel must
                 launch exactly twice per batch and every output stream is
                 non-empty
  8. merge    -- the corpus with cfg5's flags; the overlap kernel must
                 launch exactly twice per batch (the analysis and the merge
                 re-analysis), merged.fq is non-empty and the report's
                 merged_and_filtered section counts reads
  9. gap      -- the corpus with --allow_gap_overlap_trimming: the overlap
                 kernel's gapped variant once a batch in place of the
                 ungapped kernel (PER_BATCH); then, apart from the timed
                 run, the rows the gapped pass accepts on the corpus's pairs
                 as read are counted on the card and printed
                 (tools/make_synth.py plants substitutions only, so there
                 may be none)
10. cpu      -- the first 20,000 pairs (reads) of phases 5 to 8, of a
                 --allow_gap_overlap_trimming run, of an SE --adapter_fasta
                 run and of an --interleaved_in --stdout run on the card and
                 on the CPU give identical output files (the last one's
                 standard output too); the gap run is timed on the card.
                 The CPU runs ask for the CPU with FASTP_TPU_TORCH_DEVICE=cpu;
                 one more run, with the card hidden and no such request, must
                 exit non-zero
11. devices  -- the main path at 1M pairs with --devices 2 and the device
                 request cuda:0,cuda:0 (both shards of every batch share the
                 one card, so equality is shown and speed is not): files and
                 JSON equal to phase main's, two kernel launches per batch;
                 then on 20,000 pairs the se, failed and merge paths at
                 --devices 2, the main path at --devices 3 and the main path
                 at --devices 2 with FASTP_TPU_CORR_K=1 (rows over K take the
                 host's recomputation), each against phase cpu's one-device
                 run on the card
12. accum    -- the main and merge paths on 20,000 pairs with
                 FASTP_TPU_NO_ACCUM=1 against phase cpu's (accumulating)
                 runs on the card, and the device-to-host bytes per batch
                 both ways
13. pipeline -- the pipelined batch loop and the packed transfers at full
                 size: the 1M-pair main path at FASTP_TPU_PREFETCH 1 and 3 and
                 with FASTP_TPU_NO_INPUT_PACK=1, in turns (1, 3, plain, plain,
                 3, 1), each equal to phase main's files and JSON with exactly
                 one launch per batch, the walls, their medians and spreads,
                 and the bytes per batch each way; se, failed and merge at
                 prefetch 1 against their phases; 20,000-pair runs with each
                 of FASTP_TPU_NO_P3, _NO_NIB, _NO_INPUT_PACK, _NO_SLIM and
                 _NO_PACK against phase cpu's run on the card, with the input
                 scheme each took and the bytes per batch each way
                 (pipeline/device.py:fetch_stats); a job run as the resident
                 server runs it, with the thread count before and after; a
                 FASTP_TPU_PROFILE run that leaves a non-empty trace; then
                 the FASTP_TPU_TIMING lines of every 1M-pair run so far
14. graph    -- the step as a CUDA graph against the eager step
                 (graph=False) on the card, on the corpus's first 20,000
                 pairs (three batches, the last partial): every batch that
                 the runs queued goes through both again, bit-equal on every
                 key, for the main path with p3, nib, one-byte and plain
                 inputs, se, failed, merge, --allow_gap_overlap_trimming and
                 --devices 2 on cuda:0,cuda:0; a second job of the main path
                 through server._run_job captures nothing and writes the
                 same files; the host calls per batch that put work on the
                 card (torch.profiler's cudaLaunchKernel, cudaGraphLaunch
                 and cudaMemcpyAsync), graph and eager, on main, se, failed
                 and merge; every capture with its seconds and the reserved
                 bytes it added; the TIMING split of the four 1M-pair paths;
                 the captured step's device time per batch on main, se,
                 failed, merge and gap (CUDA events around replays) and its
                 largest device ops by name (one torch.profiler window over
                 three replays)
15. serve    -- `python -m fastp_tpu_torch serve --warm-run` on the card and
                 jobs through the thin client (FASTP_TPU_SERVER): three
                 20,000-pair jobs of the main path served and the same job
                 once as a cold process, their wall times (no served job
                 loads a kernel library); the main path's
                 first 200,000 pairs served, equal to the files of the same
                 prefix run in this script's process; a --merge
                 --dedup job twice, the second equal to the first; `ping`
                 counts the jobs; a second `serve` on the live socket exits
                 non-zero; `shutdown` ends the server and removes the socket
16. procs    -- the main path's first 200,000 pairs with --local_processes
                 2 and 4 on the one card, and as one process of its own: the
                 shards' files in order equal those of the same prefix run in
                 this script's process, the merged JSON too (but for
                 read1/read2_adapter_counts, whose maps cap per shard, as
                 in fastp_tpu: those two lines equal the maps of each
                 shard's records run alone in this script's process, added
                 up); --local_processes 2 again
                 with FASTP_TPU_SERVERS naming two resident servers on the
                 one card, equal to the plain --local_processes 2 run, each
                 shard inside its server; --merge --dedup with
                 --local_processes 2 on 20,000 pairs against a run in this
                 script's process (cfg5's flags less
                 --overrepresentation_analysis, whose sampling goes by a
                 read's index within its process)
17. dist     -- the main path's first 200,000 pairs as two processes that
                 exchange over torch.distributed (gloo on 127.0.0.1,
                 MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE; no
                 FASTP_TPU_FS_EXCHANGE),
                 both on the one card: the ranks' files in order equal those
                 of the same prefix run in this script's process, the merged
                 JSON too (read1/read2_adapter_counts held as in phase 15)
18. batch    -- `python -m fastp_tpu_torch.batch` over a directory of two
                 paired samples and one single-end sample against direct
                 runs of the same arguments (in this script's process);
                 overall.html is written
19. selftest -- `python -m fastp_tpu_torch test`: every check PASSED, the
                 overlap checks through the kernel at one pair row
20. no_card  -- serve --warm, test, --local_processes 2 and the batch
                 runner with the card hidden and no request for the CPU:
                 each exits non-zero and writes nothing (while the self-test's
                 process runs)
Phases 15 to 20 start the port as a user would, in processes of their own;
each job there appends each kernel's launches and the kernel libraries it
loaded to the file that FASTP_TPU_TORCH_LAUNCH_LOG names, emptied just
before the phase and read just after (the shards in two servers started
with --warm load none).  The corpus is written by tools/make_synth.py in a process of
its own while phases 3 and 4 run.
Then a JSON line of the walls, one of the graphs' device times, one of the
seconds each phase took, the card, a JSON line of the four kernels'
results (the gapped variant's launches are those of phase gap) and, last,
the device line.

    python3 chip_smoke.py --kernel-only [--old-kernel OLD.cu ...]

runs phases 1 to 3 alone (all four kernels); with --old-kernel it also
builds earlier versions of the kernels' sources, each named by its file
(overlap_sweep*.cu, stat_batch*.cu, adapter_match*.cu, e.g. commit
1877111's from `git show 1877111:fastp_tpu_torch/csrc/<name>.cu` under
_archive/), checks
each against the plain version and times it against the current kernel in
turns (old, new, new, old): overlap_sweep at two overlap settings (and its
ungapped instantiation's SASS against the old one's, by cuobjdump), then
overlap_sweep and overlap_gap_sweep on the gap row sets (bench, planted,
indel151) at the gap path's setting, stat_batch at L and 2 L,
trim_by_sequence on both mates.  The
stat_batch.cu and adapter_match.cu of commit 1877111 (their C interfaces)
are launched as their wrappers launched them (the zeroing nodes
included); a file whose C function takes another count of parameters is
refused before it is built.

    python3 chip_smoke.py --graph-only

runs phases 1 and 2 and then phase graph alone, on a corpus of 20,000
pairs (no TIMING split: the 1M-pair paths are not driven).

    python3 chip_smoke.py --turns VAR=VALUE ROUNDS

runs phases 1 and 2 and then the 1M-pair main path four times per round in
turns: as it is, with VAR=VALUE in the environment, with it again, as it
is (for example FASTP_TPU_NO_ACCUM=1, FASTP_TPU_NO_INPUT_PACK=1 or
FASTP_TPU_PREFETCH=1).  Prints every run's wall, the dispatch worker's
seconds, its transfers from the card and the schemes its inputs went up
in, then the medians and spreads (equal outputs required): what one
setting does to a wall, read within one call.

    python3 chip_smoke.py --against CHECKOUT

runs phases 1 and 2 and then the five 1M-pair paths (main, se, failed,
merge, gap) from an earlier
checkout of the repository (a directory that holds its fastp_tpu_torch/)
and from this one, a process each, in turns earlier, this, this, earlier;
outputs must be equal; prints the walls.

The script imports no JAX and nothing of fastp_tpu.
"""
import argparse
import contextlib
import ctypes
import functools
import gzip
import io
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fastp_tpu_torch import client  # noqa: E402
from fastp_tpu_torch import cuda_build  # noqa: E402
from fastp_tpu_torch import cli  # noqa: E402
from fastp_tpu_torch.io import native as native_mod  # noqa: E402
from fastp_tpu_torch.io.fastq import open_batch_reader  # noqa: E402
from fastp_tpu_torch.ops import adapter_cuda, overlap_cuda, stats_cuda  # noqa: E402
from fastp_tpu_torch.ops import launches as kernel_launches  # noqa: E402
from fastp_tpu_torch.parallel import multihost  # noqa: E402
from fastp_tpu_torch.pipeline import device as step_device  # noqa: E402
from fastp_tpu_torch.ops.common import rc  # noqa: E402
from fastp_tpu_torch.ops.adapter import (  # noqa: E402
    _match_with_one_insertion_plain, trim_by_sequence_plain)
from fastp_tpu_torch.ops.overlap import (COMPLETE_COMPARE_REQUIRE,  # noqa: E402
                                         _gap_pass, gap_sweep_select_plain,
                                         sweep_select_plain)
from fastp_tpu_torch.ops.stats import stat_batch_plain  # noqa: E402

BENCH_FLAGS = ["--correction", "--cut_right",
               "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
               "--adapter_sequence_r2", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"]
CFG8_FLAGS = ["--correction", "--cut_right", "--failed_out", "failed.fq",
              "--unpaired1", "up1.fq", "--overlapped_out", "ov.fq",
              "-l", "100"]
CFG5_FLAGS = ["--merge", "--merged_out", "merged.fq", "--dedup",
              "--dup_calc_accuracy", "1", "--overrepresentation_analysis"]
# cfg5 without --overrepresentation_analysis: that analysis samples reads by
# their index within a process, so its counts are not those of one process
# once the input is sharded (in fastp_tpu too); everything else is exact
MERGE_DEDUP_FLAGS = CFG5_FLAGS[:-1]
GAP_FLAGS = ["--allow_gap_overlap_trimming", "--correction", "--cut_right"]
# tools/make_synth.py's read-through adapters, as one FASTA
FASTA = (">r1\nAGATCGGAAGAGCACACGTCTGAACTCCAGTCA\n"
         ">r2\nAGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT\n")
GOLDENS = os.path.join(ROOT, "tests", "golden")
TESTDATA = os.path.join(ROOT, "tests", "testdata")
PE_IN = ["-i", os.path.join(TESTDATA, "R1.fq"), "-I", os.path.join(TESTDATA, "R2.fq")]
# golden directory -> the port's arguments (tests/test_parity.py's runs)
GOLDEN_RUNS = {
    "cfg1_se_default": ["-i", os.path.join(TESTDATA, "R1.fq"), "-o", "out.fq"],
    "cfg3_pe_correction": PE_IN + ["-o", "out1.fq", "-O", "out2.fq",
                                   "--correction", "--cut_right"],
    "cfg5_merge": PE_IN + ["--out1", "out1.fq", "--out2", "out2.fq"]
    + CFG5_FLAGS,
    "cfg6_failed": PE_IN + ["-o", "out1.fq", "-O", "out2.fq", "--failed_out",
                            "failed.fq", "--unpaired1", "up1.fq",
                            "--unpaired2", "up2.fq", "-l", "100"],
    "cfg7_split": PE_IN + ["-o", "out1.fq", "-O", "out2.fq", "-s", "3",
                           "-w", "1"],
    "cfg8_failed_cut": PE_IN + ["-o", "o1.fq", "-O", "o2.fq"] + CFG8_FLAGS,
}
NOT_COMPARED = ("stderr.txt", "fastp.html")  # the log; HTML embeds argv
B, L = 8192, 160
# (diff_limit, overlap_require, diff_pct): the main path's setting, a
# looser one that accepts at other offsets, and the --overlapped_out
# re-analysis (exact overlaps only)
OVERLAP_SETTINGS = ((5, 30, 0.2), (3, 10, 0.1), (5, 30, 0.0))
ACGT = np.frombuffer(b"ACGT", np.uint8)
TIMED_SETTINGS = (OVERLAP_SETTINGS[0], OVERLAP_SETTINGS[2])
MAIN_PAIRS = 1_000_000
# the first MID_PAIRS of the corpus: what the phases that start the port in
# processes of their own (serve's large job, procs, dist) run, so that the
# script keeps inside its time; each is held to one run of the same prefix
# in this process
MID_PAIRS = 200_000
CPU_PAIRS = 20_000
# further shapes the kernel is held to the plain version at, on adversarial
# rows: (B, L), the PE251 width and ragged row counts
# (the last two are the self-test's: one pair row of 89 and of 56 bases)
EDGE_SHAPES = ((B + 5, 256), (3, 256), (B + 5, L), (3, L), (1, 89), (1, 56))
# the card's peaks the bound is reckoned from: HBM3 of the H100 SXM5, and its
# integer pipes at the SXM5's boost clock (132 SMs x 64 INT32 lanes x
# 1.98 GHz; a byte compare is a quarter of a 32-bit operation)
SM_CLOCK_HZ = 1.98e9
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ
PEAK_BYTE_COMPARES_PER_S = 4 * PEAK_INT32_OPS_PER_S
# the fewest integer operations stat_batch needs per base of an included
# read (its slot, quality - 33, the two thresholds, one add of the packed
# count / q20 / q30 and one of the quality, the quality bin's clamp and
# count; the totals over slots come from the slot sums at the end) and per
# 5-mer it counts (the base's value, a rolling key's shift-or and mask,
# the count)
STAT_OPS_PER_BASE = 8
STAT_OPS_PER_KMER = 4
# stat_batch's further cases on the card: (B, L), widths 32, 160, 320 (the
# merge width) and 1,056, B = 1 and row counts that are no multiple of a
# block's chunk
STAT_SHAPES = ((B + 5, L), (1, L), (B, 32), (1000, 2 * L), (B, 2 * L),
               (300, 1056), (1, 1056))
# trim_by_sequence's cases: adapter lengths (6 to 16 random, 33 the bench's
# R1 adapter, 80 longer than 64) x match_req x (B, L)
ADAPTER_LENGTHS = (6, 8, 12, 16, 33, 80)
MATCH_REQS = (4, 5, 6)
ADAPTER_SHAPES = ((B + 5, L), (1, 32), (1000, 2 * L), (300, 1056))
BENCH_ADAPTERS = (BENCH_FLAGS[3], BENCH_FLAGS[5])
# kernel launches per batch of each path, from the step builders
# (pipeline/device.py): stat_batch before and after the filters per mate
# (plus the merged reads on merge), trim_by_sequence per explicit or
# detected adapter and mate (the SE corpus's adapter is detected), the
# overlap kernel per analysis, its gapped variant (overlap_gap_sweep) in
# its place with --allow_gap_overlap_trimming; a split launches per shard
PER_BATCH = {
    "main": {"overlap_sweep": 1, "overlap_gap_sweep": 0, "stat_batch": 4,
             "trim_by_sequence": 2},
    "se": {"overlap_sweep": 0, "overlap_gap_sweep": 0, "stat_batch": 2,
           "trim_by_sequence": 1},
    "failed": {"overlap_sweep": 2, "overlap_gap_sweep": 0, "stat_batch": 4,
               "trim_by_sequence": 0},
    "merge": {"overlap_sweep": 2, "overlap_gap_sweep": 0, "stat_batch": 5,
              "trim_by_sequence": 0},
    "gap": {"overlap_sweep": 0, "overlap_gap_sweep": 1, "stat_batch": 4,
            "trim_by_sequence": 0},
    "devices_2": {"overlap_sweep": 2, "overlap_gap_sweep": 0, "stat_batch": 8,
                  "trim_by_sequence": 4},
}
# the kernels the main path launches: what every job of its entry points
# (serve, procs, dist) must have launched
MAIN_KERNELS = tuple(k for k, n in PER_BATCH["main"].items() if n)
DEVICE_ENV = cli.DEVICE_ENV


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def normalize_json(text):
    return re.sub(r'\t"command": ".*"', '\t"command": "X"', text)


def same_outputs(dir_a, dir_b, what):
    """Every output file of dir_b is in dir_a with the same bytes (JSON
    after the command-line normalisation); returns the names compared."""
    files = sorted(f for f in os.listdir(dir_b) if f not in NOT_COMPARED)
    check("fastp.json" in files, "%s: no fastp.json in %s" % (what, dir_b))
    for f in files:
        path_a = os.path.join(dir_a, f)
        check(os.path.exists(path_a), "%s: %s is missing" % (what, f))
        with open(path_a, "rb") as fa, open(os.path.join(dir_b, f), "rb") as fb:
            a, b = fa.read(), fb.read()
        if f.endswith(".json"):
            a, b = normalize_json(a.decode()), normalize_json(b.decode())
        check(a == b, "%s: %s differs" % (what, f))
    return files


def port_cmd(*args):
    return [sys.executable, "-m", "fastp_tpu_torch", *args]


def port_env(**extra):
    """The environment of a port process: no device request (so the card)
    unless `extra` makes one."""
    env = dict(os.environ)
    env.pop(DEVICE_ENV, None)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print("phase device: %s | torch %s cuda %s | %d device(s)"
          % (card, torch.__version__, torch.version.cuda,
             torch.cuda.device_count()), flush=True)
    return card


# the C parameters each --old-kernel launcher passes: overlap_sweep's as the
# current source declares them, stat_batch's and adapter_match's as commit
# 1877111 declared them (compare_stat_with_old, compare_adapter_with_old)
OLD_C_PARAMS = {"stat_batch": 10, "adapter_match": 11}


def c_param_count(path, name):
    """The parameters of the extern "C" function `name` that `path`
    declares (None when it declares none)."""
    with open(path) as fh:
        m = re.search(r'extern\s+"C"\s+int\s+%s\s*\(([^)]*)\)' % name,
                      fh.read())
    return None if m is None else len(m.group(1).split(","))


def old_kernel_sources(paths):
    """--old-kernel's files by the kernel each is an earlier version of,
    named by its file: a name that starts with overlap_sweep, stat_batch or
    adapter_match (e.g. _archive/pr10/stat_batch.cu).  A file whose C
    function takes another count of parameters than its launcher passes
    (OLD_C_PARAMS) is refused: it would be called with the wrong
    signature."""
    out = {}
    for path in paths or ():
        name = next((k for k in cuda_build.KERNEL_LIBS
                     if os.path.basename(path).startswith(k)), None)
        check(name is not None and os.path.exists(path),
              "--old-kernel %s: no such file, or its name does not start "
              "with one of %s" % (path, ", ".join(cuda_build.KERNEL_LIBS)))
        check(name not in out, "--old-kernel names two versions of %s" % name)
        want = OLD_C_PARAMS.get(name) or c_param_count(
            os.path.join(cuda_build.CSRC, name + ".cu"), name)
        got = c_param_count(path, name)
        check(got == want,
              "--old-kernel %s: its %s takes %s parameters, the launcher "
              "passes %d (only commit 1877111's stat_batch.cu and "
              "adapter_match.cu, and an overlap_sweep.cu with the current C "
              "interface, are accepted)" % (path, name, got, want))
        out[name] = os.path.abspath(path)
    return out


def phase_build(old=None):
    """nvcc for the three kernels and the launch floor's empty kernel, for
    each earlier version that --old-kernel names (as <name>_old), and g++
    for the host library, all started together."""
    results = {}
    old = old or {}

    def build(key, fn):
        t0 = time.perf_counter()
        try:
            results[key] = (fn(), time.perf_counter() - t0)
        except Exception as exc:  # re-raised below, in the main thread
            results[key] = (exc, time.perf_counter() - t0)

    jobs = [("kernels", lambda: cuda_build.build_all(
        cuda_build.KERNEL_LIBS + ("launch_floor",))),
        ("native", native_mod.get_lib)]
    if old:
        jobs.append(("old", lambda: cuda_build._build(
            {name + "_old": path for name, path in old.items()})))
    threads = [threading.Thread(target=build, args=job) for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for key, (res, _) in results.items():
        if isinstance(res, Exception):
            raise res
    check(results["native"][0] is not None,
          "the host library (fastp_tpu_torch/native) did not build or load")
    built = []
    seconds = dict(results["kernels"][0])
    seconds.update(results["old"][0] if old else {})
    for name, sec in seconds.items():
        ptxas = [ln.strip() for ln in
                 cuda_build.build_logs.get(name, "").splitlines()
                 if "registers" in ln or "spill" in ln or "smem" in ln]
        source = old.get(name[:-4]) if name.endswith("_old") else None
        built.append("%s in %.3f s (%s; ptxas: %s)" % (
            name, sec, os.path.relpath(cuda_build.library_path(name, source),
                                       ROOT),
            " | ".join(ptxas) or "not built in this process"))
    print("phase build: at once, the three kernels, the launch floor and %d "
          "earlier version(s): %s; the host library in %.3f s (%s); all of "
          "it %.3f s"
          % (len(old), "; ".join(built), results["native"][1],
             os.path.relpath(native_mod._lib_path(), ROOT),
             max(sec for _, sec in results.values())), flush=True)


def _bench_rows(rng):
    """Bench-like pairs (tools/make_synth.py's generator): seq1 and the
    reverse complement of read 2, 151 bases padded to L."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_synth
    from types import SimpleNamespace
    args = SimpleNamespace(short_insert_rate=0.25, qual_bins="nova4",
                           n_rate=0.002, polyg_rate=0.08, dup_rate=0.05)
    r1, r2, _, _ = make_synth._gen_chunk(rng, B, 151, args)
    seq1 = np.zeros((B, L), np.uint8)
    rc2 = np.zeros((B, L), np.uint8)
    seq1[:, :151] = r1
    rc2[:, :151] = make_synth._COMP[r2[:, ::-1]]
    lens = rng.integers(60, 152, B).astype(np.int32)  # trimmed windows
    pos = np.arange(L)
    seq1[pos[None, :] >= lens[:, None]] = 0
    return seq1, rc2, lens, lens.copy()


def _adversarial_rows(rng, B=B, L=L):
    """B rows of width L that stress the edges: any byte value (bytes beyond
    the length are garbage too), lengths below overlap_require, zero
    lengths, exact full-length overlaps, overlaps found only among backward
    offsets, and mismatch counts near the limit."""
    seq1 = rng.integers(0, 256, (B, L)).astype(np.uint8)
    rc2 = rng.integers(0, 256, (B, L)).astype(np.uint8)
    len1 = rng.integers(0, L + 1, B).astype(np.int32)
    len2 = rng.integers(0, L + 1, B).astype(np.int32)
    kind = np.arange(B) % 6
    short = kind == 1
    len1[short] = rng.integers(0, 31, short.sum())
    zero = kind == 2
    len1[zero] = 0
    len2[zero & (np.arange(B) % 12 == 2)] = 0
    full = np.flatnonzero(kind == 3)
    len1[full] = L
    len2[full] = L
    rc2[full] = seq1[full]
    back = np.flatnonzero(kind == 4)
    for r in back:  # rc2[k + i] == seq1[i]: accepted at offset -k only
        k = int(rng.integers(1, 60))
        l1 = int(rng.integers(60, L - k))
        len1[r], len2[r] = l1, min(L, l1 + k)
        rc2[r, k:k + l1] = seq1[r, :l1]
        rc2[r, :k] = rng.integers(0, 256, k)
    few = np.flatnonzero(kind == 5)  # near-threshold mismatch counts
    for r in few:
        t = int(rng.integers(0, 40))
        len1[r], len2[r] = L, L - t
        rc2[r, :L - t] = seq1[r, t:]
        flip = rng.integers(0, L - t, int(rng.integers(0, 8)))
        rc2[r, flip] ^= 1
    return seq1, rc2, len1, len2


def place_overlap(rows, r, a, b, shift, forward, rng):
    """Row r of rows = (s1, rc2, len1, len2): a on read 1's side, b on
    rc(read 2)'s, overlapping at offset `shift` (forward, after `shift`
    random bases of read 1) or -shift (backward, after as many of rc(read
    2))."""
    s1, rc2, len1, len2 = rows
    n, lead = len(a), rng.choice(ACGT, shift)
    if forward:
        s1[r, :shift + n] = np.concatenate([lead, a])
        rc2[r, :n] = b
        len1[r], len2[r] = shift + n, n
    else:
        s1[r, :n] = a
        rc2[r, :shift + n] = np.concatenate([lead, b])
        len1[r], len2[r] = n, shift + n


def gap_rows(seed, B=48, L=96):
    """Pairs that overlap with a one-base insertion near the end of the
    overlap (olen 36..49, four substitutions before it), so that no offset
    passes the ungapped test and the one-insertion pass accepts.  The
    extra base sits in read 1 or in rc(read 2), the overlap at a forward or
    a backward offset.  Returns (s1, len1, s2, len2) as uint8/int32 numpy:
    read 2, not its reverse complement (rc(s2, len2) is rc2)."""
    rng = np.random.default_rng(seed)
    rows = (np.zeros((B, L), np.uint8), np.zeros((B, L), np.uint8),
            np.zeros(B, np.int32), np.zeros(B, np.int32))
    for r in range(B):
        n = int(rng.integers(36, 50))
        ins = rng.choice(ACGT, n)
        ins[n - 1] = ACGT[(list(ACGT).index(ins[n - 2]) + 1) % 4]
        p = n - 2
        norm = np.concatenate([ins[:p], ins[p + 1:n],
                               [ACGT[(list(ACGT).index(ins[n - 1]) + 2) % 4]]])
        for j in rng.choice(p, 4, replace=False):
            norm[j] = ACGT[(list(ACGT).index(ins[j]) + 1) % 4]
        a, b = (ins, norm) if r % 2 == 0 else (norm, ins)   # read 1, rc(read 2)
        place_overlap(rows, r, a, b, int(rng.integers(0, 12)), r % 4 < 2, rng)
    s1, rc2, len1, len2 = rows
    s2 = rc(torch.from_numpy(rc2), torch.from_numpy(len2)).numpy()
    return s1, len1, s2, len2


def plant_indels(rows, found, offset, overlap_len, rng, subs=0, tail=None):
    """A copy of rows = (seq1, rc2, len1, len2) with one insertion or
    deletion (one in two) planted in rc(read 2), so in read 2, inside the
    overlap of every row where `found`, at `offset` over `overlap_len`
    bases (the ungapped sweep's outputs, or an overlap known by
    construction), and `subs` substitutions in the overlap besides.  The
    indel sits anywhere in the overlap, or within its last `tail` bases;
    read 2 keeps its length (a base falls off its end, or a random one
    follows)."""
    s1, rc2, len1, len2 = (x.copy() for x in rows)
    for r in np.flatnonzero(found):
        start, n = max(-int(offset[r]), 0), int(overlap_len[r])
        l2 = int(len2[r])
        p = start + int(rng.integers(max(n - tail, 0) if tail else 0, n))
        row, base = rc2[r, :l2].copy(), rng.choice(ACGT, 1)
        rc2[r, :l2] = (np.concatenate([row[:p], base, row[p:l2 - 1]])
                       if rng.random() < 0.5 else
                       np.concatenate([row[:p], row[p + 1:], base]))
        for j in start + rng.integers(0, n, subs):
            rc2[r, j] = ACGT[(np.searchsorted(ACGT, rc2[r, j]) + 1) % 4]
    return s1, rc2, len1, len2


def indel151_rows(rng, device="cuda"):
    """The bench rows (_bench_rows: 151-base pairs, their trimmed lengths
    and their inserts) with one insertion or deletion planted in read 2
    inside the overlap of every pair the ungapped sweep (the plain version,
    on `device`) finds overlapping at the gap path's setting: reads with
    real indels."""
    rows = _bench_rows(rng)
    found, offset, ol, _ = (x.cpu().numpy() for x in sweep_select_plain(
        *(torch.from_numpy(x).to(device) for x in rows), *OVERLAP_SETTINGS[0]))
    return plant_indels(rows, found, offset, ol, rng)


def stat_rows(rng, B, L):
    """Arguments of stat_batch that stress its edges: every byte value as a
    base (with ACGT-rich rows, so that 5-mers count), qualities below 33
    and at or above 128, lengths 0 and L (and past L), and some reads
    excluded; bytes past a length are not zeroed.  Returns (bases, quals,
    lengths int32, include bool) as numpy arrays."""
    acgt = np.frombuffer(b"ACGTACGTACGTNacgt", np.uint8)
    bases = rng.choice(acgt, (B, L))
    wild = rng.random(B) < 0.3
    bases[wild] = rng.integers(0, 256, (int(wild.sum()), L))
    if B and L:
        bases.reshape(-1)[:min(256, B * L)] = np.arange(256)[:min(256, B * L)]
    quals = rng.integers(33, 75, (B, L)).astype(np.uint8)
    low = rng.random((B, L)) < 0.1
    quals[low] = rng.integers(0, 33, int(low.sum()))
    high = rng.random((B, L)) < 0.05
    quals[high] = rng.integers(128, 256, int(high.sum()))
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    lengths[::7] = L
    lengths[1::7] = 0
    lengths[2::11] = L + 3
    include = rng.random(B) < 0.8
    return bases.astype(np.uint8), quals, lengths, include


def random_adapter(rng, n):
    return rng.choice(np.frombuffer(b"ACGT", np.uint8), n).astype(np.uint8)


def adapter_rows(rng, B, L, adapter):
    """Reads for trim_by_sequence against `adapter` (uint8): planted with
    a few mismatches (the Hamming scan), with the adapter's tail at the
    read's start (negative positions), with one base inserted into or
    deleted from the adapter at the read's start (the insertion and the
    deletion fallbacks, which compare from index 0), with the mismatch
    count at the allowance, random bytes of any value, lengths 0 and L.
    Returns (bases, lengths int32) as numpy arrays."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    a = np.asarray(adapter, np.uint8)
    alen = len(a)
    bases = rng.choice(acgt, (B, L)).astype(np.uint8)
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    for r in range(B):
        kind = r % 9
        row = bases[r]
        if kind == 0 and alen:      # planted, a few mismatches
            p = int(rng.integers(0, max(1, L - 4)))
            seg = a[:L - p].copy()
            flips = rng.integers(0, len(seg), int(rng.integers(0, 3)))
            seg[flips] = rng.choice(acgt, len(flips))
            row[p:p + len(seg)] = seg
        elif kind == 1 and alen:    # the adapter's tail at the start
            k = int(rng.integers(1, 5))
            seg = a[k:][:L]
            row[:len(seg)] = seg
        elif kind in (2, 3) and alen > 2:   # one base in or out
            if kind == 2:
                i = int(rng.integers(1, max(2, alen // 2)))
                seg = np.concatenate([a[:i], rng.choice(acgt, 1), a[i:]])
            else:
                # a deletion at 3..10 in a read of 2i..4i bases: too many
                # mismatches for the Hamming scan at -1 and for the
                # insertion test, none for the deletion test
                i = int(rng.integers(3, max(4, min(11, alen // 2))))
                seg = np.concatenate([a[:i], a[i + 1:]])
            if rng.random() < 0.3:  # a mismatch near the end: a shorter match
                seg = seg.copy()
                seg[-1 - int(rng.integers(0, 3))] ^= 2
            seg = seg[:L]
            row[:len(seg)] = seg
            if kind == 2:
                lengths[r] = min(L, len(seg) + int(rng.integers(-3, 20)))
            else:
                lengths[r] = min(L, max(9, int(rng.integers(2 * i, 4 * i + 1))))
        elif kind == 4:             # any byte value
            row[:] = rng.integers(0, 256, L)
        elif kind == 5:
            lengths[r] = (0, L, 1, 3, 7)[r % 5]
        elif kind == 6 and alen:    # mismatches at and past the allowance
            p = int(rng.integers(0, max(1, L - alen)))
            seg = a[:L - p].copy()
            extra = len(seg) // 8 + int(rng.integers(0, 2))
            flips = rng.choice(len(seg), min(extra, len(seg)), replace=False)
            seg[flips] = (seg[flips] + 1) % 251 + 1
            row[p:p + len(seg)] = seg
            lengths[r] = max(lengths[r], min(L, p + len(seg)))
    return bases, lengths


def _median_ms(fn, runs=25):
    """Median over `runs` of one call between two CUDA events (what a
    caller sees: the device time and the host's gap before the launch)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def _graph_ms(fn, launches=20, replays=15):
    """Device time of one call of `fn`: `launches` calls captured into one
    CUDA graph, so that no host gap lies between them; the median over
    `replays` replays between two CUDA events, divided by `launches`.  The
    inputs stay in the L2 cache between launches, as they do in the step,
    where the ops just before the kernel wrote them.  The first call runs
    on the capturing stream, as a step's warm-up does (stat_batch makes its
    accumulator for that stream then), and the replays run there too, so
    that no two launches that share an accumulator overlap."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(launches):
            fn()
    with torch.cuda.stream(stream):   # the stream whose accumulator it holds
        return _median_ms(graph.replay, replays) / launches


def floor_ms(grid_x, grid_y, threads, cluster=1, smem=0):
    """The launch floor of a kernel's geometry: csrc/launch_floor.cu's empty
    kernel at that grid, block, cluster and dynamic shared memory, timed as
    _graph_ms times the kernels."""
    fn = cuda_build.load("launch_floor").launch_floor
    fn.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call():
        err = fn(grid_x, grid_y, threads, cluster, smem,
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, "launch_floor launch failed: CUDA error %d" % err)
    return _graph_ms(call)


def _in_turns(calls):
    """{name: call} timed with _graph_ms in turns, forward then backward
    (for two: a, b, b, a).  Returns [(name, ms)] in the order timed."""
    names = list(calls)
    return [(n, _graph_ms(calls[n])) for n in names + names[::-1]]


def _turns_text(turns):
    return ", ".join("%s %.4f ms" % t for t in turns)


def _limit_of(olen, diff_limit, diff_pct):
    """The accept test's limit per offset, as the kernel takes it:
    min(diff_limit, int(float32(olen) * diff_pct))."""
    oc = np.maximum(olen, 0).astype(np.float32)
    return np.minimum(diff_limit, (oc * np.float32(diff_pct)).astype(np.int64))


def _test_compares(x, y, n, limit, tail):
    """Byte compares one accept test needs, per row: x[:, i] against y[:, i]
    for i < n (x and y aligned), up to the first position where the
    mismatch count passes `limit` (the test has failed there), else all n
    and `tail` more (the gapped test's two last compares).  A row with
    n <= 0 compares nothing."""
    mm = (x != y) & (np.arange(x.shape[1])[None, :] < n[:, None])
    over = np.cumsum(mm, axis=1, dtype=np.int32) > limit[:, None]
    return np.where(n <= 0, 0, np.where(over.any(axis=1),
                                        over.argmax(axis=1) + 1, n + tail))


def _walk_compares(rows_np, walked_f, walked_b, setting, gapped):
    """Byte compares of the accept tests at each row's first walked_f
    forward and walked_b backward offsets (numpy [B] each), summed: the
    ungapped test over min(olen, 50) positions, the gapped one over the
    olen - 2 positions before the overlap's last two and then its two last
    compares (olen < 3 and olen > 51 rejected unread: see
    gap_needed_compares); each stopping where its mismatch count passes the
    offset's limit (_test_compares)."""
    seq1, rc2, len1, len2 = rows_np
    rows_n, width = seq1.shape
    pad = np.zeros((rows_n, width), np.uint8)
    x_all, y_all = np.concatenate([seq1, pad], 1), np.concatenate([rc2, pad], 1)
    l1, l2 = len1.astype(np.int64), len2.astype(np.int64)
    w = width if gapped else min(width, COMPLETE_COMPARE_REQUIRE)
    total = 0
    for s in range(max(int(walked_f.max(initial=0)),
                       int(walked_b.max(initial=0)))):
        for walked, olen, x, y in (
                (walked_f, np.minimum(l1 - s, l2), x_all[:, s:s + w],
                 y_all[:, :w]),
                (walked_b, np.minimum(l1, l2 - s), x_all[:, :w],
                 y_all[:, s:s + w])):
            on = s < walked
            o = olen[on]
            n = (np.where((o >= 3) & (o <= COMPLETE_COMPARE_REQUIRE + 1),
                          o - 2, 0) if gapped
                 else np.clip(o, 0, COMPLETE_COMPARE_REQUIRE))
            total += int(_test_compares(x[on], y[on], n, _limit_of(
                o, setting[0], setting[2]), 2 if gapped else 0).sum())
    return total


def _walked(hit, offset, len1, len2, overlap_require):
    """Offsets walked per row, forward and backward, by a first-accept walk
    that accepted at `offset` where `hit`: every forward offset up to the
    accepted one, or all of them and then the backward offsets up to the
    accepted one, or all of both for a row that accepts none.  Offset 0 is
    shift 0 of the forward walk, or of the backward walk for a row with no
    forward candidate (the two compare the same bytes)."""
    off = offset.astype(np.int64)
    n_f = np.maximum(len1.astype(np.int64) - overlap_require, 0)
    n_b = np.maximum(len2.astype(np.int64) - overlap_require, 0)
    fwd_hit = hit & (off >= 0) & (off < n_f)
    return (np.where(fwd_hit, off + 1, n_f),
            np.where(fwd_hit, 0, np.where(hit, 1 - off, n_b)))


def needed_compares(rows_np, found, offset, overlap_len, setting):
    """Byte compares the first-accept walk needs on these rows (numpy
    arrays: rows_np as (seq1, rc2, len1, len2), the rest the plain
    version's outputs) at setting (diff_limit, overlap_require, diff_pct).
    Returns (full, needed): `full` counts each walked offset at its whole
    overlap; `needed` each at the min(overlap, 50) positions that decide the
    accept test, cut where the mismatch count passes the limit, plus the
    whole overlap once for each accepted row (its diff)."""
    _, _, len1, len2 = rows_np
    l1, l2 = len1.astype(np.int64), len2.astype(np.int64)
    walked_f, walked_b = _walked(found, offset, len1, len2, setting[1])
    s = np.arange(max(int(walked_f.max(initial=0)),
                      int(walked_b.max(initial=0)), 1))[None, :]
    olen_f = np.maximum(np.minimum(l1[:, None] - s, l2[:, None]), 0)
    olen_b = np.maximum(np.minimum(l1[:, None], l2[:, None] - s), 0)
    full = int((olen_f * (s < walked_f[:, None])).sum()
               + (olen_b * (s < walked_b[:, None])).sum())
    needed = (_walk_compares(rows_np, walked_f, walked_b, setting, False)
              + int(overlap_len.astype(np.int64)[found].sum()))
    return full, needed


def kernel_bound(rows_np, want, setting):
    """The least time the card could take for sweep_select on these rows:
    the larger of its bytes (each input read once, each output written once)
    over the memory rate and the byte compares it needs over the integer
    rate.  Returns a dict of the counts and times (ms)."""
    seq1, rc2, len1, len2 = rows_np
    found, offset, ol, diff = (w.cpu().numpy() for w in want)
    full, needed = needed_compares(rows_np, found, offset, ol, setting)
    nbytes = (seq1.nbytes + rc2.nbytes + len1.nbytes + len2.nbytes
              + found.nbytes + offset.nbytes + ol.nbytes + diff.nbytes)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = needed / PEAK_BYTE_COMPARES_PER_S * 1e3
    return {"bytes": nbytes, "compares_needed": needed,
            "compares_at_whole_overlaps": full, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms,
            "operations_ms_at_whole_overlaps":
                full / PEAK_BYTE_COMPARES_PER_S * 1e3,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def gap_needed_compares(rows_np, ungapped, gapped, setting):
    """Byte compares the gapped variant needs on these rows (numpy arrays:
    rows_np as for needed_compares, `ungapped` sweep_select's four outputs,
    `gapped` gap_sweep_select's five): the ungapped walk's (needed_compares'
    `needed`), then, for each row that walk leaves unaccepted, the gapped
    accept tests of its gapped walk (_walk_compares: each cut where its
    mismatch count passes the offset's limit), and the winner's
    one-insertion difference once, 2 (olen - 1) compares.  The gapped walk
    counts no offset with an overlap above 51: such a row had every
    ungapped offset rejected, so mm50, the mismatches over the first 50
    positions, is over the limit at each of them, and the gapped count over
    olen - 2 >= 50 positions is at least mm50 there; they need no compare
    (csrc/overlap_sweep.cu's header has the argument)."""
    found_u, off_u, ol_u = ungapped[:3]
    _, needed = needed_compares(rows_np, found_u, off_u, ol_u, setting)
    _, off, ol, _, has_gap = gapped
    walked_f, walked_b = _walked(has_gap, off, rows_np[2], rows_np[3],
                                 setting[1])
    walk = _walk_compares(rows_np, np.where(found_u, 0, walked_f),
                          np.where(found_u, 0, walked_b), setting, True)
    winner = (2 * (ol.astype(np.int64) - 1))[has_gap].sum()
    return int(needed + walk + winner)


def gap_bound(rows_np, ungapped, gapped, setting):
    """The least time the card could take for gap_sweep_select on these
    rows: the larger of its bytes (each input read once, the five outputs
    written once) over the memory rate and gap_needed_compares over the
    integer rate."""
    seq1, rc2, len1, len2 = rows_np
    ungapped = [u.cpu().numpy() for u in ungapped]
    gapped = [g.cpu().numpy() for g in gapped]
    compares = gap_needed_compares(rows_np, ungapped, gapped, setting)
    nbytes = (seq1.nbytes + rc2.nbytes + len1.nbytes + len2.nbytes
              + sum(g.nbytes for g in gapped))
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = compares / PEAK_BYTE_COMPARES_PER_S * 1e3
    return {"bytes": nbytes, "compares_needed": compares,
            "rows_left_by_the_ungapped_pass": int((~ungapped[0]).sum()),
            "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _same_as_plain(got, want, what):
    """Largest absolute difference over the four outputs; fails unless 0."""
    worst = 0
    for key, g, w in zip(("overlapped", "offset", "overlap_len", "diff"),
                         got, want):
        check(g.shape == w.shape and g.dtype == w.dtype,
              "kernel %s/%s: %s %s, plain %s %s"
              % (what, key, g.dtype, tuple(g.shape), w.dtype, tuple(w.shape)))
        err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) \
            if g.numel() else 0
        worst = max(worst, err)
        check(err == 0, "kernel %s/%s differs from plain (max abs err %d)"
              % (what, key, err))
    return worst


def _raw_launcher(fn, tensors, setting, warps, gap=False):
    """A call of a kernel library's C entry point (overlap_sweep, or with
    `gap` overlap_gap_sweep and its has_gap output) on preallocated outputs
    (no wrapper), for timing two builds of the kernel alike.  Returns
    (call, outputs)."""
    s1, r2, l1, l2 = tensors
    rows, width = s1.shape
    dl, req, pct = setting
    outs = (torch.empty(rows, dtype=torch.bool, device=s1.device),
            *(torch.empty(rows, dtype=torch.int32, device=s1.device)
              for _ in range(3)))
    if gap:
        outs += (torch.empty(rows, dtype=torch.bool, device=s1.device),)

    def call():
        err = fn(s1.data_ptr(), r2.data_ptr(), l1.data_ptr(), l2.data_ptr(),
                 rows, width, dl, req, pct, *(o.data_ptr() for o in outs),
                 warps, torch.cuda.current_stream().cuda_stream)
        check(err == 0, "%s launch failed: CUDA error %d"
              % ("overlap_gap_sweep" if gap else "overlap_sweep", err))
    return call, outs


def kernel_sass(lib_path, mangled_part):
    """The SASS instructions (addresses and encodings left out) of the one
    kernel of a built library whose mangled name contains `mangled_part`,
    by cuobjdump beside nvcc; None where the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    chunks = [c for c in text.split("Function : ")[1:]
              if mangled_part in c.split("\n", 1)[0]]
    check(len(chunks) == 1, "%s: %d kernels named like %s"
          % (lib_path, len(chunks), mangled_part))
    return [re.sub(r"/\*.*?\*/", "", ln).strip() for ln in
            chunks[0].splitlines() if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]


def compare_with_old_kernel(old_source, tensors, want_by_setting):
    """Loads an earlier version of csrc/overlap_sweep.cu (same C interface,
    rows of 2 L bytes in shared memory; built in phase build), holds it to
    the plain version and times it against the current kernel in turns:
    old, new, new, old."""
    old_fn = cuda_build.load("overlap_sweep_old", old_source).overlap_sweep
    new_fn = overlap_cuda._kernel()
    old_fn.argtypes, old_fn.restype = new_fn.argtypes, new_fn.restype
    width = tensors[0].shape[1]
    out = {}
    for setting in TIMED_SETTINGS:
        old_call, old_outs = _raw_launcher(old_fn, tensors, setting,
                                           min(8, 48 * 1024 // (2 * width)))
        new_call, new_outs = _raw_launcher(new_fn, tensors, setting,
                                           overlap_cuda.rows_per_block(width))
        for call, outs, what in ((old_call, old_outs, "old"),
                                 (new_call, new_outs, "new")):
            call()
            torch.cuda.synchronize()
            _same_as_plain(outs, want_by_setting[setting], what + " build")
        turns = [("old", old_call), ("new", new_call), ("new", new_call),
                 ("old", old_call)]
        out[setting[2]] = [(name, _graph_ms(call)) for name, call in turns]
    # the ungapped instantiation (overlap_sweep_kernel<false>) of both
    # libraries, instruction by instruction
    sass = [kernel_sass(cuda_build.library_path(*lib),
                        "overlap_sweep_kernelILb0E")
            for lib in (("overlap_sweep",), ("overlap_sweep_old", old_source))]
    print("old kernel (%s) against the new one, B=%d L=%d, device time per "
          "launch from CUDA-graph replays of 20 launches, in turns: %s; the "
          "ungapped instantiation's SASS: %s"
          % (os.path.basename(old_source), B, L, "; ".join(
              "diff_pct %s: %s" % (pct, ", ".join(
                  "%s %.4f ms" % t for t in turns))
              for pct, turns in out.items()),
             "not compared (no cuobjdump)" if None in sass else
             "the same %d instructions in both" % len(sass[0])
             if sass[0] == sass[1] else "differs (%d instructions new, %d "
             "old; the first difference: %s)" % (
                 len(sass[0]), len(sass[1]), next(
                     ("#%d new %r, old %r" % (k, n, o) for k, (n, o) in
                      enumerate(zip(*sass)) if n != o), "in length"))),
          flush=True)
    return out


def phase_kernel(old=None):
    """The three kernels against their plain versions, timed, each beside
    its bound and its launch floor; `old` ({kernel: source}) adds earlier
    versions, checked and timed against the current ones in turns."""
    old = old or {}
    rng = np.random.default_rng(42)
    worst = 0
    rows = 0
    accepted = {}
    timing = {}
    bounds = {}
    side_stream_launches = 0
    for name, rows_np in (("bench", _bench_rows(rng)),
                          ("adversarial", _adversarial_rows(rng))):
        tensors = tuple(torch.from_numpy(x).cuda() for x in rows_np)
        wants = {}
        for setting in OVERLAP_SETTINGS:
            pct = setting[2]
            got = overlap_cuda.sweep_select(*tensors, *setting)
            torch.cuda.synchronize()
            want = wants[setting] = sweep_select_plain(*tensors, *setting)
            worst = max(worst, _same_as_plain(
                got, want, "%s at %s" % (name, setting)))
            rows += B
            accepted[pct] = accepted.get(pct, 0) + int(got[0].sum())
            if name == "bench" and setting in TIMED_SETTINGS:
                bounds[pct] = kernel_bound(rows_np, want, setting)
                timing[pct] = {
                    "ms": _graph_ms(lambda: overlap_cuda.sweep_select(
                        *tensors, *setting)),
                    "call_ms": _median_ms(lambda: overlap_cuda.sweep_select(
                        *tensors, *setting)),
                    "plain_ms": _median_ms(lambda: sweep_select_plain(
                        *tensors, *setting))}
        if name == "bench" and "overlap_sweep" in old:
            compare_with_old_kernel(old["overlap_sweep"], tensors, wants)
        if name == "bench":
            # as the batch loop launches it: from a worker thread, on a
            # side stream
            torch.cuda.synchronize()
            for setting in TIMED_SETTINGS:
                counted = kernel_launches.snapshot()
                got = _on_worker_stream(
                    lambda: overlap_cuda.sweep_select(*tensors, *setting))
                check(kernel_launches.since(counted)["overlap_sweep"] == 1,
                      "a launch from a worker thread was not counted once")
                worst = max(worst, _same_as_plain(
                    got, wants[setting], "%s at %s from a worker thread on "
                    "a side stream" % (name, setting)))
                rows += B
                side_stream_launches += 1
    check(all(accepted[pct] > 0 for _, _, pct in OVERLAP_SETTINGS),
          "a setting accepted no row: %s" % accepted)
    check(side_stream_launches == len(TIMED_SETTINGS),
          "the kernel was not launched from a worker thread on a side stream")
    warps = overlap_cuda.rows_per_block(L)
    overlap_floor = floor_ms(-(-B // warps), 1, 32 * warps, 1,
                             warps * 2 * overlap_cuda.padded_row_bytes(L))
    for t in timing.values():
        t["floor_ms"] = overlap_floor
    edge = []
    for rows_n, width in EDGE_SHAPES:
        tensors = tuple(torch.from_numpy(x).cuda() for x in
                        _adversarial_rows(rng, B=rows_n, L=width))
        for setting in OVERLAP_SETTINGS:
            got = overlap_cuda.sweep_select(*tensors, *setting)
            torch.cuda.synchronize()
            worst = max(worst, _same_as_plain(
                got, sweep_select_plain(*tensors, *setting),
                "adversarial B=%d L=%d at %s" % (rows_n, width, setting)))
        rows += rows_n * len(OVERLAP_SETTINGS)
        edge.append("B=%d L=%d" % (rows_n, width))
    print("phase kernel: overlap_sweep == plain on %d rows (accepted by "
          "diff_pct: %s; also at %s; the bench rows also in %d launches from a "
          "worker thread on a side stream), max abs err %d; B=%d L=%d: %s"
          % (rows, accepted, ", ".join(edge), side_stream_launches, worst, B,
             L, "; ".join(
              "diff_pct %s kernel %.4f ms of device time per launch (CUDA-"
              "graph replays of 20 launches, median of 15; launch floor "
              "%.4f ms), %.4f ms for one "
              "call between two events, plain %.4f ms (median of 25); needs "
              "%d byte compares (%d at whole overlaps) and %d bytes, so "
              "bound %.5f ms by %s (bytes %.5f ms at %.2f TB/s, operations "
              "%.5f ms at %.1f T byte compares/s), kernel at %.1f%% of it"
              % (pct, t["ms"], t["floor_ms"], t["call_ms"], t["plain_ms"],
                 bounds[pct]["compares_needed"],
                 bounds[pct]["compares_at_whole_overlaps"],
                 bounds[pct]["bytes"], bounds[pct]["bound_ms"],
                 bounds[pct]["bound_by"], bounds[pct]["bytes_ms"],
                 PEAK_BYTES_PER_S / 1e12, bounds[pct]["operations_ms"],
                 PEAK_BYTE_COMPARES_PER_S / 1e12,
                 100.0 * bounds[pct]["bound_ms"] / t["ms"])
              for pct, t in timing.items())), flush=True)
    return worst, timing, bounds, {
        "overlap_gap_sweep": kernel_gap(rng, overlap_floor,
                                        old.get("overlap_sweep")),
        "stat_batch": kernel_stats(rng, old.get("stat_batch")),
        "trim_by_sequence": kernel_adapter(rng, old.get("adapter_match"))}


def _bench_reads(rng):
    """The main path's reads at B x L: tools/make_synth.py's pairs (the
    bench corpus's generator), R1 and R2 with their qualities, 151 bases
    padded to L, a fifth of them trimmed shorter, zero past each length.
    Returns [(bases, quals, lengths)] for R1 and R2, as numpy arrays."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import make_synth
    from types import SimpleNamespace
    args = SimpleNamespace(short_insert_rate=0.25, qual_bins="nova4",
                           n_rate=0.002, polyg_rate=0.08, dup_rate=0.05)
    r1, r2, q1, q2 = make_synth._gen_chunk(rng, B, 151, args)
    out = []
    for r, q in ((r1, q1), (r2, q2)):
        bases = np.zeros((B, L), np.uint8)
        quals = np.zeros((B, L), np.uint8)
        bases[:, :151], quals[:, :151] = r, q
        lens = np.where(rng.random(B) < 0.2, rng.integers(0, 152, B),
                        151).astype(np.int32)
        past = np.arange(L)[None, :] >= lens[:, None]
        bases[past] = 0
        quals[past] = 0
        out.append((bases, quals, lens))
    return out


def _max_abs_err(got, want, what):
    """Largest absolute difference over outputs of equal keys, dtypes and
    shapes (dicts or tuples of tensors); fails unless it is 0."""
    items = (got.items() if isinstance(got, dict)
             else enumerate(got))
    worst = 0
    for key, g in items:
        w = want[key]
        check(g.shape == w.shape and g.dtype == w.dtype,
              "kernel %s/%s: %s %s, plain %s %s"
              % (what, key, g.dtype, tuple(g.shape), w.dtype, tuple(w.shape)))
        err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max()) \
            if g.numel() else 0
        worst = max(worst, err)
        check(err == 0, "kernel %s/%s differs from plain (max abs err %d)"
              % (what, key, err))
    if isinstance(got, dict):
        check(set(got) == set(want), "kernel %s: keys %s against %s"
              % (what, sorted(got), sorted(want)))
    return worst


def stat_bound(args, want):
    """The least time the card could take for stat_batch on these inputs:
    the larger of its bytes (bases, quals, int32 lengths, the include mask,
    the int64 outputs) over the memory rate and the integer operations the
    included bases and counted 5-mers need over the integer rate."""
    bases, quals, lengths, include = args
    Bn, Ln = bases.shape
    nbytes = 2 * Bn * Ln + 5 * Bn + 8 * stats_cuda.out_size(Ln)
    in_read = int(want["cycle_total_base"].sum())
    kmers = int(want["kmer"].sum())
    ops = STAT_OPS_PER_BASE * in_read + STAT_OPS_PER_KMER * kmers
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_INT32_OPS_PER_S * 1e3
    return {"bytes": nbytes, "bases_counted": in_read, "kmers_counted": kmers,
            "operations": ops, "bytes_ms": bytes_ms, "operations_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _time_three(kernel, plain):
    """Device ms a launch from CUDA-graph replays, one call between two
    events, and the plain chain captured as a graph the same way (what the
    parent's step spent on this work) and eager."""
    return {"ms": _graph_ms(kernel), "call_ms": _median_ms(kernel),
            "plain_ms": _graph_ms(plain, launches=5),
            "plain_eager_ms": _median_ms(plain, runs=10)}


def _old_stat_call(fn, args):
    """Commit 1877111's stat_batch as its wrapper launched it: the zeroed output (a
    node of its own), then the kernel at that wrapper's geometry (about 264
    blocks of chunks of rows).  Returns (call, output buffer)."""
    bases, quals, lengths, include = stats_cuda.kernel_inputs(*args)
    Bn, Ln = bases.shape
    tiles = max(1, -(-Ln // 32))
    chunks = max(1, min(-(-Bn // 8), 264 // tiles))
    rows = min(-(-Bn // chunks), 1023 * 8)
    chunks = -(-Bn // rows)
    out = torch.zeros(stats_cuda.out_size(Ln), dtype=torch.int64,
                      device=bases.device)

    def call():
        out.zero_()
        err = fn(bases.data_ptr(), quals.data_ptr(), lengths.data_ptr(),
                 include.data_ptr(), Bn, Ln, rows, chunks, out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        check(err == 0, "old stat_batch launch failed: CUDA error %d" % err)
    return call, out


def compare_stat_with_old(old_source, timed):
    """Commit 1877111's csrc/stat_batch.cu (built in phase build) held to the plain
    version and timed against the current kernel in turns, old, new, new,
    old, on each of `timed` ({what: args})."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = cuda_build.load("stat_batch_old", old_source).stat_batch
    fn.argtypes, fn.restype = [p] * 4 + [i] * 4 + [p, p], ctypes.c_int
    out = {}
    for what, args in timed.items():
        call, buf = _old_stat_call(fn, args)
        call()
        torch.cuda.synchronize()
        _max_abs_err(stats_cuda.split_output(buf, args[0].shape[1]),
                     stat_batch_plain(*args), "stat_batch old build " + what)
        out[what] = _in_turns({
            "old": call, "new": lambda: stats_cuda.stat_batch_cuda(*args)})
    print("old stat_batch (%s) against the new one, device time per launch "
          "from CUDA-graph replays of 20 launches, in turns: %s"
          % (os.path.relpath(old_source, ROOT), "; ".join(
              "%s: %s" % (what, _turns_text(t)) for what, t in out.items())),
          flush=True)
    return out


def kernel_stats(rng, old_source=None):
    """csrc/stat_batch.cu against stat_batch_plain on the card, bit-equal:
    the bench reads of both mates, then stat_rows at (B, L) and at
    STAT_SHAPES, each with its include mask and with none; B = 0 launches
    nothing.  Times the kernel at the main path's shape beside its launch
    floor; with `old_source` (commit 1877111's
    source) also that build, at L and at 2 L (the merged reads' width)."""
    cases, worst = [], 0
    bench = _bench_reads(rng)
    for mate, (bases, quals, lens) in enumerate(bench):
        include = rng.random(B) < 0.9
        cases.append(("bench R%d" % (mate + 1), (bases, quals, lens, include)))
    for rows_n, width in ((B, L),) + STAT_SHAPES:
        b, q, ln, inc = stat_rows(rng, rows_n, width)
        cases.append(("adversarial B=%d L=%d" % (rows_n, width),
                      (b, q, ln, inc)))
        cases.append(("adversarial B=%d L=%d, include all false"
                      % (rows_n, width), (b, q, ln, np.zeros_like(inc))))
    # the two mates side by side: the merged reads' width, 2 L
    wide = (np.hstack([bench[0][0], bench[1][0]]),
            np.hstack([bench[0][1], bench[1][1]]),
            (L + bench[1][2]).astype(np.int32), cases[0][1][3])
    cases.append(("bench R1 + R2 at L=%d" % (2 * L), wide))
    counted = kernel_launches.snapshot()
    timing = bound = old = None
    for what, arrays in cases:
        args = tuple(torch.from_numpy(x).cuda() for x in arrays)
        got = stats_cuda.stat_batch_cuda(*args)
        torch.cuda.synchronize()
        want = stat_batch_plain(*args)
        worst = max(worst, _max_abs_err(got, want, "stat_batch " + what))
        if timing is None:
            bound = stat_bound(args, want)
            timing = _time_three(lambda: stats_cuda.stat_batch_cuda(*args),
                                 lambda: stat_batch_plain(*args))
            tiles, chunks, _ = stats_cuda.geometry(B, L)
            timing["floor_ms"] = floor_ms(tiles, chunks, stats_cuda.THREADS,
                                          stats_cuda.CLUSTER)
            timed = {"B=%d L=%d" % (B, L): args}
            counted = kernel_launches.snapshot()
        if what.startswith("bench R1 + R2") and old_source:
            timed["B=%d L=%d" % (B, 2 * L)] = args
    if old_source:
        before = kernel_launches.snapshot()
        old = compare_stat_with_old(old_source, timed)
        counted = {k: v + kernel_launches.since(before)[k]
                   for k, v in counted.items()}
    check(kernel_launches.since(counted)["stat_batch"] == len(cases) - 1,
          "stat_batch launches: %s for %d calls"
          % (kernel_launches.since(counted), len(cases) - 1))
    empty = torch.zeros((0, L), dtype=torch.uint8, device="cuda")
    counted = kernel_launches.snapshot()
    got = stats_cuda.stat_batch_cuda(empty, empty, torch.zeros(
        0, dtype=torch.int32, device="cuda"), torch.zeros(
        0, dtype=torch.bool, device="cuda"))
    check(kernel_launches.since(counted)["stat_batch"] == 0
          and all(int(v.abs().sum()) == 0 for v in got.values()),
          "stat_batch at B = 0 launched or returned non-zero sums")
    print("phase kernel: stat_batch == plain, bit-equal on every key, %d "
          "cases (%s), max abs err %d; B=0 launches nothing; B=%d L=%d "
          "(bench R1): kernel %.4f ms of device time per launch (CUDA-graph "
          "replays of 20 launches; launch floor %.4f ms), %.4f ms for one "
          "call between two events, plain chain %.4f ms as a graph (%.4f ms "
          "eager); %d bytes, %d bases and %d 5-mers "
          "counted, %d integer operations, so bound %.5f ms by %s (bytes "
          "%.5f ms, operations %.5f ms at %.2f T/s), kernel at %.1f%% of it"
          % (len(cases), ", ".join(w for w, _ in cases), worst, B, L,
             timing["ms"], timing["floor_ms"], timing["call_ms"],
             timing["plain_ms"], timing["plain_eager_ms"],
             bound["bytes"], bound["bases_counted"],
             bound["kmers_counted"], bound["operations"], bound["bound_ms"],
             bound["bound_by"], bound["bytes_ms"], bound["operations_ms"],
             PEAK_INT32_OPS_PER_S / 1e12,
             100.0 * bound["bound_ms"] / timing["ms"]), flush=True)
    return {"max_abs_err": worst, "timing": timing, "bound": bound,
            "cases": len(cases), "old": old}


def adapter_compares(bases, lengths, adapter, match_req):
    """Byte compares trim_by_sequence needs on these reads, reckoned on the
    card: the Hamming walk over the start positions up to the first match
    (all of them for a read without one), each position decided at the
    compare that takes its mismatches past the allowance, or after all of
    them when it matches; then, for a read without a Hamming match, the
    insertion fallback's candidate lengths from the top down to the first
    match, and the deletion fallback's when the insertion gave no valid
    position, cmplen compares each (the count of the shifted mismatches
    that each test starts from).  Returns the count."""
    Bn, Ln = bases.shape
    a = adapter.to(torch.int64)
    alen = a.shape[0]
    if alen < match_req or Bn == 0:
        return 0
    start = -4 if alen >= 16 else -3 if alen >= 12 else -2 if alen >= 8 else 0
    dev = bases.device
    rlen = lengths.to(torch.int64)
    p = torch.arange(start, Ln - match_req, device=dev)
    i = torch.arange(alen, device=dev)
    j = p[:, None] + i[None, :]                           # [P, alen]
    padded = torch.nn.functional.pad(bases.to(torch.int64), (4, alen + 4))
    byte = padded[:, (j + 4).clamp(min=0)]                # [B, P, alen]
    cmplen = torch.minimum(rlen[:, None] - p[None, :],
                           torch.full_like(rlen[:, None], alen))
    valid = (j >= 0)[None] & (i[None, None, :] < cmplen[..., None])
    mm = ((byte != a) & valid).cumsum(-1)
    allowed = torch.div(cmplen, 8, rounding_mode="floor")
    over = mm > allowed[..., None]
    first_over = torch.where(over.any(-1), over.to(torch.int8).argmax(-1),
                             alen)
    lead = (-p).clamp(min=0)[None, :]                     # positions before 0
    decided = torch.where(over.any(-1), first_over + 1 - lead,
                          valid.sum(-1)).clamp(min=0)
    active = p[None, :] < (torch.minimum(rlen, torch.full_like(rlen, Ln))
                           - match_req)[:, None]
    matched = active & ~over.any(-1) & (allowed >= 0)
    first = torch.where(matched.any(1), matched.to(torch.int8).argmax(1),
                        p.shape[0])
    walked = active & (torch.arange(p.shape[0], device=dev)[None, :]
                       <= first[:, None])
    total = int((decided * walked).sum())
    rest = ~matched.any(1)
    # the fallbacks: each candidate length's table, as the plain version
    # makes it, for the reads without a Hamming match
    Wd = alen + 1
    a_b = torch.cat([adapter, adapter.new_zeros(1)]).expand(Bn, Wd)
    b_cut = (bases[:, :Wd] if Ln >= Wd else torch.cat(
        [bases, bases.new_zeros((Bn, Wd - Ln))], 1))
    if alen < 8:
        return total                   # no length has a limit of 0 or more
    lens = torch.arange(8, alen + 1, device=dev)
    for insertion in (True, False):
        top = (torch.minimum(rlen - 1, torch.full_like(rlen, alen)) if insertion
               else torch.minimum(rlen, torch.full_like(rlen, alen - 1)))
        m = torch.stack([
            _match_with_one_insertion_plain(b_cut, a_b, cl, cl // 8 - 1)
            if insertion else
            (_match_with_one_insertion_plain(a_b, b_cut, cl, cl // 8 - 1)
             if cl <= alen - 1 else torch.zeros(Bn, dtype=torch.bool,
                                                device=dev))
            for cl in lens.tolist()], 1)                  # [B, n]
        ok = m & (lens[None, :] <= top[:, None])
        best = torch.where(ok.any(1), (ok * lens[None, :]).amax(1), 7)
        tested = (lens[None, :] <= top[:, None]) & (lens[None, :] >= best[:, None])
        total += int((tested * lens[None, :])[rest].sum())
        pos = torch.where(best == top, 0, rlen - best - (1 if insertion else 0))
        limit = rlen - match_req - (1 if insertion else 0)
        good = ok.any(1) & (pos >= 0) & (pos < limit) & (limit > 0)
        rest = rest & ~good
    return total


def adapter_bound(rows, lens, adapter, match_req, want):
    """The least time the card could take for trim_by_sequence on these
    reads: the larger of its bytes (bases, int32 lengths, the adapter and
    the outputs) over the memory rate and the byte compares it needs
    (adapter_compares) over the integer pipes' byte-compare rate."""
    Bn, Ln = rows.shape
    nbytes = Bn * Ln + 4 * Bn + int(adapter.shape[0]) + 9 * Bn
    compares = adapter_compares(rows, lens, adapter, match_req)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = compares / PEAK_BYTE_COMPARES_PER_S * 1e3
    return {"bytes": nbytes, "compares_needed": compares,
            "found": int(want[1].sum()), "bytes_ms": bytes_ms,
            "operations_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def compare_adapter_with_old(old_source, timed):
    """Commit 1877111's csrc/adapter_match.cu (built in phase build), as its wrapper
    launched it (found and pos zeroed, a node each, then the kernel), held
    to the plain version and timed against the current kernel in turns,
    old, new, new, old, on each of `timed` ({what: (rows, lengths,
    adapter)})."""
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = cuda_build.load("adapter_match_old", old_source).adapter_match
    fn.argtypes, fn.restype = [p] * 3 + [i] * 4 + [p] * 4, ctypes.c_int
    out = {}
    for what, (rows, rl, ad) in timed.items():
        Bn, Ln = rows.shape
        rl32 = rl.to(torch.int32).contiguous()
        outs = (torch.empty(Bn, dtype=torch.int32, device=rows.device),
                torch.zeros(Bn, dtype=torch.bool, device=rows.device),
                torch.zeros(Bn, dtype=torch.int32, device=rows.device))

        def call():
            outs[1].zero_()
            outs[2].zero_()
            err = fn(rows.data_ptr(), rl32.data_ptr(), ad.data_ptr(), Bn, Ln,
                     int(ad.shape[0]), 4, *(o.data_ptr() for o in outs),
                     torch.cuda.current_stream().cuda_stream)
            check(err == 0, "old adapter_match launch failed: CUDA error %d"
                  % err)
        call()
        torch.cuda.synchronize()
        _max_abs_err(outs, trim_by_sequence_plain(rows, rl, ad, 4),
                     "trim_by_sequence old build " + what)
        out[what] = _in_turns({"old": call, "new": lambda: (
            adapter_cuda.trim_by_sequence_cuda(rows, rl, ad, 4))})
    print("old trim_by_sequence (%s) against the new one, device time per "
          "launch from CUDA-graph replays of 20 launches, in turns: %s"
          % (os.path.relpath(old_source, ROOT), "; ".join(
              "%s: %s" % (what, _turns_text(t)) for what, t in out.items())),
          flush=True)
    return out


def kernel_adapter(rng, old_source=None):
    """csrc/adapter_match.cu against trim_by_sequence_plain on the card,
    bit-equal: the bench reads of each mate with its bench adapter, then
    adapter_rows for adapters of ADAPTER_LENGTHS bases at MATCH_REQS and
    ADAPTER_SHAPES, and reads and adapters too long for shared memory (the
    scratch workspace); a short adapter launches nothing.  Times the kernel
    on the bench reads, both adapters, beside its launch floor; with
    `old_source` (commit 1877111's source) also that build, in turns."""
    worst, n_cases = 0, 0
    timing, bounds, timed = {}, {}, {}
    counted = kernel_launches.snapshot()
    for mate, (bases, _, lens) in enumerate(_bench_reads(rng)):
        rows = torch.from_numpy(bases).cuda()
        rl = torch.from_numpy(lens).cuda()
        ad = torch.frombuffer(bytearray(BENCH_ADAPTERS[mate].encode()),
                              dtype=torch.uint8).cuda()
        got = adapter_cuda.trim_by_sequence_cuda(rows, rl, ad, 4)
        torch.cuda.synchronize()
        want = trim_by_sequence_plain(rows, rl, ad, 4)
        worst = max(worst, _max_abs_err(got, want, "trim_by_sequence bench "
                                        "R%d" % (mate + 1)))
        n_cases += 1
        bounds[mate] = adapter_bound(rows, rl, ad, 4, want)
        before = kernel_launches.snapshot()
        timing[mate] = _time_three(
            lambda: adapter_cuda.trim_by_sequence_cuda(rows, rl, ad, 4),
            lambda: trim_by_sequence_plain(rows, rl, ad, 4))
        g = adapter_cuda.geometry(B, L, int(ad.shape[0]))
        timing[mate]["floor_ms"] = floor_ms(g["blocks"], 1, 32 * g["warps"],
                                            1, g["block_bytes"])
        timed["bench R%d" % (mate + 1)] = (rows, rl, ad)
        counted = {k: v + kernel_launches.since(before)[k]
                   for k, v in counted.items()}
    for alen in ADAPTER_LENGTHS:
        a = (np.frombuffer(BENCH_ADAPTERS[0].encode(), np.uint8)
             if alen == 33 else random_adapter(rng, alen))
        ad = torch.from_numpy(a.copy()).cuda()
        for rows_n, width in ADAPTER_SHAPES:
            bases, lens = adapter_rows(rng, rows_n, width, a)
            rows = torch.from_numpy(bases).cuda()
            rl = torch.from_numpy(lens).cuda()
            for req in MATCH_REQS:
                got = adapter_cuda.trim_by_sequence_cuda(rows, rl, ad, req)
                torch.cuda.synchronize()
                want = trim_by_sequence_plain(rows, rl, ad, req)
                worst = max(worst, _max_abs_err(
                    got, want, "trim_by_sequence alen=%d match_req=%d B=%d "
                    "L=%d" % (alen, req, rows_n, width)))
                n_cases += 1
    # workspaces past shared memory (scratch in device memory): reads of
    # 50,000 bases, an adapter of 2,400
    for rows_n, width, alen in ((40, 50000, 33), (8, 64, 2400)):
        a = random_adapter(rng, alen)
        bases, lens = adapter_rows(rng, rows_n, width, a)
        check(not adapter_cuda.geometry(rows_n, width, alen)["staged"],
              "B=%d L=%d alen=%d fits shared memory" % (rows_n, width, alen))
        rows = torch.from_numpy(bases).cuda()
        rl = torch.from_numpy(lens).cuda()
        ad = torch.from_numpy(a.copy()).cuda()
        got = adapter_cuda.trim_by_sequence_cuda(rows, rl, ad, 4)
        torch.cuda.synchronize()
        worst = max(worst, _max_abs_err(
            got, trim_by_sequence_plain(rows, rl, ad, 4), "trim_by_sequence "
            "alen=%d B=%d L=%d (scratch workspace)" % (alen, rows_n, width)))
        n_cases += 1
    short = sum(1 for alen in ADAPTER_LENGTHS for req in MATCH_REQS
                if alen < req) * len(ADAPTER_SHAPES)
    check(kernel_launches.since(counted)["trim_by_sequence"] == n_cases - short,
          "trim_by_sequence launches: %s for %d calls, %d with an adapter "
          "shorter than match_req" % (kernel_launches.since(counted), n_cases,
                                      short))
    old = None
    if old_source:
        before = kernel_launches.snapshot()
        old = compare_adapter_with_old(old_source, timed)
        counted = {k: v + kernel_launches.since(before)[k]
                   for k, v in counted.items()}
        check(kernel_launches.since(counted)["trim_by_sequence"]
              == n_cases - short, "trim_by_sequence launches after the old "
              "build's timing: %s" % kernel_launches.since(counted))
    ms = {k: float(np.mean([timing[m][k] for m in timing]))
          for k in timing[0]}
    bound_ms = float(np.mean([bounds[m]["bound_ms"] for m in bounds]))
    print("phase kernel: trim_by_sequence == plain, bit-equal, %d cases (the "
          "bench reads of both mates; adapters of %s bases at match_req %s on "
          "B x L %s, rows built to reach the insertion and the deletion "
          "fallback), max abs err %d; B=%d L=%d (bench R1, R2 with their "
          "adapters): kernel %s ms of device time per launch (CUDA-graph "
          "replays of 20 launches; launch floor %s ms), %s ms for one call "
          "between two events, "
          "plain chain %s ms as a graph (%s ms eager); bounds %s"
          % (n_cases, ADAPTER_LENGTHS, MATCH_REQS, ADAPTER_SHAPES, worst, B,
             L, ", ".join("%.4f" % timing[m]["ms"] for m in timing),
             ", ".join("%.4f" % timing[m]["floor_ms"] for m in timing),
             ", ".join("%.4f" % timing[m]["call_ms"] for m in timing),
             ", ".join("%.4f" % timing[m]["plain_ms"] for m in timing),
             ", ".join("%.4f" % timing[m]["plain_eager_ms"] for m in timing),
             json.dumps(bounds)), flush=True)
    return {"max_abs_err": worst, "timing": ms, "per_mate": timing,
            "bounds": bounds, "bound": {
                "bound_ms": bound_ms,
                "bound_by": bounds[0]["bound_by"]}, "cases": n_cases,
            "old": old}


# the gapped kernel's timed row sets: the bench rows, planted one-base
# insertions (gap_rows) and the bench rows with real indels (indel151_rows)
GAP_ROW_SETS = ("bench", "planted", "indel151")


def compare_gap_with_old(old_source, row_sets, setting):
    """An earlier version of csrc/overlap_sweep.cu (the current C interface;
    built in phase build as overlap_sweep_old) against the current one on
    each of GAP_ROW_SETS at `setting`: both C functions, the gapped one and
    the ungapped one, held to their plain versions and timed in turns (old,
    new, new, old).  row_sets: {name: (tensors, ungapped want, gapped
    want)}.  Returns {name: {kernel: [(old or new, ms)]}}; an old source
    without the gapped variant (no overlap_gap_sweep) gives the ungapped
    kernel's alone."""
    gap_params = c_param_count(old_source, "overlap_gap_sweep")
    check(gap_params in (None, c_param_count(os.path.join(
        cuda_build.CSRC, "overlap_sweep.cu"), "overlap_gap_sweep")),
        "--old-kernel %s: its overlap_gap_sweep takes %s parameters"
        % (old_source, gap_params))
    kernels = (("overlap_gap_sweep", True),) if gap_params else ()
    old_lib = cuda_build.load("overlap_sweep_old", old_source)
    warps = overlap_cuda.rows_per_block(L)
    out = {}
    for name, (tensors, want_u, want_g) in row_sets.items():
        out[name] = {}
        for kernel, gap in kernels + (("overlap_sweep", False),):
            want = want_g if gap else want_u
            new_fn = overlap_cuda._kernel(gap)
            old_fn = getattr(old_lib, kernel)
            old_fn.argtypes, old_fn.restype = new_fn.argtypes, new_fn.restype
            calls = {}
            for what, fn in (("old", old_fn), ("new", new_fn)):
                call, outs = _raw_launcher(fn, tensors, setting, warps, gap)
                call()
                torch.cuda.synchronize()
                _max_abs_err(outs, want, "%s build of %s on the %s rows"
                             % (what, kernel, name))
                calls[what] = call
            out[name][kernel] = [(what, _graph_ms(calls[what]))
                                 for what in ("old", "new", "new", "old")]
    print("old overlap kernel (%s) against the new one, both C functions, "
          "B=%d L=%d, %s, device time per launch from CUDA-graph replays of "
          "20 launches, in turns: %s"
          % (os.path.basename(old_source), B, L, setting, "; ".join(
              "%s rows, %s: %s" % (name, kernel, _turns_text(turns))
              for name, kernels in out.items()
              for kernel, turns in kernels.items())), flush=True)
    return out


def kernel_gap(rng, floor, old_source=None):
    """csrc/overlap_sweep.cu's gapped variant (overlap_cuda.gap_sweep_select)
    against gap_sweep_select_plain on the card, bit-equal on all five
    outputs, one launch counted as overlap_gap_sweep a call: the bench rows,
    planted one-base insertions and deletions (gap_rows, forward and
    backward offsets) and the bench rows with real indels (indel151_rows)
    at B x L, adversarial rows at EDGE_SHAPES, each at OVERLAP_SETTINGS;
    the planted rows must give gapped accepts at forward and at backward
    offsets.  Counts, for each case and setting, the rows the ungapped pass
    leaves to the gapped pass and the rows accepted there.  Times it on
    GAP_ROW_SETS at the gap path's setting, each beside its bound, its
    launch floor (`floor`: the overlap kernel's grid, which it shares) and
    the plain version captured as a graph; on the bench rows also the plain
    version eager and what the step ran in its place before the gapped
    kernel (the ungapped kernel, then _gap_pass) as a graph.  With
    `old_source`, an earlier overlap_sweep.cu against the current one on
    GAP_ROW_SETS (compare_gap_with_old)."""
    cases = [("bench", _bench_rows(rng))]
    s1, l1, s2, l2 = gap_rows(int(rng.integers(1 << 30)), B=B, L=L)
    cases.append(("planted", (s1, rc(torch.from_numpy(s2),
                                      torch.from_numpy(l2)).numpy(), l1, l2)))
    cases.append(("indel151", indel151_rows(rng)))
    for rows_n, width in EDGE_SHAPES:
        cases.append(("adversarial B=%d L=%d" % (rows_n, width),
                      _adversarial_rows(rng, B=rows_n, L=width)))
    worst, planted, accepted, sent, timed, olds = 0, {}, {}, {}, {}, {}
    setting0 = OVERLAP_SETTINGS[0]
    for what, rows_np in cases:
        tensors = tuple(torch.from_numpy(x).cuda() for x in rows_np)
        for setting in OVERLAP_SETTINGS:
            before = kernel_launches.snapshot()
            got = overlap_cuda.gap_sweep_select(*tensors, *setting)
            torch.cuda.synchronize()
            n = kernel_launches.since(before)
            check(n["overlap_gap_sweep"] == 1 and n["overlap_sweep"] == 0,
                  "overlap_gap_sweep %s at %s: launches %s" % (what, setting, n))
            want = gap_sweep_select_plain(*tensors, *setting)
            worst = max(worst, _max_abs_err(
                got, want, "overlap_gap_sweep %s at %s" % (what, setting)))
            found, offset, has_gap = got[0], got[1], got[4]
            accepted[what, setting[2]] = int(has_gap.sum())
            sent[what, setting[2]] = int((~found | has_gap).sum())
            if what == "planted":
                planted[setting] = (int((has_gap & (offset > 0)).sum()),
                                    int((has_gap & (offset < 0)).sum()))
            if what in GAP_ROW_SETS and setting == setting0:
                ungapped = sweep_select_plain(*tensors, *setting)
                olds[what] = (tensors, ungapped, want)
                kernel = functools.partial(overlap_cuda.gap_sweep_select,
                                           *tensors, *setting)
                plain = functools.partial(gap_sweep_select_plain, *tensors,
                                          *setting)
                t = timed[what] = {
                    "ms": _graph_ms(kernel), "call_ms": _median_ms(kernel),
                    "floor_ms": floor,
                    "plain_ms": _graph_ms(plain, launches=1, replays=5),
                    "bound": gap_bound(rows_np, ungapped, want, setting),
                    "rows_to_gapped_pass": sent[what, setting[2]],
                    "gapped_accepts": accepted[what, setting[2]]}
                if what == "bench":
                    def parent():
                        return _gap_pass(*tensors, *setting, *(
                            overlap_cuda.sweep_select(*tensors, *setting)))
                    t["plain_eager_ms"] = _median_ms(plain, runs=3)
                    t["parent_chain_ms"] = _graph_ms(parent, launches=1,
                                                     replays=5)
    fwd, bwd = planted[setting0]
    check(fwd > 0 and bwd > 0, "the planted rows gave %d forward and %d "
          "backward gapped accepts" % (fwd, bwd))
    old = compare_gap_with_old(old_source, olds, setting0) if old_source \
        else None
    timing = timed["bench"]
    bound = timing["bound"]

    def bound_text(b, ms):
        return ("%d of %d rows left by the ungapped pass; needs %d byte "
                "compares and %d bytes, so bound %.5f ms by %s (bytes %.5f ms, "
                "operations %.5f ms), kernel at %.1f%% of it"
                % (b["rows_left_by_the_ungapped_pass"], B,
                   b["compares_needed"], b["bytes"], b["bound_ms"],
                   b["bound_by"], b["bytes_ms"], b["operations_ms"],
                   100.0 * b["bound_ms"] / ms))
    print("phase kernel: overlap_gap_sweep == plain, bit-equal on all five "
          "outputs, %d cases x %d settings (%s), max abs err %d; rows left "
          "to the gapped pass by case and diff_pct: %s; gapped accepts: "
          "%s; the planted rows' forward and backward gapped accepts by "
          "setting: %s; B=%d L=%d (bench rows, %s): plain version %.4f ms "
          "eager; the step's chain for it before the gapped kernel (the "
          "ungapped kernel, then _gap_pass) %.4f ms as a graph"
          % (len(cases), len(OVERLAP_SETTINGS), ", ".join(w for w, _ in cases),
             worst, json.dumps({"%s %s" % k: v for k, v in sent.items()}),
             json.dumps({"%s %s" % k: v for k, v in accepted.items()}),
             json.dumps({str(k): v for k, v in planted.items()}), B, L,
             setting0, timing["plain_eager_ms"], timing["parent_chain_ms"]),
          flush=True)
    for what, t in timed.items():
        print("phase kernel: overlap_gap_sweep on the %s rows (B=%d L=%d, %s, "
              "%d rows to the gapped pass, %d gapped accepts): kernel %.4f "
              "ms of device time per launch (CUDA-graph replays of 20 "
              "launches; launch floor %.4f ms), %.4f ms for one call between "
              "two events; plain version %.4f ms as a graph; %s"
              % (what, B, L, setting0, t["rows_to_gapped_pass"],
                 t["gapped_accepts"], t["ms"], t["floor_ms"], t["call_ms"],
                 t["plain_ms"], bound_text(t["bound"], t["ms"])), flush=True)
    return {"max_abs_err": worst, "timing": timing, "bound": bound,
            "cases": len(cases) * len(OVERLAP_SETTINGS), "old": old,
            "planted_gapped_accepts": planted, "row_sets": timed}


def phase_golden(work):
    """All goldens at once: one port process each, started together."""
    procs = {}
    for name, args in GOLDEN_RUNS.items():
        d = os.path.join(work, "golden", name)
        os.makedirs(d)
        log = open(os.path.join(d, "stderr.log"), "w+")
        procs[name] = (d, log, subprocess.Popen(
            port_cmd(*args), cwd=d, env=port_env(), stdout=subprocess.DEVNULL,
            stderr=log, text=True))
    compared = []
    for name, (d, log, proc) in procs.items():
        rc = proc.wait()
        log.seek(0)
        err = log.read()
        log.close()
        os.remove(os.path.join(d, "stderr.log"))
        check(rc == 0, "golden %s failed:\n%s" % (name, err[-3000:]))
        check("running on cuda" in err, "golden %s did not use CUDA" % name)
        files = same_outputs(d, os.path.join(GOLDENS, name), "golden " + name)
        compared.append("%s (%s)" % (name, ", ".join(files)))
    print("phase golden: on the card, byte-equal to tests/golden: %s"
          % "; ".join(compared), flush=True)


def _start_corpus(work, pairs=MAIN_PAIRS):
    """tools/make_synth.py writing the corpus, as a process of its own (one
    core for most of a minute); _finish_corpus waits for it."""
    r1 = os.path.join(work, "R1.fq")
    r2 = os.path.join(work, "R2.fq")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
         "--reads", str(pairs), "--seed", "42", "--out1", r1,
         "--out2", r2], stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    return proc, r1, r2


def _finish_corpus(started):
    proc, r1, r2 = started
    _, err = proc.communicate()
    check(proc.returncode == 0, "tools/make_synth.py failed:\n%s" % err[-3000:])
    return r1, r2


def _make_corpus(work):
    return _finish_corpus(_start_corpus(work))


def _run_in_process(argv, cwd, device="cuda", **env):
    """cli.run on the card (or on the devices `device` names) in this
    process with stderr captured and `env` laid over the environment for
    the run; returns (result, log)."""
    log = io.StringIO()
    old = os.getcwd()
    saved = {k: os.environ.get(k) for k in env}
    captured = len(step_device.graph_log)
    os.chdir(cwd)
    os.environ.update(env)
    try:
        with contextlib.redirect_stderr(log):
            res = cli.run(argv, device=device)
    finally:
        os.chdir(old)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        if len(step_device.graph_log) > captured:
            CAPTURES[os.path.basename(cwd)] = step_device.graph_log[captured:]
    return res, log.getvalue()


# name of a driven run -> its FASTP_TPU_TIMING lines
TIMING_LINES = {}
# directory of a run in this process -> the graphs it captured
# (pipeline/device.py:graph_log's entries: key, seconds, reserved bytes
# added, {kernel: launches per replay}, warm-up seconds)
CAPTURES = {}
TIMING_ON = {"FASTP_TPU_TIMING": "1"}


def _drive(work, name, args, device="cuda", says="running on cuda", **env):
    """One path through cli.run on the card, with the kernel counts set to
    0 just before and read just after.  Returns (result, run directory,
    wall seconds, {kernel: launches})."""
    d = os.path.join(work, name)
    os.makedirs(d)
    kernel_launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, log = _run_in_process(["fastp_tpu_torch", *args], d, device, **env)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel_launches.snapshot()
    check(says in log, "%s run log does not say \"%s\":\n%s"
          % (name, says, log[:400]))
    timing = [ln for ln in log.splitlines() if ln.startswith("TIMING ")]
    if timing:
        TIMING_LINES[name] = timing
    return res, d, wall, launches


def _check_per_batch(what, got, batches, per_batch, shards=1):
    """Each kernel launched exactly per_batch[kernel] times a batch and
    shard in a run."""
    want = {k: v * batches * shards for k, v in per_batch.items()}
    check(got == want, "%s: kernel launches %s for %d batches, want %s"
          % (what, got, batches, want))


def _fmt(launches):
    return ", ".join("%s %d" % kv for kv in launches.items())


def _nonempty_outputs(d, what):
    files = sorted(f for f in os.listdir(d) if f.endswith(".fq"))
    for f in files:
        check(os.path.getsize(os.path.join(d, f)) > 0,
              "%s run wrote empty %s" % (what, f))
    return files


def _reads_after(d):
    with open(os.path.join(d, "fastp.json")) as fh:
        return json.load(fh)["summary"]["after_filtering"]["total_reads"]


def phase_main(work, r1, r2):
    res, d, wall, launches = _drive(
        work, "main", ["-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq",
                       *BENCH_FLAGS], **TIMING_ON)
    batches = res["batches"]
    reads = res["pre1"].reads
    check(reads == MAIN_PAIRS, "main run read %d pairs" % reads)
    check(batches == MAIN_BATCHES, "main run: %d batches" % batches)
    _check_per_batch("main", launches, batches, PER_BATCH["main"])
    _nonempty_outputs(d, "main")
    after = _reads_after(d)
    check(0 < after <= 2 * MAIN_PAIRS, "main run kept %d reads" % after)
    print("phase main: %d pairs (bench flags, --batch_size 8192) in %.3f s "
          "wall = %.0f pairs/s; %d batches, kernel launches %s; "
          "%d reads after filtering"
          % (reads, wall, reads / wall, batches, _fmt(launches), after),
          flush=True)
    return launches, wall


def phase_se(work, r1):
    res, d, wall, launches = _drive(work, "se", ["-i", r1, "-o", "out.fq"],
                                    **TIMING_ON)
    reads = res["pre"].reads
    check(reads == MAIN_PAIRS, "se run read %d reads" % reads)
    check(res["batches"] == MAIN_BATCHES, "se run: %d batches" % res["batches"])
    _check_per_batch("se", launches, res["batches"], PER_BATCH["se"])
    _nonempty_outputs(d, "se")
    after = _reads_after(d)
    check(0 < after <= MAIN_PAIRS, "se run kept %d reads" % after)
    print("phase se: %d single-end reads (cfg1 flags: adapter detection, "
          "quality and length filters) in %.3f s wall = %.0f reads/s; "
          "%d batches, kernel launches %s; %d reads after filtering"
          % (reads, wall, reads / wall, res["batches"], _fmt(launches), after),
          flush=True)
    return launches


def phase_failed(work, r1, r2):
    res, d, wall, launches = _drive(
        work, "failed", ["-i", r1, "-I", r2, "-o", "o1.fq", "-O", "o2.fq",
                         *CFG8_FLAGS], **TIMING_ON)
    batches = res["batches"]
    reads = res["pre1"].reads
    check(reads == MAIN_PAIRS, "failed run read %d pairs" % reads)
    # the overlap kernel twice a batch: the analysis and the
    # --overlapped_out re-analysis
    check(batches == MAIN_BATCHES, "failed run: %d batches" % batches)
    _check_per_batch("failed", launches, batches, PER_BATCH["failed"])
    files = _nonempty_outputs(d, "failed")
    check(files == ["failed.fq", "o1.fq", "o2.fq", "ov.fq", "up1.fq"],
          "failed run wrote %s" % files)
    print("phase failed: %d pairs (cfg8 flags) in %.3f s wall = %.0f pairs/s; "
          "%d batches, kernel launches %s; every stream non-empty: %s"
          % (reads, wall, reads / wall, batches, _fmt(launches),
             ", ".join("%s %d B" % (f, os.path.getsize(os.path.join(d, f)))
                       for f in files)), flush=True)
    return launches


def phase_merge(work, r1, r2):
    res, d, wall, launches = _drive(
        work, "merge", ["-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq",
                        *CFG5_FLAGS], **TIMING_ON)
    batches = res["batches"]
    reads = res["pre1"].reads
    check(reads == MAIN_PAIRS, "merge run read %d pairs" % reads)
    # the overlap kernel twice a batch (the analysis and the merge
    # re-analysis), stat_batch once more for the merged reads
    check(batches == MAIN_BATCHES, "merge run: %d batches" % batches)
    _check_per_batch("merge", launches, batches, PER_BATCH["merge"])
    files = _nonempty_outputs(d, "merge")
    check("merged.fq" in files, "merge run wrote %s" % files)
    with open(os.path.join(d, "fastp.json")) as fh:
        merged = json.load(fh)["merged_and_filtered"]["total_reads"]
    merged_pairs = res["filter"].merged_pairs
    check(0 < merged_pairs <= merged, "merge run merged %d pairs, reported "
          "%d merged-and-filtered reads" % (merged_pairs, merged))
    print("phase merge: %d pairs (cfg5 flags) in %.3f s wall = %.0f pairs/s; "
          "%d batches, kernel launches %s; %d pairs merged, %d reads in "
          "merged_and_filtered; %s"
          % (reads, wall, reads / wall, batches, _fmt(launches),
             merged_pairs, merged,
             ", ".join("%s %d B" % (f, os.path.getsize(os.path.join(d, f)))
                       for f in files)), flush=True)
    return launches


def _gap_accepts_on_reads(r1, r2):
    """Rows the gapped pass accepts over the corpus, counted apart from the
    timed run: the pairs as read (before the step's trimming), B at a time,
    through overlap_cuda.gap_sweep_select at the gap path's setting; its
    launches are not counted (launches.uncounted)."""
    readers = [open_batch_reader(f) for f in (r1, r2)]
    accepted = torch.zeros((), dtype=torch.int64, device="cuda")
    try:
        with kernel_launches.uncounted():
            while True:
                b1, b2 = (rd.read_batch(B, L) for rd in readers)
                if b1 is None:
                    break
                s1, l1, s2, l2 = (torch.from_numpy(np.ascontiguousarray(x)).cuda()
                                  for x in (b1.bases[:b1.n], b1.lengths[:b1.n],
                                            b2.bases[:b2.n], b2.lengths[:b2.n]))
                accepted += overlap_cuda.gap_sweep_select(
                    s1, rc(s2, l2), l1, l2, *OVERLAP_SETTINGS[0])[4].sum()
    finally:
        for rd in readers:
            rd.close()
    return int(accepted)


def phase_gap(work, r1, r2):
    """The 1M-pair corpus with --allow_gap_overlap_trimming: the overlap
    kernel's gapped variant once a batch in place of the ungapped kernel;
    then, untimed, the rows the gapped pass accepts on the corpus's pairs
    (_gap_accepts_on_reads)."""
    res, d, wall, launches = _drive(
        work, "gap", ["-i", r1, "-I", r2, "-o", "out1.fq", "-O",
                      "out2.fq", *GAP_FLAGS], **TIMING_ON)
    batches = res["batches"]
    reads = res["pre1"].reads
    check(reads == MAIN_PAIRS, "gap run read %d pairs" % reads)
    check(batches == MAIN_BATCHES, "gap run: %d batches" % batches)
    _check_per_batch("gap", launches, batches, PER_BATCH["gap"])
    _nonempty_outputs(d, "gap")
    after = _reads_after(d)
    check(0 < after <= 2 * MAIN_PAIRS, "gap run kept %d reads" % after)
    accepted = _gap_accepts_on_reads(r1, r2)
    print("phase gap: %d pairs (%s, --batch_size 8192) in %.3f s wall = %.0f "
          "pairs/s; %d batches, kernel launches %s; %d reads after "
          "filtering; apart from the run, %d of the corpus's pairs as read "
          "accepted by the gapped pass (tools/make_synth.py plants "
          "substitutions, not insertions)"
          % (reads, " ".join(GAP_FLAGS), wall, reads / wall, batches,
             _fmt(launches), after, accepted), flush=True)
    return launches, wall, accepted


def _interleave(r1, r2, path, pairs):
    """The first `pairs` records of r1 and r2 as one interleaved FASTQ."""
    with open(r1, "rb") as f1, open(r2, "rb") as f2, open(path, "wb") as out:
        for _ in range(pairs):
            out.writelines([f1.readline() for _ in range(4)]
                           + [f2.readline() for _ in range(4)])


def phase_cpu(work, r1, r2):
    """The first CPU_PAIRS of each path on the card, then on the CPU (one
    process each, started together), compared file by file.  The paths
    that write to the standard output run on the card in a subprocess too,
    with the output in a file; the others run in this process, which counts
    their kernel launches and times them (before the CPU runs start, so
    that they do not compete for the host's cores).  Returns {path:
    ({kernel: launches}, card wall seconds)} of the in-process runs."""
    prefix = ["--reads_to_process", str(CPU_PAIRS)]
    fasta = os.path.join(work, "adapters.fa")
    with open(fasta, "w") as fh:
        fh.write(FASTA)
    interleaved = os.path.join(work, "interleaved.fq")
    _interleave(r1, r2, interleaved, CPU_PAIRS)
    pe = ["-i", r1, "-I", r2]
    paths = {
        "main": pe + ["-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS],
        "se": ["-i", r1, "-o", "out.fq"],
        "failed": pe + ["-o", "o1.fq", "-O", "o2.fq", *CFG8_FLAGS],
        "merge": pe + ["-o", "out1.fq", "-O", "out2.fq", *CFG5_FLAGS],
        "gap": pe + ["-o", "out1.fq", "-O", "out2.fq", *GAP_FLAGS],
        "fasta": ["-i", r1, "-o", "out.fq", "--adapter_fasta", fasta],
        "interleaved_stdout": ["-i", interleaved, "--interleaved_in",
                               "--stdout", "--correction", "--cut_right"],
    }
    to_stdout = ("interleaved_stdout",)

    def start(name, cwd, **env):
        out = (open(os.path.join(cwd, "stdout.fq"), "wb") if name in to_stdout
               else subprocess.DEVNULL)
        proc = subprocess.Popen(port_cmd(*paths[name], *prefix), cwd=cwd,
                                env=port_env(**env), stdout=out,
                                stderr=subprocess.PIPE, text=True)
        if name in to_stdout:
            out.close()
        return proc

    def finish(name, proc, where):
        _, err = proc.communicate()
        check(proc.returncode == 0, "%s run %s failed:\n%s"
              % (where, name, err[-3000:]))
        check("running on %s" % where in err,
              "%s run %s did not run there" % (where, name))

    card = {}
    for name in paths:
        gpu_dir = os.path.join(work, "cmp_gpu_" + name)
        os.makedirs(gpu_dir)
        if name in to_stdout:
            finish(name, start(name, gpu_dir), "cuda")
            continue
        kernel_launches.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, log = _run_in_process(["fastp_tpu_torch", *paths[name], *prefix],
                                   gpu_dir)
        torch.cuda.synchronize()
        card[name] = (kernel_launches.snapshot(), time.perf_counter() - t0)
        check("running on cuda" in log, "card run %s did not use CUDA" % name)
        if name in PER_BATCH:
            _check_per_batch("%d pairs, %s" % (CPU_PAIRS, name), card[name][0],
                             res["batches"], PER_BATCH[name])
    procs = {}
    for name in paths:
        cpu_dir = os.path.join(work, "cmp_cpu_" + name)
        os.makedirs(cpu_dir)
        # seven CPU runs at once: one torch thread each, not a pool per
        # process sized to every core
        procs[name] = (cpu_dir, start(name, cpu_dir, OMP_NUM_THREADS="1",
                                      **{DEVICE_ENV: "cpu"}))
    compared = []
    for name, (cpu_dir, proc) in procs.items():
        finish(name, proc, "cpu")
        files = same_outputs(os.path.join(work, "cmp_gpu_" + name), cpu_dir,
                             "card vs cpu, " + name)
        for f in files:
            check(os.path.getsize(os.path.join(cpu_dir, f)) > 0,
                  "card vs cpu, %s: %s is empty" % (name, f))
        compared.append("%s (%s)" % (name, ", ".join(files)))
    refused = _run_without_card(work, paths["main"] + prefix)
    print("phase cpu: the first %d pairs (reads) give identical files on the "
          "card and on the CPU (%s=cpu): %s; card wall and kernel launches: "
          "%s; with the card hidden and no request for the CPU the port exits "
          "%d and writes nothing"
          % (CPU_PAIRS, DEVICE_ENV, "; ".join(compared), "; ".join(
              "%s %.3f s, %s" % (name, wall, _fmt(n))
              for name, (n, wall) in card.items()), refused), flush=True)
    return card


def _run_without_card(work, args):
    """The port with no CUDA device visible and no request for the CPU: it
    must fail at once, naming the variable, and write no output.  Returns
    its exit code."""
    d = os.path.join(work, "no_card")
    os.makedirs(d)
    res = subprocess.run(port_cmd(*args), cwd=d,
                         env=port_env(CUDA_VISIBLE_DEVICES="-1"),
                         stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                         text=True)
    check(res.returncode != 0, "the port ran without a card and without "
          "%s=cpu:\n%s" % (DEVICE_ENV, res.stderr[-2000:]))
    check(DEVICE_ENV in res.stderr, "the port's failure without a card does "
          "not name %s:\n%s" % (DEVICE_ENV, res.stderr[-2000:]))
    check("running on" not in res.stderr and not os.listdir(d),
          "the port started a run without a card: %s" % os.listdir(d))
    return res.returncode


LAUNCH_LOG_ENV = cli.LAUNCH_LOG_ENV
MAIN_BATCHES = -(-MAIN_PAIRS // B)
MID_BATCHES = -(-MID_PAIRS // B)
CPU_BATCHES = -(-CPU_PAIRS // B)


def _one_card(n):
    """The device request that puts n shards of every batch on card 0."""
    return ",".join(["cuda:0"] * n)


def phase_devices(work, r1, r2, main_wall):
    """--devices N with every shard on the one card: equality with the
    unsplit runs, and the launches of a split (one per shard and analysis).
    Returns {name: launches}."""
    pe = ["-i", r1, "-I", r2]
    main = pe + ["-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS]
    res, d, wall, launches = _drive(
        work, "devices2", main + ["--devices", "2"], device=_one_card(2),
        says="running on 2 shards of every batch: cuda:0")
    check(res["batches"] == MAIN_BATCHES, "--devices 2: %d batches"
          % res["batches"])
    _check_per_batch("--devices 2", launches, res["batches"],
                     PER_BATCH["devices_2"])
    same_outputs(d, os.path.join(work, "main"), "--devices 2 vs phase main")
    out = {"devices_2": launches}
    prefix = ["--reads_to_process", str(CPU_PAIRS)]
    short = {
        # name: (arguments, shards, phase cpu's one-device run on the card,
        # whose launches each shard makes, environment)
        "se": (["-i", r1, "-o", "out.fq"], 2, "se", {}),
        "failed": (pe + ["-o", "o1.fq", "-O", "o2.fq", *CFG8_FLAGS], 2,
                   "failed", {}),
        "merge": (pe + ["-o", "out1.fq", "-O", "out2.fq", *CFG5_FLAGS], 2,
                  "merge", {}),
        "main_3": (main, 3, "main", {}),
        "main_corr_k_1": (main, 2, "main", {"FASTP_TPU_CORR_K": "1"}),
    }
    walls = []
    for name, (args, n, one, env) in short.items():
        sres, sd, swall, n_launch = _drive(
            work, "devices_" + name, args + prefix + ["--devices", str(n)],
            device=_one_card(n),
            says="running on %d shards of every batch" % n, **env)
        _check_per_batch("--devices %d, %s" % (n, name), n_launch,
                         sres["batches"], PER_BATCH[one], shards=n)
        files = same_outputs(sd, os.path.join(work, "cmp_gpu_" + one),
                             "--devices %d, %s, vs one device" % (n, name))
        out["devices_%s_%d_pairs" % (name, CPU_PAIRS)] = n_launch
        walls.append("%s at --devices %d %.3f s, launches %s (%s)"
                     % (name, n, swall, _fmt(n_launch), ", ".join(files)))
    print("phase devices: %d pairs, main path, --devices 2 with the device "
          "request %s (BOTH SHARDS SHARE ONE CARD: equality is shown, speed "
          "is not) in %.3f s wall = %.0f pairs/s, beside phase main's %.3f s "
          "on one device; kernel launches %s (each shard its own); files "
          "and JSON equal to phase main's; %d-pair prefixes equal to the "
          "one-device runs on the card: %s"
          % (MAIN_PAIRS, _one_card(2), wall, MAIN_PAIRS / wall, main_wall,
             _fmt(launches), CPU_PAIRS, "; ".join(walls)), flush=True)
    out["walls"] = {"devices_2": wall, "main": main_wall}
    return out


def phase_accum(work, r1, r2):
    """FASTP_TPU_NO_ACCUM=1 against accumulating runs (the default: every
    other phase on one device accumulates), and what each way moves from the
    card per batch."""
    pe = ["-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq",
          "--reads_to_process", str(CPU_PAIRS)]
    moved = {}
    for name, flags in (("main", BENCH_FLAGS), ("merge", MERGE_DEDUP_FLAGS)):
        for mode, env in (("accum", {}),
                          ("per_batch", {"FASTP_TPU_NO_ACCUM": "1"})):
            before = dict(step_device.fetch_stats)
            res, d, _, _ = _drive(work, "accum_%s_%s" % (name, mode),
                                  pe + list(flags), **env)
            fetches = step_device.fetch_stats["fetches"] - before["fetches"]
            nbytes = step_device.fetch_stats["bytes"] - before["bytes"]
            want = res["batches"] + (1 if mode == "accum" else 0)
            check(fetches == want, "%s, %s: %d transfers from the card for "
                  "%d batches" % (name, mode, fetches, res["batches"]))
            moved[name, mode] = (nbytes, fetches, res["batches"])
        same_outputs(d, os.path.join(work, "accum_%s_accum" % name),
                     "%s: FASTP_TPU_NO_ACCUM=1 vs the accumulating run" % name)
        check(moved[name, "accum"][0] < moved[name, "per_batch"][0],
              "%s: accumulating moved %d bytes, per batch %d"
              % (name, moved[name, "accum"][0], moved[name, "per_batch"][0]))
    same_outputs(os.path.join(work, "accum_main_per_batch"),
                 os.path.join(work, "cmp_gpu_main"),
                 "main, FASTP_TPU_NO_ACCUM=1, vs phase cpu's run on the card")
    print("phase accum: %d pairs, main path and --merge --dedup, with and "
          "without FASTP_TPU_NO_ACCUM=1: the same files and JSON (the main "
          "path's also phase cpu's on the card); device-to-host bytes (one "
          "packed buffer per batch): %s"
          % (CPU_PAIRS, "; ".join(
              "%s %s: %d bytes in %d transfers for %d batches = %.0f bytes "
              "per batch" % (name, mode, nbytes, fetches, batches,
                             nbytes / batches)
              for (name, mode), (nbytes, fetches, batches) in moved.items())),
          flush=True)
    return {"%s_%s" % k: v[0] for k, v in moved.items()}


def _on_worker_stream(fn):
    """fn() on a thread of its own with a side stream current, as the batch
    loop's dispatch worker runs the step; returns fn's result after the
    stream has drained.  An exception of the thread is raised here."""
    box = {}

    def work():
        try:
            side = torch.cuda.Stream()
            with torch.cuda.stream(side):
                box["stream_was_side"] = (
                    torch.cuda.current_stream().cuda_stream == side.cuda_stream
                    != torch.cuda.default_stream().cuda_stream)
                box["res"] = fn()
            side.synchronize()
        except BaseException as exc:   # handed to the caller, which raises
            box["exc"] = exc

    t = threading.Thread(target=work, name="smoke_dispatch")
    t.start()
    t.join()
    if "exc" in box:
        raise box["exc"]
    check(box["stream_was_side"], "the worker thread's stream was not the "
          "side stream")
    return box["res"]


def _settled_threads():
    """threading.active_count() once the short-lived threads that zero a
    finished job's duplicate-filter buffers (duplicate.py: rezero) have
    ended; they belong to no pool and end by themselves."""
    for t in threading.enumerate():
        if "(rezero)" in t.name:
            t.join(timeout=120)
    return threading.active_count()


def _moved(fn):
    """(fn's result, what pipeline/device.py:fetch_stats counted meanwhile)."""
    before = dict(step_device.fetch_stats)
    res = fn()
    return res, {k: v - before[k] for k, v in step_device.fetch_stats.items()}


INT64_FETCH_BYTES = 1131504   # main path per batch before the packed fetch


def phase_pipeline(work, r1, r2):
    """The pipelined batch loop and the packed transfers at full size.
    Returns ({name: launches}, {name: wall seconds or bytes})."""
    pe = ["-i", r1, "-I", r2]
    main = pe + ["-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS]
    launches, numbers = {}, {}
    # 1. the main path at prefetch 1 and 3 and with plain inputs, in turns
    turns = (("prefetch1", {"FASTP_TPU_PREFETCH": "1"}),
             ("prefetch3", {"FASTP_TPU_PREFETCH": "3"}),
             ("plain_inputs", {"FASTP_TPU_NO_INPUT_PACK": "1"}),
             ("plain_inputs", {"FASTP_TPU_NO_INPUT_PACK": "1"}),
             ("prefetch3", {"FASTP_TPU_PREFETCH": "3"}),
             ("prefetch1", {"FASTP_TPU_PREFETCH": "1"}))
    walls, kinds, per_batch = [], {}, {}
    for k, (mode, env) in enumerate(turns):
        name = "pipe_main_%d_%s" % (k, mode)
        (res, d, wall, n), moved = _moved(lambda: _drive(
            work, name, main, **env, **TIMING_ON))
        check(res["batches"] == MAIN_BATCHES, "%s: %d batches"
              % (name, res["batches"]))
        _check_per_batch(name, n, res["batches"], PER_BATCH["main"])
        same_outputs(d, os.path.join(work, "main"), name + " vs phase main")
        shutil.rmtree(d)
        walls.append((mode, wall))
        kinds[mode] = res["input_kinds"]
        per_batch[mode] = (moved["upload_bytes"] / MAIN_BATCHES,
                           moved["bytes"] / MAIN_BATCHES)
        launches[name] = n
    check(set(kinds["plain_inputs"]) == {"plain"}
          and "plain" not in kinds["prefetch3"],
          "input schemes per batch: %s" % kinds)
    medians = {mode: float(np.median([w for m, w in walls if m == mode]))
               for mode in ("prefetch1", "prefetch3", "plain_inputs")}
    spread = {mode: max(w for m, w in walls if m == mode)
              - min(w for m, w in walls if m == mode) for mode in medians}
    numbers["main_walls_in_turns"] = walls
    numbers["main_medians"] = medians
    numbers["main_spreads"] = spread
    numbers["main_input_kinds"] = kinds
    # 2. se, failed, merge at prefetch 1 against their phases (prefetch 3)
    others = {"se": ["-i", r1, "-o", "out.fq"],
              "failed": pe + ["-o", "o1.fq", "-O", "o2.fq", *CFG8_FLAGS],
              "merge": pe + ["-o", "out1.fq", "-O", "out2.fq", *CFG5_FLAGS]}
    other_walls = {}
    for path, args in others.items():
        name = "pipe_%s_prefetch1" % path
        res, d, wall, n = _drive(work, name, args, FASTP_TPU_PREFETCH="1",
                                 **TIMING_ON)
        check(res["batches"] == MAIN_BATCHES, "%s: %d batches"
              % (name, res["batches"]))
        _check_per_batch(name, n, res["batches"], PER_BATCH[path])
        same_outputs(d, os.path.join(work, path),
                     "%s at prefetch 1 vs phase %s" % (path, path))
        shutil.rmtree(d)
        other_walls[path] = wall
        launches[name] = n
    numbers["prefetch1_walls"] = other_walls
    # 3. bytes each way per batch, by input scheme and by fetch packing, on
    #    20,000 pairs, each equal to phase cpu's run on the card
    short = main + ["--reads_to_process", str(CPU_PAIRS)]
    schemes = {}
    for label, env in (("default", {}),
                       ("no_p3", {"FASTP_TPU_NO_P3": "1"}),
                       ("no_nib", {"FASTP_TPU_NO_NIB": "1"}),
                       ("no_input_pack", {"FASTP_TPU_NO_INPUT_PACK": "1"}),
                       ("no_slim", {"FASTP_TPU_NO_SLIM": "1"}),
                       ("no_pack", {"FASTP_TPU_NO_PACK": "1"})):
        name = "pipe_bytes_" + label
        (res, d, _, n), moved = _moved(lambda: _drive(work, name, short,
                                                      **env))
        _check_per_batch(name, n, CPU_BATCHES, PER_BATCH["main"])
        same_outputs(d, os.path.join(work, "cmp_gpu_main"),
                     name + " vs phase cpu's run on the card")
        # the last transfer of an accumulating run is the run's sums
        schemes[label] = {
            "inputs": res["input_kinds"],
            "h2d_bytes_per_batch": moved["upload_bytes"] / CPU_BATCHES,
            "d2h_bytes_per_batch": moved["bytes"] / CPU_BATCHES,
            "d2h_transfers": moved["fetches"]}
        launches[name] = n
    want_kind = {"no_p3": "nib", "no_nib": "bq", "no_input_pack": "plain"}
    for label, kind in want_kind.items():
        check(set(schemes[label]["inputs"]) == {kind},
              "%s packed its inputs as %s" % (label, schemes[label]["inputs"]))
    check(schemes["default"]["d2h_transfers"] == CPU_BATCHES + 1
          and schemes["no_pack"]["d2h_transfers"] > 10 * CPU_BATCHES,
          "transfers: %s" % schemes)
    check(schemes["default"]["d2h_bytes_per_batch"]
          < schemes["no_slim"]["d2h_bytes_per_batch"] < INT64_FETCH_BYTES,
          "fetched bytes per batch: %s" % schemes)
    check(schemes["no_nib"]["h2d_bytes_per_batch"]
          < 0.6 * schemes["no_input_pack"]["h2d_bytes_per_batch"]
          and schemes["no_p3"]["h2d_bytes_per_batch"]
          < 0.6 * schemes["no_nib"]["h2d_bytes_per_batch"],
          "uploaded bytes per batch: %s" % schemes)
    numbers["bytes_per_batch_%d_pairs" % CPU_PAIRS] = schemes
    # 4. a job run as the resident server runs it: no thread is left
    from fastp_tpu_torch import server
    served = os.path.join(work, "pipe_served")
    os.makedirs(served)
    before = _settled_threads()
    kernel_launches.reset()
    rc = server._run_job(["fastp_tpu_torch", *short], served, None)
    launches["pipe_served_job"] = kernel_launches.snapshot()
    after = _settled_threads()
    check(rc == 0, "the served job gave %d" % rc)
    _check_per_batch("the served job", launches["pipe_served_job"],
                     CPU_BATCHES, PER_BATCH["main"])
    check(after == before, "a served job left threads: %d before, %d after: %s"
          % (before, after, [t.name for t in threading.enumerate()]))
    same_outputs(served, os.path.join(work, "cmp_gpu_main"),
                 "the served job vs phase cpu's run on the card")
    # 5. FASTP_TPU_PROFILE leaves a trace of a window of batches
    trace_dir = os.path.join(work, "pipe_trace")
    res, d, _, n = _drive(work, "pipe_profile", short,
                          FASTP_TPU_PROFILE=trace_dir)
    launches["pipe_profile"] = n
    same_outputs(d, os.path.join(work, "cmp_gpu_main"),
                 "the traced run vs phase cpu's run on the card")
    traces = os.listdir(trace_dir)
    check(len(traces) == 1, "FASTP_TPU_PROFILE wrote %s" % traces)
    with open(os.path.join(trace_dir, traces[0])) as fh:
        text = fh.read()
    check(len(text) > 10000 and '"traceEvents"' in text,
          "the trace holds %d bytes" % len(text))
    numbers["trace"] = {"bytes": len(text),
                        "kernel_events": text.count('"cat": "kernel"'),
                        "overlap_sweep_events": text.count("overlap_sweep"),
                        "stat_batch_events": text.count("stat_batch_kernel"),
                        "adapter_match_events": text.count(
                            "adapter_match_kernel")}
    print("phase pipeline: %d pairs, main path, wall seconds in turns: %s; "
          "medians %s, spreads %s; every run %d launches, files and JSON "
          "equal to phase main's; input schemes (batches): %s; bytes per "
          "batch up / down at 1M pairs: %s (the fetch was %d as int64); "
          "se, failed, merge at FASTP_TPU_PREFETCH=1 equal to their phases, "
          "walls %s; %d-pair runs equal to phase cpu's on the card: %s; a "
          "served job (server._run_job in this process): %d threads before, "
          "%d after; FASTP_TPU_PROFILE trace: %s"
          % (MAIN_PAIRS, ", ".join("%s %.3f" % w for w in walls),
             json.dumps(medians), json.dumps(spread), MAIN_BATCHES,
             json.dumps(kinds), json.dumps(per_batch), INT64_FETCH_BYTES,
             json.dumps(other_walls), CPU_PAIRS, json.dumps(schemes), before,
             after, json.dumps(numbers["trace"])), flush=True)
    for name, lines in TIMING_LINES.items():
        for line in lines:
            print("timing %s: %s" % (name, line), flush=True)
    return launches, numbers


@contextlib.contextmanager
def _recorded_batches():
    """Every batch the runs inside queue (BaseProcessor._call_step), as
    (step, arguments, whether the run accumulates, cfg, devices): what phase
    graph runs again through the eager step."""
    from fastp_tpu_torch.pipeline import runner
    real = runner.BaseProcessor._call_step
    calls = []

    def recording(proc, step, args):
        calls.append((step, args, proc._accum, proc.cfg, proc.devices))
        return real(proc, step, args)

    runner.BaseProcessor._call_step = recording
    try:
        yield calls
    finally:
        runner.BaseProcessor._call_step = real


def _eager_twin(step, cfg, devices):
    """The eager step of the same configuration on the same devices
    (graph=False), for the step a run took from the memo."""
    from fastp_tpu_torch.parallel import mesh
    build = step_device.build_pe_step if cfg.paired else step_device.build_se_step
    if isinstance(step, mesh.ShardedStep):
        return mesh.build_sharded_step(functools.partial(build, graph=False),
                                       cfg, devices)
    packed = next(k for k, v in step.entry.steps.items() if v is step)
    kw = {"rowwise": True} if step.entry.rowwise else {}
    return build(cfg, step.io.device, packed=packed, graph=False, **kw)


def _batch_outputs(step, args, accum):
    """One batch through `step` (run, fetch); returns the numpy dict with
    the batch's sums put back in."""
    from fastp_tpu_torch.parallel import mesh
    if isinstance(step, mesh.ShardedStep):
        return step(*args)
    with step.on_stream():
        out = step.run(*args, accum=accum)
        if accum:
            sums = step_device.unpack_acc(step.fetch_vector(out.delta),
                                          out.acc_meta)
        got = step.start_fetch(out).wait()
    if accum:
        got.update(sums)
    return got


def _as_the_loop_queues(step, calls):
    """The batches of `calls` as the batch loop queues them
    (runner.py:_call_step): the run, the accumulator's addition, the fetch;
    the run's sums are not fetched."""
    chain = None
    for _, args, accum, _, _ in calls:
        with step.on_stream():
            out = step.run(*args, accum=accum)
            if accum:
                if chain is None:
                    chain = out.delta.clone()
                else:
                    chain += out.delta
            step.start_fetch(out).wait()


def _bit_equal(got, want, what):
    """Every key, dtype, shape and value the same; returns the keys."""
    check(set(got) == set(want), "%s: keys %s against %s"
          % (what, sorted(set(got) ^ set(want)), sorted(want)))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            _bit_equal(g, w, "%s/%s" % (what, k))
            continue
        g, w = np.asarray(g), np.asarray(w)
        check(g.dtype == w.dtype and g.shape == w.shape
              and np.array_equal(g, w), "%s: %s differs (%s %s against %s %s)"
              % (what, k, g.dtype, g.shape, w.dtype, w.shape))
    return sorted(want)


def _launches_per_batch(fn, batches):
    """Host calls that put work on the card, from torch.profiler's trace of
    fn(): kernel launches, graph launches and copies, per batch."""
    from torch import profiler
    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU,
                                      profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = {"cudaLaunchKernel": 0, "cudaGraphLaunch": 0,
             "cudaMemcpyAsync": 0}
    for ev in prof.events():
        for name in names:
            if ev.name.startswith(name):
                names[name] += 1
    return {k: v / batches for k, v in names.items()}


def phase_graph(work, r1, r2, pipe_numbers=None):
    """The step as a CUDA graph against the eager step on the card, on the
    corpus's first CPU_PAIRS pairs (three batches, the last partial), and
    what the graphs cost.  Returns {name: launches}."""
    pe = ["-i", r1, "-I", r2]
    main = pe + ["-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS]
    prefix = ["--reads_to_process", str(CPU_PAIRS)]
    runs = {
        # name: (arguments, environment, device request, input scheme)
        "main_p3": (main, {}, "cuda", "p3"),
        "main_nib": (main, {"FASTP_TPU_NO_P3": "1"}, "cuda", "nib"),
        "main_bq": (main, {"FASTP_TPU_NO_NIB": "1"}, "cuda", "bq"),
        "main_plain": (main, {"FASTP_TPU_NO_INPUT_PACK": "1"}, "cuda",
                       "plain"),
        "se": (["-i", r1, "-o", "out.fq"], {}, "cuda", None),
        "failed": (pe + ["-o", "o1.fq", "-O", "o2.fq", *CFG8_FLAGS], {},
                   "cuda", None),
        "merge": (pe + ["-o", "out1.fq", "-O", "out2.fq", *CFG5_FLAGS], {},
                  "cuda", None),
        "gap": (pe + ["-o", "out1.fq", "-O", "out2.fq", *GAP_FLAGS], {},
                "cuda", None),
        "devices_2": (main + ["--devices", "2"], {}, _one_card(2), None),
    }
    recorded, launches, equal = {}, {}, []
    for name, (args, env, request, kind) in runs.items():
        with _recorded_batches() as calls:
            res, _, _, n = _drive(
                work, "graph_" + name, args + prefix, device=request,
                says="running on " + ("2 shards" if "," in request else
                                      "cuda"), **env)
        launches["graph_" + name] = n
        check(len(calls) == res["batches"] == CPU_BATCHES,
              "%s: %d batches queued for %d" % (name, len(calls),
                                                res["batches"]))
        _check_per_batch("graph " + name, n, res["batches"],
                         PER_BATCH[name.split("_")[0] if name.startswith(
                             "main") else name])
        if kind:
            check(set(res["input_kinds"]) == {kind}, "%s went up as %s"
                  % (name, res["input_kinds"]))
        recorded[name] = calls
        twins = {}
        for b, (step, bargs, accum, cfg, devices) in enumerate(calls):
            if id(step) not in twins:
                twins[id(step)] = _eager_twin(step, cfg, devices)
            want = _batch_outputs(twins[id(step)], bargs, accum)
            got = _batch_outputs(step, bargs, accum)
            keys = _bit_equal(got, want, "graph against eager, %s, batch %d"
                              % (name, b + 1))
        nvalid = int(calls[-1][1][-1])
        check(nvalid < B, "%s: the last batch holds %d rows" % (name, nvalid))
        equal.append("%s (%d keys, last batch %d of %d rows)"
                     % (name, len(keys), nvalid, B))
    # a second served job of one configuration: no capture, the same files
    from fastp_tpu_torch import server
    served = []
    for k in range(2):
        d = os.path.join(work, "graph_served%d" % k)
        os.makedirs(d)
        before = len(step_device.graph_log)
        kernel_launches.reset()
        rc = server._run_job(["fastp_tpu_torch", *main, *prefix], d, None)
        check(rc == 0, "served job %d exited %d" % (k, rc))
        served.append((len(step_device.graph_log) - before,
                       kernel_launches.snapshot()))
    check(served[1][0] == 0, "the second served job captured %d graphs"
          % served[1][0])
    _check_per_batch("the second served job", served[1][1], CPU_BATCHES,
                     PER_BATCH["main"])
    same_outputs(os.path.join(work, "graph_served1"),
                 os.path.join(work, "graph_served0"),
                 "the second served job vs the first")
    # what a batch issues from Python: the graph's replay against the eager
    # step, batches 2-3 of each path
    per_batch = {}
    for name in ("main_p3", "se", "failed", "merge"):
        calls = recorded[name][1:]
        step, _, _, cfg, devices = calls[0]
        eager = _eager_twin(step, cfg, devices)
        for label, which in (("graph", step), ("eager", eager)):
            per_batch[name, label] = _launches_per_batch(
                lambda: _as_the_loop_queues(which, calls), len(calls))
        g = per_batch[name, "graph"]
        check(g["cudaGraphLaunch"] == 1 and sum(g.values()) < 50,
              "%s: per batch %s" % (name, g))
    captures = {name: [(str(key[0][0][1]), key[1], key[2], round(sec, 3),
                        round(warm, 3), nbytes, held)
                       for key, sec, nbytes, held, warm in log]
                for name, log in CAPTURES.items()}
    device_ms = {name: _graph_device_time(name, recorded[name])
                 for name in ("main_p3", "se", "failed", "merge", "gap")}
    timing = {}
    for name in ("main", "se", "failed", "merge", "gap"):
        for line in TIMING_LINES.get(name, []):
            for field in ("produce", "dispatch", "fetch_wait", "wall"):
                m = re.search(r"\b%s=([0-9.]+)s" % field, line)
                if m:
                    timing.setdefault(name, {})[field] = float(m.group(1))
    trace = (pipe_numbers or {}).get("trace")
    if trace is not None:
        check(trace["overlap_sweep_events"] >= 1
              and trace["stat_batch_events"] >= 1
              and trace["adapter_match_events"] >= 1,
              "the FASTP_TPU_PROFILE trace misses a kernel: %s" % trace)
    print("phase graph: %d pairs (%d batches, the last partial), graph "
          "against eager on the card, bit-equal on every key of every "
          "batch: %s; a second served job of the main path captured %d "
          "graphs (the first %d) and wrote the same files; host calls per "
          "batch that put work on the card (batches 2-3, torch.profiler): "
          "%s; the captures of each run that made one, in this script's "
          "process (first argument's shape, accum, shard, seconds of the "
          "capture, of the warm-up runs, bytes of reserved memory it added, "
          "kernel launches per replay): %s; %d captures in all; memo "
          "entries %d, reserved %d bytes (one pool per "
          "entry, shared by its graphs); TIMING of the 1M-pair paths: %s; "
          "FASTP_TPU_PROFILE trace: %s"
          % (CPU_PAIRS, CPU_BATCHES, "; ".join(equal), served[1][0],
             served[0][0], json.dumps({"%s %s" % k: v
                                       for k, v in per_batch.items()}),
             json.dumps(captures), len(step_device.graph_log),
             len(step_device._memo), torch.cuda.memory_reserved(),
             json.dumps(timing), json.dumps(trace)), flush=True)
    for name, got in device_ms.items():
        print("graph device time %s: %s" % (name, json.dumps(got)),
              flush=True)
    return launches, device_ms


def _graph_of(step, args, accum, shard=0):
    """The _Graph that a step captured for a batch of these arguments."""
    arrays = [np.ascontiguousarray(a) for a in args]
    key = (tuple((a.dtype.str, a.shape) for a in arrays), accum, shard)
    return step._graphs[key], arrays


def _device_ops(fn, runs):
    """torch.profiler's device events (kernels, copies, sets) of fn(), in
    ms per run by name, largest first, and their sum per run."""
    from torch import profiler
    torch.cuda.synchronize()
    with profiler.profile(activities=[profiler.ProfilerActivity.CPU,
                                      profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            us = ev.time_range.elapsed_us()
            by_name[ev.name] = by_name.get(ev.name, 0.0) + us / 1e3 / runs
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return ops, sum(ms for _, ms in ops)


def _graph_device_time(name, calls, runs=3):
    """A path's captured step on its first (full) batch: device ms of one
    replay between CUDA events on the step's stream (median of 20), and
    the step's largest device ops by name from one torch.profiler window
    over `runs` replays; when CUPTI shows no node of the graph, the eager
    step's ops instead (graph=False), which the result says."""
    step, args, accum, cfg, devices = calls[0]
    g, arrays = _graph_of(step, args, accum)
    with torch.no_grad(), step.on_stream():
        g.load(step.io, arrays)
        replay_ms = _median_ms(g.graph.replay, runs=20)

        def replays():
            for _ in range(runs):
                g.graph.replay()
        ops, busy = _device_ops(replays, runs)
    source = "graph replays"
    if not ops:
        eager = _eager_twin(step, cfg, devices)
        ops, busy = _device_ops(lambda: [_batch_outputs(eager, args, accum)
                                         for _ in range(runs)], runs)
        source = "eager step (CUPTI showed no node of the graph)"
    return {"rows": int(np.asarray(args[-1])), "replay_ms": replay_ms,
            "profiled": source, "device_ms_per_batch": busy,
            "top_ops_ms": [(n[:80], round(ms, 5)) for n, ms in ops[:12]],
            "kernels_ms": {k: round(sum(ms for n, ms in ops if k in n), 5)
                           for k in ("overlap_sweep_kernel<false>",
                                     "overlap_sweep_kernel<true>",
                                     "stat_batch_kernel",
                                     "adapter_match_kernel")}}


def _prefix(src, dst, records, skip=0):
    """Records [skip, skip + records) of a FASTQ file as a file of its own."""
    with open(src, "rb") as fin, open(dst, "wb") as fout:
        for _ in range(4 * skip):
            fin.readline()
        fout.writelines(fin.readline() for _ in range(4 * records))
    return dst


def _port_job(args, cwd, module="fastp_tpu_torch", **env):
    """One `python -m module args` in a new directory `cwd`, on the card
    unless env says otherwise.  Returns (stdout, stderr, wall seconds);
    fails on a non-zero exit."""
    os.makedirs(cwd, exist_ok=True)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                         env=port_env(**env), capture_output=True, text=True)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, "%s %s exited %d:\n%s"
          % (module, " ".join(args), res.returncode, res.stderr[-3000:]))
    return res.stdout, res.stderr, wall


class LaunchLog:
    """The file FASTP_TPU_TORCH_LAUNCH_LOG names for the jobs of one phase:
    emptied by reset(), read by jobs()."""

    def __init__(self, work, name):
        self.path = os.path.join(work, "launches_%s.jsonl" % name)
        self.env = {LAUNCH_LOG_ENV: self.path}
        self.reset()

    def reset(self):
        open(self.path, "w").close()

    def jobs(self):
        with open(self.path) as fh:
            return [json.loads(line) for line in fh if line.strip()]

    def launches(self, kernel="overlap_sweep"):
        return sum(job[kernel] for job in self.jobs())

    def totals(self):
        """{kernel: launches} over the logged jobs."""
        return {k: self.launches(k) for k in kernel_launches.KERNELS}

    def loaded(self):
        """The kernel libraries the logged jobs loaded, each job's list."""
        return [job["loaded"] for job in self.jobs()]


def _same_file(path_a, path_b, what):
    with open(path_a, "rb") as fa, open(path_b, "rb") as fb:
        while True:
            a, b = fa.read(1 << 24), fb.read(1 << 24)
            check(a == b, "%s: %s differs from %s" % (what, path_a, path_b))
            if not a:
                return


ADAPTER_COUNT = re.compile(r'"([A-Za-z]+)":(\d+)')
ADAPTER_KEYS = ("read1_adapter_counts", "read2_adapter_counts")


def _without_adapter_counts(text):
    """A report with the values of read1/read2_adapter_counts taken out
    (the keys stay); returns (text, the sum of the numbers taken out)."""
    lines, taken = [], 0
    for line in normalize_json(text).split("\n"):
        if "_adapter_counts" in line:
            taken += sum(int(m.group(2)) for m in ADAPTER_COUNT.finditer(line))
            line = line.split(":", 1)[0]
        lines.append(line)
    return "\n".join(lines), taken


def _reported_adapters(counts):
    """What a report shows of a map of trimmed adapters: every sequence that
    has at least one percent of the map's total, the rest as "others"."""
    total = sum(counts.values())
    shown = {seq: n for seq, n in counts.items()
             if total and n / total >= 0.01}
    rest = total - sum(shown.values())
    if rest > 0:
        shown["others"] = rest
    return shown


# number of shards -> what _sharded_adapter_counts found for it
_SHARD_ADAPTERS = {}


def _sharded_adapter_counts(work, m1, m2, n):
    """read1/read2_adapter_counts as a report merged from n shards of the
    MID_PAIRS prefix has to show them.  Each shard's records run alone
    through the main path in this process (no launcher, no exchange, no
    merge); the runs' maps of trimmed adapters are added sequence by
    sequence, and the report's one-percent rule is applied to the sums.
    The shards' first records are multihost.shard_ranges' byte offsets,
    counted out in records here.  Returns the two dicts."""
    if n in _SHARD_ADAPTERS:
        return _SHARD_ADAPTERS[n]
    ranges1, _ = multihost.shard_ranges(m1, m2, n)
    with open(m1, "rb") as fh:
        data = fh.read()
    cuts = [data.count(b"\n", 0, start) // 4 for start, _ in ranges1]
    cuts.append(MID_PAIRS)
    del data
    sums = ({}, {})
    for k in range(n):
        d = os.path.join(work, "slice_%d_%d" % (n, k))
        os.makedirs(d)
        records = cuts[k + 1] - cuts[k]
        s1 = _prefix(m1, os.path.join(d, "S1.fq"), records, skip=cuts[k])
        s2 = _prefix(m2, os.path.join(d, "S2.fq"), records, skip=cuts[k])
        res, run, _, _ = _drive(
            d, "run", ["-i", s1, "-I", s2, "-o", "out1.fq", "-O", "out2.fq",
                       *BENCH_FLAGS])
        check(res["pre1"].reads == records, "slice %d of %d read %d pairs, "
              "not %d" % (k, n, res["pre1"].reads, records))
        for total, part in zip(sums, (res["filter"].adapter1,
                                      res["filter"].adapter2)):
            for seq, count in part.items():
                total[seq] = total.get(seq, 0) + count
        shutil.rmtree(d)
    _SHARD_ADAPTERS[n] = tuple(_reported_adapters(total) for total in sums)
    return _SHARD_ADAPTERS[n]


def _same_as_shards(single_dir, shard_dir, n, names, what, adapters=None):
    """Each of `names` in single_dir equals the shards' files 0001.name ..
    000n.name of shard_dir laid end to end; fastp.json after the
    command-line normalisation (the shards merge into one report).

    With `adapters` (what _sharded_adapter_counts returns for n), the
    sharded report's read1/read2_adapter_counts are held to those two dicts
    and not to the single process's, and the sums of the numbers on those
    lines are returned as (single, sharded).  The maps of trimmed adapters
    stop taking new sequences once they hold 20,000, and a pair whose first
    adapter was refused is not recorded for the second either
    (report/filter_model.py, as the reference's threads and fastp_tpu's
    shards), each shard's map for itself.  So on a large input the maps'
    totals depend on how the input was cut, and with them which sequences
    reach the one percent that gets a sequence named.  adapter_trimmed_reads
    and adapter_trimmed_bases are exact."""
    for name in names:
        joined = os.path.join(shard_dir, "joined." + name)
        with open(joined, "wb") as out:
            for k in range(1, n + 1):
                shard = os.path.join(shard_dir, "%04d.%s" % (k, name))
                check(os.path.exists(shard), "%s: no %s" % (what, shard))
                with open(shard, "rb") as fh:
                    shutil.copyfileobj(fh, out, 1 << 24)
        check(os.path.getsize(joined) > 0, "%s: %s is empty" % (what, name))
        _same_file(joined, os.path.join(single_dir, name), what)
        os.remove(joined)
    with open(os.path.join(single_dir, "fastp.json")) as fa, \
            open(os.path.join(shard_dir, "fastp.json")) as fb:
        a, b = fa.read(), fb.read()
    taken = (0, 0)
    if adapters is not None:
        shown = json.loads(b)["adapter_cutting"]
        for key, want in zip(ADAPTER_KEYS, adapters):
            check(shown[key] == want, "%s: %s is %s, the shards' maps added "
                  "up give %s" % (what, key, shown[key], want))
        (a, b), taken = zip(_without_adapter_counts(a),
                            _without_adapter_counts(b))
    check(normalize_json(a) == normalize_json(b),
          "%s: the merged fastp.json differs" % what)
    check(not [f for f in os.listdir(shard_dir) if f.startswith(".fastp_shard")],
          "%s: exchange files or shard logs were left behind" % what)
    return taken


@contextlib.contextmanager
def _cwd(path):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


def phase_serve(work, m1, m2, p1, p2):
    """The resident server on the card, its jobs through the thin client.
    The socket is named relative to the working directories, so that its
    length does not depend on where the checkout lies.  Returns the launches
    of the served MID_PAIRS job and of all served jobs."""
    d = os.path.join(work, "serve")
    os.makedirs(d)
    log = LaunchLog(work, "serve")
    small = ["-i", p1, "-I", p2, "-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS]
    big = ["-i", m1, "-I", m2, "-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS]
    merge = ["-i", p1, "-I", p2, "-o", "out1.fq", "-O", "out2.fq", *CFG5_FLAGS]
    warm = ["fastp_tpu_torch", "-i", p1, "-I", p2, "-o", "warm1.fq", "-O",
            "warm2.fq", "-j", "warm.json", "-h", "warm.html", *BENCH_FLAGS]
    served_env = dict(log.env, FASTP_TPU_SERVER=os.path.join("..", "s.sock"))
    err_path = os.path.join(d, "server.err")
    t0 = time.perf_counter()
    with open(err_path, "w") as err_fh:
        srv = subprocess.Popen(
            port_cmd("serve", "--socket", "s.sock", "--warm-run",
                     json.dumps(warm)), cwd=d, env=port_env(),
            stdout=subprocess.PIPE, stderr=err_fh, text=True)
    try:
        lines = []
        while not lines or not lines[-1].startswith("READY"):
            line = srv.stdout.readline()
            if not line:
                with open(err_path) as fh:
                    raise SmokeFailure("the server ended before READY:\n%s"
                                       % fh.read()[-3000:])
            lines.append(line.strip())
        ready = time.perf_counter() - t0
        check(lines[0] == "WARMED rc=0", "the warm run said %s" % lines)
        pid = int(lines[-1].split()[1])
        check(pid == srv.pid, "READY names pid %d, the server is %d"
              % (pid, srv.pid))
        served = []
        for k in range(3):
            _, err, wall = _port_job(small, os.path.join(d, "served%d" % k),
                                     **served_env)
            check("running on cuda" in err, "served job %d did not run on "
                  "the card:\n%s" % (k, err[-2000:]))
            served.append(wall)
        _, err, cold = _port_job(small, os.path.join(d, "cold"))
        check("running on cuda" in err, "the cold job did not use CUDA")
        for k in range(3):
            same_outputs(os.path.join(d, "served%d" % k),
                         os.path.join(d, "cold"), "served vs cold job")
        small_launches = log.totals()
        check(len(log.jobs()) == 3 and all(
            job["pid"] == pid for job in log.jobs()),
            "the served jobs did not run inside the server: %s" % log.jobs())
        # the server built and loaded every kernel before READY
        check(log.loaded() == [[]] * 3, "served jobs loaded kernel "
              "libraries: %s" % log.loaded())
        _check_per_batch("the served %d-pair jobs" % CPU_PAIRS, log.totals(),
                         CPU_BATCHES, PER_BATCH["main"], shards=3)
        log.reset()
        _, err, big_wall = _port_job(big, os.path.join(d, "big"), **served_env)
        big_launches = log.totals()
        _check_per_batch("the served %d-pair job" % MID_PAIRS, big_launches,
                         MID_BATCHES, PER_BATCH["main"])
        same_outputs(os.path.join(d, "big"), os.path.join(work, "main_mid"),
                     "served %d-pair job vs the same prefix in this process"
                     % MID_PAIRS)
        merge_walls = []
        for k in range(2):
            _, _, wall = _port_job(merge, os.path.join(d, "merge%d" % k),
                                   **served_env)
            merge_walls.append(wall)
        files = same_outputs(os.path.join(d, "merge1"),
                             os.path.join(d, "merge0"), "second served merge "
                             "job vs the first")
        check("merged.fq" in files, "the merge job wrote %s" % files)
        total_launches = {k: small_launches[k] + log.launches(k)
                          for k in kernel_launches.KERNELS}
        with _cwd(d):
            pong = client.ping("s.sock")
            check(pong is not None and pong.get("jobs") == 6
                  and pong.get("pid") == pid and pong.get("rc") == 0
                  and pong.get("version"), "ping said %s" % pong)
            second = subprocess.run(port_cmd("serve", "--socket", "s.sock"),
                                    env=port_env(), capture_output=True,
                                    text=True, timeout=120)
            check(second.returncode != 0 and "already" in second.stderr,
                  "a second serve on the live socket exited %d:\n%s"
                  % (second.returncode, second.stderr[-2000:]))
            again = client.ping("s.sock")
            check(again is not None and again.get("pid") == pid,
                  "the first server stopped answering: %s" % again)
            check(client.shutdown_server("s.sock"), "shutdown got no reply")
        rc = srv.wait(timeout=60)
        check(rc == 0, "the server exited %d" % rc)
        check(not os.path.exists(os.path.join(d, "s.sock")),
              "the socket was left behind")
    finally:
        if srv.poll() is None:
            srv.kill()
            srv.wait()
        srv.stdout.close()
    print("phase serve: READY %.3f s after start (--warm-run of %d pairs); "
          "%d-pair main-path job, wall seconds of `python -m fastp_tpu_torch`: "
          "served %s; cold (once) %.3f; outputs equal; %d-pair main job "
          "served in %.3f s = %.0f pairs/s, kernel launches %s, files "
          "and JSON equal to the same prefix run in this process; --merge "
          "--dedup job served twice (%s s), "
          "equal; no served job loaded a kernel library (--warm-run's "
          "--warm loaded all three before READY); ping: %s; second serve "
          "exits %d; shutdown rc 0, socket removed"
          % (ready, CPU_PAIRS, CPU_PAIRS,
             ", ".join("%.3f" % w for w in served), cold, MID_PAIRS, big_wall,
             MID_PAIRS / big_wall, _fmt(big_launches),
             ", ".join("%.3f" % w for w in merge_walls), json.dumps(pong),
             second.returncode), flush=True)
    return {"serve_%d_pairs" % MID_PAIRS: big_launches,
            "serve_all_jobs": total_launches,
            "walls": {"served": served, "cold": cold,
                      "served_%d_pairs" % MID_PAIRS: big_wall, "ready": ready}}


def _time_used(log):
    """The seconds of the report's "time used" line in a job's log (for a
    launcher: shard 0's, which waits for the others), or -1."""
    m = re.search(r"time used: (\d+) seconds", log)
    return int(m.group(1)) if m else -1


def phase_procs(work, m1, m2, p1, p2):
    """--local_processes on the one card.  Returns {name: launches}."""
    d = os.path.join(work, "procs")
    log = LaunchLog(work, "procs")
    big = ["-i", m1, "-I", m2, "-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS]
    mid = os.path.join(work, "main_mid")
    merge = ["-i", p1, "-I", p2, "-o", "out1.fq", "-O", "out2.fq",
             *MERGE_DEDUP_FLAGS]
    out = {}
    walls = {}
    others = {}
    # N = 1 as a user starts it: a process of its own, start-up included
    # (the runs in this script's process find the card held already)
    used = {}   # the job's own "time used" line: the wall less start-up
    _, err, walls[1] = _port_job(big, os.path.join(d, "n1"))
    used[1] = _time_used(err)
    same_outputs(os.path.join(d, "n1"), mid,
                 "a process of its own vs the same prefix in this process")
    for n in (2, 4):
        log.reset()
        nd = os.path.join(d, "n%d" % n)
        _, err, walls[n] = _port_job(big + ["--local_processes", str(n)], nd,
                                     **log.env)
        used[n] = _time_used(err)
        jobs = log.jobs()
        check(len(jobs) == n and len({job["pid"] for job in jobs}) == n,
              "--local_processes %d logged %s" % (n, jobs))
        out["procs_%d" % n] = log.totals()
        check(all(job[k] > 0 for job in jobs for k in MAIN_KERNELS)
              and out["procs_%d" % n]["overlap_sweep"] >= MID_BATCHES,
              "--local_processes %d launched %s for %d batches"
              % (n, jobs, MID_BATCHES))
        others[n] = _same_as_shards(
            mid, nd, n, ("out1.fq", "out2.fq"),
            "--local_processes %d vs one process" % n,
            adapters=_sharded_adapter_counts(work, m1, m2, n))
    # N = 2 again, each shard sent to a resident server of its own
    # (FASTP_TPU_SERVERS), both servers on the one card
    served_wall, out["procs_2_servers"] = _shards_in_servers(d, big, log)
    _, _, single_wall, _ = _drive(d, "merge_single", merge)
    log.reset()
    _, _, merge_wall = _port_job(merge + ["--local_processes", "2"],
                                 os.path.join(d, "merge_n2"), **log.env)
    out["procs_merge_2"] = log.totals()
    check(out["procs_merge_2"]["overlap_sweep"] > 0
          and out["procs_merge_2"]["stat_batch"] > 0,
          "the merge shards launched %s" % out["procs_merge_2"])
    _same_as_shards(os.path.join(d, "merge_single"),
                    os.path.join(d, "merge_n2"), 2,
                    ("merged.fq", "out1.fq", "out2.fq"),
                    "--merge --dedup --local_processes 2 vs one process")
    print("phase procs: %d pairs, main path, --local_processes N on one card, "
          "wall seconds of the launcher: N=1 (one process of its own) %.3f s "
          "= %.0f pairs/s, N=2 %.3f s = %.0f pairs/s, N=4 %.3f s = %.0f "
          "pairs/s (of which the job's own \"time used\": %d, %d, %d s); N=2 "
          "with FASTP_TPU_SERVERS naming two warm servers on the one card "
          "%.3f s = %.0f pairs/s, launches %s, no kernel library loaded by a "
          "served shard, every file and the JSON equal to the plain N=2 "
          "run's; kernel launches %s and %s; the shards' files in order equal one process's, the "
          "merged JSON too but for read1/read2_adapter_counts, whose "
          "maps cap per shard: those equal the maps of each shard's records "
          "run alone in this process, added up (the sums of their numbers, "
          "one process and N shards: %s); --merge --dedup (cfg5 flags less "
          "--overrepresentation_analysis) on %d pairs: in this process %.3f s, "
          "--local_processes 2 %.3f s, merged.fq, out1.fq, out2.fq and JSON "
          "equal (launches %s)"
          % (MID_PAIRS, walls[1], MID_PAIRS / walls[1], walls[2],
             MID_PAIRS / walls[2], walls[4], MID_PAIRS / walls[4], used[1],
             used[2], used[4], served_wall, MID_PAIRS / served_wall,
             _fmt(out["procs_2_servers"]),
             _fmt(out["procs_2"]), _fmt(out["procs_4"]),
             "; ".join("N=%d %d, %d" % (n, *o) for n, o in others.items()),
             CPU_PAIRS, single_wall, merge_wall, _fmt(out["procs_merge_2"])),
          flush=True)
    out["walls"] = dict(walls, n2_in_servers=served_wall)
    return out


def _shards_in_servers(d, big, log):
    """`big --local_processes 2` with FASTP_TPU_SERVERS naming two resident
    servers (started together, --warm), compared with the plain N=2 run in
    d/n2; each shard, in a server started with --warm, loads no kernel
    library.  Returns (launcher's wall seconds, {kernel: launches})."""
    socks = ["s0.sock", "s1.sock"]
    servers = []
    try:
        for sock in socks:
            err_fh = open(os.path.join(d, sock + ".err"), "w")
            servers.append((subprocess.Popen(
                port_cmd("serve", "--socket", sock, "--warm"), cwd=d,
                env=port_env(), stdout=subprocess.PIPE, stderr=err_fh,
                text=True), err_fh))
        pids = []
        for (srv, _), sock in zip(servers, socks):
            line = srv.stdout.readline()
            if not line.startswith("READY"):
                with open(os.path.join(d, sock + ".err")) as fh:
                    raise SmokeFailure("server %s said %r before READY:\n%s"
                                       % (sock, line, fh.read()[-3000:]))
            pids.append(int(line.split()[1]))
        log.reset()
        nd = os.path.join(d, "n2_servers")
        _, err, wall = _port_job(
            big + ["--local_processes", "2"], nd, FASTP_TPU_SERVERS=",".join(
                os.path.join("..", sock) for sock in socks), **log.env)
        check("running on cuda" in err, "the served shard 0 did not run on "
              "the card:\n%s" % err[-2000:])
        jobs = log.jobs()
        check(sorted(job["pid"] for job in jobs) == sorted(pids),
              "the shards did not run inside the two servers %s: %s"
              % (pids, jobs))
        check(all(job[k] > 0 for job in jobs for k in MAIN_KERNELS),
              "a served shard launched no kernel: %s" % jobs)
        check(log.loaded() == [[], []], "the shards in servers started with "
              "--warm loaded kernel libraries: %s" % log.loaded())
        same_outputs(nd, os.path.join(d, "n2"),
                     "--local_processes 2 in two servers vs the plain run")
        check(sorted(os.listdir(nd)) == sorted(os.listdir(os.path.join(d, "n2"))),
              "the served shards left other files: %s" % os.listdir(nd))
        with _cwd(d):
            for sock in socks:
                pong = client.ping(sock)
                check(pong is not None and pong.get("jobs") == 1,
                      "server %s: ping said %s" % (sock, pong))
                check(client.shutdown_server(sock), "no reply to shutdown")
        for srv, _ in servers:
            check(srv.wait(timeout=60) == 0, "a server exited non-zero")
        return wall, log.totals()
    finally:
        for srv, err_fh in servers:
            if srv.poll() is None:
                srv.kill()
                srv.wait()
            srv.stdout.close()
            err_fh.close()


def env_turns(work, setting, rounds):
    """The 1M-pair main path as it is, with `setting` (VAR=VALUE) in the
    environment, with it, as it is, `rounds` times over: the walls, the
    dispatch worker's seconds, the transfers from the card and the input
    schemes of the runs, in that order, and what separates the medians."""
    var, _, value = setting.partition("=")
    check(var and value, "--turns takes VAR=VALUE, not %r" % setting)
    r1, r2 = _make_corpus(work)
    args = ["-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS]
    runs = []
    for k, env in enumerate(({}, {var: value}, {var: value}, {}) * rounds):
        name = "turn%d" % k
        before = step_device.fetch_stats["fetches"]
        res, d, wall, launches = _drive(work, name, args,
                                        **dict(TIMING_ON, **env))
        fetches = step_device.fetch_stats["fetches"] - before
        mode = setting if env else "default"
        check(res["batches"] == MAIN_BATCHES, "turn %d (%s): %d batches"
              % (k, mode, res["batches"]))
        _check_per_batch("turn %d (%s)" % (k, mode), launches, res["batches"],
                         PER_BATCH["main"])
        if k:
            same_outputs(d, os.path.join(work, "turn0"), "turn %d vs turn 0" % k)
            shutil.rmtree(d)
        dispatch = float(re.search(r"dispatch=([0-9.]+)s",
                                   TIMING_LINES[name][1]).group(1))
        runs.append((mode, wall, dispatch, fetches,
                     json.dumps(res["input_kinds"])))
    report = {}
    for mode in ("default", setting):
        walls = [r[1] for r in runs if r[0] == mode]
        report[mode] = {"median_wall": float(np.median(walls)),
                        "spread": max(walls) - min(walls),
                        "median_dispatch": float(np.median(
                            [r[2] for r in runs if r[0] == mode]))}
    print("turns: %d pairs, main path, wall seconds (the dispatch worker's; "
          "transfers from the card; batches per input scheme) in turns: %s; "
          "%s; outputs equal"
          % (MAIN_PAIRS, ", ".join("%s %.3f (%.2f; %d; %s)" % r for r in runs),
             json.dumps(report)), flush=True)


def against_parent(work, parent_root):
    """The five 1M-pair paths as processes of their own from an earlier
    checkout of this repository (`parent_root`: a directory that holds its
    fastp_tpu_torch package) and from this one, in turns earlier, this,
    this, earlier; each run's files and JSON must equal the first's.  Both
    trees build their kernel and host library in a short untimed job first.
    Prints the walls (start-up included on both sides)."""
    r1, r2 = _make_corpus(work)
    pe = ["-i", r1, "-I", r2]
    paths = {
        "main": pe + ["-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS],
        "se": ["-i", r1, "-o", "out.fq"],
        "failed": pe + ["-o", "o1.fq", "-O", "o2.fq", *CFG8_FLAGS],
        "merge": pe + ["-o", "out1.fq", "-O", "out2.fq", *CFG5_FLAGS],
        "gap": pe + ["-o", "out1.fq", "-O", "out2.fq", *GAP_FLAGS],
    }
    roots = {"earlier": os.path.abspath(parent_root), "this": ROOT}

    def job(root, args, d):
        os.makedirs(d)
        env = port_env(FASTP_TPU_TIMING="1")
        env["PYTHONPATH"] = root
        t0 = time.perf_counter()
        res = subprocess.run(port_cmd(*args), cwd=d, env=env,
                             stdout=subprocess.DEVNULL,
                             stderr=subprocess.PIPE, text=True)
        wall = time.perf_counter() - t0
        check(res.returncode == 0 and "running on cuda" in res.stderr,
              "%s from %s failed:\n%s" % (args, root, res.stderr[-3000:]))
        return wall, [ln for ln in res.stderr.splitlines()
                      if ln.startswith("TIMING ")]

    for which, root in roots.items():
        job(root, GOLDEN_RUNS["cfg3_pe_correction"],
            os.path.join(work, "warm_" + which))
    report = {}
    for name, args in paths.items():
        walls = []
        for k, which in enumerate(("earlier", "this", "this", "earlier")):
            d = os.path.join(work, "%s_%d_%s" % (name, k, which))
            wall, timing = job(roots[which], args, d)
            walls.append((which, wall))
            if k:
                same_outputs(d, os.path.join(work, name + "_0_earlier"),
                             "%s, turn %d (%s) vs turn 0" % (name, k, which))
                shutil.rmtree(d)
            if k < 2:
                for line in timing:
                    print("timing %s (%s tree): %s" % (name, which, line),
                          flush=True)
        shutil.rmtree(os.path.join(work, name + "_0_earlier"))
        report[name] = {
            "walls_in_turns": walls,
            "median": {w: float(np.median([x for y, x in walls if y == w]))
                       for w in roots}}
    print("against %s: %d pairs, a process of its own per run, wall seconds "
          "(start-up included), outputs equal: %s"
          % (parent_root, MAIN_PAIRS, json.dumps(report)), flush=True)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def phase_dist(work, m1, m2):
    """Two ranks of one job over torch.distributed, both on the one card.
    Returns ({kernel: launches}, wall seconds)."""
    d = os.path.join(work, "dist")
    os.makedirs(d)
    log = LaunchLog(work, "dist")
    big = ["-i", m1, "-I", m2, "-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS]
    port = _free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        port_cmd(*big), cwd=d, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, env=port_env(
            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank),
            WORLD_SIZE="2", GLOO_SOCKET_IFNAME="lo", **log.env))
        for rank in range(2)]
    try:
        for rank, proc in enumerate(procs):
            _, err = proc.communicate(timeout=600)
            check(proc.returncode == 0, "rank %d exited %d:\n%s"
                  % (rank, proc.returncode, err[-3000:]))
            check("running on cuda" in err, "rank %d did not use CUDA" % rank)
            check("shared-filesystem" not in err,
                  "rank %d fell back to the file exchange" % rank)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    wall = time.perf_counter() - t0
    jobs = log.jobs()
    check(len(jobs) == 2 and len({job["pid"] for job in jobs}) == 2
          and all(job[k] > 0 for job in jobs for k in MAIN_KERNELS),
          "the two ranks logged %s" % jobs)
    launches = log.totals()
    check(launches["overlap_sweep"] >= MID_BATCHES, "the ranks launched %s "
          "for %d batches" % (launches, MID_BATCHES))
    taken = _same_as_shards(os.path.join(work, "main_mid"), d, 2,
                            ("out1.fq", "out2.fq"),
                            "two ranks over torch.distributed vs one process",
                            adapters=_sharded_adapter_counts(work, m1, m2, 2))
    print("phase dist: %d pairs, main path, two ranks (gloo on 127.0.0.1, no "
          "FASTP_TPU_FS_EXCHANGE), both on the one card, in %.3f s wall from "
          "start to the second rank's end = %.0f pairs/s; kernel launches "
          "%s (overlap_sweep %s); the ranks' files in order equal one process's, the "
          "merged JSON too but for read1/read2_adapter_counts, which equal "
          "the maps of each rank's records run alone in this process, added "
          "up (the sums of their numbers, one process and two ranks: %d, %d)"
          % (MID_PAIRS, wall, MID_PAIRS / wall, _fmt(launches),
             " + ".join(str(job["overlap_sweep"]) for job in jobs), *taken),
          flush=True)
    return launches, wall


def phase_selftest(work, meanwhile):
    """`python -m fastp_tpu_torch test` on the card; `meanwhile()` (a phase
    that needs no card) runs while the self-test's process does."""
    log = LaunchLog(work, "selftest")
    d = os.path.join(work, "selftest")
    os.makedirs(d)
    t0 = time.perf_counter()
    proc = subprocess.Popen(port_cmd("test"), cwd=d, env=port_env(**log.env),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        meanwhile()
        stdout, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, "the self-test exited %d:\n%s"
          % (proc.returncode, err[-3000:]))
    lines = [ln for ln in stdout.splitlines() if ": " in ln]
    passed = [ln for ln in lines if ln.endswith(": PASSED")]
    check(len(passed) == len(lines) >= 10 and "ALL PASSED" in stdout,
          "the self-test printed:\n%s" % stdout)
    launches = log.totals()
    check(launches["overlap_sweep"] >= 2 and launches["trim_by_sequence"] >= 1,
          "the self-test launched %s (OverlapAnalysis::analyze and "
          "BaseCorrector analyse one pair row each, AdapterTrimmer one read)"
          % launches)
    print("phase selftest: `python -m fastp_tpu_torch test` on the card in "
          "%.3f s (phase no_card ran meanwhile): %d checks PASSED, ALL "
          "PASSED; kernel launches at B=1: %s"
          % (wall, len(passed), _fmt(launches)), flush=True)
    return launches


def _gunzip(path):
    with gzip.open(path, "rb") as fh:
        return fh.read()


def phase_batch(work, r1, r2):
    """The batch runner over two paired samples and one single-end sample of
    CPU_PAIRS each, against direct runs of the arguments it builds."""
    from fastp_tpu_torch import batch
    d = os.path.join(work, "batch")
    indir = os.path.join(d, "in")
    os.makedirs(indir)
    for k, name in enumerate(("a", "b")):
        _prefix(r1, os.path.join(indir, name + "_R1.fq"), CPU_PAIRS, k * CPU_PAIRS)
        _prefix(r2, os.path.join(indir, name + "_R2.fq"), CPU_PAIRS, k * CPU_PAIRS)
    _prefix(r1, os.path.join(indir, "c.fq"), CPU_PAIRS, 2 * CPU_PAIRS)
    extra = ["--correction", "--cut_right"]
    log = LaunchLog(work, "batch")
    stdout, _, wall = _port_job(
        ["-i", indir, "-o", os.path.join(d, "out"), "-r",
         os.path.join(d, "rep"), "--args=" + " ".join(extra)], d,
        module="fastp_tpu_torch.batch", **log.env)
    launches = log.totals()
    jobs = batch.scan_dir(indir)
    check(len(jobs) == 3 and sum(1 for _, second in jobs if second) == 2,
          "scan_dir found %s" % jobs)
    check(len(log.jobs()) == 3 and len({j["pid"] for j in log.jobs()}) == 1,
          "the batch jobs did not run in one process: %s" % log.jobs())
    check(launches["overlap_sweep"] >= 2 and launches["stat_batch"] >= 6,
          "the batch's jobs launched %s" % launches)
    check(os.path.getsize(os.path.join(d, "rep", "overall.html")) > 0,
          "no overall.html")
    compared = []
    for job in jobs:
        args = batch.build_args(job, os.path.join(d, "direct_out"),
                                os.path.join(d, "direct_rep"), extra)
        os.makedirs(os.path.join(d, "direct_rep"), exist_ok=True)
        _run_in_process(["fastp_tpu_torch", *args], d)
        for flag in ("-o", "-O", "--json"):
            if flag not in args:
                continue
            direct = args[args.index(flag) + 1]
            ours = direct.replace("direct_", "")
            if flag == "--json":
                with open(ours) as fa, open(direct) as fb:
                    same = normalize_json(fa.read()) == normalize_json(fb.read())
            else:
                same = _gunzip(ours) == _gunzip(direct) != b""
            check(same, "batch: %s differs from the direct run's" % ours)
            compared.append(os.path.basename(ours))
    print("phase batch: `python -m fastp_tpu_torch.batch` over 3 samples of "
          "%d (two paired, one single-end) in %.3f s in one process, kernel "
          "launches %s; equal to direct runs: %s; overall.html "
          "written" % (CPU_PAIRS, wall, _fmt(launches), ", ".join(compared)),
          flush=True)
    return launches


def phase_no_card(work, p1, p2):
    """The four entry points with the card hidden and no request for the
    CPU, started together: each must exit non-zero, name the variable and
    write nothing."""
    d = os.path.join(work, "no_card_entry")
    indir = os.path.join(work, "batch", "in")
    runs = {
        "serve": port_cmd("serve", "--socket", "s.sock", "--warm"),
        "test": port_cmd("test"),
        "local_processes": port_cmd("-i", p1, "-I", p2, "-o", "out1.fq", "-O",
                                    "out2.fq", "--local_processes", "2"),
        "batch": [sys.executable, "-m", "fastp_tpu_torch.batch", "-i", indir,
                  "-o", "out", "-r", "rep"],
    }
    procs = {}
    for name, cmd in runs.items():
        os.makedirs(os.path.join(d, name))
        procs[name] = subprocess.Popen(
            cmd, cwd=os.path.join(d, name),
            env=port_env(CUDA_VISIBLE_DEVICES="-1"), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    codes = {}
    for name, proc in procs.items():
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            raise SmokeFailure("%s without a card did not end" % name)
        left = os.listdir(os.path.join(d, name))
        check(proc.returncode != 0 and DEVICE_ENV in err and not left
              and "READY" not in out and "PASSED" not in out,
              "%s without a card and without %s=cpu: exit %d, files %s\n%s"
              % (name, DEVICE_ENV, proc.returncode, left, err[-2000:]))
        codes[name] = proc.returncode
    print("phase no_card: with the card hidden and no request for the CPU "
          "each entry point exits non-zero, names %s and writes nothing: %s"
          % (DEVICE_ENV, ", ".join("%s %d" % kv for kv in codes.items())),
          flush=True)


def _mid_reference(work, m1, m2):
    """The first MID_PAIRS of the corpus through the main path in this
    process: what phases serve, procs and dist hold their runs to.  Returns
    its overlap kernel launches."""
    res, d, wall, launches = _drive(
        work, "main_mid", ["-i", m1, "-I", m2, "-o", "out1.fq", "-O",
                           "out2.fq", *BENCH_FLAGS])
    check(res["batches"] == MID_BATCHES, "the %d-pair run: %d batches"
          % (MID_PAIRS, res["batches"]))
    _check_per_batch("the %d-pair run" % MID_PAIRS, launches, res["batches"],
                     PER_BATCH["main"])
    _nonempty_outputs(d, "the %d-pair run" % MID_PAIRS)
    print("reference for phases serve, procs and dist: the first %d pairs, "
          "main path, in this process in %.3f s wall; %d batches, kernel "
          "launches %s" % (MID_PAIRS, wall, res["batches"], _fmt(launches)),
          flush=True)
    return launches


# phase -> the seconds it took in this run
PHASE_SECONDS = {}
SCRIPT_T0 = time.perf_counter()


def _timed(name, phase, *args):
    t0 = time.perf_counter()
    try:
        return phase(*args)
    finally:
        PHASE_SECONDS[name] = round(time.perf_counter() - t0, 3)
        print("seconds: %s %.1f, the script so far %.1f"
              % (name, PHASE_SECONDS[name], time.perf_counter() - SCRIPT_T0),
              flush=True)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel-only", action="store_true",
                        help="phases device, build and kernel alone")
    parser.add_argument("--old-kernel", metavar="OLD.cu", nargs="+",
                        help="earlier versions of csrc/overlap_sweep.cu, "
                             "stat_batch.cu or adapter_match.cu (named by "
                             "file) to check and time beside the current "
                             "ones")
    parser.add_argument("--turns", nargs=2, metavar=("VAR=VALUE", "ROUNDS"),
                        help="phases device and build, then the 1M-pair main "
                             "path without and with VAR=VALUE in the "
                             "environment, in turns, four runs a round")
    parser.add_argument("--graph-only", action="store_true",
                        help="phases device and build, then phase graph on a "
                             "corpus of its first 20,000 pairs")
    parser.add_argument("--against", metavar="CHECKOUT",
                        help="phases device and build, then the four 1M-pair "
                             "paths from an earlier checkout of the repository "
                             "and from this one, in turns, a process each")
    args = parser.parse_args(argv)
    card = phase_device()
    old = old_kernel_sources(args.old_kernel)
    phase_build(old)
    if args.against:
        os.makedirs(os.path.join(ROOT, "_smoke"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_smoke")) as work:
            against_parent(work, args.against)
        print(card)
        print("--against run: no other phase was driven")
        return 0
    if args.graph_only:
        os.makedirs(os.path.join(ROOT, "_smoke"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_smoke")) as work:
            r1, r2 = _finish_corpus(_start_corpus(work, CPU_PAIRS))
            _, device_ms = phase_graph(work, r1, r2)
        print(card)
        print("graph-only run: no other phase was driven")
        return 0
    if args.turns:
        os.makedirs(os.path.join(ROOT, "_smoke"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_smoke")) as work:
            env_turns(work, args.turns[0], int(args.turns[1]))
        print(card)
        print("turns run: no other phase was driven")
        return 0
    launches = {}
    if args.kernel_only:
        worst, timing, bounds, new_kernels = phase_kernel(old)
    else:
        os.makedirs(os.path.join(ROOT, "_smoke"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_smoke")) as work:
            # the corpus is written by a process of its own meanwhile
            corpus = _start_corpus(work)
            try:
                worst, timing, bounds, new_kernels = _timed(
                    "kernel", phase_kernel, old)
                _timed("golden", phase_golden, work)
                r1, r2 = _timed("corpus_wait", _finish_corpus, corpus)
            finally:
                if corpus[0].poll() is None:
                    corpus[0].kill()
                    corpus[0].communicate()
            main_launches, main_wall = _timed("main", phase_main, work, r1, r2)
            launches = {"main": main_launches,
                        "se": _timed("se", phase_se, work, r1),
                        "failed": _timed("failed", phase_failed, work, r1, r2),
                        "merge": _timed("merge", phase_merge, work, r1, r2)}
            launches["gap"], gap_wall, gap_accepted = _timed(
                "gap", phase_gap, work, r1, r2)
            short_runs = _timed("cpu", phase_cpu, work, r1, r2)
            launches["gap_%d_pairs" % CPU_PAIRS] = short_runs["gap"][0]
            split = _timed("devices", phase_devices, work, r1, r2, main_wall)
            moved = _timed("accum", phase_accum, work, r1, r2)
            piped, pipe_numbers = _timed("pipeline", phase_pipeline, work,
                                         r1, r2)
            graph_launches, device_ms = _timed("graph", phase_graph, work,
                                               r1, r2, pipe_numbers)
            launches.update(graph_launches)
            p1 = _prefix(r1, os.path.join(work, "P1.fq"), CPU_PAIRS)
            p2 = _prefix(r2, os.path.join(work, "P2.fq"), CPU_PAIRS)
            m1 = _prefix(r1, os.path.join(work, "M1.fq"), MID_PAIRS)
            m2 = _prefix(r2, os.path.join(work, "M2.fq"), MID_PAIRS)
            launches["main_%d_pairs" % MID_PAIRS] = _timed(
                "mid_reference", _mid_reference, work, m1, m2)
            served = _timed("serve", phase_serve, work, m1, m2, p1, p2)
            shards = _timed("procs", phase_procs, work, m1, m2, p1, p2)
            launches["dist_2_ranks"], dist_wall = _timed(
                "dist", phase_dist, work, m1, m2)
            walls = {"gap": {"wall": gap_wall,
                             "gapped_accepts": gap_accepted},
                     "serve": served.pop("walls"),
                     "procs": shards.pop("walls"),
                     "devices": split.pop("walls"), "dist_2_ranks": dist_wall,
                     "d2h_bytes_%d_pairs" % CPU_PAIRS: moved,
                     "pipeline": pipe_numbers}
            launches.update(split)
            launches.update(piped)
            launches.update(served)
            launches.update(shards)
            launches["batch"] = _timed("batch", phase_batch, work, r1, r2)
            launches["selftest"] = _timed(
                "selftest_and_no_card", phase_selftest, work,
                lambda: phase_no_card(work, p1, p2))
        shutil.rmtree(os.path.join(ROOT, "_smoke"), ignore_errors=True)
    main_pct, zero_pct = (setting[2] for setting in TIMED_SETTINGS)
    t, t0 = timing[main_pct], timing[zero_pct]
    bound, bound0 = bounds[main_pct], bounds[zero_pct]
    if not args.kernel_only:
        print(json.dumps({"wall_seconds": walls}))
        print(json.dumps({"graph_device_ms": device_ms}))
        print(json.dumps({"phase_seconds": PHASE_SECONDS,
                          "script_seconds": time.perf_counter() - SCRIPT_T0}))
    print(card)

    def per_path(kernel):
        return {path: n[kernel] for path, n in launches.items()
                if isinstance(n, dict) and kernel in n}

    def entry(name, source, replaces, result, why, path="main"):
        t, bound = result["timing"], result["bound"]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": launches.get(path, {}).get(name),
                "launches_per_path": per_path(name),
                "max_abs_err": result["max_abs_err"], "ms": t["ms"],
                "floor_ms": t["floor_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"],
                "share_of_bound": bound["bound_ms"] / t["ms"],
                "library_ms": None, "library_ms_why": why,
                "call_ms": t["call_ms"], "plain_eager_ms": t["plain_eager_ms"],
                "cases": result["cases"], "old_in_turns": result["old"]}

    print(json.dumps({"kernels": [{
        "name": "overlap_sweep", "route": "cuda",
        "source": "fastp_tpu_torch/csrc/overlap_sweep.cu",
        "replaces": "fastp_tpu/ops/overlap_pallas.py:26",
        "launches": launches.get("main", {}).get("overlap_sweep"),
        "launches_per_path": per_path("overlap_sweep"),
        "max_abs_err": worst, "ms": t["ms"], "floor_ms": t["floor_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "share_of_bound": bound["bound_ms"] / t["ms"],
        "library_ms": None,
        "library_ms_why": "no single PyTorch call computes the first "
                          "accepted overlap offset",
        "call_ms": t["call_ms"], "bound": bound,
        "ms_diff_pct_0": t0["ms"], "call_ms_diff_pct_0": t0["call_ms"],
        "plain_ms_diff_pct_0": t0["plain_ms"],
        "bound_ms_diff_pct_0": bound0["bound_ms"],
        "share_of_bound_diff_pct_0": bound0["bound_ms"] / t0["ms"]},
        dict(entry("overlap_gap_sweep", "fastp_tpu_torch/csrc/overlap_sweep.cu",
                   "fastp_tpu/ops/overlap.py:255", new_kernels["overlap_gap_sweep"],
                   "no single PyTorch call computes the first offset whose "
                   "one-insertion difference passes", path="gap"),
             parent_chain_ms=new_kernels["overlap_gap_sweep"]["timing"][
                 "parent_chain_ms"],
             planted_gapped_accepts={str(k): v for k, v in new_kernels[
                 "overlap_gap_sweep"]["planted_gapped_accepts"].items()},
             row_sets={what: {
                 "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound"]["bound_ms"],
                 "bound_by": r["bound"]["bound_by"],
                 "compares_needed": r["bound"]["compares_needed"],
                 "rows_to_gapped_pass": r["rows_to_gapped_pass"],
                 "gapped_accepts": r["gapped_accepts"]}
                 for what, r in new_kernels["overlap_gap_sweep"][
                     "row_sets"].items()}),
        entry("stat_batch", "fastp_tpu_torch/csrc/stat_batch.cu",
              "fastp_tpu/ops/stats.py:26", new_kernels["stat_batch"],
              "no single PyTorch call computes the whole dict of per-cycle "
              "sums and histograms"),
        entry("trim_by_sequence", "fastp_tpu_torch/csrc/adapter_match.cu",
              "fastp_tpu/ops/adapter.py:57", new_kernels["trim_by_sequence"],
              "no single PyTorch call computes the first adapter match")]}))
    if args.kernel_only:
        print("kernel-only run: the main path was not driven")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
