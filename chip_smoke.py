"""Smoke run of the PyTorch port (fastp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints one line, and any failure exits non-zero:
  1. device   -- requires CUDA; prints the card's name and power limit
  2. build    -- builds the overlap kernel from fastp_tpu_torch/csrc (nvcc)
                 and the host library from fastp_tpu_torch/native (g++), both
                 at once; prints what ptxas reports for the kernel
  3. kernel   -- the CUDA overlap kernel against its plain PyTorch version
                 at B=8192, L=160 on bench-like and adversarial rows
                 (exact) at three overlap settings, diff_pct = 0 (the
                 --overlapped_out re-analysis) among them; on adversarial
                 rows at L=256 (the PE251 width) and at row counts that are
                 no multiple of the rows a block takes (8192 + 5, 3); the
                 byte compares the bench rows need and from them the
                 kernel's bound; CUDA-event timings of the kernel and of the
                 plain version; the bench rows once more launched from a
                 worker thread on a side stream, as the batch loop does
  4. golden   -- `python -m fastp_tpu_torch` on the golden inputs of cfg1
                 (single-end), cfg3, cfg5 (--merge, dedup, overrepresented
                 sequences), cfg6 (--failed_out, unpaired), cfg7 (split)
                 and cfg8 (--failed_out, --overlapped_out): every FASTQ
                 file of each golden and fastp.json
  5. main     -- a 1,000,000-pair PE151 corpus through cli.run with the
                 bench flags; the kernel must launch once per batch or more;
                 the run accumulates (the batch's sums stay on the card until
                 the end of the run)
  6. se       -- R1 of that corpus as single-end input with cfg1's flags
  7. failed   -- the corpus with cfg8's flags; the kernel must launch
                 exactly twice per batch and every output stream is non-empty
  8. merge    -- the corpus with cfg5's flags; the kernel must launch
                 exactly twice per batch (the analysis and the merge
                 re-analysis), merged.fq is non-empty and the report's
                 merged_and_filtered section counts reads
  9. cpu      -- the first 20,000 pairs (reads) of phases 5 to 8, of a
                 --allow_gap_overlap_trimming run, of an SE --adapter_fasta
                 run and of an --interleaved_in --stdout run on the card and
                 on the CPU give identical output files (the last one's
                 standard output too); the gap run is timed on the card.
                 The CPU runs ask for the CPU with FASTP_TPU_TORCH_DEVICE=cpu;
                 one more run, with the card hidden and no such request, must
                 exit non-zero
 10. devices  -- the main path at 1M pairs with --devices 2 and the device
                 request cuda:0,cuda:0 (both shards of every batch share the
                 one card, so equality is shown and speed is not): files and
                 JSON equal to phase main's, two kernel launches per batch;
                 then on 20,000 pairs the se, failed and merge paths at
                 --devices 2, the main path at --devices 3 and the main path
                 at --devices 2 with FASTP_TPU_CORR_K=1 (rows over K take the
                 host's recomputation), each against phase cpu's one-device
                 run on the card
 11. accum    -- the main and merge paths on 20,000 pairs with
                 FASTP_TPU_NO_ACCUM=1 against phase cpu's (accumulating)
                 runs on the card, and the device-to-host bytes per batch
                 both ways
 12. pipeline -- the pipelined batch loop and the packed transfers at full
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
 13. graph    -- the step as a CUDA graph against the eager step
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
                 bytes it added; the TIMING split of the four 1M-pair paths
 14. serve    -- `python -m fastp_tpu_torch serve --warm-run` on the card and
                 jobs through the thin client (FASTP_TPU_SERVER): three
                 20,000-pair jobs of the main path served and the same job
                 once as a cold process, their wall times; the main path's
                 first 200,000 pairs served, equal to the files of the same
                 prefix run in this script's process; a --merge
                 --dedup job twice, the second equal to the first; `ping`
                 counts the jobs; a second `serve` on the live socket exits
                 non-zero; `shutdown` ends the server and removes the socket
 15. procs    -- the main path's first 200,000 pairs with --local_processes
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
 16. dist     -- the main path's first 200,000 pairs as two processes that
                 exchange over torch.distributed (gloo on 127.0.0.1,
                 MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE; no
                 FASTP_TPU_FS_EXCHANGE),
                 both on the one card: the ranks' files in order equal those
                 of the same prefix run in this script's process, the merged
                 JSON too (read1/read2_adapter_counts held as in phase 14)
 17. batch    -- `python -m fastp_tpu_torch.batch` over a directory of two
                 paired samples and one single-end sample against direct
                 runs of the same arguments (in this script's process);
                 overall.html is written
 18. selftest -- `python -m fastp_tpu_torch test`: every check PASSED, the
                 overlap checks through the kernel at one pair row
 19. no_card  -- serve --warm, test, --local_processes 2 and the batch
                 runner with the card hidden and no request for the CPU:
                 each exits non-zero and writes nothing (while the self-test's
                 process runs)
Phases 14 to 19 start the port as a user would, in processes of their own;
each job there appends the overlap kernel's launches to the file that
FASTP_TPU_TORCH_LAUNCH_LOG names, emptied just before the phase and read
just after.  The corpus is written by tools/make_synth.py in a process of
its own while phases 3 and 4 run.
Then a JSON line of the walls, one of the seconds each phase took, the card,
a JSON line of the kernel results and, last, the device line.

    python3 chip_smoke.py --kernel-only [--old-kernel OLD.cu]

runs phases 1 to 3 alone; with --old-kernel it also builds an earlier
version of the kernel's source (same C interface), checks it against the
plain version and times the two in turns (old, new, new, old).

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

runs phases 1 and 2 and then the four 1M-pair paths from an earlier
checkout of the repository (a directory that holds its fastp_tpu_torch/)
and from this one, a process each, in turns earlier, this, this, earlier;
outputs must be equal; prints the walls.

The script imports no JAX and nothing of fastp_tpu.
"""
import argparse
import contextlib
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
from fastp_tpu_torch.ops import overlap_cuda  # noqa: E402
from fastp_tpu_torch.parallel import multihost  # noqa: E402
from fastp_tpu_torch.pipeline import device as step_device  # noqa: E402
from fastp_tpu_torch.ops.overlap import (COMPLETE_COMPARE_REQUIRE,  # noqa: E402
                                         sweep_select_plain)

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
# the card's peaks the bound is reckoned from: HBM3 of the H100 SXM, and byte
# compares on the integer pipes (132 SMs x 64 INT32 lanes x 4 bytes a 32-bit
# operation x 1.75 GHz)
PEAK_BYTES_PER_S = 3.35e12
PEAK_BYTE_COMPARES_PER_S = 132 * 64 * 4 * 1.75e9
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


def phase_build():
    """nvcc for the kernel and g++ for the host library, started together."""
    results = {}

    def build(key, fn):
        t0 = time.perf_counter()
        try:
            results[key] = (fn(), time.perf_counter() - t0)
        except Exception as exc:  # re-raised below, in the main thread
            results[key] = (exc, time.perf_counter() - t0)

    threads = [threading.Thread(target=build, args=(key, fn)) for key, fn in (
        ("kernel", lambda: cuda_build.load("overlap_sweep")),
        ("native", native_mod.get_lib))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for key, (res, _) in results.items():
        if isinstance(res, Exception):
            raise res
    check(results["native"][0] is not None,
          "the host library (fastp_tpu_torch/native) did not build or load")
    ptxas = [ln.strip() for ln in
             cuda_build.build_logs.get("overlap_sweep", "").splitlines()
             if "registers" in ln or "spill" in ln]
    print("phase build: overlap_sweep built and loaded in %.3f s (%s), the "
          "host library in %.3f s (%s); ptxas: %s"
          % (results["kernel"][1],
             os.path.relpath(cuda_build.library_path("overlap_sweep"), ROOT),
             results["native"][1],
             os.path.relpath(native_mod._lib_path(), ROOT),
             " | ".join(ptxas) or "not built in this process"), flush=True)


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
    where the ops just before the kernel wrote them."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return _median_ms(graph.replay, replays) / launches


def needed_compares(found, offset, overlap_len, len1, len2, overlap_require):
    """Byte compares the first-accept walk needs on these rows, reckoned
    from the plain version's outputs (numpy arrays): every forward offset
    up to the accepted one, or all of them and then the backward offsets up
    to the accepted one, or all of both for a row that accepts none.
    Returns (full, prefix): `full` counts each walked offset at its whole
    overlap; `prefix` at min(overlap, 50) positions, which decide the accept
    test, plus the whole overlap once for each accepted row (its diff)."""
    l1, l2 = len1.astype(np.int64), len2.astype(np.int64)
    off = offset.astype(np.int64)
    n_f = np.maximum(l1 - overlap_require, 0)
    n_b = np.maximum(l2 - overlap_require, 0)
    # offset 0 is shift 0 of the forward walk, or of the backward walk for
    # a row with no forward candidate (the two compare the same bytes)
    fwd_hit = found & (off >= 0) & (off < n_f)
    walked_f = np.where(fwd_hit, off + 1, n_f)
    walked_b = np.where(fwd_hit, 0, np.where(found, 1 - off, n_b))
    s = np.arange(max(int(n_f.max()), int(n_b.max()), 1))[None, :]
    olen_f = np.maximum(np.minimum(l1[:, None] - s, l2[:, None]), 0)
    olen_b = np.maximum(np.minimum(l1[:, None], l2[:, None] - s), 0)
    in_f, in_b = s < walked_f[:, None], s < walked_b[:, None]
    cap = COMPLETE_COMPARE_REQUIRE
    full = int((olen_f * in_f).sum() + (olen_b * in_b).sum())
    prefix = int((np.minimum(olen_f, cap) * in_f).sum()
                 + (np.minimum(olen_b, cap) * in_b).sum()
                 + overlap_len.astype(np.int64)[found].sum())
    return full, prefix


def kernel_bound(rows_np, want, overlap_require):
    """The least time the card could take for sweep_select on these rows:
    the larger of its bytes (each input read once, each output written once)
    over the memory rate and the byte compares it needs over the integer
    rate.  Returns a dict of the counts and times (ms)."""
    seq1, rc2, len1, len2 = rows_np
    found, offset, ol, diff = (w.cpu().numpy() for w in want)
    full, prefix = needed_compares(found, offset, ol, len1, len2,
                                   overlap_require)
    nbytes = (seq1.nbytes + rc2.nbytes + len1.nbytes + len2.nbytes
              + found.nbytes + offset.nbytes + ol.nbytes + diff.nbytes)
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = prefix / PEAK_BYTE_COMPARES_PER_S * 1e3
    return {"bytes": nbytes, "compares_needed": prefix,
            "compares_at_whole_overlaps": full, "bytes_ms": bytes_ms,
            "operations_ms": ops_ms,
            "operations_ms_at_whole_overlaps":
                full / PEAK_BYTE_COMPARES_PER_S * 1e3,
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


def _raw_launcher(fn, tensors, setting, warps):
    """A call of a kernel library's C entry point on preallocated outputs
    (no wrapper), for timing two builds of the kernel alike.  Returns
    (call, outputs)."""
    s1, r2, l1, l2 = tensors
    rows, width = s1.shape
    dl, req, pct = setting
    outs = (torch.empty(rows, dtype=torch.bool, device=s1.device),
            *(torch.empty(rows, dtype=torch.int32, device=s1.device)
              for _ in range(3)))

    def call():
        err = fn(s1.data_ptr(), r2.data_ptr(), l1.data_ptr(), l2.data_ptr(),
                 rows, width, dl, req, pct, *(o.data_ptr() for o in outs),
                 warps, torch.cuda.current_stream().cuda_stream)
        check(err == 0, "overlap_sweep launch failed: CUDA error %d" % err)
    return call, outs


def compare_with_old_kernel(old_source, tensors, want_by_setting):
    """Builds an earlier version of csrc/overlap_sweep.cu (same C interface,
    rows of 2 L bytes in shared memory), holds it to the plain version and
    times it against the current kernel in turns: old, new, new, old."""
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
    print("old kernel (%s) against the new one, B=%d L=%d, device time per "
          "launch from CUDA-graph replays of 20 launches, in turns: %s"
          % (os.path.basename(old_source), B, L, "; ".join(
              "diff_pct %s: %s" % (pct, ", ".join(
                  "%s %.4f ms" % t for t in turns))
              for pct, turns in out.items())), flush=True)
    return out


def phase_kernel(old_source=None):
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
                bounds[pct] = kernel_bound(rows_np, want, setting[1])
                timing[pct] = {
                    "ms": _graph_ms(lambda: overlap_cuda.sweep_select(
                        *tensors, *setting)),
                    "call_ms": _median_ms(lambda: overlap_cuda.sweep_select(
                        *tensors, *setting)),
                    "plain_ms": _median_ms(lambda: sweep_select_plain(
                        *tensors, *setting))}
        if name == "bench" and old_source:
            compare_with_old_kernel(old_source, tensors, wants)
        if name == "bench":
            # as the batch loop launches it: from a worker thread, on a
            # side stream
            torch.cuda.synchronize()
            for setting in TIMED_SETTINGS:
                counted = overlap_cuda.sweep_select.launches
                got = _on_worker_stream(
                    lambda: overlap_cuda.sweep_select(*tensors, *setting))
                check(overlap_cuda.sweep_select.launches == counted + 1,
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
              "graph replays of 20 launches, median of 15), %.4f ms for one "
              "call between two events, plain %.4f ms (median of 25); needs "
              "%d byte compares (%d at whole overlaps) and %d bytes, so "
              "bound %.5f ms by %s (bytes %.5f ms at %.2f TB/s, operations "
              "%.5f ms at %.1f T byte compares/s), kernel at %.1f%% of it"
              % (pct, t["ms"], t["call_ms"], t["plain_ms"],
                 bounds[pct]["compares_needed"],
                 bounds[pct]["compares_at_whole_overlaps"],
                 bounds[pct]["bytes"], bounds[pct]["bound_ms"],
                 bounds[pct]["bound_by"], bounds[pct]["bytes_ms"],
                 PEAK_BYTES_PER_S / 1e12, bounds[pct]["operations_ms"],
                 PEAK_BYTE_COMPARES_PER_S / 1e12,
                 100.0 * bounds[pct]["bound_ms"] / t["ms"])
              for pct, t in timing.items())), flush=True)
    return worst, timing, bounds


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
# added, launches per replay, warm-up seconds)
CAPTURES = {}
TIMING_ON = {"FASTP_TPU_TIMING": "1"}


def _drive(work, name, args, device="cuda", says="running on cuda", **env):
    """One path through cli.run on the card, with the kernel counts set to
    0 just before and read just after.  Returns (result, run directory,
    wall seconds, overlap kernel launches)."""
    d = os.path.join(work, name)
    os.makedirs(d)
    overlap_cuda.sweep_select.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, log = _run_in_process(["fastp_tpu_torch", *args], d, device, **env)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = overlap_cuda.sweep_select.launches
    check(says in log, "%s run log does not say \"%s\":\n%s"
          % (name, says, log[:400]))
    timing = [ln for ln in log.splitlines() if ln.startswith("TIMING ")]
    if timing:
        TIMING_LINES[name] = timing
    return res, d, wall, launches


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
    check(launches == batches == MAIN_BATCHES,
          "overlap kernel launched %d times for %d batches" % (launches, batches))
    _nonempty_outputs(d, "main")
    after = _reads_after(d)
    check(0 < after <= 2 * MAIN_PAIRS, "main run kept %d reads" % after)
    print("phase main: %d pairs (bench flags, --batch_size 8192) in %.3f s "
          "wall = %.0f pairs/s; %d batches, %d overlap kernel launches; "
          "%d reads after filtering"
          % (reads, wall, reads / wall, batches, launches, after), flush=True)
    return launches, wall


def phase_se(work, r1):
    res, d, wall, launches = _drive(work, "se", ["-i", r1, "-o", "out.fq"],
                                    **TIMING_ON)
    reads = res["pre"].reads
    check(reads == MAIN_PAIRS, "se run read %d reads" % reads)
    check(launches == 0, "the SE path launched the overlap kernel")
    _nonempty_outputs(d, "se")
    after = _reads_after(d)
    check(0 < after <= MAIN_PAIRS, "se run kept %d reads" % after)
    print("phase se: %d single-end reads (cfg1 flags: adapter detection, "
          "quality and length filters) in %.3f s wall = %.0f reads/s; "
          "%d batches, %d reads after filtering"
          % (reads, wall, reads / wall, res["batches"], after), flush=True)
    return launches


def phase_failed(work, r1, r2):
    res, d, wall, launches = _drive(
        work, "failed", ["-i", r1, "-I", r2, "-o", "o1.fq", "-O", "o2.fq",
                         *CFG8_FLAGS], **TIMING_ON)
    batches = res["batches"]
    reads = res["pre1"].reads
    check(reads == MAIN_PAIRS, "failed run read %d pairs" % reads)
    check(launches == 2 * batches == 2 * MAIN_BATCHES,
          "overlap kernel launched %d times for %d batches (want twice per "
          "batch: the analysis and the --overlapped_out re-analysis)"
          % (launches, batches))
    files = _nonempty_outputs(d, "failed")
    check(files == ["failed.fq", "o1.fq", "o2.fq", "ov.fq", "up1.fq"],
          "failed run wrote %s" % files)
    print("phase failed: %d pairs (cfg8 flags) in %.3f s wall = %.0f pairs/s; "
          "%d batches, %d overlap kernel launches (%.2f per batch); every "
          "stream non-empty: %s"
          % (reads, wall, reads / wall, batches, launches, launches / batches,
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
    check(launches == 2 * batches == 2 * MAIN_BATCHES,
          "overlap kernel launched %d times for %d batches (want twice per "
          "batch: the analysis and the merge re-analysis)" % (launches, batches))
    files = _nonempty_outputs(d, "merge")
    check("merged.fq" in files, "merge run wrote %s" % files)
    with open(os.path.join(d, "fastp.json")) as fh:
        merged = json.load(fh)["merged_and_filtered"]["total_reads"]
    merged_pairs = res["filter"].merged_pairs
    check(0 < merged_pairs <= merged, "merge run merged %d pairs, reported "
          "%d merged-and-filtered reads" % (merged_pairs, merged))
    print("phase merge: %d pairs (cfg5 flags) in %.3f s wall = %.0f pairs/s; "
          "%d batches, %d overlap kernel launches (%.2f per batch); %d pairs "
          "merged, %d reads in merged_and_filtered; %s"
          % (reads, wall, reads / wall, batches, launches, launches / batches,
             merged_pairs, merged,
             ", ".join("%s %d B" % (f, os.path.getsize(os.path.join(d, f)))
                       for f in files)), flush=True)
    return launches


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
    (launches, card wall seconds)} of the in-process runs."""
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
        overlap_cuda.sweep_select.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, log = _run_in_process(["fastp_tpu_torch", *paths[name], *prefix],
                                 gpu_dir)
        torch.cuda.synchronize()
        card[name] = (overlap_cuda.sweep_select.launches,
                      time.perf_counter() - t0)
        check("running on cuda" in log, "card run %s did not use CUDA" % name)
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
          "card and on the CPU (%s=cpu): %s; card wall and overlap kernel "
          "launches: %s; with the card hidden and no request for the CPU the "
          "port exits %d and writes nothing"
          % (CPU_PAIRS, DEVICE_ENV, "; ".join(compared), "; ".join(
              "%s %.3f s, %d" % (name, wall, n)
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
    check(res["batches"] == MAIN_BATCHES and launches == 2 * MAIN_BATCHES,
          "--devices 2: %d overlap kernel launches for %d batches (want one "
          "per shard)" % (launches, res["batches"]))
    same_outputs(d, os.path.join(work, "main"), "--devices 2 vs phase main")
    out = {"devices_2": launches}
    prefix = ["--reads_to_process", str(CPU_PAIRS)]
    short = {
        # name: (arguments, shards, launches per batch and shard, phase
        # cpu's one-device run on the card, environment)
        "se": (["-i", r1, "-o", "out.fq"], 2, 0, "se", {}),
        "failed": (pe + ["-o", "o1.fq", "-O", "o2.fq", *CFG8_FLAGS], 2, 2,
                   "failed", {}),
        "merge": (pe + ["-o", "out1.fq", "-O", "out2.fq", *CFG5_FLAGS], 2, 2,
                  "merge", {}),
        "main_3": (main, 3, 1, "main", {}),
        "main_corr_k_1": (main, 2, 1, "main", {"FASTP_TPU_CORR_K": "1"}),
    }
    walls = []
    for name, (args, n, per_batch, one, env) in short.items():
        _, sd, swall, n_launch = _drive(
            work, "devices_" + name, args + prefix + ["--devices", str(n)],
            device=_one_card(n),
            says="running on %d shards of every batch" % n, **env)
        check(n_launch == n * per_batch * CPU_BATCHES,
              "--devices %d, %s: %d overlap kernel launches for %d batches"
              % (n, name, n_launch, CPU_BATCHES))
        files = same_outputs(sd, os.path.join(work, "cmp_gpu_" + one),
                             "--devices %d, %s, vs one device" % (n, name))
        out["devices_%s_%d_pairs" % (name, CPU_PAIRS)] = n_launch
        walls.append("%s at --devices %d %.3f s, %d launches (%s)"
                     % (name, n, swall, n_launch, ", ".join(files)))
    print("phase devices: %d pairs, main path, --devices 2 with the device "
          "request %s (BOTH SHARDS SHARE ONE CARD: equality is shown, speed "
          "is not) in %.3f s wall = %.0f pairs/s, beside phase main's %.3f s "
          "on one device; %d overlap kernel launches (2 per batch); files "
          "and JSON equal to phase main's; %d-pair prefixes equal to the "
          "one-device runs on the card: %s"
          % (MAIN_PAIRS, _one_card(2), wall, MAIN_PAIRS / wall, main_wall,
             launches, CPU_PAIRS, "; ".join(walls)), flush=True)
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
        check(n == res["batches"] == MAIN_BATCHES,
              "%s: %d overlap kernel launches for %d batches"
              % (name, n, res["batches"]))
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
    others = {"se": (["-i", r1, "-o", "out.fq"], 0),
              "failed": (pe + ["-o", "o1.fq", "-O", "o2.fq", *CFG8_FLAGS], 2),
              "merge": (pe + ["-o", "out1.fq", "-O", "out2.fq", *CFG5_FLAGS],
                        2)}
    other_walls = {}
    for path, (args, per) in others.items():
        name = "pipe_%s_prefetch1" % path
        res, d, wall, n = _drive(work, name, args, FASTP_TPU_PREFETCH="1",
                                 **TIMING_ON)
        check(n == per * MAIN_BATCHES and res["batches"] == MAIN_BATCHES,
              "%s: %d overlap kernel launches for %d batches"
              % (name, n, res["batches"]))
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
        check(n == res["batches"] == CPU_BATCHES, "%s: %d launches" % (name, n))
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
    overlap_cuda.sweep_select.launches = 0
    rc = server._run_job(["fastp_tpu_torch", *short], served, None)
    launches["pipe_served_job"] = overlap_cuda.sweep_select.launches
    after = _settled_threads()
    check(rc == 0 and launches["pipe_served_job"] == CPU_BATCHES,
          "the served job gave %d, %d launches"
          % (rc, launches["pipe_served_job"]))
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
                        "overlap_sweep_events": text.count("overlap_sweep")}
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
        overlap_cuda.sweep_select.launches = 0
        rc = server._run_job(["fastp_tpu_torch", *main, *prefix], d, None)
        check(rc == 0, "served job %d exited %d" % (k, rc))
        served.append((len(step_device.graph_log) - before,
                       overlap_cuda.sweep_select.launches))
    check(served[1][0] == 0 and served[1][1] == CPU_BATCHES,
          "the second served job captured %d graphs, %d launches"
          % served[1])
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
                        round(warm, 3), nbytes, sweeps)
                       for key, sec, nbytes, sweeps, warm in log]
                for name, log in CAPTURES.items()}
    timing = {}
    for name in ("main", "se", "failed", "merge"):
        for line in TIMING_LINES.get(name, []):
            for field in ("produce", "dispatch", "fetch_wait", "wall"):
                m = re.search(r"\b%s=([0-9.]+)s" % field, line)
                if m:
                    timing.setdefault(name, {})[field] = float(m.group(1))
    trace = (pipe_numbers or {}).get("trace")
    if trace is not None:
        check(trace["overlap_sweep_events"] >= 1,
              "the FASTP_TPU_PROFILE trace names no overlap_sweep: %s" % trace)
    print("phase graph: %d pairs (%d batches, the last partial), graph "
          "against eager on the card, bit-equal on every key of every "
          "batch: %s; a second served job of the main path captured %d "
          "graphs (the first %d) and wrote the same files; host calls per "
          "batch that put work on the card (batches 2-3, torch.profiler): "
          "%s; the captures of each run that made one, in this script's "
          "process (first argument's shape, accum, shard, seconds of the "
          "capture, of the warm-up runs, bytes of reserved memory it added, "
          "overlap launches per replay): %s; %d captures in all; memo "
          "entries %d, reserved %d bytes (one pool per "
          "entry, shared by its graphs); TIMING of the 1M-pair paths: %s; "
          "FASTP_TPU_PROFILE trace: %s"
          % (CPU_PAIRS, CPU_BATCHES, "; ".join(equal), served[1][0],
             served[0][0], json.dumps({"%s %s" % k: v
                                       for k, v in per_batch.items()}),
             json.dumps(captures), len(step_device.graph_log),
             len(step_device._memo), torch.cuda.memory_reserved(),
             json.dumps(timing), json.dumps(trace)), flush=True)
    return launches


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

    def launches(self):
        return sum(job["overlap_sweep"] for job in self.jobs())


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
        small_launches = log.launches()
        check(len(log.jobs()) == 3 and all(
            job["pid"] == pid for job in log.jobs()),
            "the served jobs did not run inside the server: %s" % log.jobs())
        log.reset()
        _, err, big_wall = _port_job(big, os.path.join(d, "big"), **served_env)
        big_launches = log.launches()
        check(big_launches >= MID_BATCHES, "the served %d-pair job launched "
              "the overlap kernel %d times for %d batches"
              % (MID_PAIRS, big_launches, MID_BATCHES))
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
        total_launches = small_launches + log.launches()
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
          "served in %.3f s = %.0f pairs/s, %d overlap kernel launches, files "
          "and JSON equal to the same prefix run in this process; --merge "
          "--dedup job served twice (%s s), "
          "equal; ping: %s; second serve exits %d; shutdown rc 0, socket "
          "removed"
          % (ready, CPU_PAIRS, CPU_PAIRS,
             ", ".join("%.3f" % w for w in served), cold, MID_PAIRS, big_wall,
             MID_PAIRS / big_wall, big_launches,
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
        out["procs_%d" % n] = log.launches()
        check(all(job["overlap_sweep"] > 0 for job in jobs)
              and out["procs_%d" % n] >= MID_BATCHES,
              "--local_processes %d launched the overlap kernel %s times for "
              "%d batches" % (n, [job["overlap_sweep"] for job in jobs],
                              MID_BATCHES))
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
    out["procs_merge_2"] = log.launches()
    check(out["procs_merge_2"] > 0, "the merge shards launched no kernel")
    _same_as_shards(os.path.join(d, "merge_single"),
                    os.path.join(d, "merge_n2"), 2,
                    ("merged.fq", "out1.fq", "out2.fq"),
                    "--merge --dedup --local_processes 2 vs one process")
    print("phase procs: %d pairs, main path, --local_processes N on one card, "
          "wall seconds of the launcher: N=1 (one process of its own) %.3f s "
          "= %.0f pairs/s, N=2 %.3f s = %.0f pairs/s, N=4 %.3f s = %.0f "
          "pairs/s (of which the job's own \"time used\": %d, %d, %d s); N=2 "
          "with FASTP_TPU_SERVERS naming two warm servers on the one card "
          "%.3f s = %.0f pairs/s, %d launches, every file and the JSON equal "
          "to the plain N=2 run's; overlap kernel launches %d "
          "and %d; the shards' files in order equal one process's, the "
          "merged JSON too but for read1/read2_adapter_counts, whose "
          "maps cap per shard: those equal the maps of each shard's records "
          "run alone in this process, added up (the sums of their numbers, "
          "one process and N shards: %s); --merge --dedup (cfg5 flags less "
          "--overrepresentation_analysis) on %d pairs: in this process %.3f s, "
          "--local_processes 2 %.3f s, merged.fq, out1.fq, out2.fq and JSON "
          "equal (%d launches)"
          % (MID_PAIRS, walls[1], MID_PAIRS / walls[1], walls[2],
             MID_PAIRS / walls[2], walls[4], MID_PAIRS / walls[4], used[1],
             used[2], used[4], served_wall, MID_PAIRS / served_wall,
             out["procs_2_servers"],
             out["procs_2"], out["procs_4"],
             "; ".join("N=%d %d, %d" % (n, *o) for n, o in others.items()),
             CPU_PAIRS, single_wall, merge_wall, out["procs_merge_2"]), flush=True)
    out["walls"] = dict(walls, n2_in_servers=served_wall)
    return out


def _shards_in_servers(d, big, log):
    """`big --local_processes 2` with FASTP_TPU_SERVERS naming two resident
    servers (started together, --warm), compared with the plain N=2 run in
    d/n2.  Returns (launcher's wall seconds, overlap kernel launches)."""
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
        check(all(job["overlap_sweep"] > 0 for job in jobs),
              "a served shard launched no kernel: %s" % jobs)
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
        return wall, log.launches()
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
        check(launches == res["batches"] == MAIN_BATCHES,
              "turn %d (%s): %d batches, %d launches"
              % (k, mode, res["batches"], launches))
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
    """The four 1M-pair paths as processes of their own from an earlier
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
    Returns (overlap kernel launches, wall seconds)."""
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
          and all(job["overlap_sweep"] > 0 for job in jobs),
          "the two ranks logged %s" % jobs)
    launches = log.launches()
    check(launches >= MID_BATCHES, "the ranks launched the overlap kernel %d "
          "times for %d batches" % (launches, MID_BATCHES))
    taken = _same_as_shards(os.path.join(work, "main_mid"), d, 2,
                            ("out1.fq", "out2.fq"),
                            "two ranks over torch.distributed vs one process",
                            adapters=_sharded_adapter_counts(work, m1, m2, 2))
    print("phase dist: %d pairs, main path, two ranks (gloo on 127.0.0.1, no "
          "FASTP_TPU_FS_EXCHANGE), both on the one card, in %.3f s wall from "
          "start to the second rank's end = %.0f pairs/s; %d overlap kernel "
          "launches (%s); the ranks' files in order equal one process's, the "
          "merged JSON too but for read1/read2_adapter_counts, which equal "
          "the maps of each rank's records run alone in this process, added "
          "up (the sums of their numbers, one process and two ranks: %d, %d)"
          % (MID_PAIRS, wall, MID_PAIRS / wall, launches,
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
    launches = log.launches()
    check(launches >= 2, "the self-test launched the overlap kernel %d times "
          "(OverlapAnalysis::analyze and BaseCorrector analyse one pair row "
          "each)" % launches)
    print("phase selftest: `python -m fastp_tpu_torch test` on the card in "
          "%.3f s (phase no_card ran meanwhile): %d checks PASSED, ALL "
          "PASSED; %d overlap kernel launches at B=1"
          % (wall, len(passed), launches), flush=True)
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
    launches = log.launches()
    jobs = batch.scan_dir(indir)
    check(len(jobs) == 3 and sum(1 for _, second in jobs if second) == 2,
          "scan_dir found %s" % jobs)
    check(len(log.jobs()) == 3 and len({j["pid"] for j in log.jobs()}) == 1,
          "the batch jobs did not run in one process: %s" % log.jobs())
    check(launches >= 2, "the batch's paired jobs launched %d kernels" % launches)
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
          "%d (two paired, one single-end) in %.3f s in one process, %d "
          "overlap kernel launches; equal to direct runs: %s; overall.html "
          "written" % (CPU_PAIRS, wall, launches, ", ".join(compared)),
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
    check(launches == res["batches"] == MID_BATCHES,
          "the %d-pair run: %d overlap kernel launches for %d batches"
          % (MID_PAIRS, launches, res["batches"]))
    _nonempty_outputs(d, "the %d-pair run" % MID_PAIRS)
    print("reference for phases serve, procs and dist: the first %d pairs, "
          "main path, in this process in %.3f s wall; %d batches, %d overlap "
          "kernel launches" % (MID_PAIRS, wall, res["batches"], launches),
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
    parser.add_argument("--old-kernel", metavar="OLD.cu",
                        help="an earlier version of csrc/overlap_sweep.cu to "
                             "check and time beside the current one")
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
    phase_build()
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
            phase_graph(work, r1, r2)
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
        worst, timing, bounds = phase_kernel(args.old_kernel)
    else:
        os.makedirs(os.path.join(ROOT, "_smoke"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_smoke")) as work:
            # the corpus is written by a process of its own meanwhile
            corpus = _start_corpus(work)
            try:
                worst, timing, bounds = _timed("kernel", phase_kernel,
                                               args.old_kernel)
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
            short_runs = _timed("cpu", phase_cpu, work, r1, r2)
            launches["gap_%d_pairs" % CPU_PAIRS] = short_runs["gap"][0]
            split = _timed("devices", phase_devices, work, r1, r2, main_wall)
            moved = _timed("accum", phase_accum, work, r1, r2)
            piped, pipe_numbers = _timed("pipeline", phase_pipeline, work,
                                         r1, r2)
            launches.update(_timed("graph", phase_graph, work, r1, r2,
                                   pipe_numbers))
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
            walls = {"serve": served.pop("walls"),
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
        print(json.dumps({"phase_seconds": PHASE_SECONDS,
                          "script_seconds": time.perf_counter() - SCRIPT_T0}))
    print(card)
    print(json.dumps({"kernels": [{
        "name": "overlap_sweep", "route": "cuda",
        "source": "fastp_tpu_torch/csrc/overlap_sweep.cu",
        "replaces": "fastp_tpu/ops/overlap_pallas.py:26",
        "launches": launches.get("main"), "launches_per_path": launches,
        "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
        "share_of_bound": bound["bound_ms"] / t["ms"],
        "library_ms": None,
        "library_ms_why": "no single PyTorch call computes the first "
                          "accepted overlap offset",
        "call_ms": t["call_ms"], "bound": bound,
        "ms_diff_pct_0": t0["ms"], "call_ms_diff_pct_0": t0["call_ms"],
        "plain_ms_diff_pct_0": t0["plain_ms"],
        "bound_ms_diff_pct_0": bound0["bound_ms"],
        "share_of_bound_diff_pct_0": bound0["bound_ms"] / t0["ms"]}]}))
    if args.kernel_only:
        print("kernel-only run: the main path was not driven")
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
