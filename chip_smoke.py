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
                 plain version
  4. golden   -- `python -m fastp_tpu_torch` on the golden inputs of cfg1
                 (single-end), cfg3, cfg5 (--merge, dedup, overrepresented
                 sequences), cfg6 (--failed_out, unpaired), cfg7 (split)
                 and cfg8 (--failed_out, --overlapped_out): every FASTQ
                 file of each golden and fastp.json
  5. main     -- a 1,000,000-pair PE151 corpus through cli.run with the
                 bench flags; the kernel must launch once per batch or more
  6. se       -- R1 of that corpus as single-end input with cfg1's flags
  7. failed   -- the corpus with cfg8's flags; the kernel must launch at
                 least twice per batch and every output stream is non-empty
  8. merge    -- the corpus with cfg5's flags; the kernel must launch at
                 least twice per batch (the analysis and the merge
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
 10. serve    -- `python -m fastp_tpu_torch serve --warm-run` on the card and
                 jobs through the thin client (FASTP_TPU_SERVER): three
                 20,000-pair jobs of the main path served and the same three
                 as cold processes, both sets of wall times; the 1M-pair
                 main job served, equal to phase main's files; a --merge
                 --dedup job twice, the second equal to the first; `ping`
                 counts the jobs; a second `serve` on the live socket exits
                 non-zero; `shutdown` ends the server and removes the socket
 11. procs    -- the 1M-pair main path with --local_processes 2 and 4 on
                 the one card, and as one process of its own: the shards'
                 files in order equal phase main's, the merged JSON too (but
                 for the numbers in read1/read2_adapter_counts, whose maps
                 cap per shard, as in fastp_tpu); --merge --dedup with
                 --local_processes 2 on 20,000 pairs against one process
                 (cfg5's flags less --overrepresentation_analysis, whose
                 sampling goes by a read's index within its process)
 12. selftest -- `python -m fastp_tpu_torch test`: every check PASSED, the
                 overlap checks through the kernel at one pair row
 13. batch    -- `python -m fastp_tpu_torch.batch` over a directory of two
                 paired samples and one single-end sample against direct
                 runs of the same arguments; overall.html is written
 14. no_card  -- serve --warm, test, --local_processes 2 and the batch
                 runner with the card hidden and no request for the CPU:
                 each exits non-zero and writes nothing
Phases 10 to 14 start the port as a user would, in processes of their own;
each job there appends the overlap kernel's launches to the file that
FASTP_TPU_TORCH_LAUNCH_LOG names, emptied just before the phase and read
just after.
Then a JSON line of the kernel results and, last, the device line.

    python3 chip_smoke.py --kernel-only [--old-kernel OLD.cu]

runs phases 1 to 3 alone; with --old-kernel it also builds an earlier
version of the kernel's source (same C interface), checks it against the
plain version and times the two in turns (old, new, new, old).

The script imports no JAX and nothing of fastp_tpu.
"""
import argparse
import contextlib
import gzip
import io
import json
import os
import re
import shutil
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
    check(all(accepted[pct] > 0 for _, _, pct in OVERLAP_SETTINGS),
          "a setting accepted no row: %s" % accepted)
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
          "diff_pct: %s; also at %s), max abs err %d; B=%d L=%d: %s"
          % (rows, accepted, ", ".join(edge), worst, B, L, "; ".join(
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


def _make_corpus(work):
    r1 = os.path.join(work, "R1.fq")
    r2 = os.path.join(work, "R2.fq")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", str(MAIN_PAIRS), "--seed", "42",
                    "--out1", r1, "--out2", r2],
                   check=True, capture_output=True)
    return r1, r2


def _run_in_process(argv, cwd):
    """cli.run on the card in this process with stderr captured; returns
    (result, log)."""
    log = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stderr(log):
            res = cli.run(argv, device="cuda")
    finally:
        os.chdir(old)
    return res, log.getvalue()


def _drive(work, name, args):
    """One path at full size through cli.run on the card, with the kernel
    counts set to 0 just before and read just after.  Returns (result,
    run directory, wall seconds, overlap kernel launches)."""
    d = os.path.join(work, name)
    os.makedirs(d)
    overlap_cuda.sweep_select.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, log = _run_in_process(["fastp_tpu_torch", *args], d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = overlap_cuda.sweep_select.launches
    check("running on cuda" in log, "%s run log does not show the CUDA "
          "device" % name)
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
                       *BENCH_FLAGS])
    batches = res["batches"]
    reads = res["pre1"].reads
    check(reads == MAIN_PAIRS, "main run read %d pairs" % reads)
    check(launches >= batches > 0,
          "overlap kernel launched %d times for %d batches" % (launches, batches))
    _nonempty_outputs(d, "main")
    after = _reads_after(d)
    check(0 < after <= 2 * MAIN_PAIRS, "main run kept %d reads" % after)
    print("phase main: %d pairs (bench flags, --batch_size 8192) in %.3f s "
          "wall = %.0f pairs/s; %d batches, %d overlap kernel launches; "
          "%d reads after filtering"
          % (reads, wall, reads / wall, batches, launches, after), flush=True)
    return launches


def phase_se(work, r1):
    res, d, wall, launches = _drive(work, "se", ["-i", r1, "-o", "out.fq"])
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
                         *CFG8_FLAGS])
    batches = res["batches"]
    reads = res["pre1"].reads
    check(reads == MAIN_PAIRS, "failed run read %d pairs" % reads)
    check(launches >= 2 * batches > 0,
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
                        *CFG5_FLAGS])
    batches = res["batches"]
    reads = res["pre1"].reads
    check(reads == MAIN_PAIRS, "merge run read %d pairs" % reads)
    check(launches >= 2 * batches > 0,
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
        procs[name] = (cpu_dir, start(name, cpu_dir, **{DEVICE_ENV: "cpu"}))
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


def _without_adapter_counts(text):
    """A report with the numbers of its read1/read2_adapter_counts taken
    out (the sequences named there stay); returns (text, the sum of the
    numbers taken out)."""
    lines, taken = [], 0
    for line in normalize_json(text).split("\n"):
        if "_adapter_counts" in line:
            taken += sum(int(m.group(2)) for m in ADAPTER_COUNT.finditer(line))
            line = ADAPTER_COUNT.sub(r'"\1"', line)
        lines.append(line)
    return "\n".join(lines), taken


def _same_as_shards(single_dir, shard_dir, n, names, what, capped=False):
    """Each of `names` in single_dir equals the shards' files 0001.name ..
    000n.name of shard_dir laid end to end; fastp.json after the
    command-line normalisation (the shards merge into one report).  With
    `capped`, the numbers of read1/read2_adapter_counts are left out of the
    comparison (the sequences named there are not) and their sums are
    returned as (single, sharded): the maps of trimmed adapters stop taking
    new sequences once they hold 20,000, and a pair whose first adapter was
    refused is not recorded for the second either (report/filter_model.py,
    as the reference's threads and fastp_tpu's shards), each shard's map
    for itself, so on a large input these counts depend on how the input
    was cut.  adapter_trimmed_reads and adapter_trimmed_bases are exact."""
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
    if capped:
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


def phase_serve(work, r1, r2, p1, p2):
    """The resident server on the card, its jobs through the thin client.
    The socket is named relative to the working directories, so that its
    length does not depend on where the checkout lies.  Returns the launches
    of the served 1M-pair job and of all served jobs."""
    d = os.path.join(work, "serve")
    os.makedirs(d)
    log = LaunchLog(work, "serve")
    small = ["-i", p1, "-I", p2, "-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS]
    big = ["-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS]
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
        served, cold = [], []
        for k in range(3):
            _, err, wall = _port_job(small, os.path.join(d, "served%d" % k),
                                     **served_env)
            check("running on cuda" in err, "served job %d did not run on "
                  "the card:\n%s" % (k, err[-2000:]))
            served.append(wall)
        for k in range(3):
            _, err, wall = _port_job(small, os.path.join(d, "cold%d" % k))
            check("running on cuda" in err, "cold job %d did not use CUDA" % k)
            cold.append(wall)
            same_outputs(os.path.join(d, "served%d" % k),
                         os.path.join(d, "cold%d" % k), "served vs cold job")
        small_launches = log.launches()
        check(len(log.jobs()) == 3 and all(
            job["pid"] == pid for job in log.jobs()),
            "the served jobs did not run inside the server: %s" % log.jobs())
        log.reset()
        _, err, big_wall = _port_job(big, os.path.join(d, "big"), **served_env)
        big_launches = log.launches()
        check(big_launches >= MAIN_BATCHES, "the served 1M-pair job launched "
              "the overlap kernel %d times for %d batches"
              % (big_launches, MAIN_BATCHES))
        same_outputs(os.path.join(d, "big"), os.path.join(work, "main"),
                     "served 1M-pair job vs phase main")
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
          "served %s; cold %s; outputs equal; 1M-pair main job served in "
          "%.3f s = %.0f pairs/s, %d overlap kernel launches, files and JSON "
          "equal to phase main's; --merge --dedup job served twice (%s s), "
          "equal; ping: %s; second serve exits %d; shutdown rc 0, socket "
          "removed"
          % (ready, CPU_PAIRS, CPU_PAIRS,
             ", ".join("%.3f" % w for w in served),
             ", ".join("%.3f" % w for w in cold), big_wall,
             MAIN_PAIRS / big_wall, big_launches,
             ", ".join("%.3f" % w for w in merge_walls), json.dumps(pong),
             second.returncode), flush=True)
    return {"serve_1m": big_launches, "serve_all_jobs": total_launches,
            "walls": {"served": served, "cold": cold, "served_1m": big_wall,
                      "ready": ready}}


def _time_used(log):
    """The seconds of the report's "time used" line in a job's log (for a
    launcher: shard 0's, which waits for the others), or -1."""
    m = re.search(r"time used: (\d+) seconds", log)
    return int(m.group(1)) if m else -1


def phase_procs(work, r1, r2, p1, p2):
    """--local_processes on the one card.  Returns {name: launches}."""
    d = os.path.join(work, "procs")
    log = LaunchLog(work, "procs")
    big = ["-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq", *BENCH_FLAGS]
    merge = ["-i", p1, "-I", p2, "-o", "out1.fq", "-O", "out2.fq",
             *MERGE_DEDUP_FLAGS]
    out = {}
    walls = {}
    others = {}
    # N = 1 as a user starts it: a process of its own, start-up included
    # (phase main ran in this script's process, which held the card already)
    used = {}   # the job's own "time used" line: the wall less start-up
    _, err, walls[1] = _port_job(big, os.path.join(d, "n1"))
    used[1] = _time_used(err)
    same_outputs(os.path.join(d, "n1"), os.path.join(work, "main"),
                 "a process of its own vs phase main")
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
              and out["procs_%d" % n] >= MAIN_BATCHES,
              "--local_processes %d launched the overlap kernel %s times for "
              "%d batches" % (n, [job["overlap_sweep"] for job in jobs],
                              MAIN_BATCHES))
        others[n] = _same_as_shards(
            os.path.join(work, "main"), nd, n, ("out1.fq", "out2.fq"),
            "--local_processes %d vs phase main" % n, capped=True)
    # the same again with each child's OpenMP pool cut to its share of the
    # host's cores (torch sizes it to every core in every child): timing only
    cores = os.cpu_count() or 1
    shared = {}
    for n in (2, 4):
        share = str(max(1, cores // n))
        nd = os.path.join(d, "n%d_threads" % n)
        _, _, shared[n] = _port_job(big + ["--local_processes", str(n)], nd,
                                    OMP_NUM_THREADS=share, MKL_NUM_THREADS=share)
        shutil.rmtree(nd)
    log.reset()
    _, _, single_wall = _port_job(merge, os.path.join(d, "merge_single"))
    _, _, merge_wall = _port_job(merge + ["--local_processes", "2"],
                                 os.path.join(d, "merge_n2"), **log.env)
    out["procs_merge_2"] = log.launches()
    check(out["procs_merge_2"] > 0, "the merge shards launched no kernel")
    _same_as_shards(os.path.join(d, "merge_single"),
                    os.path.join(d, "merge_n2"), 2,
                    ("merged.fq", "out1.fq", "out2.fq"),
                    "--merge --dedup --local_processes 2 vs one process")
    print("phase procs: 1M pairs, main path, --local_processes N on one card, "
          "wall seconds of the launcher: N=1 (one process of its own) %.3f s "
          "= %.0f pairs/s, N=2 %.3f s = %.0f pairs/s, N=4 %.3f s = %.0f "
          "pairs/s (of which the job's own \"time used\": %d, %d, %d s); with "
          "OMP_NUM_THREADS = %d cores / N in the children: N=2 "
          "%.3f s, N=4 %.3f s; overlap kernel launches %d "
          "and %d; the shards' files in order equal phase main's, the "
          "merged JSON too but for the numbers in read1/read2_adapter_"
          "counts, whose maps cap per shard (their sums, one process and N "
          "shards: %s); --merge --dedup (cfg5 flags less "
          "--overrepresentation_analysis) on %d pairs: one process %.3f s, "
          "--local_processes 2 %.3f s, merged.fq, out1.fq, out2.fq and JSON "
          "equal (%d launches)"
          % (walls[1], MAIN_PAIRS / walls[1], walls[2], MAIN_PAIRS / walls[2],
             walls[4], MAIN_PAIRS / walls[4], used[1], used[2], used[4],
             cores, shared[2], shared[4],
             out["procs_2"], out["procs_4"],
             "; ".join("N=%d %d, %d" % (n, *o) for n, o in others.items()),
             CPU_PAIRS, single_wall, merge_wall, out["procs_merge_2"]), flush=True)
    out["walls"] = dict(walls, threads_shared=shared, cores=cores)
    return out


def phase_selftest(work):
    log = LaunchLog(work, "selftest")
    stdout, _, wall = _port_job(["test"], os.path.join(work, "selftest"),
                                **log.env)
    lines = [ln for ln in stdout.splitlines() if ": " in ln]
    passed = [ln for ln in lines if ln.endswith(": PASSED")]
    check(len(passed) == len(lines) >= 10 and "ALL PASSED" in stdout,
          "the self-test printed:\n%s" % stdout)
    launches = log.launches()
    check(launches >= 2, "the self-test launched the overlap kernel %d times "
          "(OverlapAnalysis::analyze and BaseCorrector analyse one pair row "
          "each)" % launches)
    print("phase selftest: `python -m fastp_tpu_torch test` on the card in "
          "%.3f s: %d checks PASSED, ALL PASSED; %d overlap kernel launches "
          "at B=1" % (wall, len(passed), launches), flush=True)
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
        _port_job(args, d)
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


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernel-only", action="store_true",
                        help="phases device, build and kernel alone")
    parser.add_argument("--old-kernel", metavar="OLD.cu",
                        help="an earlier version of csrc/overlap_sweep.cu to "
                             "check and time beside the current one")
    args = parser.parse_args(argv)
    card = phase_device()
    phase_build()
    worst, timing, bounds = phase_kernel(args.old_kernel)
    launches = {}
    if not args.kernel_only:
        os.makedirs(os.path.join(ROOT, "_smoke"), exist_ok=True)
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_smoke")) as work:
            phase_golden(work)
            r1, r2 = _make_corpus(work)
            launches = {"main": phase_main(work, r1, r2),
                        "se": phase_se(work, r1),
                        "failed": phase_failed(work, r1, r2),
                        "merge": phase_merge(work, r1, r2)}
            short_runs = phase_cpu(work, r1, r2)
            launches["gap_%d_pairs" % CPU_PAIRS] = short_runs["gap"][0]
            p1 = _prefix(r1, os.path.join(work, "P1.fq"), CPU_PAIRS)
            p2 = _prefix(r2, os.path.join(work, "P2.fq"), CPU_PAIRS)
            served = phase_serve(work, r1, r2, p1, p2)
            shards = phase_procs(work, r1, r2, p1, p2)
            walls = {"serve": served.pop("walls"),
                     "procs": shards.pop("walls")}
            launches.update(served)
            launches.update(shards)
            launches["selftest"] = phase_selftest(work)
            launches["batch"] = phase_batch(work, r1, r2)
            phase_no_card(work, p1, p2)
        shutil.rmtree(os.path.join(ROOT, "_smoke"), ignore_errors=True)
    main_pct, zero_pct = (setting[2] for setting in TIMED_SETTINGS)
    t, t0 = timing[main_pct], timing[zero_pct]
    bound, bound0 = bounds[main_pct], bounds[zero_pct]
    if not args.kernel_only:
        print(json.dumps({"wall_seconds": walls}))
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
