"""Smoke run of the PyTorch port (fastp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; each prints one line, and any failure exits non-zero:
  1. device   -- requires CUDA; prints the card's name and power limit
  2. build    -- builds the overlap kernel from fastp_tpu_torch/csrc
  3. kernel   -- the CUDA overlap kernel against its plain PyTorch version
                 at B=8192, L=160 on bench-like and adversarial rows
                 (exact), with CUDA-event timings of both
  4. golden   -- `python -m fastp_tpu_torch` on the cfg3 golden inputs
  5. main     -- a 1,000,000-pair PE151 corpus through cli.run with the
                 bench flags; the kernel must launch once per batch or more
  6. cpu      -- the first 20,000 pairs on the card and on the CPU give
                 identical FASTQ and JSON
Then a JSON line of the kernel results and, last, the device line.
The script imports no JAX.
"""
import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fastp_tpu_torch import cuda_build  # noqa: E402
from fastp_tpu_torch import cli  # noqa: E402
from fastp_tpu_torch.ops import overlap_cuda  # noqa: E402
from fastp_tpu_torch.ops.overlap import sweep_select_plain  # noqa: E402

BENCH_FLAGS = ["--correction", "--cut_right",
               "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
               "--adapter_sequence_r2", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"]
GOLDEN = os.path.join(ROOT, "tests", "golden", "cfg3_pe_correction")
TESTDATA = os.path.join(ROOT, "tests", "testdata")
B, L = 8192, 160
# (diff_limit, overlap_require, diff_pct): the main path's setting, and a
# looser one that accepts at other offsets
OVERLAP_SETTINGS = ((5, 30, 0.2), (3, 10, 0.1))
MAIN_PAIRS = 1_000_000
CPU_PAIRS = 20_000


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def normalize_json(text):
    return re.sub(r'\t"command": ".*"', '\t"command": "X"', text)


def same_outputs(dir_a, dir_b, what):
    for f in ("out1.fq", "out2.fq"):
        with open(os.path.join(dir_a, f), "rb") as fa, \
                open(os.path.join(dir_b, f), "rb") as fb:
            check(fa.read() == fb.read(), "%s: %s differs" % (what, f))
    with open(os.path.join(dir_a, "fastp.json")) as fa, \
            open(os.path.join(dir_b, "fastp.json")) as fb:
        check(normalize_json(fa.read()) == normalize_json(fb.read()),
              "%s: fastp.json differs" % what)


def port_cmd(*args):
    return [sys.executable, "-m", "fastp_tpu_torch", *args]


def port_env(**extra):
    env = dict(os.environ)
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
    t0 = time.perf_counter()
    cuda_build.load("overlap_sweep")
    print("phase build: overlap_sweep built and loaded in %.3f s (%s)"
          % (time.perf_counter() - t0,
             os.path.relpath(cuda_build.library_path("overlap_sweep"), ROOT)),
          flush=True)


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


def _adversarial_rows(rng):
    """Rows that stress the edges: any byte value (bytes beyond the length
    are garbage too), lengths below overlap_require, zero lengths, exact
    full-length overlaps, and overlaps found only among backward offsets."""
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


def phase_kernel():
    rng = np.random.default_rng(42)
    worst = 0
    rows = 0
    accepted = 0
    timing = None
    for name, rows_np in (("bench", _bench_rows(rng)),
                          ("adversarial", _adversarial_rows(rng))):
        s1, r2, l1, l2 = (torch.from_numpy(x).cuda() for x in rows_np)
        for dl, req, pct in OVERLAP_SETTINGS:
            got = overlap_cuda.sweep_select(s1, r2, l1, l2, dl, req, pct)
            torch.cuda.synchronize()
            want = sweep_select_plain(s1, r2, l1, l2, dl, req, pct)
            for key, g, w in zip(("overlapped", "offset", "overlap_len", "diff"),
                                 got, want):
                err = int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
                worst = max(worst, err)
                check(err == 0, "kernel %s/%s differs from plain (max abs "
                      "err %d) at setting %s" % (name, key, err, (dl, req, pct)))
            rows += B
            accepted += int(got[0].sum())
            if name == "bench" and (dl, req, pct) == OVERLAP_SETTINGS[0]:
                timing = (
                    _median_ms(lambda: overlap_cuda.sweep_select(
                        s1, r2, l1, l2, dl, req, pct)),
                    _median_ms(lambda: sweep_select_plain(
                        s1, r2, l1, l2, dl, req, pct)))
    print("phase kernel: overlap_sweep == plain on %d rows (%d accepted), "
          "max abs err %d; B=%d L=%d kernel %.4f ms, plain %.4f ms "
          "(CUDA events, median of 25)"
          % (rows, accepted, worst, B, L, timing[0], timing[1]), flush=True)
    return worst, timing


def phase_golden(work):
    d = os.path.join(work, "golden")
    os.makedirs(d)
    res = subprocess.run(
        port_cmd("-i", os.path.join(TESTDATA, "R1.fq"),
                 "-I", os.path.join(TESTDATA, "R2.fq"),
                 "-o", "out1.fq", "-O", "out2.fq", "--correction", "--cut_right"),
        cwd=d, env=port_env(), capture_output=True, text=True)
    check(res.returncode == 0, "golden run failed:\n" + res.stderr[-3000:])
    check("running on cuda" in res.stderr, "golden run did not use CUDA")
    same_outputs(d, GOLDEN, "golden")
    print("phase golden: cfg3 out1.fq, out2.fq and fastp.json match "
          "tests/golden/cfg3_pe_correction on the card", flush=True)


def _make_corpus(work):
    r1 = os.path.join(work, "R1.fq")
    r2 = os.path.join(work, "R2.fq")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", str(MAIN_PAIRS), "--seed", "42",
                    "--out1", r1, "--out2", r2],
                   check=True, capture_output=True)
    return r1, r2


def _run_in_process(argv, cwd):
    """cli.run in this process with stderr captured; returns (result, log)."""
    log = io.StringIO()
    old = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stderr(log):
            res = cli.run(argv)
    finally:
        os.chdir(old)
    return res, log.getvalue()


def phase_main(work, r1, r2):
    d = os.path.join(work, "main")
    os.makedirs(d)
    argv = ["fastp_tpu_torch", "-i", r1, "-I", r2, "-o", "out1.fq",
            "-O", "out2.fq", *BENCH_FLAGS]
    overlap_cuda.sweep_select.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, log = _run_in_process(argv, d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = overlap_cuda.sweep_select.launches
    batches = res["batches"]
    reads = res["pre1"].reads
    check("running on cuda" in log, "main run log does not show the CUDA device")
    check(reads == MAIN_PAIRS, "main run read %d pairs" % reads)
    check(launches >= batches > 0,
          "overlap kernel launched %d times for %d batches" % (launches, batches))
    for f in ("out1.fq", "out2.fq"):
        check(os.path.getsize(os.path.join(d, f)) > 0, "main run wrote empty " + f)
    with open(os.path.join(d, "fastp.json")) as fh:
        summary = json.load(fh)["summary"]
    after = summary["after_filtering"]["total_reads"]
    check(0 < after <= 2 * MAIN_PAIRS, "main run kept %d reads" % after)
    print("phase main: %d pairs (bench flags, --batch_size 8192) in %.3f s "
          "wall = %.0f pairs/s; %d batches, %d overlap kernel launches; "
          "%d reads after filtering"
          % (reads, wall, reads / wall, batches, launches, after), flush=True)
    return launches


def phase_cpu(work, r1, r2):
    args = ["-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq",
            "--reads_to_process", str(CPU_PAIRS), *BENCH_FLAGS]
    gpu_dir = os.path.join(work, "cmp_gpu")
    cpu_dir = os.path.join(work, "cmp_cpu")
    os.makedirs(gpu_dir)
    os.makedirs(cpu_dir)
    _, log = _run_in_process(["fastp_tpu_torch", *args], gpu_dir)
    check("running on cuda" in log, "card run did not use CUDA")
    res = subprocess.run(port_cmd(*args), cwd=cpu_dir,
                         env=port_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True)
    check(res.returncode == 0, "cpu run failed:\n" + res.stderr[-3000:])
    check("running on cpu" in res.stderr, "cpu run did not run on the CPU")
    same_outputs(gpu_dir, cpu_dir, "card vs cpu")
    print("phase cpu: first %d pairs give identical out1.fq, out2.fq and "
          "fastp.json on the card and on the CPU" % CPU_PAIRS, flush=True)


def main():
    card = phase_device()
    phase_build()
    worst, (kernel_ms, plain_ms) = phase_kernel()
    os.makedirs(os.path.join(ROOT, "_smoke"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_smoke")) as work:
        phase_golden(work)
        r1, r2 = _make_corpus(work)
        launches = phase_main(work, r1, r2)
        phase_cpu(work, r1, r2)
    shutil.rmtree(os.path.join(ROOT, "_smoke"), ignore_errors=True)
    print(card)
    print(json.dumps({"kernels": [{
        "name": "overlap_sweep", "route": "cuda",
        "source": "fastp_tpu_torch/csrc/overlap_sweep.cu",
        "replaces": "fastp_tpu/ops/overlap_pallas.py:26",
        "launches": launches, "max_abs_err": worst,
        "ms": kernel_ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
