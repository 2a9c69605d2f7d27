"""Where the device time of the port's stat_batch, trim_by_sequence and
gapped overlap (overlap_gap_sweep) kernels goes, on one NVIDIA GPU.

    python3 kernel_variants.py [--old-kernel DIR/overlap_sweep.cu ...]

Each kernel source marks the points of a block's (for the overlap kernel:
a warp's) way through it with PHASE(k) (0 its start, then the end of each
phase), a macro that is empty in the port's build.  This script builds
copies of fastp_tpu_torch/csrc/stat_batch.cu, adapter_match.cu and
overlap_sweep.cu with PHASE defined: one that writes a %globaltimer stamp
at every mark (-DFASTP_STAMPS; thread 0 of a block), one that is the
kernel as the port builds it, and others that end the kernel at one mark
(-DFASTP_STOP=k: the time of the phases before it).  It launches them at
the main path's shape (B=8192, L=160: chip_smoke.py's bench reads with
their adapters, one read a warp for adapter_match; for overlap_gap_sweep,
at the gap path's setting, chip_smoke.py's three row sets: the bench
rows, planted insertions, the bench rows with real indels) and prints each
phase's median time over the blocks, and each copy's device time per
launch from CUDA-graph replays, the copies of a kernel in turns (forward,
then backward).  It also times a few geometries of the full kernels, which
their C functions take as arguments.  --old-kernel names earlier versions
of overlap_sweep.cu with the same PHASE marks (the source before a change,
with its marks added, or designs tried against it), each labelled by its
directory, built, stamped and timed beside the current one; the build
lines give each copy's registers (ptxas).  A copy that ends early
computes wrong results: it is timed, never used or checked.  Needs a card;
imports no JAX and nothing of fastp_tpu.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from fastp_tpu_torch import cuda_build  # noqa: E402
from fastp_tpu_torch.ops import adapter_cuda, overlap_cuda, stats_cuda  # noqa: E402
from fastp_tpu_torch.ops.common import rc  # noqa: E402

B, L = chip_smoke.B, chip_smoke.L

# the phases between a kernel's PHASE marks, in order
PHASES = {
    "stat_batch": ["staging", "column sums", "histograms, __syncthreads",
                   "cluster.sync", "slice sums, accumulator's atomics",
                   "threadfence, ticket", "cluster.sync (last?)",
                   "last cluster's output, cluster.sync", "zeroing"],
    "adapter_match": ["staging", "Hamming scan", "prefix tables",
                      "fallback tests, outputs"],
    "overlap_sweep": ["staging", "ungapped forward rounds",
                      "ungapped backward rounds, the winner's full count",
                      "gapped forward rounds", "gapped backward rounds",
                      "the gapped winner's difference", "the store"],
}
# the copies that end at a mark (a stat_batch block may leave only before
# the first cluster.sync: after it, its shared memory is read by the others)
STOPS = {
    "stat_batch": [("staging only", 1), ("no flush", 3)],
    "adapter_match": [("staging only", 1), ("no fallbacks", 2)],
    "overlap_sweep": [("staging only", 1), ("ungapped rounds only", 3)],
}
# the C function each library is timed through, and its parameters
P, I = ctypes.c_void_p, ctypes.c_int
ENTRY = {
    "stat_batch": ("stat_batch", [P] * 4 + [I] * 5 + [P] * 3),
    "adapter_match": ("adapter_match", [P] * 3 + [I] * 11 + [P] * 5),
    "overlap_sweep": ("overlap_gap_sweep",
                      [P] * 4 + [I] * 4 + [ctypes.c_float] + [P] * 5 + [I, P]),
}
HOOKS = r"""
#ifndef FASTP_STOP
#define FASTP_STOP -1
#endif
#ifdef FASTP_STAMPS
#define FASTP_STAMP(k) fastp_stamp(k)
#else
#define FASTP_STAMP(k) ((void)0)
#endif
__device__ unsigned long long g_stamps[1 << 16];
__device__ __forceinline__ void fastp_stamp(int k) {
  if (threadIdx.x != 0) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  const int b = blockIdx.y * gridDim.x + blockIdx.x;
  if (b * 16 + k < (1 << 16)) g_stamps[b * 16 + k] = t;
}
extern "C" int read_stamps(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, g_stamps, sizeof(g_stamps)));
}
extern "C" int clear_stamps() {
  void* p = nullptr;
  const cudaError_t e = cudaGetSymbolAddress(&p, g_stamps);
  return static_cast<int>(e != cudaSuccess ? e : cudaMemset(p, 0, sizeof(g_stamps)));
}
#define PHASE(k) do { FASTP_STAMP(k); if ((k) == FASTP_STOP) return; } while (0)
"""


def phase_marks(text):
    """The k of every PHASE(k) in a kernel's source, in order."""
    return [int(k) for k in re.findall(r"^\s*PHASE\((\d+)\);", text, re.M)]


def profiled(name, source=None):
    """The source of `name` (csrc/<name>.cu, or the file `source`) with
    PHASE defined (HOOKS before it)."""
    with open(source or os.path.join(cuda_build.CSRC, name + ".cu")) as fh:
        text = fh.read()
    if phase_marks(text) != list(range(len(PHASES[name]) + 1)):
        raise SystemExit("kernel_variants.py: %s's PHASE marks are not "
                         "0 to %d in order"
                         % (source or name + ".cu", len(PHASES[name])))
    return HOOKS + text


def phase_times(fn_read, n_units, phases):
    """Median over the units that passed both of its stamps of each phase's
    us (a phase that only some units run, such as the last block's output,
    is the median over those), the span from the first stamp to the last,
    and the spread of the units' first stamps (when they started)."""
    buf = np.zeros(1 << 16, np.uint64)
    chip_smoke.check(fn_read(buf.ctypes.data) == 0, "read_stamps failed")
    t = (buf[:n_units * 16].reshape(n_units, 16)[:, :len(phases) + 1]
         .astype(np.int64))
    t = t[t[:, 0] > 0]
    seen = t[t > 0]
    out = {"units": int(len(t)),
           "kernel_span_us": float(seen.max() - seen.min()) / 1e3,
           "start_spread_us": float(t[:, 0].max() - t[:, 0].min()) / 1e3}
    for k, name in enumerate(phases):
        both = (t[:, k] > 0) & (t[:, k + 1] > 0)   # units that passed both
        out[name] = (float(np.median(t[both, k + 1] - t[both, k])) / 1e3
                     if both.any() else None)
    return out


def build(work, name, stop=None, stamps=False, source=None):
    """Writes the profiled source of `name` (or of the file `source`) and
    starts nvcc on it, ending the kernel at mark `stop` if given, stamping
    every mark with `stamps`; returns (library path, process)."""
    src = os.path.join(work, "%s_%d.cu" % (name, len(os.listdir(work))))
    with open(src, "w") as fh:
        fh.write(profiled(name, source))
    lib = src[:-3] + ".so"
    flags = (([] if stop is None else ["-DFASTP_STOP=%d" % stop])
             + (["-DFASTP_STAMPS"] if stamps else []))
    return lib, subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def stat_call(fn, args, cluster=stats_cuda.CLUSTER, rows=None):
    bases, quals, lengths, include = stats_cuda.kernel_inputs(*args)
    _, chunks, rows = stats_cuda.geometry(B, L, cluster, rows)
    acc = torch.zeros(stats_cuda.acc_size(L), dtype=torch.int64, device="cuda")
    out = torch.empty(stats_cuda.out_size(L), dtype=torch.int64, device="cuda")

    def call():
        err = fn(bases.data_ptr(), quals.data_ptr(), lengths.data_ptr(),
                 include.data_ptr(), B, L, rows, chunks, cluster,
                 acc.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        chip_smoke.check(err == 0, "stat_batch variant: CUDA error %d" % err)
    return call


def trim_call(fn, rows, lens, ad, warps=None, blocks=None):
    alen = int(ad.shape[0])
    g = adapter_cuda.geometry(B, L, alen)
    if warps:
        g["block_bytes"] = (g["ad_bytes"]
                            + warps * (g["row_bytes"] + 20 * g["table"]))
        g["warps"], g["blocks"] = warps, blocks or -(-B // warps)
    outs = (torch.empty(B, dtype=torch.int32, device="cuda"),
            torch.empty(B, dtype=torch.bool, device="cuda"),
            torch.empty(B, dtype=torch.int32, device="cuda"))
    rl = lens.to(torch.int32)

    def call():
        err = fn(rows.data_ptr(), rl.data_ptr(), ad.data_ptr(), B, L, alen, 4,
                 g["warps"], g["blocks"], 1, g["ad_bytes"], g["row_bytes"],
                 g["table"], g["block_bytes"], 0,
                 *(o.data_ptr() for o in outs),
                 torch.cuda.current_stream().cuda_stream)
        chip_smoke.check(err == 0, "adapter_match variant: CUDA error %d" % err)
    return call


def gap_call(fn, tensors):
    """A launch of overlap_gap_sweep (a copy's C function) at the gap path's
    setting on preallocated outputs."""
    return chip_smoke._raw_launcher(fn, tensors, chip_smoke.OVERLAP_SETTINGS[0],
                                    overlap_cuda.rows_per_block(L), gap=True)[0]


def gap_row_sets(rng):
    """chip_smoke.GAP_ROW_SETS at B x L: {name: (seq1, rc2, len1, len2)} as
    CUDA tensors."""
    s1, l1, s2, l2 = chip_smoke.gap_rows(int(rng.integers(1 << 30)), B=B, L=L)
    rows = {"bench": chip_smoke._bench_rows(rng),
            "planted": (s1, rc(torch.from_numpy(s2), torch.from_numpy(l2))
                        .numpy(), l1, l2),
            "indel151": chip_smoke.indel151_rows(rng)}
    return {name: tuple(torch.from_numpy(x).cuda() for x in rows[name])
            for name in chip_smoke.GAP_ROW_SETS}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-kernel", metavar="DIR/overlap_sweep.cu",
                    nargs="+", default=[],
                    help="earlier versions of overlap_sweep.cu with the same "
                         "PHASE marks, each named by its directory, "
                         "profiled and timed beside the current one")
    args = ap.parse_args(argv)
    chip_smoke.check(torch.cuda.is_available(), "no CUDA device")
    card = chip_smoke.phase_device()
    os.makedirs(os.path.join(ROOT, "_smoke"), exist_ok=True)
    variants = [(name, "", None) for name in PHASES]
    for path in args.old_kernel:
        tag = os.path.basename(os.path.dirname(os.path.abspath(path))) + " "
        chip_smoke.check(all(t != tag for _, t, _ in variants),
                         "--old-kernel: two files in directories named %s"
                         % tag)
        variants.append(("overlap_sweep", tag, os.path.abspath(path)))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_smoke")) as work:
        jobs = {}
        for name, tag, source in variants:
            for what, stop in [("full", None)] + STOPS[name]:
                jobs[name, tag + what] = build(work, name, stop, source=source)
            jobs[name, tag + "stamped"] = build(work, name, stamps=True,
                                                source=source)
        libs = {}
        for key, (lib, proc) in jobs.items():
            _, err = proc.communicate()
            chip_smoke.check(proc.returncode == 0, "nvcc failed for %s: %s"
                             % (key, err[-2000:]))
            libs[key] = ctypes.CDLL(lib)
            if key[1].endswith("full"):
                print("%s, %s: ptxas %s" % (key[0], key[1], " | ".join(
                    ln.split(":", 1)[-1].strip() for ln in err.splitlines()
                    if "registers" in ln or "Compiling entry" in ln)),
                    flush=True)
        for (name, _), lib in libs.items():
            fn = getattr(lib, ENTRY[name][0])
            fn.restype = ctypes.c_int
            fn.argtypes = ENTRY[name][1]
            lib.read_stamps.argtypes = [P]
            lib.read_stamps.restype = ctypes.c_int
            lib.clear_stamps.restype = ctypes.c_int
        rng = np.random.default_rng(42)
        bench = chip_smoke._bench_reads(rng)
        bases, quals, lens = (torch.from_numpy(x).cuda() for x in bench[0])
        include = torch.from_numpy(rng.random(B) < 0.9).cuda()
        args_stat = (bases, quals, lens, include)
        ad = torch.frombuffer(bytearray(chip_smoke.BENCH_ADAPTERS[0].encode()),
                              dtype=torch.uint8).cuda()
        full_stat = libs["stat_batch", "full"].stat_batch
        full_trim = libs["adapter_match", "full"].adapter_match
        timed = {
            "stat_batch copies": chip_smoke._in_turns({
                what: stat_call(libs["stat_batch", what].stat_batch, args_stat)
                for what, _ in [("full", None)] + STOPS["stat_batch"]}),
            "stat_batch geometry (cluster, rows a chunk)": chip_smoke._in_turns({
                "%d, %d" % (c, r): stat_call(full_stat, args_stat, c, r)
                for c, r in ((8, 128), (4, 128), (1, 128), (8, 64))}),
            "trim_by_sequence copies": chip_smoke._in_turns({
                what: trim_call(libs["adapter_match", what].adapter_match,
                                bases, lens, ad)
                for what, _ in [("full", None)] + STOPS["adapter_match"]}),
            "trim_by_sequence warps a block": chip_smoke._in_turns({
                str(w): trim_call(full_trim, bases, lens, ad, w)
                for w in (8, 4, 2)}),
            "trim_by_sequence blocks of 8 warps (reads a warp in turn)":
                chip_smoke._in_turns({
                    str(n): trim_call(full_trim, bases, lens, ad, 8, n)
                    for n in (1024, 528, 264)}),
        }
        stamps = {}
        for name, call, units in (
                ("stat_batch", stat_call(libs["stat_batch", "stamped"]
                                         .stat_batch, args_stat),
                 np.prod(stats_cuda.geometry(B, L)[:2])),
                ("adapter_match", trim_call(libs["adapter_match", "stamped"]
                                            .adapter_match, bases, lens, ad),
                 adapter_cuda.geometry(B, L, 33)["blocks"])):
            for _ in range(3):
                call()
            torch.cuda.synchronize()
            stamps[name] = phase_times(libs[name, "stamped"].read_stamps,
                                       int(units), PHASES[name])
            print("%s phases (median us over %s, the last of 3 launches): %s"
                  % (name, "blocks" if name == "stat_batch" else
                     "blocks' first warps", json.dumps(stamps[name])),
                  flush=True)
        # the gapped overlap kernel, on each row set: its copies (and the
        # old source's) in turns, then each stamped copy's phases
        tags = [tag for name, tag, _ in variants if name == "overlap_sweep"]
        copies = [tag + what for tag in tags
                  for what, _ in [("full", None)] + STOPS["overlap_sweep"]]
        for rows, tensors in gap_row_sets(np.random.default_rng(42)).items():
            timed["overlap_gap_sweep copies, %s rows" % rows] = \
                chip_smoke._in_turns({what: gap_call(
                    libs["overlap_sweep", what].overlap_gap_sweep, tensors)
                    for what in copies})
            for tag in tags:
                lib = libs["overlap_sweep", tag + "stamped"]
                torch.cuda.synchronize()
                chip_smoke.check(lib.clear_stamps() == 0, "clear_stamps failed")
                call = gap_call(lib.overlap_gap_sweep, tensors)
                for _ in range(3):
                    call()
                torch.cuda.synchronize()
                key = "%soverlap_gap_sweep, %s rows" % (tag, rows)
                stamps[key] = phase_times(
                    lib.read_stamps, B // overlap_cuda.rows_per_block(L),
                    PHASES["overlap_sweep"])
                print("%s phases (median us over the blocks' first warps "
                      "that passed both marks, the last of 3 launches): %s"
                      % (key, json.dumps(stamps[key])), flush=True)
        for what, turns in timed.items():
            print("%s, B=%d L=%d, ms a launch in turns: %s"
                  % (what, B, L, chip_smoke._turns_text(turns)), flush=True)
    print(card)
    print(json.dumps({"kernel_variants": timed, "phases": stamps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
