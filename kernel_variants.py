"""Where the device time of the port's stat_batch and trim_by_sequence
kernels goes, on one NVIDIA GPU.

    python3 kernel_variants.py

Each kernel source marks the points of a block's way through it with
PHASE(k) (0 its start, then the end of each phase), a macro that is empty
in the port's build.  This script builds copies of
fastp_tpu_torch/csrc/stat_batch.cu and adapter_match.cu with PHASE defined:
one that writes a %globaltimer stamp at every mark (-DFASTP_STAMPS; thread
0 of a block), one that is the kernel as the port builds it, and others
that end the kernel at one mark (-DFASTP_STOP=k: the time of the phases
before it).  It launches them at the main path's shape (B=8192,
L=160, chip_smoke.py's bench reads with their adapters; one read a warp for
adapter_match) and prints each phase's median time over the blocks, and
each copy's device time per launch from CUDA-graph replays, the copies of a
kernel in turns (forward, then backward).  It also times a few geometries
of the full kernels, which their C functions take as arguments.  A copy
that ends early computes wrong results: it is timed, never used or
checked.  Needs a card; imports no JAX and nothing of fastp_tpu.
"""
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
from fastp_tpu_torch.ops import adapter_cuda, stats_cuda  # noqa: E402

B, L = chip_smoke.B, chip_smoke.L

# the phases between a kernel's PHASE marks, in order
PHASES = {
    "stat_batch": ["staging", "column sums", "histograms, __syncthreads",
                   "cluster.sync", "slice sums, accumulator's atomics",
                   "threadfence, ticket", "cluster.sync (last?)",
                   "last cluster's output, cluster.sync", "zeroing"],
    "adapter_match": ["staging", "Hamming scan", "prefix tables",
                      "fallback tests, outputs"],
}
# the copies that end at a mark (a stat_batch block may leave only before
# the first cluster.sync: after it, its shared memory is read by the others)
STOPS = {
    "stat_batch": [("staging only", 1), ("no flush", 3)],
    "adapter_match": [("staging only", 1), ("no fallbacks", 2)],
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
#define PHASE(k) do { FASTP_STAMP(k); if ((k) == FASTP_STOP) return; } while (0)
"""


def phase_marks(text):
    """The k of every PHASE(k) in a kernel's source, in order."""
    return [int(k) for k in re.findall(r"^\s*PHASE\((\d+)\);", text, re.M)]


def profiled(name):
    """The source of `name` with PHASE defined (HOOKS before it)."""
    with open(os.path.join(cuda_build.CSRC, name + ".cu")) as fh:
        text = fh.read()
    if phase_marks(text) != list(range(len(PHASES[name]) + 1)):
        raise SystemExit("kernel_variants.py: %s.cu's PHASE marks are not "
                         "0 to %d in order" % (name, len(PHASES[name])))
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


def build(work, name, stop=None, stamps=False):
    """Writes the profiled source of `name` and starts nvcc on it, ending
    the kernel at mark `stop` if given, stamping every mark with `stamps`;
    returns (library path, process)."""
    src = os.path.join(work, "%s_%d.cu" % (name, len(os.listdir(work))))
    with open(src, "w") as fh:
        fh.write(profiled(name))
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


def main():
    chip_smoke.check(torch.cuda.is_available(), "no CUDA device")
    card = chip_smoke.phase_device()
    os.makedirs(os.path.join(ROOT, "_smoke"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "_smoke")) as work:
        jobs = {(name, what): build(work, name, stop)
                for name in PHASES
                for what, stop in [("full", None)] + STOPS[name]}
        jobs.update({(name, "stamped"): build(work, name, stamps=True)
                     for name in PHASES})
        libs = {}
        for key, (lib, proc) in jobs.items():
            _, err = proc.communicate()
            chip_smoke.check(proc.returncode == 0, "nvcc failed for %s: %s"
                             % (key, err[-2000:]))
            libs[key] = ctypes.CDLL(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        for (name, _), lib in libs.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = ([p] * 4 + [i] * 5 + [p] * 3 if name == "stat_batch"
                           else [p] * 3 + [i] * 11 + [p] * 5)
            lib.read_stamps.argtypes = [p]
            lib.read_stamps.restype = ctypes.c_int
        rng = np.random.default_rng(42)
        bench = chip_smoke._bench_reads(rng)
        bases, quals, lens = (torch.from_numpy(x).cuda() for x in bench[0])
        include = torch.from_numpy(rng.random(B) < 0.9).cuda()
        args = (bases, quals, lens, include)
        ad = torch.frombuffer(bytearray(chip_smoke.BENCH_ADAPTERS[0].encode()),
                              dtype=torch.uint8).cuda()
        full_stat = libs["stat_batch", "full"].stat_batch
        full_trim = libs["adapter_match", "full"].adapter_match
        timed = {
            "stat_batch copies": chip_smoke._in_turns({
                what: stat_call(libs["stat_batch", what].stat_batch, args)
                for what, _ in [("full", None)] + STOPS["stat_batch"]}),
            "stat_batch geometry (cluster, rows a chunk)": chip_smoke._in_turns({
                "%d, %d" % (c, r): stat_call(full_stat, args, c, r)
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
                                         .stat_batch, args),
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
        for what, turns in timed.items():
            print("%s, B=%d L=%d, ms a launch in turns: %s"
                  % (what, B, L, chip_smoke._turns_text(turns)), flush=True)
    print(card)
    print(json.dumps({"kernel_variants": timed, "phases": stamps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
