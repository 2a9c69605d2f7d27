"""The port's two kernels for XLA ops, stat_batch (csrc/stat_batch.cu) and
trim_by_sequence (csrc/adapter_match.cu), and the launch tally of all
three kernels (fastp_tpu_torch/ops/launches.py).

The plain versions (ops/stats.py:stat_batch_plain,
ops/adapter.py:trim_by_sequence_plain), the kernels' references, are held
exactly to fastp_tpu's stat_batch and trim_by_sequence on chip_smoke.py's
adversarial rows: every byte value as a base, qualities below 33 and at or
above 128, lengths 0 and L, reads excluded, widths 32, 320 and 1,056;
adapters of 6, 8, 12, 16, 33 and 80 bases at match_req 4, 5 and 6, on rows
built to reach the insertion and the deletion fallbacks.

The kernels cannot run without a card, so their arithmetic is modelled
here step for step and held exactly to the plain versions:
`stat_kernel_model` (numpy: column tiles of 32 lanes, chunks of rows walked
by eight warps in turn, a thread's three counts of a slot as 10-bit fields
of one int32, the block's int32 sums in shared memory, the flush into the
int64 output, reads and length_sum from the first tile only), including
chunks that a batch leaves partial; `adapter_kernel_model` (a warp per
read: rounds of 32 start positions with the lowest matching lane winning,
the early exit past the allowance, C's division, the fallbacks top down in
rounds of 32 lengths, the two-pass one-insertion test).  On the CPU the
dispatching names never reach the kernels' loader; a meta tensor, a wrong
dtype, shape or contiguity raise before a launch.  On a card (marker
`cuda`, skipped here) each kernel is held to its plain version.
"""
import os
import threading

import numpy as np
import pytest
import torch

from fastp_tpu.ops import adapter as j_adapter
from fastp_tpu.ops import stats as j_stats
from fastp_tpu_torch import cuda_build
from fastp_tpu_torch.ops import adapter as t_adapter
from fastp_tpu_torch.ops import adapter_cuda, launches, stats_cuda
from fastp_tpu_torch.ops import stats as t_stats
from fastp_tpu_torch.pipeline import device as t_device
from chip_smoke import PER_BATCH, adapter_rows, random_adapter, stat_rows
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse fixture)
from test_torch_step import CONFIGS, SE_CONFIGS, _cfg, _synth_batch

ADAPTER_R1 = np.frombuffer(b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA", np.uint8)
ADAPTER_LENGTHS = (6, 8, 12, 16, 33, 80)
MATCH_REQS = (4, 5, 6)
WIDTHS = (32, 320, 1056)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def same(got, want):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), \
        np.argwhere(g.astype(np.int64) != w.astype(np.int64))[:5]


def same_stats(got, want):
    assert set(got) == set(want)
    for k in want:
        same(got[k], want[k])


def adapter_of(n, seed=0):
    if n == len(ADAPTER_R1):
        return ADAPTER_R1.copy()
    return random_adapter(np.random.default_rng(100 + n + seed), n)


# --- the plain versions against fastp_tpu -----------------------------------

@pytest.mark.parametrize("L", WIDTHS)
def test_stat_batch_plain_matches_fastp_tpu(L):
    b, q, l, inc = stat_rows(np.random.default_rng(L), 48, L)
    want = j_stats.stat_batch(b, q, l, inc)
    same_stats(t_stats.stat_batch_plain(T(b), T(q), T(l), T(inc)), want)
    none = np.zeros_like(inc)
    got = t_stats.stat_batch_plain(T(b), T(q), T(l), T(none))
    same_stats(got, j_stats.stat_batch(b, q, l, none))
    assert int(got["reads"]) == 0 and int(got["qual_hist"].sum()) == 0


@pytest.mark.parametrize("match_req", MATCH_REQS)
@pytest.mark.parametrize("alen", ADAPTER_LENGTHS)
@pytest.mark.parametrize("L", (32, 320))
def test_trim_by_sequence_plain_matches_fastp_tpu(L, alen, match_req):
    a = adapter_of(alen)
    b, l = adapter_rows(np.random.default_rng(L + alen), 40, L, a)
    got = t_adapter.trim_by_sequence_plain(T(b), T(l), T(a), match_req)
    for g, w in zip(got, j_adapter.trim_by_sequence(b, l, a.tobytes(),
                                                    match_req)):
        same(g, w)


@pytest.mark.parametrize("alen", (33, 80))
def test_trim_by_sequence_plain_matches_fastp_tpu_wide(alen):
    a = adapter_of(alen)
    b, l = adapter_rows(np.random.default_rng(alen), 40, 1056, a)
    got = t_adapter.trim_by_sequence_plain(T(b), T(l), T(a), 4)
    for g, w in zip(got, j_adapter.trim_by_sequence(b, l, a.tobytes(), 4)):
        same(g, w)


# --- a model of csrc/stat_batch.cu ------------------------------------------

_VAL = np.full(256, -1, np.int64)
for _v, _b in enumerate(b"ATCG"):
    _VAL[_b] = _v


def stat_kernel_model(bases, quals, lengths, include, rows_per_block=None):
    """csrc/stat_batch.cu step for step: returns the int64 output buffer."""
    B, L = bases.shape
    tiles, chunks, rows = stats_cuda.geometry(B, L, rows_per_block)
    out = np.zeros(stats_cuda.out_size(L), np.int64)
    tail = stats_cuda.COLUMN_VALUES * L
    for ty in range(chunks):
        r0, r1 = ty * rows, min(ty * rows + rows, B)
        for tx in range(tiles):
            p = tx * 32 + np.arange(32)
            column = p < L
            pc = np.minimum(p, max(L - 1, 0))
            s_column = np.zeros((stats_cuda.COLUMN_VALUES, 32), np.int64)
            s_qual = np.zeros(128, np.int64)
            s_kmer = np.zeros(1024, np.int64)
            for warp in range(stats_cuda.WARPS):
                walked = range(r0 + warp, r1, stats_cuda.WARPS)
                assert len(walked) <= 1023      # a 10-bit field holds it
                packed = np.zeros((8, 32), np.int64)
                qual_sum = np.zeros((8, 32), np.int64)
                total_base = np.zeros(32, np.int64)
                total_qual = np.zeros(32, np.int64)
                for r in walked:
                    rlen, inc = int(lengths[r]), bool(include[r])
                    if tx == 0 and inc:         # lane 0 of the first tile
                        out[tail + 128 + 2048] += 1
                        out[tail + 128 + 2049] += rlen
                    live = inc & column & (p < rlen)
                    if not live.any():
                        continue
                    b = bases[r, pc].astype(np.int64)
                    q = quals[r, pc].astype(np.int64)
                    add = (1 | (q >= ord("5")).astype(np.int64) << 10
                           | (q >= ord("?")).astype(np.int64) << 20)
                    for s in range(8):
                        hit = live & ((b & 7) == s)
                        packed[s] += np.where(hit, add, 0)
                        qual_sum[s] += np.where(hit, q - 33, 0)
                    total_base += live
                    total_qual += np.where(live, q - 33, 0)
                    np.add.at(s_qual, np.minimum(q, 127)[live], 1)
                    key = _VAL[b]
                    ok = live & (p >= 4) & (key >= 0)
                    for back in range(1, 5):
                        v = _VAL[bases[r, np.maximum(pc - back, 0)]]
                        ok &= v >= 0
                        key = key + (v << (2 * back))
                    np.add.at(s_kmer, key[ok], 1)
                assert (packed < 1 << 30).all()
                for s in range(8):
                    s_column[s] += packed[s] & 1023
                    s_column[8 + s] += (packed[s] >> 10) & 1023
                    s_column[16 + s] += packed[s] >> 20
                    s_column[24 + s] += qual_sum[s]
                s_column[32] += total_base
                s_column[33] += total_qual
            assert (np.abs(s_column) < 2 ** 31).all()   # int32 in the block
            for j in range(stats_cuda.COLUMN_VALUES):
                out[j * L + p[column]] += s_column[j, column]
            out[tail:tail + 128] += s_qual
            out[tail + 128:tail + 128 + 1024] += s_kmer
    return out


@pytest.mark.parametrize("B,L,rows", [
    (37, 160, 5),      # the last chunk partial, warps with no row
    (64, 70, None),    # the default geometry, a partial column tile
    (20, 1056, 7),     # 33 column tiles
    (1, 32, None),
    (130, 320, 48),
])
def test_stat_kernel_model_matches_plain(B, L, rows):
    b, q, l, inc = stat_rows(np.random.default_rng(B * L), B, L)
    out = stat_kernel_model(b, q, l, inc, rows)
    got = stats_cuda.split_output(torch.from_numpy(out), L)
    same_stats(got, t_stats.stat_batch_plain(T(b), T(q), T(l), T(inc)))
    none = np.zeros_like(inc)
    got = stats_cuda.split_output(torch.from_numpy(
        stat_kernel_model(b, q, l, none, rows)), L)
    same_stats(got, t_stats.stat_batch_plain(T(b), T(q), T(l), T(none)))


@pytest.mark.parametrize("B,L", [(8192, 160), (8192, 320), (1, 32), (8197, 1056),
                                 (1_000_000, 160), (0, 160)])
def test_stat_geometry_covers_the_batch(B, L):
    tiles, chunks, rows = stats_cuda.geometry(B, L)
    assert tiles == max(1, -(-L // 32))
    assert chunks * rows >= B and (chunks - 1) * rows < max(B, 1)
    assert -(-rows // stats_cuda.WARPS) <= 1023 and chunks <= 65535
    if B >= 8192:
        assert tiles * chunks >= 132        # every SM of the H100 has a block


# --- a model of csrc/adapter_match.cu ---------------------------------------

def _c_div8(x):
    """csrc/adapter_match.cu: floor_div8, in C's integer division."""
    return int(x / 8) if x >= 0 else -int((7 - x) / 8)


def adapter_kernel_model(bases, lengths, adapter, match_req):
    """csrc/adapter_match.cu step for step; returns (new_len, found, pos,
    phase) with phase 1 for a Hamming match, 2 and 3 for the insertion and
    deletion fallbacks, 0 for none."""
    B, L = bases.shape
    ad = [int(x) for x in adapter]
    alen = len(ad)
    start = -4 if alen >= 16 else -3 if alen >= 12 else -2 if alen >= 8 else 0
    out = np.zeros((4, B), np.int64)
    for r in range(B):
        row = bases[r]
        rlen = int(lengths[r])

        def at(j):
            return int(row[j]) if j < L else 0

        def hamming(p, cmplen, allowed):
            if allowed < 0:
                return False
            mm = 0
            for i in range(max(0, -p), cmplen):
                mm += at(p + i) != ad[i]
                if mm > allowed:
                    return False
            return True

        def one_insertion(insertion, cl, limit):
            if cl < 2 or limit < 0:
                return False
            ins = at if insertion else (lambda j: ad[j])
            norm = (lambda j: ad[j]) if insertion else at
            right_total = sum(ins(j + 1) != norm(j) for j in range(cl))
            right_last = ins(cl) != norm(cl - 1)
            left = right_before = 0
            for i in range(1, cl):
                left += ins(i - 1) != norm(i - 1)
                right_before += ins(i) != norm(i - 1)
                if left + right_last > limit:
                    return False
                if left + (right_total - right_before) <= limit:
                    return True
            return False

        def fallback(insertion):
            top = min(rlen - 1, alen) if insertion else min(rlen, alen - 1)
            best = -1
            hi = top
            while hi >= 8:
                votes = [lane for lane in range(32) if hi - lane >= 8
                         and one_insertion(insertion, hi - lane,
                                           (hi - lane) // 8 - 1)]
                if votes:
                    best = hi - min(votes)
                    break
                hi -= 32
            if best < 0:
                return None
            p = 0 if best == top else (rlen - 1 - best if insertion
                                       else rlen - best)
            p_limit = rlen - match_req - (1 if insertion else 0)
            if p < 0 or p >= p_limit or p_limit <= 0:
                return None
            return p

        found, pos, phase = False, 0, 0
        p_end = min(L, rlen) - match_req
        base = start
        while base < p_end:
            votes = [lane for lane in range(32) if base + lane < p_end
                     and hamming(base + lane, min(rlen - base - lane, alen),
                                 _c_div8(min(rlen - base - lane, alen)))]
            if votes:
                found, pos, phase = True, base + min(votes), 1
                break
            base += 32
        for insertion, ph in ((True, 2), (False, 3)):
            if not found:
                p = fallback(insertion)
                if p is not None:
                    found, pos, phase = True, p, ph
        new_len = rlen if not found else 0 if pos < 0 else min(pos, rlen)
        out[:, r] = (new_len, found, pos, phase)
    return out


@pytest.mark.parametrize("match_req", MATCH_REQS)
@pytest.mark.parametrize("alen", ADAPTER_LENGTHS)
def test_adapter_kernel_model_matches_plain(alen, match_req):
    a = adapter_of(alen, seed=1)
    L = 160 if alen < 80 else 320
    b, l = adapter_rows(np.random.default_rng(7 * alen + match_req), 72, L, a)
    new_len, found, pos, phase = adapter_kernel_model(b, l, a, match_req)
    want = t_adapter.trim_by_sequence_plain(T(b), T(l), T(a), match_req)
    for g, w in zip((new_len, found, pos), want):
        same(w, g)
    assert (phase == 1).any()
    if alen >= 12:   # the rows planted with one base in or out reach both
        assert (phase == 2).any() and (phase == 3).any()


def test_adapter_kernel_model_on_the_bench_rows():
    """The main path's reads (tools/make_synth.py pairs, R1 with its
    read-through adapter) through the model and the plain version."""
    b, _, l = _synth_batch(5, B=96)[:3]
    new_len, found, pos, phase = adapter_kernel_model(b, l, ADAPTER_R1, 4)
    want = t_adapter.trim_by_sequence_plain(T(b), T(l), T(ADAPTER_R1), 4)
    for g, w in zip((new_len, found, pos), want):
        same(w, g)
    assert (phase == 1).sum() > 5


# --- the dispatch and the wrappers' checks ----------------------------------

@pytest.fixture
def no_loader(monkeypatch):
    """The kernels' loader raises: nothing may reach it."""
    def refuse(*args, **kw):
        raise AssertionError("the kernel loader was reached")
    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "function", refuse)


def test_on_the_cpu_the_plain_versions_run(no_loader):
    b, q, l, inc = stat_rows(np.random.default_rng(3), 40, 96)
    before = launches.snapshot()
    same_stats(t_stats.stat_batch(T(b), T(q), T(l), T(inc)),
               t_stats.stat_batch_plain(T(b), T(q), T(l), T(inc)))
    a = adapter_of(33)
    rows, lens = adapter_rows(np.random.default_rng(4), 40, 96, a)
    for g, w in zip(t_adapter.trim_by_sequence(T(rows), T(lens), T(a)),
                    t_adapter.trim_by_sequence_plain(T(rows), T(lens), T(a))):
        same(g, w)
    assert launches.snapshot() == before


def test_a_meta_tensor_raises(no_loader):
    b = torch.zeros((4, 32), dtype=torch.uint8, device="meta")
    l = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="meta"):
        t_stats.stat_batch(b, b, l, torch.ones(4, dtype=torch.bool,
                                               device="meta"))
    with pytest.raises(ValueError, match="meta"):
        t_adapter.trim_by_sequence(b, l, torch.zeros(8, dtype=torch.uint8,
                                                     device="meta"))


def test_the_cuda_wrappers_refuse_cpu_tensors(no_loader):
    b = torch.zeros((4, 32), dtype=torch.uint8)
    l = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        stats_cuda.stat_batch_cuda(b, b, l, torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="CUDA"):
        adapter_cuda.trim_by_sequence_cuda(b, l, torch.zeros(8, dtype=torch.uint8))


def _stat_args():
    b = torch.zeros((6, 40), dtype=torch.uint8)
    return b, b.clone(), torch.zeros(6, dtype=torch.int16), \
        torch.ones(6, dtype=torch.bool)


@pytest.mark.parametrize("which,bad,error", [
    (0, lambda t: t.to(torch.int32), TypeError),
    (1, lambda t: t[:, :20], ValueError),
    (1, lambda t: torch.zeros((40, 6), dtype=torch.uint8).T, ValueError),
    (2, lambda t: t.float(), TypeError),
    (2, lambda t: t[:5], ValueError),
    (3, lambda t: t.to(torch.uint8), TypeError),
    (3, lambda t: t[:3], ValueError),
    (0, lambda t: t[0], ValueError),
])
def test_stat_inputs_are_checked(which, bad, error):
    args = list(_stat_args())
    args[which] = bad(args[which])
    with pytest.raises(error):
        stats_cuda.kernel_inputs(*args)


@pytest.mark.parametrize("which,bad,error", [
    (0, lambda t: t.to(torch.int8), TypeError),
    (0, lambda t: torch.zeros((40, 6), dtype=torch.uint8).T, ValueError),
    (1, lambda t: t.to(torch.float64), TypeError),
    (1, lambda t: t[:2], ValueError),
    (2, lambda t: t.to(torch.int32), TypeError),
    (2, lambda t: t.reshape(2, 4), ValueError),
    (2, lambda t: torch.zeros(16, dtype=torch.uint8)[::2], ValueError),
])
def test_adapter_inputs_are_checked(which, bad, error):
    args = [torch.zeros((6, 40), dtype=torch.uint8),
            torch.zeros(6, dtype=torch.int32), torch.zeros(8, dtype=torch.uint8)]
    args[which] = bad(args[which])
    with pytest.raises(error):
        adapter_cuda.kernel_inputs(*args)


def test_the_inputs_are_converted_on_their_device():
    b, q, l, inc = _stat_args()
    got = stats_cuda.kernel_inputs(b, q, l, inc)
    assert got[2].dtype == torch.int32 and got[2].is_contiguous()
    assert got[0] is b and got[1] is q and got[3] is inc
    a = torch.zeros(8, dtype=torch.uint8)
    got = adapter_cuda.kernel_inputs(b, l, a)
    assert got[1].dtype == torch.int32 and got[2] is a   # no copy of it


def _checking(monkeypatch, seen):
    """Dispatching names that check what each call site passes as the CUDA
    wrappers would, then run the plain version."""
    plain_stats, plain_trim = t_stats.stat_batch_plain, t_adapter.trim_by_sequence_plain

    def stat_batch(bases, quals, lengths, include):
        stats_cuda.kernel_inputs(bases, quals, lengths, include)
        seen["stat_batch"] += 1
        return plain_stats(bases, quals, lengths, include)

    def trim_by_sequence(bases, lengths, adapter, match_req=4):
        adapter_cuda.kernel_inputs(bases, lengths, adapter)
        seen["trim_by_sequence"] += 1
        return plain_trim(bases, lengths, adapter, match_req)

    monkeypatch.setattr(t_stats, "stat_batch", stat_batch)
    monkeypatch.setattr(t_adapter, "trim_by_sequence", trim_by_sequence)


# the step configs of chip_smoke.py's paths, whose calls per batch (a kernel
# launch each on the card) are chip_smoke.PER_BATCH's: bench = main, cfg8 =
# failed, merge's device flags, gap, and the SE default with an adapter;
# then the configs no path of chip_smoke.py runs, with their own counts
# (stat_batch, trim_by_sequence)
SMOKE_PATHS = {("pe", "bench"): "main", ("pe", "cfg8"): "failed",
               ("pe", "merge"): "merge", ("pe", "gap"): "gap",
               ("se", "bench"): "se"}
OTHER_CALLS_PER_BATCH = {("pe", "merge_unmerged"): (7, 0),
                         ("pe", "fasta"): (4, 4), ("se", "fasta"): (2, 2)}


def _calls_per_batch(kind, name):
    path = SMOKE_PATHS.get((kind, name))
    if path is None:
        return OTHER_CALLS_PER_BATCH[kind, name]
    return (PER_BATCH[path]["stat_batch"], PER_BATCH[path]["trim_by_sequence"])


@pytest.mark.parametrize("kind,name",
                         sorted(set(SMOKE_PATHS) | set(OTHER_CALLS_PER_BATCH)))
def test_every_call_site_passes_what_the_kernels_take(monkeypatch, tmp_path,
                                                       kind, name):
    seen = dict.fromkeys(launches.KERNELS, 0)
    _checking(monkeypatch, seen)
    paired = kind == "pe"
    flags = (CONFIGS if paired else SE_CONFIGS)[name]
    cfg = _cfg(flags, True, paired=paired, tmp_path=tmp_path)
    build = t_device.build_pe_step if paired else t_device.build_se_step
    batch = _synth_batch(17, B=64, nvalid=60)
    batch = batch if paired else batch[:3]
    build(cfg, "cpu")(*batch, *t_device.make_aux(cfg, 60))
    assert (seen["stat_batch"], seen["trim_by_sequence"]) == \
        _calls_per_batch(kind, name)


# --- the tally of launches ---------------------------------------------------

def test_the_tally_counts_each_kernel_once_per_call():
    before = launches.snapshot()
    for name in launches.KERNELS:
        launches.count(name)
    launches.count("stat_batch")
    assert launches.since(before) == {"overlap_sweep": 1, "stat_batch": 2,
                                      "trim_by_sequence": 1}


def test_uncounted_launches_are_tallied_and_replays_counted():
    before = launches.snapshot()
    with launches.uncounted() as tally:
        launches.count("stat_batch")
        launches.count("trim_by_sequence")
        with launches.uncounted() as inner:
            launches.count("stat_batch")
        assert inner["stat_batch"] == 1
        launches.count("stat_batch")
    assert tally == {"overlap_sweep": 0, "stat_batch": 2, "trim_by_sequence": 1}
    assert launches.snapshot() == before           # nothing counted
    for _ in range(3):
        launches.count_replayed(tally)
    assert launches.since(before) == {"overlap_sweep": 0, "stat_batch": 6,
                                      "trim_by_sequence": 3}


def test_an_uncounted_block_tallies_its_own_thread_only():
    before = launches.snapshot()
    with launches.uncounted() as tally:
        t = threading.Thread(target=launches.count, args=("overlap_sweep",))
        t.start()
        t.join()
        launches.count("overlap_sweep")
    assert tally["overlap_sweep"] == 1
    assert launches.since(before)["overlap_sweep"] == 1


def test_the_library_names():
    assert cuda_build.KERNEL_LIBS == ("overlap_sweep", "stat_batch",
                                      "adapter_match")
    for name in cuda_build.KERNEL_LIBS:
        assert cuda_build.library_path(name).endswith(".so")


FAKE_NVCC = """#!/bin/sh
out=""; src=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; *.cu) src="$1";; esac
  shift
done
echo "ptxas info: $src" >&2
case "$src" in *bad.cu) exit 1;; esac
cp "$src" "$out"
"""


def test_the_builds_start_together_and_a_failure_raises(monkeypatch,
                                                        tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC)
    nvcc.chmod(0o755)
    build_dir = tmp_path / "build"
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(build_dir))
    monkeypatch.setattr(cuda_build, "build_logs", {})
    sources = {}
    for name in ("one", "two"):
        sources[name] = str(tmp_path / (name + ".cu"))
        (tmp_path / (name + ".cu")).write_text("// " + name)
    seconds = cuda_build._build(sources)
    assert set(seconds) == {"one", "two"}
    for name, source in sources.items():
        with open(cuda_build.library_path(name, source)) as f:
            assert f.read() == "// " + name
        assert "ptxas info" in cuda_build.build_logs[name]
    (tmp_path / "bad.cu").write_text("x")
    with pytest.raises(RuntimeError, match="nvcc failed for .*bad.cu"):
        cuda_build._build({"bad": str(tmp_path / "bad.cu"),
                           "one": sources["one"]})
    assert sorted(os.listdir(build_dir)) == sorted(
        os.path.basename(cuda_build.library_path(n, s))
        for n, s in sources.items())    # no temporary file is left


# --- on the card --------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("B,L", [(8192, 160), (8197, 320), (1, 32), (37, 1056)])
def test_stat_kernel_matches_plain_on_card(B, L):
    _card()
    b, q, l, inc = (T(x).cuda() for x in stat_rows(np.random.default_rng(B), B, L))
    for include in (inc, torch.zeros_like(inc)):
        before = launches.snapshot()
        got = stats_cuda.stat_batch_cuda(b, q, l, include)
        torch.cuda.synchronize()
        assert launches.since(before)["stat_batch"] == 1
        want = t_stats.stat_batch_plain(b, q, l, include)
        for k in want:
            assert torch.equal(got[k].cpu(), want[k].cpu()), k


@pytest.mark.cuda
@pytest.mark.parametrize("match_req", MATCH_REQS)
@pytest.mark.parametrize("alen", ADAPTER_LENGTHS)
def test_adapter_kernel_matches_plain_on_card(alen, match_req):
    _card()
    a = T(adapter_of(alen)).cuda()
    for B, L in ((8197, 160), (1, 32), (300, 1056)):
        rows, lens = adapter_rows(np.random.default_rng(B + alen), B, L,
                                  a.cpu().numpy())
        rows, lens = T(rows).cuda(), T(lens).cuda()
        got = adapter_cuda.trim_by_sequence_cuda(rows, lens, a, match_req)
        torch.cuda.synchronize()
        want = t_adapter.trim_by_sequence_plain(rows, lens, a, match_req)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
