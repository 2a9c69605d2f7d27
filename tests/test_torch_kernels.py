"""The port's two kernels for XLA ops, stat_batch (csrc/stat_batch.cu) and
trim_by_sequence (csrc/adapter_match.cu), and the launch tally of all the
port's kernels (fastp_tpu_torch/ops/launches.py; the overlap kernel's
models are in tests/test_torch_overlap.py, its gapped variant's check on
the card here).

The plain versions (ops/stats.py:stat_batch_plain,
ops/adapter.py:trim_by_sequence_plain), the kernels' references, are held
exactly to fastp_tpu's stat_batch and trim_by_sequence on chip_smoke.py's
adversarial rows: every byte value as a base, qualities below 33 and at or
above 128, lengths 0 and L, reads excluded, widths 32, 320 and 1,056;
adapters of 6, 8, 12, 16, 33 and 80 bases at match_req 4, 5 and 6, on rows
built to reach the insertion and the deletion fallbacks.

The kernels cannot run without a card, so their arithmetic is modelled
here step for step and held exactly to the plain versions:
`stat_kernel_model` (numpy: column tiles of 32 lanes, chunks of at most 128
rows, a thread's counts of a slot pair as 16-bit fields, the block's sums
as 10-bit fields, the 2-bit base codes and the 5-mer key rolling along a
16-cycle segment, the cluster's sums in int32, the int64 accumulator and
its ticket, which the last cluster turns into the output and leaves at 0,
whatever order the clusters finish in), including chunks that a batch
leaves partial; `adapter_kernel_model` (a warp per read: the staged read
with its zero pad, rounds of 32 start positions compared a 32-bit word at a
time with masks for the bytes before the read and past cmplen, the warp's
stop once every lane is past its allowance, C's division, the fallbacks
from one prefix pass of both roles, top down in rounds of 32 lengths).  A
hypothesis test holds the fallbacks' O(1) prefix form to the serial loop
and to fastp_tpu's tables in both roles.  On the CPU the dispatching names
never reach the kernels' loader; a meta tensor, a wrong dtype, shape or
contiguity raise before a launch.  On a card (marker `cuda`, skipped here)
each kernel is held to its plain version.
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


def base_codes(words):
    """csrc/stat_batch.cu:base_codes on uint32 words (four bases each): the
    2-bit code from bits 1 and 2 of each byte, 0x80 for a byte that is not
    A, C, G or T."""
    x = np.asarray(words, np.uint32)
    v = (((x >> 1) & 0x01010101) << 1) | ((x >> 2) & 0x01010101)
    acgt = np.zeros_like(x)
    for ch in b"ACGT":
        for k in range(4):
            hit = ((x >> (8 * k)) & 0xFF) == ch
            acgt |= np.where(hit, np.uint32(0xFF << (8 * k)), np.uint32(0))
    return (v | (~acgt & np.uint32(0x80808080))).astype(np.uint32)


def _codes_of(b):
    """The staged bytes' codes, as the kernel's word pass makes them."""
    flat = np.ascontiguousarray(b, np.uint8)
    pad = (-flat.shape[-1]) % 4
    flat = np.pad(flat, [(0, 0)] * (flat.ndim - 1) + [(0, pad)])
    words = flat.view("<u4")
    out = base_codes(words).view(np.uint8)
    return out[..., :b.shape[-1]].astype(np.int64)


def stat_block_partials(bases, quals, lengths, include, tx, r0, r1):
    """One block of csrc/stat_batch.cu: column tile tx, rows [r0, r1).
    Returns its int32 partials (PARTIALS values)."""
    B, L = bases.shape
    c0 = tx * 32
    lane = np.arange(32)
    p = c0 + lane
    part = np.zeros(stats_cuda.PARTIALS, np.int64)
    rows = np.arange(r0, r1)
    if tx == 0 and len(rows):       # reads and length_sum, the first tile
        inc = include[rows].astype(bool)
        part[-2] = inc.sum()
        part[-1] = lengths[rows][inc].astype(np.int64).sum()
    if not len(rows):
        return part
    assert len(rows) <= stats_cuda.MAX_ROWS
    # a thread walks every WARPS-th row: its counts fit 5-bit fields and its
    # raw quality sums 16-bit ones
    assert -(-len(rows) // stats_cuda.WARPS) <= 31
    assert -(-len(rows) // stats_cuda.WARPS) * 255 <= 0xFFFF
    live = (include[rows].astype(bool)[:, None] & (p < L)[None, :]
            & (p[None, :] < lengths[rows][:, None]))
    # the staged chunk: 16 bases before the tile (the halo), the tile's
    # bases and qualities; the kernel never reads a staged byte outside the row
    halo_cols = np.arange(c0 - 16, c0 + 32)
    inside = (halo_cols >= 0) & (halo_cols < L)
    # what the kernel never loads is any byte on the card: here ACGT, so that
    # it would count if it were read
    staged = np.random.default_rng(r0 + tx).choice(
        np.frombuffer(b"ACGT", np.uint8), (len(rows), 48))
    staged[:, inside] = bases[rows][:, halo_cols[inside]]
    codes = _codes_of(staged)
    b = staged[:, 16:].astype(np.int64)
    q = np.zeros((len(rows), 32), np.int64)
    q[:, p < L] = quals[rows][:, p[p < L]]
    slot = b & 7
    packed = 1 | (q >= ord("5")).astype(np.int64) << 10 \
        | (q >= ord("?")).astype(np.int64) << 20
    s_cnt = np.zeros((8, 32), np.int64)
    s_qs = np.zeros((8, 32), np.int64)
    lanes = np.broadcast_to(lane, live.shape)
    np.add.at(s_cnt, (slot[live], lanes[live]), packed[live])
    np.add.at(s_qs, (slot[live], lanes[live]), q[live] - 33)
    for field in range(3):          # each count fits its 10-bit field
        assert ((s_cnt >> (10 * field)) & 1023 == (s_cnt >> (10 * field))
                - ((s_cnt >> (10 * field + 10)) << 10)).all()
    assert (s_cnt < 1 << 30).all()
    # the histograms: a thread per row and 16-cycle segment, the 5-mer key
    # rolling along it from the staged codes (4 before the segment), a run
    # of equal bins added at once
    s_qual = np.zeros(128, np.int64)
    s_kmer = np.zeros(1024, np.int64)
    for i, r in enumerate(rows):
        for seg in range(2):
            p0 = c0 + 16 * seg
            end = (min(L, int(lengths[r]), p0 + 16) if include[r] else p0)
            if p0 >= end:
                continue
            seg_codes = codes[i, 12 + 16 * seg:32 + 16 * seg]
            key = run = 0
            for c in seg_codes[:4]:
                key = ((key << 2) | (c & 3)) & 1023
                run = 0 if c & 0x80 else run + 1
            for j, c in enumerate(seg_codes[4:]):
                key = ((key << 2) | (c & 3)) & 1023
                run = 0 if c & 0x80 else run + 1
                if p0 + j < end:
                    s_qual[min(int(quals[r, p0 + j]), 127)] += 1
                    if run >= 5 and p0 + j >= 4:
                        s_kmer[key] += 1
    for j in range(32):
        ch, sl = divmod(j, 8)
        part[j * 32:(j + 1) * 32] = ((s_cnt[sl] >> (10 * ch)) & 1023
                                     if ch < 3 else s_qs[sl])
    part[1024:1152] = s_qual
    part[1152:2176] = s_kmer
    assert (np.abs(part) < 2 ** 31).all()          # int32 in the block
    return part


def stat_kernel_model(bases, quals, lengths, include, rows_per_block=None,
                      cluster=stats_cuda.CLUSTER, acc=None, order=None):
    """csrc/stat_batch.cu step for step: every block's partials, their
    sums over a cluster of `cluster` chunks of one tile (int32; each block
    sums a slice), the non-zero sums added to the int64 accumulator `acc`
    and a ticket taken by each block, cluster by cluster in `order` (a
    permutation of the clusters; the card's is any), and the cluster that
    holds the last ticket writing the output buffer and setting the
    accumulator and the ticket back to 0.  Returns the output."""
    B, L = bases.shape
    tiles, chunks, rows = stats_cuda.geometry(B, L, cluster, rows_per_block)
    assert chunks % cluster == 0 and rows <= stats_cuda.MAX_ROWS
    if acc is None:
        acc = np.zeros(stats_cuda.acc_size(L), np.int64)
    assert len(acc) == stats_cuda.acc_size(L) and not acc.any()
    tail = 32 * L
    clusters = [(tx, g) for tx in range(tiles) for g in range(chunks // cluster)]
    if order is not None:
        clusters = [clusters[i] for i in order]
    out = None
    for tx, g in clusters:
        part = np.zeros(stats_cuda.PARTIALS, np.int64)
        for ty in range(g * cluster, (g + 1) * cluster):
            r0 = ty * rows
            part += stat_block_partials(bases, quals, lengths, include, tx,
                                        min(r0, B), min(r0 + rows, B))
        assert (np.abs(part) < 2 ** 31).all()      # int32 in the cluster
        for i in np.flatnonzero(part):
            if i < 1024:
                pc = tx * 32 + i % 32
                if pc < L:
                    acc[(i // 32) * L + pc] += part[i]
            else:
                acc[tail + i - 1024] += part[i]
        ticket = acc[-1]           # each block of the cluster takes one
        acc[-1] += cluster
        if ticket + cluster == tiles * chunks:  # the last: every output value
            cyc = acc[:tail].reshape(32, L)
            out = np.concatenate([
                acc[:tail], cyc[0:8].sum(0), cyc[24:32].sum(0),
                acc[tail:tail + 128 + 1024], np.zeros(1024, np.int64),
                acc[tail + 1152:tail + 1154]])
            acc[:] = 0
    assert out is not None and len(out) == stats_cuda.out_size(L)
    assert not acc.any()           # the next launch starts from zero
    return out


def test_base_codes_of_every_byte():
    words = np.arange(256, dtype=np.uint32) * 0x01010101
    got = base_codes(words) & 0xFF
    for b in range(256):
        want = _VAL[b] if _VAL[b] >= 0 else None
        if want is None:
            assert got[b] & 0x80, b
        else:
            assert got[b] == want, (b, got[b])
    text = b"ACGTNacg\x00\xffTG"
    got = base_codes(np.frombuffer(text, np.uint8).view("<u4")).view(np.uint8)
    for b, c in zip(text, got):
        assert (c & 0x80 == 0 and c == _VAL[b]) if _VAL[b] >= 0 else c & 0x80


@pytest.mark.parametrize("B,L,rows,cluster", [
    (37, 160, 5, 8),      # the last cluster partial, warps with no row
    (64, 70, None, 8),    # the default geometry, a partial column tile, L % 16
    (20, 1056, 7, 2),     # 33 column tiles
    (1, 32, None, 8),
    (130, 320, 48, 1),
    (300, 160, None, 4),
])
def test_stat_kernel_model_matches_plain(B, L, rows, cluster):
    b, q, l, inc = stat_rows(np.random.default_rng(B * L), B, L)
    out = stat_kernel_model(b, q, l, inc, rows, cluster)
    got = stats_cuda.split_output(torch.from_numpy(out), L)
    same_stats(got, t_stats.stat_batch_plain(T(b), T(q), T(l), T(inc)))
    none = np.zeros_like(inc)
    got = stats_cuda.split_output(torch.from_numpy(
        stat_kernel_model(b, q, l, none, rows, cluster)), L)
    same_stats(got, t_stats.stat_batch_plain(T(b), T(q), T(l), T(none)))


def test_stat_accumulator_serves_launch_after_launch():
    """One accumulator for two launches in a row, the clusters finishing in
    another order each time: the same output, and zero after each."""
    b, q, l, inc = stat_rows(np.random.default_rng(5), 90, 96)
    acc = np.zeros(stats_cuda.acc_size(96), np.int64)
    n = stats_cuda.geometry(90, 96, 2, 11)
    clusters = n[0] * n[1] // 2
    outs = [stat_kernel_model(b, q, l, inc, 11, 2, acc, order)
            for order in (None, np.random.default_rng(1).permutation(clusters))]
    assert np.array_equal(outs[0], outs[1])
    same_stats(stats_cuda.split_output(torch.from_numpy(outs[1]), 96),
               t_stats.stat_batch_plain(T(b), T(q), T(l), T(inc)))


@pytest.mark.parametrize("B,L", [(8192, 160), (8192, 320), (1, 32), (8197, 1056),
                                 (1_000_000, 160), (0, 160)])
def test_stat_geometry_covers_the_batch(B, L):
    tiles, chunks, rows = stats_cuda.geometry(B, L)
    assert tiles == max(1, -(-L // 32))
    assert chunks * rows >= B and chunks % stats_cuda.CLUSTER == 0
    assert (chunks - stats_cuda.CLUSTER) * rows < max(B, 1)
    assert rows <= stats_cuda.MAX_ROWS <= 1023 and chunks <= 65535
    if B >= 8192:
        assert tiles * chunks >= 2 * 132     # two blocks for each SM of the H100
    for cluster in (1, 2, 4, 8):
        assert stats_cuda.geometry(B, L, cluster)[1] % cluster == 0


# --- a model of csrc/adapter_match.cu ---------------------------------------

def _c_div8(x):
    """csrc/adapter_match.cu: floor_div8, in C's integer division."""
    return int(x / 8) if x >= 0 else -int((7 - x) / 8)


def byte_mask(lo, hi):
    """csrc/adapter_match.cu:byte_mask: bytes [lo, hi) of a word."""
    below_hi = (1 << (8 * hi)) - 1
    below_lo = (1 << (8 * lo)) - 1
    return (below_hi & ~below_lo) & 0xFFFFFFFF if hi > lo else 0


def differs(x, y):
    """csrc/adapter_match.cu's byte-wise compare of two words: the high bit
    of every byte that differs."""
    x ^= y
    return (((x & 0x7F7F7F7F) + 0x7F7F7F7F) | x) & 0x80808080


def word_at(buf, off):
    """The staged buffer's little-endian word at any byte offset (two
    aligned words and a funnel shift)."""
    lo = int.from_bytes(bytes(buf[off & ~3:(off & ~3) + 4]), "little")
    hi = int.from_bytes(bytes(buf[(off & ~3) + 4:(off & ~3) + 8]), "little")
    return ((hi << 32 | lo) >> (8 * (off & 3))) & 0xFFFFFFFF


def prefix_tables(row, ad, top, top_del):
    """csrc/adapter_match.cu:prefix_tables, both roles in one pass over
    j < top (the deletion's to top_del): (kth, D1 and M of the insertion,
    D1 and M of the deletion), with M[m] = min over 1 <= i < m of
    D0[i] - D1[i]."""
    far = 1 << 30
    n = max(top, top_del) + 2
    d1i, mi, d1d, md = [0] * n, [far] * n, [0] * n, [far] * n
    kth = []
    D0 = Di = Dd = 0
    run_i = run_d = far
    for j in range(top):
        r0, r1 = int(row[16 + j]), int(row[16 + j + 1])
        a0, a1 = int(ad[j]), int(ad[j + 1])
        d0 = r0 != a0
        if d0:
            kth.append(j)
        D0 += d0
        Di += r1 != a0
        d1i[j + 1] = Di
        run_i = min(run_i, D0 - Di)
        mi[j + 2] = run_i
        if j < top_del:
            Dd += a1 != r0
            d1d[j + 1] = Dd
            run_d = min(run_d, D0 - Dd)
            md[j + 2] = run_d
    return kth, d1i, mi, d1d, md


def one_insertion_prefix(cl, limit, d1s, mins, kth):
    """csrc/adapter_match.cu:one_insertion: the serial loop's answer from
    the tables."""
    if cl < 2 or limit < 0:
        return False
    t = limit - (d1s[cl] - d1s[cl - 1])
    f = 1 if t < 0 else kth[t] + 1 if t < len(kth) else 1 << 30
    m = min(f, cl)
    return m >= 2 and mins[m] <= limit - d1s[cl]


def one_insertion_serial(ins, norm, cl, limit):
    """Matcher::matchWithOneInsertion as the kernel of commit 1877111 ran it: the serial
    loop, fail test first."""
    if cl < 2 or limit < 0:
        return False
    right_total = sum(ins[j + 1] != norm[j] for j in range(cl))
    right_last = ins[cl] != norm[cl - 1]
    left = right_before = 0
    for i in range(1, cl):
        left += ins[i - 1] != norm[i - 1]
        right_before += ins[i] != norm[i - 1]
        if left + right_last > limit:
            return False
        if left + (right_total - right_before) <= limit:
            return True
    return False


def adapter_kernel_model(bases, lengths, adapter, match_req):
    """csrc/adapter_match.cu step for step (a warp's adapter and staged
    read, the word compares with their masks and the warp's early stop, the
    prefix tables of both fallbacks); returns (new_len, found, pos, phase)
    with phase 1 for a Hamming match, 2 and 3 for the insertion and
    deletion fallbacks, 0 for none."""
    B, L = bases.shape
    alen = len(adapter)
    g = adapter_cuda.geometry(B, L, alen)
    ad = np.zeros(g["ad_bytes"], np.uint8)
    ad[:alen] = adapter
    words = -(-alen // 4)
    ad_words = [int.from_bytes(bytes(ad[4 * w:4 * w + 4]), "little")
                for w in range(words)]
    start = -4 if alen >= 16 else -3 if alen >= 12 else -2 if alen >= 8 else 0
    out = np.zeros((4, B), np.int64)
    for r in range(B):
        row = np.zeros(g["row_bytes"], np.uint8)   # 16 zeros, the read, zeros
        row[16:16 + L] = bases[r]
        rlen = int(lengths[r])
        found, pos, phase = False, 0, 0
        p_end = min(L, rlen) - match_req
        base = start
        while base < p_end:
            mms, allowed = [], []
            for lane in range(32):
                p = base + lane
                cmplen = min(rlen - p, alen)
                allowed.append(_c_div8(cmplen) if p < p_end else -1)
                mms.append(0)
            for w in range(words):
                for lane in range(32):
                    p = base + lane
                    cmplen = min(rlen - p, alen)
                    head = byte_mask(min(max(0, -p), 4), 4) & 0x80808080
                    last = (max(cmplen, 1) - 1) >> 2
                    tail = byte_mask(0, min(max(cmplen - 4 * last, 0), 4)) \
                        & 0x80808080
                    m = 0x80808080 if w < last else tail if w == last else 0
                    if w == 0:
                        m &= head
                    mms[lane] += bin(differs(word_at(row, 16 + p + 4 * w),
                                             ad_words[w]) & m).count("1")
                # the warp checks after every second word
                if w % 2 and all(m > a for m, a in zip(mms, allowed)):
                    break
            votes = [lane for lane in range(32) if mms[lane] <= allowed[lane]]
            if votes:
                found, pos, phase = True, base + min(votes), 1
                break
            base += 32
        if not found:
            top_ins = min(rlen - 1, alen)
            top_del = min(rlen, alen - 1)
            if max(top_ins, top_del) >= 8:
                kth, d1i, mi, d1d, md = prefix_tables(
                    row, ad, max(top_ins, top_del), top_del)
                for insertion, top, d1s, mins, ph in (
                        (True, top_ins, d1i, mi, 2),
                        (False, top_del, d1d, md, 3)):
                    best, hi = -1, top
                    while hi >= 8:
                        votes = [lane for lane in range(32) if hi - lane >= 8
                                 and one_insertion_prefix(
                                     hi - lane, (hi - lane) // 8 - 1, d1s,
                                     mins, kth)]
                        if votes:
                            best = hi - min(votes)
                            break
                        hi -= 32
                    if best < 0:
                        continue
                    p = 0 if best == top else (rlen - 1 - best if insertion
                                               else rlen - best)
                    p_limit = rlen - match_req - (1 if insertion else 0)
                    if p < 0 or p >= p_limit or p_limit <= 0:
                        continue
                    found, pos, phase = True, p, ph
                    break
        new_len = rlen if not found else 0 if pos < 0 else min(pos, rlen)
        out[:, r] = (new_len, found, pos if found else 0, phase)
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


@pytest.mark.parametrize("off", range(8))
def test_word_compares_with_their_edge_masks(off):
    """Four bytes a compare at any alignment, any byte values, masked to
    [lo, hi), count what a byte loop counts."""
    rng = np.random.default_rng(off)
    for alphabet in (np.frombuffer(b"ACGT", np.uint8), np.arange(256)):
        buf = rng.choice(alphabet, 24).astype(np.uint8)
        ref = rng.choice(alphabet, 4).astype(np.uint8)
        ref[rng.integers(0, 4)] = buf[off + 1]     # a byte or two agree
        ref_word = int.from_bytes(bytes(ref), "little")
        for lo in range(5):
            for hi in range(5):
                got = bin(differs(word_at(buf, off), ref_word)
                          & byte_mask(lo, hi)).count("1")
                want = sum(buf[off + k] != ref[k] for k in range(lo, hi))
                assert got == want, (lo, hi)
    for x in (0, 0x80, 0x7F, 0xFF, 0x01, 0xFE):   # the add carries nowhere
        for k in range(4):
            assert differs(x << (8 * k), 0) == (0x80 << (8 * k) if x else 0)


@pytest.mark.parametrize("L,alen", [(8, 33), (160, 6), (1056, 80), (5, 200000)])
def test_adapter_geometry_fits(L, alen):
    g = adapter_cuda.geometry(1000, L, alen)
    per_warp = g["row_bytes"] + 20 * g["table"]
    assert g["row_bytes"] >= 16 + L + alen + 56 and g["row_bytes"] % 16 == 0
    assert g["ad_bytes"] >= alen + 8 and g["table"] >= alen + 2
    assert g["block_bytes"] == g["ad_bytes"] + g["warps"] * per_warp
    assert per_warp % 16 == 0 and g["ad_bytes"] % 16 == 0
    assert 1 <= g["warps"] <= 8
    if g["staged"]:
        assert g["block_bytes"] <= adapter_cuda.SHARED_BYTES
        assert g["blocks"] * g["warps"] >= 1000
    else:
        assert g["ad_bytes"] + per_warp > adapter_cuda.SHARED_BYTES
    assert adapter_cuda.geometry(8192, 160, 33)["staged"]


@pytest.mark.parametrize("name", ["stat_batch", "adapter_match",
                                  "overlap_sweep"])
def test_kernel_variants_apply(name):
    """kernel_variants.py's copies of a kernel define its PHASE marks: the
    source has one mark for each end of a phase the script names, in order,
    and leaves PHASE empty unless a build defines it; each stop is a mark."""
    import kernel_variants
    with open(os.path.join(cuda_build.CSRC, name + ".cu")) as fh:
        text = fh.read()
    n = len(kernel_variants.PHASES[name])
    assert kernel_variants.phase_marks(text) == list(range(n + 1))
    assert "#ifndef PHASE\n#define PHASE(k)\n#endif" in text
    assert all(0 < k < n for _, k in kernel_variants.STOPS[name])
    profiled = kernel_variants.profiled(name)
    assert profiled.index("#define PHASE(k) do") < profiled.index("#ifndef PHASE")


@pytest.mark.parametrize("name", ["overlap_sweep", "stat_batch",
                                  "adapter_match"])
def test_old_kernel_of_another_interface_is_refused(tmp_path, name):
    """--old-kernel takes a stat_batch.cu or adapter_match.cu only with the
    C parameters of commit 1877111's, which its launchers pass, and an
    overlap_sweep.cu only with the current one's: the current stat_batch.cu
    and adapter_match.cu are refused before anything is built or called."""
    import chip_smoke
    with open(os.path.join(cuda_build.CSRC, name + ".cu")) as fh:
        current = fh.read()
    path = tmp_path / (name + "_old.cu")
    path.write_text(current)
    if name == "overlap_sweep":
        assert chip_smoke.old_kernel_sources([str(path)]) == {
            name: str(path)}
    else:
        with pytest.raises(chip_smoke.SmokeFailure, match="parameters"):
            chip_smoke.old_kernel_sources([str(path)])
        n = chip_smoke.OLD_C_PARAMS[name]
        path.write_text('extern "C" int %s(%s) { return 0; }\n'
                        % (name, ", ".join("int a%d" % k for k in range(n))))
        assert chip_smoke.old_kernel_sources([str(path)]) == {
            name: str(path)}
    path.write_text('extern "C" int %s(int a) { return 0; }\n' % name)
    with pytest.raises(chip_smoke.SmokeFailure, match="parameters"):
        chip_smoke.old_kernel_sources([str(path)])


# --- the prefix form of one insertion -------------------------------------------

from hypothesis import given, settings, strategies as st  # noqa: E402


@st.composite
def _insertion_cases(draw):
    letters = draw(st.integers(1, 4))
    n = draw(st.integers(2, 40))
    a = draw(st.lists(st.integers(0, letters - 1), min_size=n + 1,
                      max_size=n + 1))
    b = draw(st.lists(st.integers(0, letters - 1), min_size=n + 1,
                      max_size=n + 1))
    cl = draw(st.integers(2, n))
    limit = draw(st.integers(-1, 5))
    return np.array(a, np.uint8) + 65, np.array(b, np.uint8) + 65, cl, limit


@pytest.mark.parametrize("role", ["insertion", "deletion"])
@settings(max_examples=150, deadline=None, database=None)
@given(case=_insertion_cases())
def test_one_insertion_prefix_form(role, case):
    """The tables' O(1) answer (csrc/adapter_match.cu:one_insertion) equals
    the serial loop and fastp_tpu's _match_with_one_insertion_static, with
    the read as `ins` (insertion) or as `norm` (deletion)."""
    read, adapter, cl, limit = case
    row = np.zeros(16 + len(read) + 8, np.uint8)
    row[16:16 + len(read)] = read
    ad = np.concatenate([adapter, np.zeros(8, np.uint8)])
    insertion = role == "insertion"
    kth, d1i, mi, d1d, md = prefix_tables(row, ad, cl, cl)
    got = one_insertion_prefix(cl, limit, *((d1i, mi) if insertion
                                            else (d1d, md)), kth)
    ins, norm = (read, adapter) if insertion else (adapter, read)
    assert got == one_insertion_serial(ins, norm, cl, limit)
    want = j_adapter._match_with_one_insertion_static(
        ins[None, :].astype(np.uint8), norm[None, :].astype(np.uint8), cl,
        limit)
    assert got == bool(np.asarray(want)[0])


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
    assert launches.since(before) == {"overlap_sweep": 1,
                                      "overlap_gap_sweep": 1, "stat_batch": 2,
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
    assert tally == {"overlap_sweep": 0, "overlap_gap_sweep": 0,
                     "stat_batch": 2, "trim_by_sequence": 1}
    assert launches.snapshot() == before           # nothing counted
    for _ in range(3):
        launches.count_replayed(tally)
    assert launches.since(before) == {"overlap_sweep": 0,
                                      "overlap_gap_sweep": 0, "stat_batch": 6,
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


@pytest.mark.cuda
@pytest.mark.parametrize("setting", [(5, 30, 0.2), (3, 10, 0.1), (5, 30, 0.0)])
def test_gap_kernel_matches_plain_on_card(setting):
    """The overlap kernel's gapped variant against gap_sweep_select_plain,
    every output bit-equal, one launch counted as overlap_gap_sweep: planted
    insertions, adversarial rows at the bench width, the PE251 width and a
    width no multiple of 16."""
    _card()
    from chip_smoke import _adversarial_rows, gap_rows
    from fastp_tpu_torch.ops import overlap as t_overlap
    from fastp_tpu_torch.ops import overlap_cuda
    from fastp_tpu_torch.ops.common import rc
    s1, l1, s2, l2 = gap_rows(20, B=512)
    cases = [(s1, rc(T(s2), T(l2)).numpy(), l1, l2)]
    for B, L in ((8197, 160), (37, 256), (101, 120)):
        cases.append(_adversarial_rows(np.random.default_rng(B), B=B, L=L))
    for seq1, rc2, len1, len2 in cases:
        args = [T(x).cuda() for x in (seq1, rc2, len1, len2)]
        before = launches.snapshot()
        got = overlap_cuda.gap_sweep_select(*args, *setting)
        torch.cuda.synchronize()
        assert launches.since(before)["overlap_gap_sweep"] == 1
        want = t_overlap.gap_sweep_select_plain(*args, *setting)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu())
