"""The port's overlap analysis against fastp_tpu's.

The plain sweep+select (fastp_tpu_torch.ops.overlap.sweep_select_plain, the
CUDA kernel's reference) is held exactly to fastp_tpu's sequential-offset
loop and to its Pallas kernel run in interpret mode; the plain gapped
version (gap_sweep_select_plain, the reference of the kernel's gapped
variant, --allow_gap_overlap_trimming) to the loop's allow_gap branch on
every key, has_gap included, on rows with planted one-base insertions,
rows where d1 is -1 and d2 accepts, overlaps of 50 and 51, cmplen < 2 and a
width below overlap_require among others; the float32 acceptance limit is
checked as a table; the CUDA kernel itself is checked against the plain
version on the card (skipped without one).

The kernel cannot run without a card, so its arithmetic is modelled here in
numpy, step for step (`kernel_model`: the padded rows as 32-bit words, the
unaligned fetch from two aligned words, the carry-trick byte count, the
mask of the last word, the 50-position prefix that ends two bytes into
word 12, the round that ends once every lane's count has passed diff_limit,
32 offsets a round with the lowest set bit of the ballot winning, forward
rounds before backward, the full count split over the lanes; with
`gap`, the gapped test taken inside the ungapped rounds that reach an
overlap of 51, from their counts less the mismatches counted at the
overlap's last two positions, plus the two last compares, and the
one-insertion difference at the winner as the warp takes it, a run of
positions a lane and a scan across lanes), and the model is held exactly
to the plain versions, which walk every offset, and to fastp_tpu's loop on
chip_smoke.py's adversarial rows, planted indels and rows rejected
ungapped by one mismatch at olen 45 to 53; a hypothesis test holds the
gapped accept test and the warp's difference to _gap_diff.  A read outside
a staged row raises in the model, where the kernel would read another
row's bytes.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fastp_tpu.ops import overlap as j_overlap
from fastp_tpu.ops.overlap_pallas import analyze_pallas
from fastp_tpu_torch.ops import overlap as t_overlap
from fastp_tpu_torch.ops import launches, overlap_cuda
from fastp_tpu_torch.ops.common import rc
from chip_smoke import (ACGT, BENCH_ADAPTERS, _adversarial_rows,
                        gap_needed_compares, gap_rows, needed_compares,
                        place_overlap, plant_indels)
from hypothesis import given, settings, strategies as st
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse fixture)

KEYS = ("overlapped", "offset", "overlap_len", "diff")


def _corpus(trial, B=64, L=96):
    """The tests/test_overlap_pallas.py corpus: ACGTN reads, real overlaps
    planted on even rows with a few errors, zero beyond each length."""
    rng = np.random.default_rng(trial)
    comp = np.zeros(256, np.uint8)
    for k, v in ((65, 84), (84, 65), (67, 71), (71, 67), (78, 78)):
        comp[k] = v
    len1 = rng.integers(40, L - 5, B).astype(np.int32)
    len2 = rng.integers(40, L - 5, B).astype(np.int32)
    s1 = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (B, L),
                    p=[.24, .24, .24, .24, .04])
    s2 = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, L))
    for i in range(0, B, 2):
        off = int(rng.integers(0, 40))
        l1, l2 = int(len1[i]), int(len2[i])
        olen = min(l1 - off, l2)
        if olen <= 0:
            continue
        for j in range(olen):
            s2[i, l2 - 1 - j] = comp[s1[i, off + j]]
        for _ in range(int(rng.integers(0, 4))):
            s2[i, int(rng.integers(0, l2))] = rng.choice(
                np.frombuffer(b"ACGT", np.uint8))
    pos = np.arange(L)
    s1[pos[None, :] >= len1[:, None]] = 0
    s2[pos[None, :] >= len2[:, None]] = 0
    return s1, len1, s2, len2


def _dirty(seed, B=96, L=160):
    """Any byte value, lengths from 0 to L, backward-only overlaps."""
    rng = np.random.default_rng(seed)
    s1 = rng.integers(1, 256, (B, L)).astype(np.uint8)
    s2 = rng.integers(1, 256, (B, L)).astype(np.uint8)
    len1 = rng.integers(0, L + 1, B).astype(np.int32)
    len2 = rng.integers(0, L + 1, B).astype(np.int32)
    rc2 = np.asarray(rc(torch.from_numpy(s2), torch.from_numpy(len2)))
    for r in range(0, B, 3):  # rc2[k + i] == s1[i] for one k > 0
        k = int(rng.integers(1, 50))
        l1 = int(rng.integers(40, L - k))
        len1[r], len2[r] = l1, l1 + k
        s1[r, :l1] = rng.choice(np.frombuffer(b"ACGT", np.uint8), l1)
        rc2 = np.asarray(rc(torch.from_numpy(s2), torch.from_numpy(len2)))
        want = rc2[r].copy()
        want[k:k + l1] = s1[r, :l1]
        # s2 = rc(want) over len2: write the reverse complement back
        comp = np.zeros(256, np.uint8)
        for a, b in ((65, 84), (84, 65), (67, 71), (71, 67)):
            comp[a] = b
        s2[r, :l1 + k] = np.where(comp[want[:l1 + k][::-1]] > 0,
                                  comp[want[:l1 + k][::-1]],
                                  want[:l1 + k][::-1])
    pos = np.arange(L)
    s1[pos[None, :] >= len1[:, None]] = 0
    s2[pos[None, :] >= len2[:, None]] = 0
    return s1, len1, s2, len2


def _port(s1, l1, s2, l2, dl, req, pct, allow_gap=False):
    return t_overlap.analyze(torch.from_numpy(s1), torch.from_numpy(l1),
                             torch.from_numpy(s2), torch.from_numpy(l2),
                             dl, req, pct, allow_gap)


def _same(got, want, keys=KEYS):
    for k in keys:
        assert np.array_equal(np.asarray(got[k]).astype(np.int64),
                              np.asarray(want[k]).astype(np.int64)), k


@pytest.mark.parametrize("trial,L", [(0, 96), (1, 96), (2, 160)])
@pytest.mark.parametrize("setting", [(5, 30, 0.2), (2, 20, 0.1), (5, 30, 0.0)])
def test_plain_matches_analyze_loop(trial, L, setting):
    s1, l1, s2, l2 = _corpus(trial, L=L)
    want = j_overlap._analyze_loop(s1, l1, s2, l2, *setting, False)
    got = _port(s1, l1, s2, l2, *setting)
    _same(got, want)
    # diff_pct = 0 (the --overlapped_out re-analysis) accepts exact overlaps
    assert np.asarray(want["overlapped"]).sum() > (3 if setting[2] == 0 else 10)


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_matches_analyze_loop_dirty(seed):
    s1, l1, s2, l2 = _dirty(seed)
    want = j_overlap._analyze_loop(s1, l1, s2, l2, 5, 30, 0.2, False)
    _same(_port(s1, l1, s2, l2, 5, 30, 0.2), want)
    # some pairs are accepted only among the backward offsets
    assert (np.asarray(want["offset"]) < 0).sum() > 5


def test_plain_matches_pallas_interpret():
    s1, l1, s2, l2 = _corpus(5, B=16, L=160)
    want = analyze_pallas(s1, l1, s2, l2, 5, 30, 0.2, interpret=True)
    _same(_port(s1, l1, s2, l2, 5, 30, 0.2), want)


@pytest.mark.parametrize("pct", [0.2, 0.1, 0.05, 0.3, 0.0])
def test_float32_limit_table(pct):
    """limit = min(diff_limit, int(float32(olen) * float32(pct))) for every
    olen 0..160, as fastp_tpu computes it (0 everywhere at pct = 0)."""
    olen = np.arange(0, 161, dtype=np.int32)
    want = np.asarray(jnp.minimum(5, (jnp.asarray(olen).astype(jnp.float32)
                                      * pct).astype(jnp.int32)))
    got = t_overlap.diff_limit_of(torch.from_numpy(olen), 5, pct)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    wide = np.asarray(jnp.minimum(1000, (jnp.asarray(olen).astype(jnp.float32)
                                         * pct).astype(jnp.int32)))
    assert np.array_equal(
        t_overlap.diff_limit_of(torch.from_numpy(olen), 1000, pct).numpy(), wide)


def _next(x, k=1):
    return ACGT[(np.searchsorted(ACGT, x) + k) % 4]


# the kinds of gap_edge_rows, eight rows each: (d1 is -1, overlap length)
EDGE_KINDS = ((True, 40), (True, 51), (False, 50), (False, 51), (False, 36),
              (False, 50))


def gap_edge_rows(seed=13, L=96):
    """Gapped accepts at their edges, eight rows of each EDGE_KINDS entry,
    forward and backward.  "d1 is -1": seq1's side a and rc2's side b agree
    but for 5 (= the limit) substitutions before the overlap's last two
    bases, then a ends "AC" and b "GA": accLeft[cmplen - 2] + accRight[cmplen
    - 1] is 6 with seq1 as ins and 5 with rc2 as ins, so d1 is -1 and d2
    accepts.  Otherwise a one-base insertion two bases before the overlap's
    end, in either read, with 5 substitutions before it; at olen 51 the
    ungapped test reads the insertion's position as its 50th.  Returns
    (s1, len1, s2, len2, want) with want = (offset, overlap_len) per row."""
    rng = np.random.default_rng(seed)
    B = 8 * len(EDGE_KINDS)
    rows = (np.zeros((B, L), np.uint8), np.zeros((B, L), np.uint8),
            np.zeros(B, np.int32), np.zeros(B, np.int32))
    want = []
    for r in range(B):
        d1_minus, n = EDGE_KINDS[r // 8]
        if d1_minus:
            a = rng.choice(ACGT, n)
            b = a.copy()
            subs = rng.choice(n - 2, 5, replace=False)
            b[subs] = _next(a[subs])
            a[n - 2:], b[n - 2:] = np.frombuffer(b"AC", np.uint8), \
                np.frombuffer(b"GA", np.uint8)
        else:
            ins = rng.choice(ACGT, n)
            ins[n - 1] = _next(ins[n - 2])
            p = n - 2
            norm = np.concatenate([ins[:p], ins[p + 1:], [_next(ins[n - 1], 2)]])
            subs = rng.choice(p, 5, replace=False)
            norm[subs] = _next(ins[subs])
            a, b = (ins, norm) if r % 4 < 2 else (norm, ins)
        forward = r % 2 == 0
        shift = int(rng.integers(0 if forward else 1, 12))
        place_overlap(rows, r, a, b, shift, forward, rng)
        want.append((shift if forward else -shift, n))
    s1, rc2, len1, len2 = rows
    s2 = rc(torch.from_numpy(rc2), torch.from_numpy(len2)).numpy()
    return s1, len1, s2, len2, np.array(want)


def tiny_overlap_rows(L=24):
    """For overlap_require 0, where offsets with an overlap of one or two
    bases (cmplen < 2) are tried: rows of A against C (nothing passes at
    any offset), one gapped accept at cmplen 2 (ACG against AGT) and random
    rows, lengths 0 to L."""
    rng = np.random.default_rng(14)
    B = 16
    s1 = rng.choice(ACGT, (B, L))
    rc2 = rng.choice(ACGT, (B, L))
    len1 = rng.integers(0, L + 1, B).astype(np.int32)
    len2 = rng.integers(0, L + 1, B).astype(np.int32)
    for r in range(6):
        s1[r], rc2[r] = ord("A"), ord("C")
        len1[r], len2[r] = r + 1, (r + 1, 3, 1, 6, 2, 2)[r]
    s1[6, :3], rc2[6, :3] = np.frombuffer(b"ACG", np.uint8), \
        np.frombuffer(b"AGT", np.uint8)
    len1[6] = len2[6] = 3
    s2 = rc(torch.from_numpy(rc2), torch.from_numpy(len2)).numpy()
    return s1, len1, s2, len2


def narrow_rows(L=24):
    """Exact full-length overlaps at a width no larger than
    overlap_require: no offset is tried, nothing is accepted."""
    rng = np.random.default_rng(15)
    s1 = rng.choice(ACGT, (16, L))
    len1 = np.full(16, L, np.int32)
    s2 = rc(torch.from_numpy(s1), torch.from_numpy(len1)).numpy()
    return s1, len1, s2, len1.copy()


ADAPTERS = [np.frombuffer(a.encode(), np.uint8) for a in BENCH_ADAPTERS]
_COMP = np.zeros(256, np.uint8)
_COMP[np.frombuffer(b"ACGTN", np.uint8)] = np.frombuffer(b"TGCAN", np.uint8)


def indel_pairs(seed, B=128, L=160):
    """151-base pairs of inserts 40 to 300 (reads past a short insert go
    on into the bench adapters, then random bases), each with one insertion
    or deletion planted in read 2 inside the overlap (plant_indels): in the
    first half of the rows anywhere, with two substitutions; in the second
    within the overlap's last three bases, with four, where some short
    overlaps take a gapped accept.  Returns (s1, len1, s2, len2)."""
    rng = np.random.default_rng(seed)
    n = 151
    inserts = rng.integers(40, 301, B)
    s1, rc2 = np.zeros((B, L), np.uint8), np.zeros((B, L), np.uint8)
    for r, ins in enumerate(inserts):
        frag = rng.choice(ACGT, ins)
        reads = [np.concatenate([x, ad, rng.choice(ACGT, n)])[:n]
                 for x, ad in ((frag, ADAPTERS[0]),
                               (_COMP[frag[::-1]], ADAPTERS[1]))]
        s1[r, :n], rc2[r, :n] = reads[0], _COMP[reads[1][::-1]]
    lens = np.full(B, n, np.int32)
    # the overlap: forward at insert - 151 over 302 - insert bases, or
    # backward at -(151 - insert) over the insert
    offset = inserts - n
    olen = np.where(inserts >= n, 2 * n - inserts, inserts)
    half = np.arange(B) >= B // 2
    rows = (s1, rc2, lens, lens.copy())
    rows = [np.where(half.reshape((B,) + (1,) * (a.ndim - 1)), b, a)
            for a, b in zip(plant_indels(rows, ~half, offset, olen, rng, 2),
                            plant_indels(rows, half, offset, olen, rng, 4, 3))]
    s2 = rc(torch.from_numpy(rows[1]), torch.from_numpy(rows[3])).numpy()
    return rows[0], rows[2], s2, rows[3]


def boundary_rows(setting, seed=19, L=96):
    """Rows that the ungapped test rejects by one mismatch at an overlap of
    45, 49 or 50 to 53: `limit` substitutions in the first 40 bases and one
    more at olen - 1 or olen - 2 where that is among the first 50 (mm50 =
    limit + 1), else at 49, and the overlap's end made so that the gapped
    test's two last compares pass.  At olen 51 and below the gapped count
    over olen - 2 positions misses that last mismatch, so the gapped test
    accepts there; at 52 and 53 it covers all 50 positions of mm50 and
    rejects.  At olen 45 and 49 with the mismatch at olen - 2, the ungapped
    round's loop leaves the lane one position early (its count past
    diff_limit at its last word but one), so the kernel's gapped test, taken
    from that count, must not subtract the position it did not count.  In
    half of the forward rows read 2 goes on for 8 bases past the overlap,
    and the first forward copy of each kind sits at offset 31: there the
    first offset with olen <= 51 is the planted one, the last lane of a
    round.
    Eight copies of each kind, forward and backward offsets.  Returns (s1,
    len1, s2, len2, want) with want = (offset, overlap_len, gapped accept
    expected there) per row."""
    dl, _, pct = setting
    rng = np.random.default_rng(seed)
    kinds = [(n, q) for n in (45, 49, 50, 51, 52, 53)
             for q in sorted({min(n - 2, 49), min(n - 1, 49)})]
    B = 8 * len(kinds)
    rows = (np.zeros((B, L), np.uint8), np.zeros((B, L), np.uint8),
            np.zeros(B, np.int32), np.zeros(B, np.int32))
    want = []
    for r in range(B):
        n, q = kinds[r // 8]
        limit = int(_limit(np.array([n]), dl, pct)[0])
        a = rng.choice(ACGT, n)
        b = a.copy()
        subs = rng.choice(40, limit, replace=False)
        b[subs] = _next(a[subs])
        # one of the two last compares passes: b[n - 1] == a[n - 2]; a[n - 1]
        # equal to it too where position n - 1 is no mismatch
        b[n - 1] = a[n - 2]
        if q == n - 1:   # the last mismatch on the overlap's last base
            a[n - 1] = _next(a[n - 2])
        else:
            a[n - 1] = a[n - 2]
            b[q] = _next(a[q])
        forward = r % 2 == 0
        # the first copy of a kind at forward offset 31: its overlap's
        # first offset with olen <= 51 is the last lane of a round
        shift = 31 if r % 8 == 0 else int(rng.integers(0 if forward else 1, 12))
        place_overlap(rows, r, a, b, shift, forward, rng)
        if r % 4 == 0:   # read 2 goes on past read 1's end, as it mostly does
            rows[1][r, n:n + 8] = rng.choice(ACGT, 8)
            rows[3][r] = n + 8
        want.append((shift if forward else -shift, n, n <= 51))
    s1, rc2, len1, len2 = rows
    s2 = rc(torch.from_numpy(rc2), torch.from_numpy(len2)).numpy()
    return s1, len1, s2, len2, np.array(want)


GAP_CASES = {
    "corpus": (lambda: _corpus(9, L=96), (5, 30, 0.2)),
    "dirty": (lambda: _dirty(10, B=48), (5, 30, 0.2)),
    "gap": (lambda: gap_rows(11), (5, 30, 0.2)),
    "edges": (lambda: gap_edge_rows()[:4], (5, 30, 0.2)),
    "tiny_overlaps": (tiny_overlap_rows, (5, 0, 0.2)),
    "narrow": (narrow_rows, (5, 30, 0.2)),
    "indels": (lambda: indel_pairs(18), (5, 30, 0.2)),
    "boundary": (lambda: boundary_rows((5, 30, 0.2))[:4], (5, 30, 0.2)),
    "boundary_tight": (lambda: boundary_rows((3, 10, 0.1))[:4], (3, 10, 0.1)),
}


@pytest.mark.parametrize("rows", list(GAP_CASES))
def test_gapped_matches_analyze_loop(rows):
    """The plain gapped version (the kernel's signature) against the loop's
    allow_gap branch, every key including has_gap; analyze with allow_gap
    gives the same on the CPU."""
    make, setting = GAP_CASES[rows]
    s1, l1, s2, l2 = make()
    want = j_overlap._analyze_loop(s1, l1, s2, l2, *setting, True)
    rc2 = rc(torch.from_numpy(s2), torch.from_numpy(l2))
    got = dict(zip(KEYS + ("has_gap",), t_overlap.gap_sweep_select_plain(
        torch.from_numpy(s1), rc2, torch.from_numpy(l1), torch.from_numpy(l2),
        *setting)))
    _same(got, want, KEYS + ("has_gap",))
    _same(_port(s1, l1, s2, l2, *setting, allow_gap=True), want,
          KEYS + ("has_gap",))
    has_gap = np.asarray(want["has_gap"])
    if rows == "gap":   # the planted insertions are found only with a gap
        assert has_gap.sum() > len(has_gap) // 2
        assert (np.asarray(want["offset"])[has_gap] < 0).any()
        assert not np.asarray(_port(s1, l1, s2, l2, *setting)[
            "overlapped"]).any()
    if rows == "edges":   # each row at its planted offset, with a gap
        edge = gap_edge_rows()[4]
        assert has_gap.all()
        assert np.array_equal(np.asarray(want["offset"]), edge[:, 0])
        assert np.array_equal(np.asarray(want["overlap_len"]), edge[:, 1])
    if rows == "tiny_overlaps":
        assert not np.asarray(want["overlapped"])[:6].any()
        assert has_gap[6] and int(want["overlap_len"][6]) == 3
    if rows == "narrow":
        assert not np.asarray(want["overlapped"]).any()


@pytest.mark.parametrize("rows", list(GAP_CASES))
def test_no_gapped_accept_above_olen_51(rows):
    """The argument behind the gapped kernel's first gapped offset
    (csrc/overlap_sweep.cu, gap_start): a row that reaches the gapped pass
    had every ungapped offset rejected, so at olen >= 52, where the gapped
    count over olen - 2 positions covers the 50 of mm50, no gapped offset
    accepts.  No row of fastp_tpu's loop with allow_gap, nor of the plain
    gapped version, has a gapped accept there: the gap cases, 151-base
    pairs with real indels, and rows rejected ungapped by one mismatch at
    olen 50 to 53."""
    make, setting = GAP_CASES[rows]
    s1, l1, s2, l2 = make()
    want = {k: np.asarray(v) for k, v in j_overlap._analyze_loop(
        s1, l1, s2, l2, *setting, True).items()}
    rc2 = rc(torch.from_numpy(s2), torch.from_numpy(l2)).numpy()
    got = gap_sweep_select_plain_np(s1, rc2, l1, l2, *setting)
    for out in (want, got):
        has_gap = out["has_gap"].astype(bool)
        assert not (has_gap & (out["overlap_len"] >= 52)).any()
    if rows in ("gap", "edges", "indels", "boundary", "boundary_tight"):
        assert got["has_gap"].any() and want["has_gap"].any()


@pytest.mark.parametrize("setting", [(5, 30, 0.2), (3, 10, 0.1)])
def test_boundary_rows_accept_gapped_only_below_olen_52(setting):
    """boundary_rows against the plain version: the ungapped pass rejects
    every planted offset (mm50 = limit + 1); the gapped pass accepts there
    at olen 45 to 51, where its count misses the last mismatch, and not at
    52 and 53, where it covers all of mm50; the kernel's model, which takes
    the gapped test only in rounds that reach an overlap of 51, gives the
    same on every key."""
    s1, l1, s2, l2, planted = boundary_rows(setting)
    rc2 = rc(torch.from_numpy(s2), torch.from_numpy(l2)).numpy()
    ungapped = dict(zip(KEYS, (x.numpy() for x in t_overlap.sweep_select_plain(
        *(torch.from_numpy(x) for x in (s1, rc2, l1, l2)), *setting))))
    got = gap_sweep_select_plain_np(s1, rc2, l1, l2, *setting)
    at = (got["offset"] == planted[:, 0]) & got["has_gap"].astype(bool)
    assert not (ungapped["overlapped"]
                & (ungapped["offset"] == planted[:, 0])).any()
    assert np.array_equal(at, planted[:, 2] == 1)
    assert np.array_equal(got["overlap_len"][at], planted[at, 1])
    assert set(planted[:, 1]) == {45, 49, 50, 51, 52, 53}
    _same(kernel_model(s1, rc2, l1, l2, *setting, gap=True), got,
          KEYS + ("has_gap",))


def test_edge_rows_take_d2_where_d1_is_minus_one():
    """gap_edge_rows' first kind at its winning alignment: gap_diff with
    seq1 as ins is -1, with rc2 as ins it passes, and the diff is the
    latter."""
    s1, l1, s2, l2, edge = gap_edge_rows()
    rc2 = rc(torch.from_numpy(s2), torch.from_numpy(l2)).numpy()
    got = gap_sweep_select_plain_np(s1, rc2, l1, l2, 5, 30, 0.2)
    for r in range(16):
        off, n = (int(x) for x in edge[r])
        a = s1[r, max(off, 0):max(off, 0) + n]
        b = rc2[r, max(-off, 0):max(-off, 0) + n]
        one = lambda x, y: int(t_overlap._gap_diff(   # noqa: E731
            torch.from_numpy(x[None]), torch.from_numpy(y[None]),
            torch.tensor([n - 1], dtype=torch.int32),
            torch.tensor([5], dtype=torch.int32))[0])
        assert one(a, b) == -1
        assert 0 <= one(b, a) <= 5 and one(b, a) == got["diff"][r]


def gap_sweep_select_plain_np(seq1, rc2, len1, len2, *setting):
    return {k: v.numpy() for k, v in zip(
        KEYS + ("has_gap",), t_overlap.gap_sweep_select_plain(
            *(torch.from_numpy(x) for x in (seq1, rc2, len1, len2)),
            *setting))}


U32 = np.uint32
LANES = np.arange(32)


def _staged_words(row, L):
    """One string as the kernel stages it: L bytes, zero pad, as words."""
    buf = np.zeros(overlap_cuda.padded_row_bytes(L), np.uint8)
    buf[:L] = row
    return buf.view("<u4")


def _funnelshift_r(lo, hi, sh):
    """Low word of (hi:lo) >> sh, sh in bits (the CUDA intrinsic)."""
    both = lo.astype(np.uint64) | (hi.astype(np.uint64) << np.uint64(32))
    return (both >> sh.astype(np.uint64)).astype(U32)


def _nonzero_bytes(x):
    carry = (x & U32(0x7f7f7f7f)) + U32(0x7f7f7f7f)
    return np.bitwise_count((carry | x) & U32(0x80808080)).astype(np.int64)


def _first_bytes(n):
    return ((np.uint64(1) << (8 * n).astype(np.uint64)) - np.uint64(1)).astype(U32)


def _count_prefix(x32, y32, t, n, dl):
    """count_prefix of the kernel for the 32 lanes of a warp: shifts t,
    lengths 0 <= n <= 50 (13 words; a longer n is a fault of the caller).
    Lanes with n == 0 read nothing; the warp leaves the loop once no lane
    both has words left and a count within dl.  Returns the counts and
    `counted`, the positions the warp's loop covered (4 per word it took)."""
    assert n.max() <= 50, "count_prefix counts at most 50 positions"
    q, sh = t >> 2, 8 * (t & 3)
    mm = np.zeros(len(t), np.int64)
    lo = np.zeros(len(t), U32)
    lo[n > 0] = x32[q[n > 0]]
    for w in range(13):
        left = n - 4 * w
        on = left > 0
        hi = np.zeros(len(t), U32)
        hi[on] = x32[q[on] + w + 1]
        d = _funnelshift_r(lo, hi, sh) ^ y32[w]
        d = np.where(left < 4, d & _first_bytes(np.clip(left, 0, 3)), d)
        mm[on] += _nonzero_bytes(d)[on]
        lo = np.where(on, hi, lo)
        if not np.any((left > 4) & (mm <= dl)):   # __any_sync
            break
    return mm, 4 * (w + 1)


def _limit(olen, dl, pct):
    lim = (np.maximum(olen, 0).astype(np.float32) * np.float32(pct)).astype(np.int64)
    return np.minimum(lim, dl)


def _gap_start(lx, ly):
    """gap_start: the first shift whose overlap is at most 51, from which
    on every overlap is (0 when ly <= 51)."""
    return 0 if ly <= 51 else max(0, lx - 51)


def _gap_accepts(x32, y32, s, olen, end, mm, limit):
    """gap_accepts for 32 lanes the ungapped test has just rejected: mm, the
    lane's count, exact over its first `end` positions, less its mismatches
    at positions olen - 2 and olen - 1 where it counted them, plus the
    lesser of the two last compares, within the limit (olen >= 3; the four
    bytes read only there)."""
    x8, y8 = x32.view(np.uint8), y32.view(np.uint8)
    ok = np.flatnonzero(olen >= 3)
    a, b = x8[s[ok] + olen[ok] - 2], x8[s[ok] + olen[ok] - 1]
    c, d = y8[olen[ok] - 2], y8[olen[ok] - 1]
    left = (mm[ok] - ((olen[ok] - 2 < end[ok]) & (a != c))
            - ((olen[ok] - 1 < end[ok]) & (b != d)))
    accept = np.zeros(len(s), bool)
    accept[ok] = left + ((b != c) & (d != a)) <= limit[ok]
    return accept


def _first_set(base, flags):
    """base + the lowest lane whose flag is set (__ballot_sync, __ffs - 1),
    or None."""
    votes = int(np.sum(flags.astype(np.int64) << LANES))
    return base + (votes & -votes).bit_length() - 1 if votes else None


def _first_accept(x32, y32, lx, ly, dl, req, pct, gap=False):
    """first_accept: (shift, olen) of the first ungapped accept, or None;
    and, with `gap`, the first shift that passed the gapped test in the
    rounds from _gap_start that accepted nothing (gap_accepts), or None."""
    n_cand = lx - req
    gap_shift = None
    for base in range(0, max(n_cand, 0), 32):
        s = base + LANES
        olen = np.minimum(lx - s, ly)
        cand = s < n_cand
        n = np.where(cand, np.minimum(np.maximum(olen, 0), 50), 0)
        mm, counted = _count_prefix(x32, y32, s, n, dl)
        limit = _limit(olen, dl, pct)
        win = _first_set(base, cand & (mm <= limit))
        if win is not None:
            return (win, min(lx - win, ly)), gap_shift
        if gap and gap_shift is None and base + 31 >= _gap_start(lx, ly):
            gap_shift = _first_set(base, cand & _gap_accepts(
                x32, y32, s, olen, np.minimum(n, counted), mm, limit))
    return None, gap_shift


def _count_total(x32, y32, t, olen):
    q, sh = t >> 2, np.full(1, 8 * (t & 3))
    per_lane = np.zeros(32, np.int64)
    for w in range((olen + 3) >> 2):
        d = _funnelshift_r(x32[q + w:q + w + 1], x32[q + w + 1:q + w + 2],
                           sh) ^ y32[w]
        left = olen - 4 * w
        if left < 4:
            d = d & _first_bytes(np.full(1, left))
        per_lane[w % 32] += int(_nonzero_bytes(d)[0])
    return int(per_lane.sum())


def _gap_diff_warp(ins8, norm8, cm, limit):
    """gap_diff_warp: each lane sums e = (ins[j] != norm[j]) - (ins[j + 1] !=
    norm[j]) over its run of ceil(cm / 32) positions, keeping the least
    prefix before each j >= 1; an inclusive scan over the lanes, then the
    warp's least value, the sum of the second term (R) and accLeft[cm - 2].
    ins8, norm8: views of staged rows from the alignment's start."""
    if cm < 2:
        return -1
    per = -(-cm // 32)
    runs, lows, right, left = [], [], 0, 0
    for lane in range(32):
        lo = min(lane * per, cm)
        run, low = 0, 1 << 30
        for j in range(lo, min(lo + per, cm)):
            if j >= 1:
                low = min(low, run)
            ml, mr = int(ins8[j] != norm8[j]), int(ins8[j + 1] != norm8[j])
            run += ml - mr
            right += mr
            left += ml if j < cm - 1 else 0
        runs.append(run)
        lows.append(low)
    incl = np.cumsum(runs)
    least = min(int(incl[k] - runs[k] + lows[k]) for k in range(32))
    if left + int(ins8[cm] != norm8[cm - 1]) > limit:
        return -1
    return right + least


def _gap_diff_of(seq1_side, rc2_side, olen, dl, pct):
    limit = int(_limit(np.array([olen]), dl, pct)[0])
    d1 = _gap_diff_warp(seq1_side, rc2_side, olen - 1, limit)
    if 0 <= d1 <= limit:
        return d1
    return _gap_diff_warp(rc2_side, seq1_side, olen - 1, limit)


def kernel_model(seq1, rc2, len1, len2, dl, req, pct, gap=False):
    """csrc/overlap_sweep.cu in numpy, one pair row (warp) at a time; with
    `gap` its gapped variant (the has_gap key added)."""
    B, L = seq1.shape
    out = np.zeros((5, B), np.int64)
    for r in range(B):
        a32, b32 = _staged_words(seq1[r], L), _staged_words(rc2[r], L)
        l1 = min(max(int(len1[r]), 0), L)
        l2 = min(max(int(len2[r]), 0), L)
        hit, gap_f = _first_accept(a32, b32, l1, l2, dl, req, pct, gap)
        if hit is not None:
            out[:4, r] = 1, hit[0], hit[1], _count_total(a32, b32, *hit)
            continue
        hit, gap_b = _first_accept(b32, a32, l2, l1, dl, req, pct, gap)
        if hit is not None:
            out[:4, r] = 1, -hit[0], hit[1], _count_total(b32, a32, *hit)
            continue
        a8, b8 = a32.view(np.uint8), b32.view(np.uint8)
        if gap_f is not None:    # ins of d1: the shifted seq1
            olen = min(l1 - gap_f, l2)
            out[:, r] = 1, gap_f, olen, _gap_diff_of(
                a8[gap_f:], b8, olen, dl, pct), 1
        elif gap_b is not None:  # ins of d1: seq1 unshifted, the shift on rc2
            olen = min(l1, l2 - gap_b)
            out[:, r] = 1, -gap_b, olen, _gap_diff_of(
                a8, b8[gap_b:], olen, dl, pct), 1
    return dict(zip(KEYS + ("has_gap",), out if gap else out[:4]))


@pytest.mark.parametrize("B,L", [(192, 160), (96 + 5, 160), (3, 160),
                                 (96, 256), (48 + 5, 256), (64, 120)])
@pytest.mark.parametrize("setting", [(5, 30, 0.2), (3, 10, 0.1), (5, 30, 0.0)])
def test_kernel_model_matches_plain_and_loop(B, L, setting):
    """chip_smoke.py's adversarial rows, at the bench width, at the PE251
    width, at a width that is no multiple of 16, and at row counts that are
    no multiple of the rows a block takes."""
    seq1, rc2, l1, l2 = _adversarial_rows(np.random.default_rng(B + L), B=B, L=L)
    got = kernel_model(seq1, rc2, l1, l2, *setting)
    plain = dict(zip(KEYS, t_overlap.sweep_select_plain(
        *(torch.from_numpy(x) for x in (seq1, rc2, l1, l2)), *setting)))
    _same(got, plain)
    # fastp_tpu's loop takes read 2 and reverse-complements it itself, which
    # keeps only ACGTN: the same rows over that alphabet (equal bytes stay
    # equal, a byte flipped by 1 stays different), read 2 = rc(rc2)
    letters = np.frombuffer(b"ACGTN", np.uint8)
    seq1n, rc2n = letters[seq1 % 5], letters[rc2 % 5]
    s2 = rc(torch.from_numpy(rc2n), torch.from_numpy(l2))
    rc2n = rc(s2, torch.from_numpy(l2)).numpy()
    want = j_overlap._analyze_loop(seq1n, l1, s2.numpy(), l2, *setting, False)
    _same(kernel_model(seq1n, rc2n, l1, l2, *setting), want)
    assert B <= 16 or np.asarray(want["overlapped"]).sum() > B // 8
    if B > 16:
        assert (got["offset"] < 0).any() and (got["offset"] > 0).any()
        assert 0 < got["overlapped"].sum() < B


def test_kernel_model_reads_no_byte_past_a_length():
    """Bytes beyond a row's length never reach a count: changing them
    changes nothing (in the model and in the plain version alike)."""
    rng = np.random.default_rng(5)
    seq1, rc2, l1, l2 = _adversarial_rows(rng, B=96, L=160)
    base = kernel_model(seq1, rc2, l1, l2, 5, 30, 0.2)
    pos = np.arange(160)
    seq1b, rc2b = seq1.copy(), rc2.copy()
    seq1b[pos[None, :] >= l1[:, None]] ^= 0xff
    rc2b[pos[None, :] >= l2[:, None]] ^= 0xff
    _same(kernel_model(seq1b, rc2b, l1, l2, 5, 30, 0.2), base)


@pytest.mark.parametrize("req,dl", [(0, 5), (1, 5), (200, 5), (30, 0)])
def test_kernel_model_at_odd_settings(req, dl):
    """overlap_require of 0 (an empty overlap is a candidate), 1 and beyond
    L (no candidate at all), and a zero diff_limit."""
    seq1, rc2, l1, l2 = _adversarial_rows(np.random.default_rng(6), B=48, L=120)
    got = kernel_model(seq1, rc2, l1, l2, dl, req, 0.2)
    plain = dict(zip(KEYS, t_overlap.sweep_select_plain(
        *(torch.from_numpy(x) for x in (seq1, rc2, l1, l2)), dl, req, 0.2)))
    _same(got, plain)


def _gap_model_case(name):
    """(seq1, rc2, len1, len2, setting) of the gapped model's cases."""
    if name.startswith("adversarial"):
        B, L = {"adversarial": (96, 160), "adversarial_pe251": (40 + 5, 256),
                "adversarial_odd": (37, 120)}[name]
        return (*_adversarial_rows(np.random.default_rng(B + L + 1), B=B,
                                   L=L), (5, 30, 0.2))
    setting = {"tiny_overlaps": (5, 0, 0.2), "boundary_tight": (3, 10, 0.1),
               "boundary_req0": (5, 0, 0.2)}.get(name, (5, 30, 0.2))
    s1, l1, s2, l2 = {"gap": lambda: gap_rows(16, B=64),
                      "edges": lambda: gap_edge_rows(17)[:4],
                      "tiny_overlaps": tiny_overlap_rows,
                      "narrow": narrow_rows,
                      "indels": lambda: indel_pairs(20),
                      "boundary": lambda: boundary_rows(setting, 21)[:4],
                      "boundary_tight": lambda: boundary_rows(setting, 22)[:4],
                      "boundary_req0": lambda: boundary_rows(setting, 23)[:4],
                      }[name]()
    rc2 = rc(torch.from_numpy(s2), torch.from_numpy(l2)).numpy()
    return s1, rc2, l1, l2, setting


@pytest.mark.parametrize("name", ["adversarial", "adversarial_pe251",
                                  "adversarial_odd", "gap", "edges",
                                  "tiny_overlaps", "narrow", "indels",
                                  "boundary", "boundary_tight",
                                  "boundary_req0"])
def test_gap_kernel_model_matches_plain(name):
    """The gapped variant's model (the ungapped rounds, with the gapped
    tests of those that reach an overlap of 51 taken from their counts, the
    one-insertion difference at the winner) held to the plain gapped
    version, which walks every offset, on every key, has_gap included: any
    byte value, the PE251 width, a width no multiple of 16, planted
    insertions in either read at forward and backward offsets, d1 = -1 with
    d2 accepting, olen 50 and 51, cmplen < 2, a width below
    overlap_require, 151-base pairs with real indels and rows rejected
    ungapped by one mismatch at olen 45 to 53, at overlap_require 0 too;
    the plain version has no gapped accept above olen 51 on any of them."""
    seq1, rc2, l1, l2, setting = _gap_model_case(name)
    got = kernel_model(seq1, rc2, l1, l2, *setting, gap=True)
    want = gap_sweep_select_plain_np(seq1, rc2, l1, l2, *setting)
    _same(got, want, KEYS + ("has_gap",))
    assert not (want["has_gap"].astype(bool) & (want["overlap_len"] >= 52)).any()
    if name in ("gap", "edges", "boundary", "boundary_tight", "boundary_req0"):
        assert got["has_gap"].any()
    if name in ("gap", "edges"):
        assert got["has_gap"].sum() > len(l1) // 2
        assert (got["offset"][got["has_gap"] > 0] < 0).any()
        assert (got["offset"][got["has_gap"] > 0] > 0).any()


def test_gap_kernel_model_reads_no_byte_past_a_length():
    for name in ("gap", "indels"):
        seq1, rc2, l1, l2, setting = _gap_model_case(name)
        base = kernel_model(seq1, rc2, l1, l2, *setting, gap=True)
        pos = np.arange(seq1.shape[1])
        seq1b, rc2b = seq1.copy(), rc2.copy()
        seq1b[pos[None, :] >= l1[:, None]] ^= 0xff
        rc2b[pos[None, :] >= l2[:, None]] ^= 0xff
        _same(kernel_model(seq1b, rc2b, l1, l2, *setting, gap=True), base,
              KEYS + ("has_gap",))


@st.composite
def _lanes_of_a_row(draw):
    """One staged pair row and a warp's 32 lanes on it: each lane a shift t,
    a cmplen (-1 up to what the row holds past t) and a limit within
    diff_limit.  y is x from a shift t0 on with a few substitutions and at
    most one base left out (so that the lanes near t0 pass), or random."""
    L = draw(st.integers(3, 100))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
    letters = np.frombuffer(b"ACGT", np.uint8)[:draw(st.integers(1, 4))]
    x = rng.choice(letters, L)
    t0 = draw(st.integers(0, L - 1))
    y = np.concatenate([x[t0:], rng.choice(letters, t0)])
    if draw(st.booleans()):          # one base of x left out of y
        k = int(rng.integers(0, L))
        y = np.concatenate([y[:k], y[k + 1:], rng.choice(letters, 1)])
    flips = rng.integers(0, L, draw(st.integers(0, 8)))
    y[flips] = rng.choice(letters, len(flips))
    if draw(st.booleans()):
        y = rng.choice(letters, L)
    dl = draw(st.integers(-1, 8))
    t = np.clip(t0 + rng.integers(-3, 4, 32), 0, L - 1)
    t[rng.random(32) < 0.3] = rng.integers(0, L, 32)[:1]
    cm = np.array([int(rng.integers(-1, L - int(u))) for u in t])
    limit = rng.integers(-1, dl + 1, 32)
    return x, y, t.astype(np.int64), cm, limit, dl


@settings(max_examples=200, deadline=None, database=None)
@given(case=_lanes_of_a_row())
def test_word_wise_gap_test_equals_gap_diff(case):
    """The kernel's gapped accept test, taken from an ungapped round's count
    (the word-wise count over the first min(olen, 50) positions, the warp
    leaving the loop once every lane's count has passed diff_limit, less the
    mismatches it counted at positions olen - 2 and olen - 1, plus the
    lesser of the two last compares), equals "either role's gap_diff passes
    the limit" on every lane whose ungapped test it rejected, overlaps above
    51 among them; and its warp-wise one-insertion difference equals
    _gap_diff in both roles, lane by lane."""
    x, y, t, cm, limit, dl = case
    L = len(x)
    x32, y32 = _staged_words(x, L), _staged_words(y, L)
    x8, y8 = x32.view(np.uint8), y32.view(np.uint8)
    olen = cm + 1
    n = np.minimum(np.maximum(olen, 0), 50)
    mm, counted = _count_prefix(x32, y32, t, n, dl)
    rejected = mm > limit   # the lanes whose gapped test the kernel takes
    accept = _gap_accepts(x32, y32, t, olen, np.minimum(n, counted), mm, limit)
    xpad = np.concatenate([x, np.zeros(L, np.uint8)])
    ins = torch.from_numpy(np.stack([xpad[u:u + L] for u in t]))
    norm = torch.from_numpy(np.repeat(y[None], 32, 0))
    cmt, limt = (torch.from_numpy(v.astype(np.int32)) for v in (cm, limit))
    d1 = t_overlap._gap_diff(ins, norm, cmt, limt).numpy()
    d2 = t_overlap._gap_diff(norm, ins, cmt, limt).numpy()
    dd = np.where((d1 < 0) | (d1 > limit), d2, d1)
    assert np.array_equal(accept[rejected], ((dd >= 0) & (dd <= limit))[rejected])
    for k in range(32):
        assert _gap_diff_warp(x8[t[k]:], y8, int(cm[k]), int(limit[k])) == d1[k]
        assert _gap_diff_warp(y8, x8[t[k]:], int(cm[k]), int(limit[k])) == d2[k]


@pytest.mark.parametrize("L,stride,rows", [
    (160, 176, 8), (256, 272, 8), (100, 128, 8), (32, 48, 8),
    (3072, 3088, 7), (24560, 24576, 1), (24576, 24592, 0), (0, 16, 0)])
def test_shared_memory_rows(L, stride, rows):
    assert overlap_cuda.padded_row_bytes(L) == stride
    assert overlap_cuda.rows_per_block(L) == rows
    # the furthest word the kernel reads: the one after the word that holds
    # byte L - 1 + 3 (an unaligned fetch of the last full word)
    assert L <= 0 or 4 * ((L - 1 + 3) // 4 + 1) + 4 <= stride


def _test_cost(x, y, n, limit, tail):
    """Compares of one accept test, byte by byte: stop once the mismatches
    pass `limit`, else n and `tail` more."""
    mm = 0
    for i in range(n):
        mm += int(x[i] != y[i])
        if mm > limit:
            return i + 1
    return n + tail if n > 0 else 0


def _offsets(seq1, rc2, l1, l2, r, req):
    """Row r's offsets in walk order: (offset, olen, x, y), x[i] against
    y[i] for i < olen being the overlap's byte pairs."""
    a, b = int(l1[r]), int(l2[r])
    return [(t, min(a - t, b), seq1[r, t:], rc2[r])
            for t in range(max(a - req, 0))] \
        + [(-k, min(a, b - k), seq1[r], rc2[r, k:])
           for k in range(max(b - req, 0))]


@pytest.mark.parametrize("setting", [(5, 30, 0.2), (5, 30, 0.0)])
def test_needed_compares_counts_the_walk(setting):
    """chip_smoke.py's count of the byte compares behind the kernel's
    bound, against a walk of the offsets one by one: each offset's accept
    test over min(olen, 50) positions, stopped where its mismatches pass
    the limit, and the winner's whole overlap once."""
    rows = _adversarial_rows(np.random.default_rng(12), B=96, L=160)
    seq1, rc2, l1, l2 = rows
    found, offset, ol, _ = (x.numpy() for x in t_overlap.sweep_select_plain(
        *(torch.from_numpy(x) for x in rows), *setting))
    dl, req, pct = setting
    full = needed = 0
    for r in range(96):
        walk = _offsets(seq1, rc2, l1, l2, r, req)
        if found[r]:   # offset 0 is shift 0 of whichever direction comes first
            walk = walk[:[o for o, *_ in walk].index(int(offset[r])) + 1]
            assert walk[-1][1] == ol[r]
            needed += int(ol[r])
        for _, o, x, y in walk:
            full += max(o, 0)
            needed += _test_cost(x, y, min(max(o, 0), 50), int(_limit(o, dl, pct)), 0)
    assert needed_compares(rows, found, offset, ol, setting) == (full, needed)
    assert 0 < needed < full


@pytest.mark.parametrize("name", ["gap", "adversarial", "indels"])
def test_gap_needed_compares_counts_the_walk(name):
    """chip_smoke.py's count of the byte compares behind the gapped
    variant's bound, against a walk of the gapped offsets one by one over
    the rows the ungapped pass leaves: each offset's test over olen - 2
    positions (none below olen 3, and none at olen 52 or more, which such a
    row cannot accept: test_no_gapped_accept_above_olen_51), stopped where
    its mismatches pass the limit, else with its two last compares; the
    winner's difference once."""
    seq1, rc2, l1, l2, setting = _gap_model_case(name)
    rows = (seq1, rc2, l1, l2)
    args = [torch.from_numpy(x) for x in rows]
    ungapped = [x.numpy() for x in t_overlap.sweep_select_plain(*args, *setting)]
    gapped = [x.numpy() for x in t_overlap.gap_sweep_select_plain(*args, *setting)]
    dl, req, pct = setting
    _, want = needed_compares(rows, *ungapped[:3], setting)
    for r in np.flatnonzero(~ungapped[0]):
        walk = _offsets(seq1, rc2, l1, l2, r, req)
        if gapped[4][r]:
            walk = walk[:[o for o, *_ in walk].index(int(gapped[1][r])) + 1]
            assert walk[-1][1] == gapped[2][r]
            want += 2 * (int(gapped[2][r]) - 1)
        for _, o, x, y in walk:
            want += _test_cost(x, y, o - 2 if 3 <= o <= 51 else 0,
                               int(_limit(o, dl, pct)), 2)
    assert gap_needed_compares(rows, ungapped, gapped, setting) == want
    assert gapped[4].any() or name == "adversarial"


def test_wrapper_uses_plain_version_on_cpu():
    s1, l1, s2, l2 = _corpus(6, B=32)
    before = launches.snapshot()
    _port(s1, l1, s2, l2, 5, 30, 0.2)
    _port(s1, l1, s2, l2, 5, 30, 0.2, allow_gap=True)
    assert launches.snapshot() == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the overlap kernel runs only on the card")
    for s1, l1, s2, l2 in (_corpus(7, B=512, L=160), _dirty(8, B=512),
                           _corpus(9, B=37, L=256), _corpus(10, B=3, L=100)):
        s1, l1, s2, l2 = (torch.from_numpy(x).cuda() for x in (s1, l1, s2, l2))
        rc2 = rc(s2, l2).contiguous()
        for setting in ((5, 30, 0.2), (2, 20, 0.1), (5, 30, 0.0)):
            before = launches.snapshot()
            got = overlap_cuda.sweep_select(s1, rc2, l1, l2, *setting)
            torch.cuda.synchronize()
            assert launches.since(before)["overlap_sweep"] == 1
            want = t_overlap.sweep_select_plain(s1, rc2, l1, l2, *setting)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu().to(torch.int64), w.cpu().to(torch.int64))
