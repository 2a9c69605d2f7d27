"""The port's overlap analysis against fastp_tpu's.

The plain sweep+select (fastp_tpu_torch.ops.overlap.sweep_select_plain, the
CUDA kernel's reference) is held exactly to fastp_tpu's sequential-offset
loop and to its Pallas kernel run in interpret mode; the gapped analysis
(--allow_gap_overlap_trimming) to the loop's allow_gap branch, on rows with
planted one-base insertions among others; the float32 acceptance limit is
checked as a table; the CUDA kernel itself is checked against the plain
version on the card (skipped without one).

The kernel cannot run without a card, so its arithmetic is modelled here in
numpy, step for step (`kernel_model`: the padded rows as 32-bit words, the
unaligned fetch from two aligned words, the carry-trick byte count, the
mask of the last word, the 50-position prefix that ends two bytes into
word 12, the round that ends once every lane's count has passed diff_limit,
32 offsets a round with the lowest set bit of the ballot winning, forward
rounds before backward, the full count split over the lanes), and
the model is held exactly to the plain version and to fastp_tpu's loop on
chip_smoke.py's adversarial rows.  A read outside a staged row raises in
the model, where the kernel would read another row's bytes.
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
from chip_smoke import _adversarial_rows, needed_compares
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


def gap_rows(seed, B=48, L=96):
    """Pairs that overlap with a one-base insertion near the end of the
    overlap (olen 36..49, four substitutions before it), so that no offset
    passes the ungapped test and the one-insertion pass accepts.  The
    extra base sits in read 1 or in rc(read 2), the overlap at a forward or
    a backward offset.  Returns (s1, len1, s2, len2) as uint8/int32 numpy."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    s1 = np.zeros((B, L), np.uint8)
    rc2 = np.zeros((B, L), np.uint8)
    len1 = np.zeros(B, np.int32)
    len2 = np.zeros(B, np.int32)
    for r in range(B):
        n = int(rng.integers(36, 50))
        ins = rng.choice(acgt, n)
        ins[n - 1] = acgt[(list(acgt).index(ins[n - 2]) + 1) % 4]
        p = n - 2
        norm = np.concatenate([ins[:p], ins[p + 1:n],
                               [acgt[(list(acgt).index(ins[n - 1]) + 2) % 4]]])
        for j in rng.choice(p, 4, replace=False):
            norm[j] = acgt[(list(acgt).index(ins[j]) + 1) % 4]
        a, b = (ins, norm) if r % 2 == 0 else (norm, ins)   # read 1, rc(read 2)
        shift = int(rng.integers(0, 12))
        lead = rng.choice(acgt, shift)
        if r % 4 < 2:      # forward offset `shift`
            s1[r, :shift + n] = np.concatenate([lead, a])
            rc2[r, :n] = b
            len1[r], len2[r] = shift + n, n
        else:              # backward offset -shift
            s1[r, :n] = a
            rc2[r, :shift + n] = np.concatenate([lead, b])
            len1[r], len2[r] = n, shift + n
    s2 = rc(torch.from_numpy(rc2), torch.from_numpy(len2)).numpy()
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


@pytest.mark.parametrize("rows", ["corpus", "dirty", "gap"])
def test_gapped_matches_analyze_loop(rows):
    """The ungapped pass plus the one-insertion pass against the loop's
    allow_gap branch, every key including has_gap."""
    s1, l1, s2, l2 = {"corpus": lambda: _corpus(9, L=96),
                      "dirty": lambda: _dirty(10, B=48),
                      "gap": lambda: gap_rows(11)}[rows]()
    want = j_overlap._analyze_loop(s1, l1, s2, l2, 5, 30, 0.2, True)
    _same(_port(s1, l1, s2, l2, 5, 30, 0.2, allow_gap=True), want,
          KEYS + ("has_gap",))
    if rows == "gap":   # the planted insertions are found only with a gap
        has_gap = np.asarray(want["has_gap"])
        assert has_gap.sum() > len(has_gap) // 2
        assert (np.asarray(want["offset"])[has_gap] < 0).any()
        assert not np.asarray(_port(s1, l1, s2, l2, 5, 30, 0.2)[
            "overlapped"]).any()


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
    lengths 0 <= n <= 50.  Lanes with n == 0 read nothing; the warp leaves
    the loop once no lane both has words left and a count within dl."""
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
    return mm


def _limit(olen, dl, pct):
    lim = (np.maximum(olen, 0).astype(np.float32) * np.float32(pct)).astype(np.int64)
    return np.minimum(lim, dl)


def _first_accept(x32, y32, lx, ly, dl, req, pct):
    n_cand = lx - req
    for base in range(0, max(n_cand, 0), 32):
        s = base + LANES
        olen = np.minimum(lx - s, ly)
        n = np.where(s < n_cand, np.minimum(np.maximum(olen, 0), 50), 0)
        accept = (s < n_cand) & (_count_prefix(x32, y32, s, n, dl)
                                 <= _limit(olen, dl, pct))
        votes = int(np.sum(accept.astype(np.int64) << LANES))
        if votes:
            win = base + (votes & -votes).bit_length() - 1   # __ffs - 1
            return win, min(lx - win, ly)
    return None


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


def kernel_model(seq1, rc2, len1, len2, dl, req, pct):
    """csrc/overlap_sweep.cu in numpy, one pair row (warp) at a time."""
    B, L = seq1.shape
    out = np.zeros((4, B), np.int64)
    for r in range(B):
        a32, b32 = _staged_words(seq1[r], L), _staged_words(rc2[r], L)
        l1 = min(max(int(len1[r]), 0), L)
        l2 = min(max(int(len2[r]), 0), L)
        hit = _first_accept(a32, b32, l1, l2, dl, req, pct)
        if hit is not None:
            out[:, r] = 1, hit[0], hit[1], _count_total(a32, b32, *hit)
            continue
        hit = _first_accept(b32, a32, l2, l1, dl, req, pct)
        if hit is not None:
            out[:, r] = 1, -hit[0], hit[1], _count_total(b32, a32, *hit)
    return dict(zip(KEYS, out))


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


@pytest.mark.parametrize("L,stride,rows", [
    (160, 176, 8), (256, 272, 8), (100, 128, 8), (32, 48, 8),
    (3072, 3088, 7), (24560, 24576, 1), (24576, 24592, 0), (0, 16, 0)])
def test_shared_memory_rows(L, stride, rows):
    assert overlap_cuda.padded_row_bytes(L) == stride
    assert overlap_cuda.rows_per_block(L) == rows
    # the furthest word the kernel reads: the one after the word that holds
    # byte L - 1 + 3 (an unaligned fetch of the last full word)
    assert L <= 0 or 4 * ((L - 1 + 3) // 4 + 1) + 4 <= stride


@pytest.mark.parametrize("setting", [(5, 30, 0.2), (5, 30, 0.0)])
def test_needed_compares_counts_the_walk(setting):
    """chip_smoke.py's count of the byte compares behind the kernel's
    bound, against a walk of the offsets one by one."""
    seq1, rc2, l1, l2 = _adversarial_rows(np.random.default_rng(12), B=96, L=160)
    found, offset, ol, _ = (x.numpy() for x in t_overlap.sweep_select_plain(
        *(torch.from_numpy(x) for x in (seq1, rc2, l1, l2)), *setting))
    req = setting[1]
    full = prefix = 0
    for r in range(96):
        a, b = int(l1[r]), int(l2[r])
        walk = [(t, min(a - t, b)) for t in range(max(a - req, 0))] \
            + [(-k, min(a, b - k)) for k in range(max(b - req, 0))]
        if found[r]:   # offset 0 is shift 0 of whichever direction comes first
            walk = walk[:[o for o, _ in walk].index(int(offset[r])) + 1]
            assert walk[-1][1] == ol[r]
            prefix += int(ol[r])
        walk = [o for _, o in walk]
        full += sum(max(o, 0) for o in walk)
        prefix += sum(min(max(o, 0), 50) for o in walk)
    assert needed_compares(found, offset, ol, l1, l2, req) == (full, prefix)
    assert 0 < prefix < full


def test_wrapper_uses_plain_version_on_cpu():
    s1, l1, s2, l2 = _corpus(6, B=32)
    before = launches.snapshot()
    _port(s1, l1, s2, l2, 5, 30, 0.2)
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
