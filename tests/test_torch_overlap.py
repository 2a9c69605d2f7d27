"""The port's overlap analysis against fastp_tpu's.

The plain sweep+select (fastp_tpu_torch.ops.overlap.sweep_select_plain, the
CUDA kernel's reference) is held exactly to fastp_tpu's sequential-offset
loop and to its Pallas kernel run in interpret mode; the gapped analysis
(--allow_gap_overlap_trimming) to the loop's allow_gap branch, on rows with
planted one-base insertions among others; the float32 acceptance limit is
checked as a table; the CUDA kernel itself is checked against the plain
version on the card (skipped without one).
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fastp_tpu.ops import overlap as j_overlap
from fastp_tpu.ops.overlap_pallas import analyze_pallas
from fastp_tpu_torch.ops import overlap as t_overlap
from fastp_tpu_torch.ops import overlap_cuda
from fastp_tpu_torch.ops.common import rc
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


def test_wrapper_uses_plain_version_on_cpu():
    s1, l1, s2, l2 = _corpus(6, B=32)
    before = overlap_cuda.sweep_select.launches
    _port(s1, l1, s2, l2, 5, 30, 0.2)
    assert overlap_cuda.sweep_select.launches == before


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the overlap kernel runs only on the card")
    for s1, l1, s2, l2 in (_corpus(7, B=512, L=160), _dirty(8, B=512)):
        s1, l1, s2, l2 = (torch.from_numpy(x).cuda() for x in (s1, l1, s2, l2))
        rc2 = rc(s2, l2).contiguous()
        for setting in ((5, 30, 0.2), (2, 20, 0.1), (5, 30, 0.0)):
            before = overlap_cuda.sweep_select.launches
            got = overlap_cuda.sweep_select(s1, rc2, l1, l2, *setting)
            torch.cuda.synchronize()
            assert overlap_cuda.sweep_select.launches == before + 1
            want = t_overlap.sweep_select_plain(s1, rc2, l1, l2, *setting)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu().to(torch.int64), w.cpu().to(torch.int64))
