"""The port's ops (fastp_tpu_torch.ops) against their fastp_tpu.ops
counterparts on the same numpy inputs, made from a seed.

Every output of these ops is an integer, a bool or a byte, so the tolerance
is exact: any difference is a bug.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fastp_tpu.ops import adapter as j_adapter
from fastp_tpu.ops import common as j_common
from fastp_tpu.ops import correct as j_correct
from fastp_tpu.ops import filter as j_filter
from fastp_tpu.ops import overlap as j_overlap
from fastp_tpu.ops import polyx as j_polyx
from fastp_tpu.ops import stats as j_stats
from fastp_tpu.ops import trim as j_trim
from fastp_tpu_torch.ops import adapter as t_adapter
from fastp_tpu_torch.ops import common as t_common
from fastp_tpu_torch.ops import correct as t_correct
from fastp_tpu_torch.ops import filter as t_filter
from fastp_tpu_torch.ops import overlap as t_overlap
from fastp_tpu_torch.ops import polyx as t_polyx
from fastp_tpu_torch.ops import stats as t_stats
from fastp_tpu_torch.ops import trim as t_trim
from test_torch_cli import one_torch_thread  # noqa: F401 (autouse fixture)

ADAPTER_R1 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
ADAPTER_R2 = b"AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
ALPHABET = np.frombuffer(b"ACGTACGTACGTACGTNNacgtRY.", np.uint8)
COMP = np.zeros(256, np.uint8)
for _k, _v in ((65, 84), (84, 65), (67, 71), (71, 67), (78, 78)):
    COMP[_k] = _v


def same(got, want):
    """Exact equality after casting both sides to int64 numpy."""
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), \
        np.argwhere(g.astype(np.int64) != w.astype(np.int64))[:5]


def batch(seed, B=200, L=160, min_len=0):
    """Random reads with N and non-ACGT bytes, quals 33..74, some
    G-tails and adapter read-through, zero beyond each length."""
    rng = np.random.default_rng(seed)
    bases = rng.choice(ALPHABET, (B, L))
    quals = rng.integers(33, 75, (B, L)).astype(np.uint8)
    low = rng.random((B, L)) < 0.15
    quals[low] = rng.integers(33, 45, int(low.sum()))
    lengths = rng.integers(min_len, L + 1, B).astype(np.int32)
    lengths[:4] = (0, 1, L, L - 1)
    for r in range(0, B, 5):  # poly-G / poly-A tails
        n = int(rng.integers(8, 40))
        end = int(lengths[r])
        bases[r, max(0, end - n):end] = ord("G" if r % 2 else "A")
    for r in range(2, B, 7):  # adapter read-through
        a = np.frombuffer(ADAPTER_R1 if r % 2 else ADAPTER_R2, np.uint8)
        start = int(rng.integers(-5, L))
        for i, c in enumerate(a):
            if 0 <= start + i < L:
                bases[r, start + i] = c
    pos = np.arange(L)
    bases[pos[None, :] >= lengths[:, None]] = 0
    quals[pos[None, :] >= lengths[:, None]] = 0
    return bases, quals, lengths


def pairs(seed, B=128, L=160):
    """Read pairs with planted overlaps (forward and backward offsets) and
    a few errors, the tests/test_overlap_pallas.py corpus recipe."""
    rng = np.random.default_rng(seed)
    len1 = rng.integers(40, L + 1, B).astype(np.int32)
    len2 = rng.integers(40, L + 1, B).astype(np.int32)
    s1 = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (B, L),
                    p=[.24, .24, .24, .24, .04])
    s2 = rng.choice(np.frombuffer(b"ACGT", np.uint8), (B, L))
    for i in range(B):
        if i % 3 == 2:
            continue
        l1, l2 = int(len1[i]), int(len2[i])
        off = int(rng.integers(0, 40)) if i % 3 == 0 else -int(rng.integers(0, 40))
        if off >= 0:
            olen = min(l1 - off, l2)
            for j in range(max(olen, 0)):
                s2[i, l2 - 1 - j] = COMP[s1[i, off + j]]
        else:
            k = -off
            olen = min(l1, l2 - k)
            for j in range(max(olen, 0)):
                s2[i, l2 - 1 - k - j] = COMP[s1[i, j]]
        for _ in range(int(rng.integers(0, 6))):
            s2[i, int(rng.integers(0, l2))] = rng.choice(
                np.frombuffer(b"ACGT", np.uint8))
    q1 = rng.choice(np.array([35, 47, 50, 60, 63, 70], np.uint8), (B, L))
    q2 = rng.choice(np.array([35, 47, 50, 60, 63, 70], np.uint8), (B, L))
    pos = np.arange(L)
    for s, q, ln in ((s1, q1, len1), (s2, q2, len2)):
        s[pos[None, :] >= ln[:, None]] = 0
        q[pos[None, :] >= ln[:, None]] = 0
    return s1, q1, len1, s2, q2, len2


def T(x):
    return torch.from_numpy(np.array(x))


class Cut:
    def __init__(self, front=False, tail=False, right=False, wf=4, qf=20,
                 wt=4, qt=20, wr=4, qr=20):
        self.enabledFront, self.enabledTail, self.enabledRight = front, tail, right
        self.windowSizeFront, self.qualityFront = wf, qf
        self.windowSizeTail, self.qualityTail = wt, qt
        self.windowSizeRight, self.qualityRight = wr, qr


@pytest.mark.parametrize("L", [96, 160])
def test_common_helpers(L):
    b, q, l = batch(1, L=L)
    rng = np.random.default_rng(2)
    shift = rng.integers(-3, L + 4, b.shape[0]).astype(np.int32)
    same(t_common.rc(T(b), T(l)), j_common.rc(b, l))
    same(t_common.complement(T(b)), j_common.complement(b))
    same(t_common.reverse_rows(T(q), T(l)), j_common.reverse_rows(q, l))
    same(t_common.roll_front(T(b), T(shift)), j_common.roll_front(b, shift))
    same(t_common.roll_back(T(b), T(np.abs(shift))),
         j_common.roll_back(b, np.abs(shift)))
    same(t_common.base2val(T(b)), j_common.base2val(b))
    same(t_common.base_slot(T(b)), j_common.base_slot(b))
    # first-index semantics with ties: several True per row, and none
    mask = rng.random((b.shape[0], L)) < 0.05
    mask[::3] = False
    mask[1::3, 5:9] = True
    same(t_common.first_true_index(T(mask), T(l)),
         j_common.first_true_index(mask, l))


@pytest.mark.parametrize("L", [96, 160])
def test_stat_batch(L):
    b, q, l = batch(3, L=L)
    include = np.random.default_rng(4).random(b.shape[0]) < 0.8
    got = t_stats.stat_batch(T(b), T(q), T(l), T(include))
    want = j_stats.stat_batch(b, q, l, include)
    assert set(got) == set(want)
    for k in want:
        same(got[k], want[k])


@pytest.mark.parametrize("front_arg,tail_arg,cut", [
    (0, 0, Cut()),
    (3, 2, Cut()),
    (0, 0, Cut(front=True)),
    (0, 0, Cut(tail=True)),
    (0, 0, Cut(right=True)),
    (2, 1, Cut(front=True, tail=True, wf=5, qf=25, wt=3, qt=15)),
    (1, 0, Cut(front=True, right=True, wr=6, qr=28)),
    (0, 3, Cut(tail=True, wt=1, qt=30)),
])
@pytest.mark.parametrize("L", [96, 160])
def test_trim_and_cut(L, front_arg, tail_arg, cut):
    b, q, l = batch(5, L=L)
    got = t_trim.trim_and_cut(T(b), T(q), T(l), front_arg, tail_arg, cut)
    want = j_trim.trim_and_cut(b, q, l, front_arg, tail_arg, cut)
    for g, w in zip(got, want):
        same(g, w)


@pytest.mark.parametrize("L", [96, 160])
@pytest.mark.parametrize("min_len", [10, 5])
def test_polyg_polyx(L, min_len):
    b, _, l = batch(6, L=L)
    same(t_polyx.trim_polyg(T(b), T(l), min_len), j_polyx.trim_polyg(b, l, min_len))
    for g, w in zip(t_polyx.trim_polyx(T(b), T(l), min_len),
                    j_polyx.trim_polyx(b, l, min_len)):
        same(g, w)


@pytest.mark.parametrize("L", [96, 160])
def test_correct_by_overlap(L):
    s1, q1, l1, s2, q2, l2 = pairs(7, L=L)
    ov = j_overlap._analyze_loop(s1, l1, s2, l2, 5, 30, 0.2, False)
    ov = {k: np.asarray(v) for k, v in ov.items()}
    assert ov["overlapped"].sum() > 20 and (ov["diff"] > 0).sum() > 10
    args = (ov["overlapped"], ov["offset"], ov["overlap_len"], ov["diff"])
    got = t_correct.correct_by_overlap(T(s1), T(q1), T(l1), T(s2), T(q2), T(l2),
                                       *(T(a) for a in args))
    want = j_correct.correct_by_overlap(s1, q1, l1, s2, q2, l2, *args)
    for g, w in zip(got[:8], want[:8]):
        same(g, w)
    for k in ("mask1", "mask2"):
        same(got[8][k], want[8][k])
    assert int(np.asarray(want[5]).sum()) > 0  # some bases were corrected


@pytest.mark.parametrize("C", [2048, 40, 1])
def test_extract_deltas_sparse(C):
    """Row-major slots, sentinel row B / pos 0 / flat index B*L-1 in unused
    slots, and a count above C when the list overflows."""
    rng = np.random.default_rng(8)
    B, L = 64, 96
    mask = rng.random((B, L)) < 0.02
    seq = rng.integers(1, 256, (B, L)).astype(np.uint8)
    qual = rng.integers(1, 256, (B, L)).astype(np.uint8)
    got = t_correct.extract_deltas_sparse(T(mask), T(seq), T(qual), C)
    want = j_correct.extract_deltas_sparse(mask, seq, qual, C)
    for g, w in zip(got, want):
        same(g, w)
    if C < mask.sum():
        assert int(got[4]) > C


@pytest.mark.parametrize("adapter", [ADAPTER_R1, ADAPTER_R2, b"TTTTCCACGGGG",
                                     b"GATCGGAAG", b"AGATCG"])
@pytest.mark.parametrize("L", [96, 160])
def test_trim_by_sequence(L, adapter):
    b, _, l = batch(9, L=L)
    a = torch.tensor(list(adapter), dtype=torch.uint8)
    got = t_adapter.trim_by_sequence(T(b), T(l), a)
    want = j_adapter.trim_by_sequence(b, l, adapter)
    for g, w in zip(got, want):
        same(g, w)


def test_trim_by_overlap():
    rng = np.random.default_rng(10)
    B = 256
    l1 = rng.integers(0, 161, B).astype(np.int32)
    l2 = rng.integers(0, 161, B).astype(np.int32)
    ok = rng.random(B) < 0.7
    off = rng.integers(-60, 60, B).astype(np.int32)
    ol = rng.integers(0, 161, B).astype(np.int32)
    f1 = rng.integers(0, 10, B).astype(np.int32)
    f2 = rng.integers(0, 10, B).astype(np.int32)
    args = (l1, l2, ok, off, ol, f1, f2)
    for g, w in zip(t_adapter.trim_by_overlap(*(T(a) for a in args)),
                    j_adapter.trim_by_overlap(*args)):
        same(g, w)


class FilterCfg:
    def __init__(self, qual=True, length=True, complexity=False, avg=0,
                 max_len=0):
        self.qualfilter_enabled = qual
        self.qualifiedQual = 33 + 15
        self.unqualifiedPercentLimit = 40
        self.avgQualReq = avg
        self.nBaseLimit = 5
        self.lengthFilter_enabled = length
        self.requiredLength = 15
        self.maxLength = max_len
        self.complexity_enabled = complexity
        self.complexity_threshold_percent = 30


@pytest.mark.parametrize("cfg", [FilterCfg(), FilterCfg(qual=False),
                                 FilterCfg(length=False, avg=25),
                                 FilterCfg(complexity=True, max_len=120)])
def test_pass_filter(cfg):
    b, q, l = batch(11)
    alive = np.random.default_rng(12).random(b.shape[0]) < 0.9
    same(t_filter.pass_filter(T(b), T(q), T(l), T(alive), cfg),
         j_filter.pass_filter(b, q, l, alive, cfg))


def _enc(s, width=None):
    raw = np.frombuffer(s.encode(), np.uint8)
    out = np.zeros((1, width or len(raw)), np.uint8)
    out[0, :len(raw)] = raw
    return out, np.array([len(raw)], np.int32)


def test_golden_vectors():
    """The reference self-test vectors of tests/test_ops_golden.py, through
    both packages."""
    seq = "TTTTAACCCCCCCCCCCCCCCCCCCCCCCCCCCCAATTTT"
    qual = "/////CCCCCCCCCCCC////CCCCCCCCCCCCCC////E"
    b, l = _enc(seq)
    q, _ = _enc(qual)
    cut = Cut(front=True, tail=True)
    got = t_trim.trim_and_cut(T(b), T(q), T(l), 0, 1, cut)
    for g, w in zip(got, j_trim.trim_and_cut(b, q, l, 0, 1, cut)):
        same(g, w)
    f, r = int(got[0][0]), int(got[1][0])
    assert seq[f:f + r] == "CCCCCCCCCCCCCCCCCCCCCCCCCCCC"

    b, l = _enc("ATTTTAAAAAAAAAATAAAAAAAAAAAAACAAAAAAAAAAAAAAAAAAAAAAAAAT")
    got = t_polyx.trim_polyx(T(b), T(l), 10)
    for g, w in zip(got, j_polyx.trim_polyx(b, l, 10)):
        same(g, w)
    assert int(got[0][0]) == 5 and int(got[3][0]) == 51

    b, l = _enc("ATCGATCGATC" + "G" * 24)
    assert int(t_polyx.trim_polyg(T(b), T(l), 10)[0]) == 7

    b, l = _enc("TTTTAACCCCCCCCCCCCCCCCCCCCCCCCCCCCAATTTTAAAATTTTCCCCGGGG")
    a = b"TTTTCCACGGGGATACTACTG"
    got = t_adapter.trim_by_sequence(T(b), T(l), torch.tensor(list(a),
                                                              dtype=torch.uint8))
    for g, w in zip(got, j_adapter.trim_by_sequence(b, l, a)):
        same(g, w)
    assert int(got[0][0]) == 44

    r1 = ("CAGCGCCTACGGGCCCCTTTTTCTGCGCGACCGCGTGGCTGTGGGCGCGGATGCCTTTGAGCGCGG"
          "TGACTTCTCACTGCGTATCGAGC")
    r2 = ("ACCTCCAGCGGCTCGATACGCAGTGAGAAGTCACCGCGCTCAAAGGCATCCGCGCCCACAGCCACG"
          "CGGTCGCGCAGAAAAAGGGGTCC")
    b1, l1 = _enc(r1)
    b2, l2 = _enc(r2)
    ov = t_overlap.analyze(T(b1), T(l1), T(b2), T(l2), 2, 30, 0.2)
    assert (bool(ov["overlapped"][0]), int(ov["offset"][0]),
            int(ov["overlap_len"][0]), int(ov["diff"][0])) == (True, 10, 79, 1)

    s1 = "TTTTAACCCCCCCCCCCCCCCCCCCCCCCCCCCCAATTTTAAAATTTTCCACGGGG"
    q1 = "EEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEE/EEEEE"
    s2 = "AAAAAAAAAACCCCGGGGAAAATTTTAAAATTGGGGGGGGGGTGGGGGGGGGGGGG"
    q2 = "EEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEE/EEEEEEEEEEEEE"
    (b1, l1), (b2, l2) = _enc(s1), _enc(s2)
    (qb1, _), (qb2, _) = _enc(q1), _enc(q2)
    ov = t_overlap.analyze(T(b1), T(l1), T(b2), T(l2), 5, 30, 0.2)
    out = t_correct.correct_by_overlap(
        T(b1), T(qb1), T(l1), T(b2), T(qb2), T(l2), ov["overlapped"],
        ov["offset"], ov["overlap_len"], ov["diff"])
    assert bytes(out[0][0].numpy()).decode() == s1.replace("CCACGGGG", "CCCCGGGG")
    assert bytes(out[2][0].numpy()).decode() == s2.replace("GTGGG", "GGGGG")
    assert bytes(out[1][0].numpy()).decode() == "E" * 56
    assert bytes(out[3][0].numpy()).decode() == "E" * 56
