"""`fastp_tpu_torch test` -- built-in self tests mirroring `fastp test`
(reference: src/unittest.cpp:18-32), on tensors of the run's device.  The
reference's component tests are reproduced under the names fastp_tpu gives
them: Sequence, Read, FastqReader, Filter, PolyX, AdapterTrimmer,
OverlapAnalysis, ReadPair(merge), BaseCorrector, NucleotideTree, Evaluator.
On a card the three overlap checks go through the hand-written overlap
kernel at one pair row."""
from __future__ import annotations

import numpy as np
import torch


def _encoder(device):
    def enc(s):
        b = np.frombuffer(s.encode() if isinstance(s, str) else s, np.uint8)
        return (torch.from_numpy(b.copy()).reshape(1, -1).to(device),
                torch.tensor([len(b)], dtype=torch.int32, device=device))
    return enc


def _dec(arr, length):
    return bytes(arr.cpu().numpy()[0, :int(length)]).decode()


def run_self_tests(device) -> bool:
    """Run the checks on `device` (a torch.device: the caller resolved it);
    prints one line per check and returns whether all passed."""
    _enc = _encoder(device)
    from .ops import trim as trim_ops
    from .ops import polyx as polyx_ops
    from .ops import adapter as adapter_ops
    from .ops import overlap as overlap_ops
    from .ops import correct as correct_ops
    from .ops import merge as merge_ops
    from .ops.common import rc

    ok = True

    def check(name, cond):
        nonlocal ok
        print("%s: %s" % (name, "PASSED" if cond else "FAILED"))
        ok = ok and cond

    # Sequence::test (reference: src/sequence.cpp:85-97)
    s, l = _enc("AAAATTTTCCCCGGGG")
    out = rc(s, l)
    check("Sequence::reverseComplement",
          _dec(out, 16) == "CCCCGGGGAAAATTTT")

    # Read::test (reference: src/read.cpp:192-199) -- name index parsing
    from .utils.readname import last_index, first_index
    name = b"@NS500713:64:HFKJJBGXY:1:11101:20469:1097 1:N:0:TATAGCCT+GGTCCCGA"
    check("Read::lastIndex", last_index(name) == b"GGTCCCGA"
          and first_index(name) == b"TATAGCCT")

    # FastqReader::test equivalent: tokenize an embedded 2-record stream
    # incl. an empty-sequence record (reference: src/fastqreader.cpp:386-404
    # reads testdata/R1.fq with the same shapes)
    from .io.fastq import FastqReader
    import io as _io
    data = (b"@r1 comment\nACGTN\n+\nFFFFF\n"
            b"@r2\n\n+\n\n"
            b"@r3\nGGCC\n+\nFFFF\n")
    rd = FastqReader.__new__(FastqReader)
    rd.phred64 = False
    rd._fh = _io.BytesIO(data)
    rd._zipped = False
    rd._decomp = None
    rd._lines = []
    rd._lidx = 0
    rd._tail = b""
    rd._eof = False
    rd._stopped = False
    rd.bytes_read = 0
    rd._budget = None
    rd._skip_lines = 0
    rd._records_left = None
    r1 = rd.read()
    r2 = rd.read()
    r3 = rd.read()
    check("FastqReader::read",
          r1 is not None and r1.name == b"@r1 comment" and r1.seq == b"ACGTN"
          and r2 is not None and r2.seq == b""
          and r3 is not None and r3.qual == b"FFFF" and rd.read() is None)

    # Filter::test (reference: src/filter.cpp:260-279)
    class QC:
        enabledFront = True
        enabledTail = True
        enabledRight = False
        windowSizeFront = 4
        qualityFront = 20
        windowSizeTail = 4
        qualityTail = 20
        windowSizeRight = 4
        qualityRight = 20
    seq = "TTTTAACCCCCCCCCCCCCCCCCCCCCCCCCCCCAATTTT"
    qual = "/////CCCCCCCCCCCC////CCCCCCCCCCCCCC////E"
    b, l = _enc(seq)
    q, _ = _enc(qual)
    front, rlen, alive = trim_ops.trim_and_cut(b, q, l, 0, 1, QC)
    f, r = int(front[0]), int(rlen[0])
    check("Filter::trimAndCut",
          bool(alive[0]) and seq[f:f + r] == "CCCCCCCCCCCCCCCCCCCCCCCCCCCC"
          and qual[f:f + r] == "CCCCCCCCCCC////CCCCCCCCCCCCC")

    # PolyX::test (reference: src/polyx.cpp:118-130)
    seq = "ATTTTAAAAAAAAAATAAAAAAAAAAAAACAAAAAAAAAAAAAAAAAAAAAAAAAT"
    b, l = _enc(seq)
    new_len, trimmed, poly, nbases = polyx_ops.trim_polyx(b, l, 10)
    check("PolyX::trimPolyX",
          _dec(b, new_len[0]) == "ATTTT" and int(nbases[0]) == 51)

    # AdapterTrimmer::test (reference: src/adaptertrimmer.cpp:172-195)
    seq = "TTTTAACCCCCCCCCCCCCCCCCCCCCCCCCCCCAATTTTAAAATTTTCCCCGGGG"
    b, l = _enc(seq)
    new_len, found, _pos = adapter_ops.trim_by_sequence(
        b, l, _enc("TTTTCCACGGGGATACTACTG")[0][0])
    check("AdapterTrimmer::trimBySequence",
          bool(found[0]) and _dec(b, new_len[0])
          == "TTTTAACCCCCCCCCCCCCCCCCCCCCCCCCCCCAATTTTAAAA")

    # OverlapAnalysis::test (reference: src/overlapanalysis.cpp:185-203)
    r1s = "CAGCGCCTACGGGCCCCTTTTTCTGCGCGACCGCGTGGCTGTGGGCGCGGATGCCTTTGAGCGCGGTGACTTCTCACTGCGTATCGAGC"
    r2s = "ACCTCCAGCGGCTCGATACGCAGTGAGAAGTCACCGCGCTCAAAGGCATCCGCGCCCACAGCCACGCGGTCGCGCAGAAAAAGGGGTCC"
    b1, l1 = _enc(r1s)
    b2, l2 = _enc(r2s)
    ov = overlap_ops.analyze(b1, l1, b2, l2, 2, 30, 0.2)
    check("OverlapAnalysis::analyze",
          bool(ov["overlapped"][0]) and int(ov["offset"][0]) == 10
          and int(ov["overlap_len"][0]) == 79 and int(ov["diff"][0]) == 1)

    # ReadPair merge golden (reference: src/read.cpp:291-310 uses the same
    # overlap pair; merged = r1[:ol+off] + rc(r2)[ol:])
    q1, _ = _enc("F" * 89)
    q2, _ = _enc("#" * 89)
    ms, mq, ml, l1m, l2m = merge_ops.merge_pairs(
        b1, q1, l1, b2, q2, l2,
        ov["overlapped"], ov["offset"], ov["overlap_len"], out_width=192)
    rc2 = r2s[::-1].translate(str.maketrans("ATCG", "TAGC"))
    exp = r1s[:89] + rc2[79:89]
    check("ReadPair::fastMerge",
          int(ml[0]) == len(exp) and _dec(ms, ml[0]) == exp)

    # BaseCorrector::test (reference: src/basecorrector.cpp:85-107)
    s1 = "TTTTAACCCCCCCCCCCCCCCCCCCCCCCCCCCCAATTTTAAAATTTTCCACGGGG"
    cq1 = "EEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEE/EEEEE"
    s2 = "AAAAAAAAAACCCCGGGGAAAATTTTAAAATTGGGGGGGGGGTGGGGGGGGGGGGG"
    cq2 = "EEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEEE/EEEEEEEEEEEEE"
    cb1, cl1 = _enc(s1)
    cb2, cl2 = _enc(s2)
    cqb1, _ = _enc(cq1)
    cqb2, _ = _enc(cq2)
    cov = overlap_ops.analyze(cb1, cl1, cb2, cl2, 5, 30, 0.2)
    ns1, nq1, ns2, nq2, _cm, _corr, _r1c, _r2c, _m = correct_ops.correct_by_overlap(
        cb1, cqb1, cl1, cb2, cqb2, cl2,
        cov["overlapped"], cov["offset"], cov["overlap_len"], cov["diff"])
    check("BaseCorrector::correctByOverlapAnalysis",
          _dec(ns1, 56) == "TTTTAACCCCCCCCCCCCCCCCCCCCCCCCCCCCAATTTTAAAATTTTCCCCGGGG"
          and _dec(ns2, 56) == "AAAAAAAAAACCCCGGGGAAAATTTTAAAATTGGGGGGGGGGGGGGGGGGGGGGGG"
          and _dec(nq1, 56) == "E" * 56 and _dec(nq2, 56) == "E" * 56)

    # NucleotideTree::test (reference: src/nucleotidetree.cpp:90-104):
    # dominant-path consensus over noisy copies of one sequence
    from .evaluator import NucleotideTree
    tree = NucleotideTree()
    base_seq = b"AAAATTTTCCCCGGGGATCGATCGATCG"
    for i in range(100):
        tail = b"ATCG"[i % 4:i % 4 + 1] if i % 10 == 0 else b""
        tree.add_seq(base_seq + tail)
    path, _reached_leaf = tree.dominant_path()
    check("NucleotideTree::getDominantPath",
          path.startswith(base_seq.decode()))

    # Evaluator::test (reference: src/evaluator.cpp:615-620): seq <-> int
    from .evaluator import _seq2int, _int2seq
    key = _seq2int(b"ATCGATCGAT", 0, 10, -1)
    check("Evaluator::seq2int", key >= 0 and _int2seq(key, 10) == "ATCGATCGAT")

    print("\n==========================")
    print("ALL PASSED" if ok else "SOME FAILED")
    return ok
