"""Pre-pass evaluation: sequence length, read count, two-color detection,
overrepresented sequences, and adapter auto-detection
(reference: src/evaluator.cpp:16-613).

The adapter auto-detection is inherently sequential-adaptive (running-count
skip heuristics), so it is reproduced exactly on the host; the 10-mer seed
histogram and low-complexity key filtering are vectorized with numpy.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import Options
from .io.fastq import FastqReader, Record
from .knownadapters import get_known_adapters


def _seq2int(seq: bytes, pos: int, keylen: int, last_val: int) -> int:
    """reference: src/evaluator.cpp:560-613"""
    table = {65: 0, 84: 1, 67: 2, 71: 3}  # A T C G
    if last_val >= 0:
        mask = (1 << (keylen * 2)) - 1
        key = (last_val << 2) & mask
        v = table.get(seq[pos + keylen - 1])
        if v is None:
            return -1
        return key + v
    key = 0
    for i in range(pos, pos + keylen):
        v = table.get(seq[i])
        if v is None:
            return -1
        key = (key << 2) + v
    return key


def _int2seq(val: int, seqlen: int) -> str:
    bases = "ATCG"
    out = ["N"] * seqlen
    for d in range(seqlen):
        out[seqlen - d - 1] = bases[val & 0x03]
        val >>= 2
    return "".join(out)


class NucleotideTree:
    """Count trie over base chars (reference: src/nucleotidetree.cpp:32-88)."""

    __slots__ = ("children", "counts")

    def __init__(self):
        self.children: Dict[int, "NucleotideTree"] = {}
        self.counts: Dict[int, int] = {}

    def add_seq(self, seq: bytes):
        cur = self
        for ch in seq:
            if ch == 78:  # 'N'
                break
            b = ch & 0x07
            if b not in cur.children:
                cur.children[b] = NucleotideTree()
                cur.counts[b] = 0
            cur.counts[b] = cur.counts.get(b, 0) + 1
            cur = cur.children[b]

    def dominant_path(self) -> Tuple[str, bool]:
        """Returns (path, reached_leaf)."""
        RATIO = 0.95
        NUM = 50
        reached_leaf = True
        out = []
        cur = self
        base_of_slot = {ord(c) & 7: c for c in "ATCGN"}
        while True:
            total = sum(cur.counts.get(b, 0) for b in cur.children)
            if total < NUM:
                break
            dominant = None
            for b in sorted(cur.children):
                if cur.counts[b] / total >= RATIO:
                    dominant = b
                    break
            if dominant is None:
                reached_leaf = False
                break
            out.append(base_of_slot.get(dominant, "N"))
            cur = cur.children[dominant]
        return "".join(out), reached_leaf


class Evaluator:
    def __init__(self, opt: Options):
        self.opt = opt

    # -- simple evaluations ------------------------------------------------
    def is_two_color_system(self) -> bool:
        """reference: src/evaluator.cpp:16-32"""
        reader = FastqReader(self.opt.in1)
        r = reader.read()
        reader.close()
        if r is None:
            return False
        return (r.name.startswith(b"@NS") or r.name.startswith(b"@NB")
                or r.name.startswith(b"@NDX") or r.name.startswith(b"@A0"))

    def evaluate_seq_len(self):
        if self.opt.in1:
            self.opt.seqLen1 = self._compute_seq_len(self.opt.in1)
        if self.opt.in2:
            self.opt.seqLen2 = self._compute_seq_len(self.opt.in2)

    def _compute_seq_len(self, filename: str) -> int:
        reader = FastqReader(filename)
        seqlen = 0
        for _ in range(1000):
            r = reader.read()
            if r is None:
                break
            seqlen = max(seqlen, len(r.seq))
        reader.close()
        return seqlen

    def evaluate_read_num(self) -> int:
        """reference: src/evaluator.cpp:165-205"""
        reader = FastqReader(self.opt.in1)
        READ_LIMIT = 512 * 1024
        BASE_LIMIT = 151 * 512 * 1024
        records = 0
        bases = 0
        first_pos = 0
        reached_eof = False
        first = True
        while records < READ_LIMIT and bases < BASE_LIMIT:
            r = reader.read()
            if r is None:
                reached_eof = True
                break
            if first:
                first_pos = reader.bytes_read
                first = False
            records += 1
            bases += len(r.seq)
        import os
        total = os.path.getsize(self.opt.in1)
        reader.close()
        if reached_eof:
            return records
        if records > 0:
            bytes_per_read = (reader.bytes_read - first_pos) / records
            return int(total * 1.01 / bytes_per_read)
        return 0

    # -- overrepresented sequences (reference: src/evaluator.cpp:65-163) ---
    def evaluate_overrep_seqs(self):
        if self.opt.in1:
            self.opt.overRepSeqs1 = self._compute_overrep_seq(self.opt.in1, self.opt.seqLen1)
        if self.opt.in2:
            self.opt.overRepSeqs2 = self._compute_overrep_seq(self.opt.in2, self.opt.seqLen2)

    def _compute_overrep_seq(self, filename: str, seqlen: int) -> Dict[str, int]:
        reader = FastqReader(filename)
        BASE_LIMIT = 151 * 10000
        bases = 0
        seq_counts: Dict[bytes, int] = {}
        steps = [10, 20, 40, 100, min(150, seqlen - 2)]
        while bases < BASE_LIMIT:
            r = reader.read()
            if r is None:
                break
            rlen = len(r.seq)
            bases += rlen
            s = r.seq
            for step in steps:
                for i in range(0, rlen - step):
                    k = s[i:i + step]
                    seq_counts[k] = seq_counts.get(k, 0) + 1
        reader.close()

        hotseqs: Dict[str, int] = {}
        for k, count in seq_counts.items():
            n = len(k)
            if n >= seqlen - 1:
                if count >= 3:
                    hotseqs[k.decode()] = count
            elif n >= 100:
                if count >= 5:
                    hotseqs[k.decode()] = count
            elif n >= 40:
                if count >= 20:
                    hotseqs[k.decode()] = count
            elif n >= 20:
                if count >= 100:
                    hotseqs[k.decode()] = count
            elif n >= 10:
                if count >= 500:
                    hotseqs[k.decode()] = count

        # remove substrings (iteration in std::map order = sorted)
        keys = sorted(hotseqs)
        removed = set()
        for seq in keys:
            if seq in removed:
                continue
            count = hotseqs[seq]
            for seq2 in keys:
                if seq2 in removed:
                    continue
                count2 = hotseqs[seq2]
                if seq != seq2 and seq in seq2 and count // count2 < 10:
                    removed.add(seq)
                    break
        return {k: v for k, v in hotseqs.items() if k not in removed}

    # -- adapter detection (reference: src/evaluator.cpp:207-526) ----------
    def eval_adapter_and_read_num(self, is_r2: bool) -> Tuple[str, int]:
        """Native array path when the C++ helpers are available (the
        256K-read scans are far too slow in per-record Python)."""
        from .io import native as native_mod
        if native_mod.get_lib() is not None:
            return self._eval_adapter_and_read_num_native(is_r2)
        return self._eval_adapter_and_read_num_py(is_r2)

    def _eval_adapter_and_read_num_native(self, is_r2: bool) -> Tuple[str, int]:
        import os
        from .io import native as native_mod
        from .io.fastq import ArrayFastqReader
        filename = self.opt.in2 if is_r2 else self.opt.in1
        READ_LIMIT = 256 * 1024
        BASE_LIMIT = 151 * READ_LIMIT
        reader = ArrayFastqReader(filename)
        chunks = []
        records = 0
        width = 192
        reached_eof = False
        while records < READ_LIMIT:
            bt = reader.read_batch(min(65536, READ_LIMIT - records), width)
            if bt is None:
                reached_eof = True
                break
            width = max(width, bt.width)
            chunks.append(bt)
            records += bt.n
            if sum(int(c.lengths.sum()) for c in chunks) >= BASE_LIMIT:
                break
        reader.close()
        if records == 0:
            return "", 0
        bases = np.zeros((records, width), np.uint8)
        lengths = np.zeros(records, np.int32)
        rec_bytes = np.zeros(records, np.int64)
        off = 0
        for c in chunks:
            bases[off:off + c.n, :c.width] = c.bases
            lengths[off:off + c.n] = c.lengths
            rec_bytes[off:off + c.n] = (c.name_len.astype(np.int64)
                                        + c.strand_len
                                        + 2 * c.lengths + 4)
            off += c.n
        # replicate the reference's per-read stop condition exactly:
        # keep read i iff i < READ_LIMIT and bases-before(i) < BASE_LIMIT
        cum_before = np.concatenate([[0], np.cumsum(lengths[:-1], dtype=np.int64)])
        keep = int(np.searchsorted(cum_before, BASE_LIMIT, "left"))
        if keep < records:
            reached_eof = False
            bases = bases[:keep]
            lengths = lengths[:keep]
            rec_bytes = rec_bytes[:keep]
            records = keep

        if reached_eof:
            read_num = records
        elif records > 1:
            total = os.path.getsize(filename)
            bytes_per_read = float(rec_bytes[1:].mean())
            read_num = int(total * 1.01 / bytes_per_read)
        else:
            read_num = records

        if records < 10000:
            return "", read_num

        lib = native_mod.get_lib()
        known = get_known_adapters()
        adapters = sorted(known)  # std::map order
        blob = b"".join(a.encode() for a in adapters)
        alens = np.array([len(a) for a in adapters], np.int32)
        aoffs = np.zeros(len(adapters), np.int64)
        np.cumsum(alens[:-1], out=aoffs[1:])
        counts_out = np.zeros(len(adapters), np.int64)
        mism_out = np.zeros(len(adapters), np.int64)
        import ctypes
        checked = ctypes.c_int64(0)
        best_i = lib.known_adapter_scan(
            bases, lengths, records, width,
            np.frombuffer(blob, np.uint8), aoffs, alens, len(adapters),
            counts_out, mism_out, ctypes.byref(checked))
        checked_reads = int(checked.value)
        if best_i >= 0:
            max_count = int(counts_out[best_i])
            best = adapters[best_i]
            if max_count > checked_reads // 50 or (
                    max_count > checked_reads // 200
                    and int(mism_out[best_i]) < checked_reads):
                sys.stderr.write(known[best] + "\n" + best + "\n")
                return best, read_num

        shift_tail = max(1, self.opt.trim.tail1)
        keylen = 10
        size = 1 << (keylen * 2)
        counts = np.zeros(size, np.uint32)
        lib.seed_histogram(bases, lengths, records, width, shift_tail, counts)
        counts[0] = 0
        adapter = self._pick_top_seed_adapter(
            counts, size, keylen,
            lambda seed: self._get_adapter_with_seed_native(
                seed, bases, lengths, keylen, shift_tail))
        return adapter, read_num

    def _pick_top_seed_adapter(self, counts, size, keylen, seed_extend):
        """Candidate filtering + top-10 fold test
        (reference: src/evaluator.cpp:390-439)."""
        keys_all = np.arange(size, dtype=np.int64)
        atcg = np.zeros((4, size), np.int16)
        for i in range(keylen):
            b = (keys_all >> (i * 2)) & 0x03
            for base in range(4):
                atcg[base] += (b == base)
        low_complexity = (atcg >= keylen - 4).any(axis=0)
        too_gc = (atcg[2] + atcg[3]) >= keylen - 2
        starts_gggg = (keys_all >> 12) == 0xFF
        candidate = ~(low_complexity | too_gc | starts_gggg)
        total = int(counts[candidate].sum())

        cand_keys = keys_all[candidate]
        cand_counts = counts[candidate].astype(np.int64)
        order = np.lexsort((cand_keys, cand_counts))[::-1]
        topkeys = cand_keys[order[:10]]

        FOLD_THRESHOLD = 20
        for key in topkeys:
            key = int(key)
            if key == 0:
                continue
            seq = _int2seq(key, keylen)
            count = int(counts[key])
            if count < 10 or count * size < total * FOLD_THRESHOLD:
                break
            diff = sum(1 for s_ in range(len(seq) - 1) if seq[s_] != seq[s_ + 1])
            if diff < 3:
                continue
            adapter = seed_extend(key)
            if adapter:
                return adapter
        return ""

    def _get_adapter_with_seed_native(self, seed: int, bases, lengths,
                                      keylen: int, shift_tail: int) -> str:
        from .io import native as native_mod
        lib = native_mod.get_lib()
        CAP = 200000
        hit_read = np.zeros(CAP, np.int32)
        hit_pos = np.zeros(CAP, np.int32)
        n = int(lib.collect_seed_hits(bases, lengths, len(lengths),
                                      bases.shape[1], seed, shift_tail,
                                      500, CAP, hit_read, hit_pos))
        fwd = NucleotideTree()
        bwd = NucleotideTree()
        for k in range(n):
            r = int(hit_read[k])
            p = int(hit_pos[k])
            rlen = int(lengths[r])
            row = bases[r]
            fwd.add_seq(row[p + keylen: rlen - shift_tail].tobytes())
            bwd.add_seq(row[:p].tobytes()[::-1])
        fpath, fwd_ok = fwd.dominant_path()
        bpath, bwd_ok = bwd.dominant_path()
        reached_leaf = fwd_ok and bwd_ok
        adapter = bpath[::-1] + _int2seq(seed, keylen) + fpath
        if len(adapter) > 60:
            adapter = adapter[:60]
        matched = self._match_known_adapter(adapter)
        if matched:
            known = get_known_adapters()
            sys.stderr.write(known[matched] + "\n" + matched + "\n")
            return matched
        if reached_leaf:
            sys.stderr.write(adapter + "\n")
            return adapter
        return ""

    def _eval_adapter_and_read_num_py(self, is_r2: bool) -> Tuple[str, int]:
        filename = self.opt.in2 if is_r2 else self.opt.in1
        reader = FastqReader(filename)
        READ_LIMIT = 256 * 1024
        BASE_LIMIT = 151 * READ_LIMIT
        records = 0
        bases = 0
        first_pos = 0
        first = True
        reached_eof = False
        reads: List[Record] = []
        while records < READ_LIMIT and bases < BASE_LIMIT:
            r = reader.read()
            if r is None:
                reached_eof = True
                break
            if first:
                first_pos = reader.bytes_read
                first = False
            bases += len(r.seq)
            reads.append(r)
            records += 1
        import os
        read_num = 0
        if reached_eof:
            read_num = records
        elif records > 0:
            total = os.path.getsize(filename)
            bytes_per_read = (reader.bytes_read - first_pos) / records
            read_num = int(total * 1.01 / bytes_per_read)
        reader.close()

        if records < 10000:
            return "", read_num

        known = self._check_known_adapters(reads)
        if len(known) > 8:
            return known, read_num

        shift_tail = max(1, self.opt.trim.tail1)
        keylen = 10
        size = 1 << (keylen * 2)
        counts = np.zeros(size, np.uint32)
        # vectorized rolling 10-mer histogram over positions 20..len-10-shiftTail
        for r in reads:
            s = np.frombuffer(r.seq, np.uint8)
            rlen = len(s)
            hi = rlen - keylen - shift_tail  # inclusive last pos
            if hi < 20:
                continue
            v = np.full(rlen, -1, np.int64)
            v[s == 65] = 0
            v[s == 84] = 1
            v[s == 67] = 2
            v[s == 71] = 3
            # keys at pos p use bases p..p+9
            npos = hi - 20 + 1
            keys = np.zeros(npos, np.int64)
            ok = np.ones(npos, bool)
            for k in range(keylen):
                chunk = v[20 + k: 20 + k + npos]
                keys = (keys << 2) | np.maximum(chunk, 0)
                ok &= chunk >= 0
            np.add.at(counts, keys[ok], 1)
        counts[0] = 0

        # candidate filters (reference: src/evaluator.cpp:390-409)
        keys_all = np.arange(size, dtype=np.int64)
        atcg = np.zeros((4, size), np.int16)
        for i in range(keylen):
            b = (keys_all >> (i * 2)) & 0x03
            for base in range(4):
                atcg[base] += (b == base)
        low_complexity = (atcg >= keylen - 4).any(axis=0)
        too_gc = (atcg[2] + atcg[3]) >= keylen - 2
        starts_gggg = (keys_all >> 12) == 0xFF
        candidate = ~(low_complexity | too_gc | starts_gggg)
        total = int(counts[candidate].sum())

        # top-10 by (count desc, key desc) among candidates
        cand_keys = keys_all[candidate]
        cand_counts = counts[candidate].astype(np.int64)
        order = np.lexsort((cand_keys, cand_counts))[::-1]
        topkeys = cand_keys[order[:10]]

        FOLD_THRESHOLD = 20
        for key in topkeys:
            key = int(key)
            if key == 0:
                continue
            seq = _int2seq(key, keylen)
            count = int(counts[key])
            if count < 10 or count * size < total * FOLD_THRESHOLD:
                break
            diff = sum(1 for s_ in range(len(seq) - 1) if seq[s_] != seq[s_ + 1])
            if diff < 3:
                continue
            adapter = self._get_adapter_with_seed(key, reads, keylen)
            if adapter:
                return adapter, read_num
        return "", read_num

    def _check_known_adapters(self, reads: List[Record]) -> str:
        """reference: src/evaluator.cpp:207-293 (sequential-adaptive scan)."""
        known = get_known_adapters()
        adapters = sorted(known)  # std::map order
        n_ad = len(adapters)
        a_arrs = [np.frombuffer(a.encode(), np.uint8) for a in adapters]
        a_lens = np.array([len(a) for a in adapters])
        possible = np.zeros(n_ad, np.int64)
        mismatches = np.zeros(n_ad, np.int64)

        MAX_CHECK_READS = 100000
        MAX_CHECK_BASES = MAX_CHECK_READS * 1000
        MAX_HIT = 1000
        match_req = 8
        allow_each = 16

        checked_reads = 0
        checked_bases = 0
        cur_max = 0
        for r in reads:
            rdata = np.frombuffer(r.seq, np.uint8)
            rlen = len(rdata)
            checked_reads += 1
            checked_bases += rlen
            if checked_reads > MAX_CHECK_READS or checked_bases > MAX_CHECK_BASES:
                break
            if cur_max > MAX_HIT:
                break
            for ai in range(n_ad):
                alen = a_lens[ai]
                if alen >= rlen:
                    continue
                if cur_max > 20 and possible[ai] < cur_max // 10:
                    continue
                m = self._first_match(rdata, rlen, a_arrs[ai], int(alen),
                                      match_req, allow_each)
                if m is not None:
                    possible[ai] += 1
                    if cur_max < possible[ai]:
                        cur_max = int(possible[ai])
                    mismatches[ai] += m
        best = ""
        max_count = 0
        for ai in range(n_ad):
            if possible[ai] > max_count:
                best = adapters[ai]
                max_count = int(possible[ai])
        bi = adapters.index(best) if best else -1
        if max_count > checked_reads // 50 or (
                max_count > checked_reads // 200 and bi >= 0
                and mismatches[bi] < checked_reads):
            sys.stderr.write(known[best] + "\n")
            sys.stderr.write(best + "\n")
            return best
        return ""

    @staticmethod
    def _first_match(rdata: np.ndarray, rlen: int, adata: np.ndarray, alen: int,
                     match_req: int, allow_each: int) -> Optional[int]:
        """First pos whose Hamming test passes; returns its mismatch count.

        Vectorized over positions: mism[p] = sum_i (a[i] != r[p+i]),
        cmplen = min(rlen-p, alen), allowed = cmplen // allow_each.
        """
        n_p = rlen - match_req
        if n_p <= 0:
            return None
        pos = np.arange(n_p)
        cmplen = np.minimum(rlen - pos, alen)
        mism = np.zeros(n_p, np.int32)
        rpad = np.concatenate([rdata, np.zeros(alen, np.uint8)])
        for i in range(alen):
            mism += ((rpad[i:i + n_p] != adata[i]) & (i < cmplen)).astype(np.int32)
        allowed = cmplen // allow_each
        matched = mism <= allowed
        idx = np.flatnonzero(matched)
        if len(idx) == 0:
            return None
        return int(mism[idx[0]])

    def _get_adapter_with_seed(self, seed: int, reads: List[Record], keylen: int) -> str:
        """reference: src/evaluator.cpp:472-526"""
        shift_tail = max(1, self.opt.trim.tail1)
        MAX_SEARCH_LENGTH = 500
        fwd = NucleotideTree()
        bwd = NucleotideTree()
        for r in reads:
            s = r.seq
            rlen = len(s)
            key = -1
            hi = rlen - keylen - shift_tail
            for p in range(20, min(hi, MAX_SEARCH_LENGTH - 1) + 1):
                key = _seq2int(s, p, keylen, key)
                if key == seed:
                    # substr(pos+keylen, rlen-keylen-shiftTail-pos)
                    fwd.add_seq(s[p + keylen: p + keylen + (rlen - keylen - shift_tail - p)])
                    bwd.add_seq(s[:p][::-1])
        # the reference threads ONE reachedLeaf flag through both calls; it is
        # only ever set false, so the result is fwd_ok AND bwd_ok
        fpath, fwd_ok = fwd.dominant_path()
        bpath, bwd_ok = bwd.dominant_path()
        reached_leaf = fwd_ok and bwd_ok
        adapter = bpath[::-1] + _int2seq(seed, keylen) + fpath
        if len(adapter) > 60:
            adapter = adapter[:60]
        matched = self._match_known_adapter(adapter)
        if matched:
            known = get_known_adapters()
            sys.stderr.write(known[matched] + "\n" + matched + "\n")
            return matched
        if reached_leaf:
            sys.stderr.write(adapter + "\n")
            return adapter
        return ""

    @staticmethod
    def _match_known_adapter(seq: str) -> str:
        for adapter in sorted(get_known_adapters()):
            if len(seq) < len(adapter):
                continue
            diff = sum(1 for i in range(len(adapter)) if adapter[i] != seq[i])
            if diff == 0:
                return adapter
        return ""
