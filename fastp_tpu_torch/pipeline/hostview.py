"""Host-side reconstruction of device-windowed read content.

The device step returns only scalars and sparse correction deltas; the host
reconstructs any needed window bytes from the original record bytes plus
(total_front, deltas).  Rows whose corrections overflow the delta slots are
recomputed exactly with a Python port of the base corrector
(reference: src/basecorrector.cpp:16-83).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

GOOD_QUAL = 63  # '?'
BAD_QUAL = 47   # '/'

# full 256-entry complement table: ACGT/acgt complemented, everything else 'N'
# (matches Sequence::reverseComplement, src/sequence.cpp:23-50)
_RC_TABLE = bytes(
    {65: 84, 97: 84, 84: 65, 116: 65, 67: 71, 99: 71, 71: 67, 103: 67}.get(c, 78)
    for c in range(256))


def complement_byte(c: int) -> int:
    return {65: 84, 97: 84, 84: 65, 116: 65, 67: 71, 99: 71,
            71: 67, 103: 67}.get(c, 78)


def rc_bytes(seq: bytes) -> bytes:
    out = bytearray(len(seq))
    for i, c in enumerate(reversed(seq)):
        out[i] = complement_byte(c)
    return bytes(out)


def host_analyze_overlap(s1: np.ndarray, s2: np.ndarray, diff_limit: int,
                         overlap_require: int, diff_pct: float):
    """Ungapped OverlapAnalysis::analyze for ONE pair — exact numpy port of
    ops/overlap._analyze_loop's first-accept scan (reference:
    src/overlapanalysis.cpp:16-116).  Used only on sparse-correction
    overflow, where the per-read overlap fields were kept on device; rows
    flagged corr_able were found by the UNGAPPED scan (gap candidates only
    fill rows the ungapped scan missed), so this reproduces the device's
    (offset, overlap_len) bit-for-bit for them.

    s1/s2: uint8 arrays of the exact device window (start total_front,
    length rlen_pre_ovtrim).  Returns (found, offset, olen, diff)."""
    l1, l2 = len(s1), len(s2)
    rc2 = np.frombuffer(s2.tobytes()[::-1].translate(_RC_TABLE), np.uint8)
    dpct = np.float32(diff_pct)
    for off in range(0, l1 - overlap_require):
        olen = min(l1 - off, l2)
        limit = min(diff_limit, int(np.float32(olen) * dpct))
        mm = s1[off:off + olen] != rc2[:olen]
        total = int(mm.sum())
        if (int(mm[:50].sum()) <= limit
                and (total <= limit or olen > 50)):
            return True, off, olen, total
    for k in range(0, l2 - overlap_require):
        olen = min(l1, l2 - k)
        limit = min(diff_limit, int(np.float32(olen) * dpct))
        mm = rc2[k:k + olen] != s1[:olen]
        total = int(mm.sum())
        if (int(mm[:50].sum()) <= limit
                and (total <= limit or olen > 50)):
            return True, -k, olen, total
    return False, 0, 0, 0


def host_correct_pair(s1: bytearray, q1: bytearray, s2: bytearray, q2: bytearray,
                      len2: int, offset: int, overlap_len: int):
    """Exact port of BaseCorrector::correctByOverlapAnalysis body (the
    caller guarantees overlapped && diff != 0 && !hasGap)."""
    start1 = max(0, offset)
    start2 = len2 - max(0, -offset) - 1
    for i in range(overlap_len):
        p1 = start1 + i
        p2 = start2 - i
        if p1 >= len(s1) or p2 < 0 or p2 >= len(s2):
            continue
        if s1[p1] != complement_byte(s2[p2]):
            if q1[p1] >= GOOD_QUAL and q2[p2] <= BAD_QUAL:
                s2[p2] = complement_byte(s1[p1])
                q2[p2] = q1[p1]
            elif q2[p2] >= GOOD_QUAL and q1[p1] <= BAD_QUAL:
                s1[p1] = complement_byte(s2[p2])
                q1[p1] = q2[p2]


class PairWindowView:
    """Per-batch lazy view of windowed (possibly corrected) pair content."""

    def __init__(self, seqs1, quals1, seqs2, quals2, out: Dict,
                 correction_enabled: bool, width: int, corr_c: int = None,
                 ov_params: Optional[Tuple[int, int, float]] = None):
        self.seqs1 = seqs1
        self.quals1 = quals1
        self.seqs2 = seqs2
        self.quals2 = quals2
        self.tf1 = out["total_front1"]
        self.tf2 = out["total_front2"]
        self.width = width
        self._cache: Dict[int, Tuple[bytes, bytes, bytes, bytes]] = {}
        self.correction = correction_enabled
        self.rowwise = False
        if correction_enabled and "c1k_pos" in out:
            # mesh path: per-row [K, B] delta matrices (device
            # extract_deltas, spmd-local); rows with count > K recompute
            # exactly per row like the global-overflow branch
            B = len(self.tf1)
            K = out["c1k_pos"].shape[0]
            cnt1 = np.asarray(out["c1k_cnt"][:B], np.int64)
            cnt2 = np.asarray(out["c2k_cnt"][:B], np.int64)
            self.rowwise = True
            self.overflow = False
            self._k = K
            self._row_over = (cnt1 > K) | (cnt2 > K)
            self._cnt1, self._cnt2 = cnt1, cnt2
            self._m1 = (out["c1k_pos"], out["c1k_u8"])
            self._m2 = (out["c2k_pos"], out["c2k_u8"])
            self.ov_offset = out.get("ov_offset")
            self.ov_olen = out.get("ov_olen")
            self.rlen1_pre = out.get("rlen1_pre_ovtrim")
            self.rlen2_pre = out["rlen2_pre_ovtrim"]
            self.ov_params = ov_params
            self.has_corr = (cnt1 > 0) | (cnt2 > 0)
            return
        if correction_enabled:
            if corr_c is None:
                corr_c = out["c1_rows"].shape[0]  # capacity baked into the step
            n1 = int(out["c1_count"])
            n2 = int(out["c2_count"])
            self.overflow = n1 > corr_c or n2 > corr_c
            # lean steps keep the per-read overlap fields on device and ship
            # a corr_able bit instead; overflow then re-derives (offset,
            # olen) per row via host_analyze_overlap (ov_params)
            self.ov_offset = out.get("ov_offset")
            self.ov_olen = out.get("ov_olen")
            self.rlen1_pre = out.get("rlen1_pre_ovtrim")
            self.rlen2_pre = out["rlen2_pre_ovtrim"]
            self.ov_params = ov_params
            B = len(self.tf1)
            self.has_corr = np.zeros(B, bool)
            if self.overflow:
                # sparse list truncated: every correctable row is recomputed
                if self.ov_offset is None:
                    self.has_corr[:] = out["corr_able"][:B]
                else:
                    self.has_corr[:] = (out["ov_ok"][:B]
                                        & ~out["ov_hasgap"][:B]
                                        & (out["ov_diff"][:B] != 0))
                self.c1 = self.c2 = None
            else:
                # rows ascend (row-major nonzero) -> searchsorted per row
                self.c1 = (out["c1_rows"][:n1], out["c1_pos"][:n1],
                           out["c1_base"][:n1], out["c1_qual"][:n1])
                self.c2 = (out["c2_rows"][:n2], out["c2_pos"][:n2],
                           out["c2_base"][:n2], out["c2_qual"][:n2])
                self.has_corr[self.c1[0][self.c1[0] < B]] = True
                self.has_corr[self.c2[0][self.c2[0] < B]] = True
        else:
            self.has_corr = None

    @staticmethod
    def _apply_sparse(buf: bytearray, qbuf: bytearray, deltas, i: int):
        rows, pos, base, qual = deltas
        lo = np.searchsorted(rows, i, "left")
        hi = np.searchsorted(rows, i, "right")
        for k in range(lo, hi):
            p = int(pos[k])
            if p < len(buf):
                buf[p] = int(base[k])
                qbuf[p] = int(qual[k])

    def window(self, i: int):
        """Returns (seq1, qual1, seq2, qual2) window-suffix bytes for row i."""
        s01 = int(self.tf1[i])
        s02 = int(self.tf2[i])
        s1 = self.seqs1[i][s01:]
        q1 = self.quals1[i][s01:]
        s2 = self.seqs2[i][s02:]
        q2 = self.quals2[i][s02:]
        if not self.correction or not self.has_corr[i]:
            return s1, q1, s2, q2
        if i in self._cache:
            return self._cache[i]
        b1 = bytearray(s1)
        bq1 = bytearray(q1)
        b2 = bytearray(s2)
        bq2 = bytearray(q2)
        if self.rowwise:
            if self._row_over[i]:
                if self.ov_offset is not None:
                    off, ol = int(self.ov_offset[i]), int(self.ov_olen[i])
                else:
                    dl, ovr, dp = self.ov_params
                    p1, p2 = int(self.rlen1_pre[i]), int(self.rlen2_pre[i])
                    _, off, ol, _ = host_analyze_overlap(
                        np.frombuffer(s1[:p1], np.uint8),
                        np.frombuffer(s2[:p2], np.uint8), dl, ovr, dp)
                host_correct_pair(b1, bq1, b2, bq2,
                                  int(self.rlen2_pre[i]), off, ol)
            else:
                K = self._k
                for (posm, u8m), cnt, buf, qbuf in (
                        (self._m1, self._cnt1, b1, bq1),
                        (self._m2, self._cnt2, b2, bq2)):
                    for k in range(int(cnt[i])):
                        p = int(posm[k, i])
                        if p < len(buf):
                            buf[p] = int(u8m[k, i])
                            qbuf[p] = int(u8m[K + k, i])
            res = (bytes(b1), bytes(bq1), bytes(b2), bytes(bq2))
            self._cache[i] = res
            return res
        if self.overflow:
            if self.ov_offset is not None:
                off, ol = int(self.ov_offset[i]), int(self.ov_olen[i])
            else:
                dl, ovr, dp = self.ov_params
                p1, p2 = int(self.rlen1_pre[i]), int(self.rlen2_pre[i])
                _, off, ol, _ = host_analyze_overlap(
                    np.frombuffer(s1[:p1], np.uint8),
                    np.frombuffer(s2[:p2], np.uint8), dl, ovr, dp)
            host_correct_pair(b1, bq1, b2, bq2, int(self.rlen2_pre[i]),
                              off, ol)
        else:
            self._apply_sparse(b1, bq1, self.c1, i)
            self._apply_sparse(b2, bq2, self.c2, i)
        res = (bytes(b1), bytes(bq1), bytes(b2), bytes(bq2))
        self._cache[i] = res
        return res

    def r1(self, i: int, end: int) -> Tuple[bytes, bytes]:
        s1, q1, _, _ = self.window(i)
        return s1[:end], q1[:end]

    def r2(self, i: int, end: int) -> Tuple[bytes, bytes]:
        _, _, s2, q2 = self.window(i)
        return s2[:end], q2[:end]

    def r1_slice(self, i: int, a: int, b: int) -> bytes:
        s1, _, _, _ = self.window(i)
        return s1[a:b]

    def r2_slice(self, i: int, a: int, b: int) -> bytes:
        _, _, s2, _ = self.window(i)
        return s2[a:b]

    def merged(self, i: int, rlen1: int, rlen2: int, ol: int,
               m_len1: int, m_len2: int) -> Tuple[bytes, bytes]:
        """Reconstruct the merged read (reference: src/overlapanalysis.cpp:152-183):
        r1[:len1_m] + rc(r2_final)[ol : ol+len2_m] (quality rides along)."""
        s1, q1, s2, q2 = self.window(i)
        ms = s1[:m_len1]
        mq = q1[:m_len1]
        if m_len2 > 0:
            rcs = s2[:rlen2].translate(_RC_TABLE)[::-1]
            rcq = q2[:rlen2][::-1]
            ms += rcs[ol:ol + m_len2]
            mq += rcq[ol:ol + m_len2]
        return ms, mq
