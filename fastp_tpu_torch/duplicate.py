"""Duplication profiling / deduplication
(reference: src/duplicate.cpp:7-173).

The reference hashes the whole (pair-concatenated) sequence with
position-indexed prime multipliers into 1-3 Bloom-filter bit buffers whose
sizes are powers of two, using first-arrival-wins test-and-set.  The quirk
that `isDup` keeps only the LAST buffer's result
(src/duplicate.cpp:154-167: `isDup = (ret & byte) != 0` inside the loop,
not &&=) is replicated.

Order within a batch follows input order, matching a single-worker
reference run (-w 1); the multi-threaded reference is itself
nondeterministic here.

Implemented with vectorized numpy on the host: hashing is a masked
gather/multiply/sum over [B, 2L] int64 (sums stay < 2^44, no overflow),
and first-wins semantics use stable sorts per batch.
"""
from __future__ import annotations

import os

import numpy as np

from .config import Options

PRIME_ARRAY_LEN = 1 << 9

_BASE_CODE = np.full(256, 13, np.int64)
_BASE_CODE[ord("A")] = 7
_BASE_CODE[ord("T")] = 222
_BASE_CODE[ord("C")] = 74
_BASE_CODE[ord("G")] = 31
_BASE_CODE_F = _BASE_CODE.astype(np.float64)


import threading

# Bloom-buffer pool for resident-server processes: committing ~1 GB of
# fresh zero pages costs 6-13 s of write faults on this virtualized host
# (22-57 us/page, volatile); recycled buffers are re-zeroed off the
# critical path when the filter is released and stay page-committed.
# Only ONE size class is retained (the most recent) so a server cycling
# through accuracy levels doesn't accumulate every configuration's peak.
# `_buf_pending` counts buffers being re-zeroed in the background so a
# back-to-back job WAITS for the in-flight re-zero (<1 s memset) instead
# of allocating — and pre-faulting — a fresh buffer every run.
_buf_pool = {}
_buf_pool_lock = threading.Lock()
_buf_pool_cv = threading.Condition(_buf_pool_lock)
_buf_pending = {}  # size -> count being re-zeroed
_BUF_POOL_MAX = 6  # buffers kept per size (accuracy 6 = 6 buffers,
#                    default --dedup accuracy 3 = 4 buffers)
_retained_size = [0]  # the ONE size class currently pooled (latest release)


def _prefault(b: np.ndarray) -> np.ndarray:
    """Commit every page up front (one write per 4KB) in server mode.

    The probe pattern is a uniform random walk over hundreds of MB; on
    this virtualized host a first-touch write fault costs ~23us, so a
    fresh lazily-backed buffer pays ~6s of faults spread across the first
    batches of a big run (measured: 1.07s/32k-pair batch fresh vs 0.08s
    pre-faulted).  In a resident server the commit runs once — during the
    pre-READY warm job — and pooled buffers (re-zeroed in place on
    release) never pay it again.  Gated to server mode because small
    one-shot jobs (tests, tiny inputs) probe only a few thousand pages:
    lazy faulting costs them ~50ms where an eager commit would cost
    seconds.  MADV_HUGEPAGE was tried and removed: with defrag=madvise
    the kernel attempts direct compaction on every fault and never
    assembles a huge page on this hypervisor (AnonHugePages stays 0),
    making faults 75% slower."""
    # parse the value, not string truthiness: '0'/'false' must disable
    # prefaulting even where server.py setdefault'ed it to '1'
    if os.environ.get("FASTP_TPU_POOL_PREFAULT", "") not in ("", "0", "false"):
        b[::4096] = 0
    return b


def _acquire_buf(n_bytes: int) -> np.ndarray:
    with _buf_pool_cv:
        while True:
            lst = _buf_pool.get(n_bytes)
            if lst:
                return lst.pop()
            if not _buf_pending.get(n_bytes):
                break  # nothing in flight: allocate fresh
            # a matching buffer is being re-zeroed (~0.3s/GB memset);
            # waiting beats a fresh 6-13s pre-fault
            if not _buf_pool_cv.wait(timeout=30.0):
                break
    return _prefault(np.zeros(n_bytes, np.uint8))


def _release_bufs(bufs) -> None:
    keep = []
    with _buf_pool_cv:
        for b in bufs:
            lst = _buf_pool.get(b.nbytes, [])
            if len(lst) + _buf_pending.get(b.nbytes, 0) < _BUF_POOL_MAX:
                _buf_pending[b.nbytes] = _buf_pending.get(b.nbytes, 0) + 1
                keep.append(b)
        if keep:
            # Retention decision happens HERE, atomically with the pending
            # bump: mark this size class the retained one and evict others
            # now.  The rezero threads below never touch other sizes, so a
            # same-size waiter woken by notify_all can't lose its buffer to
            # a concurrent rezero of a different size class.
            _retained_size[0] = keep[0].nbytes
            for size in list(_buf_pool):
                if size != keep[0].nbytes:
                    del _buf_pool[size]
    if not keep:
        return

    def rezero():
        for b in keep:
            b[:] = 0
            with _buf_pool_cv:
                if b.nbytes == _retained_size[0]:
                    _buf_pool.setdefault(b.nbytes, []).append(b)
                # else: a different size was released meanwhile; drop this
                # buffer rather than resurrecting an evicted size class
                _buf_pending[b.nbytes] -= 1
                _buf_pool_cv.notify_all()

    threading.Thread(target=rezero, daemon=True).start()


_prime_cache = {}


def _gen_primes(count: int) -> np.ndarray:
    """reference: src/duplicate.cpp:66-84 (10000-stride prime walk).
    Memoized: a resident server creates one Duplicate per job."""
    if count in _prime_cache:
        return _prime_cache[count]
    out = np.zeros(count, np.uint64)
    number = 10000
    found = 0
    while found < count:
        number += 1
        is_prime = True
        i = 2
        while i * i <= number:
            if number % i == 0:
                is_prime = False
                break
            i += 1
        if is_prime:
            out[found] = number
            found += 1
            number += 10000
    _prime_cache[count] = out
    return out


class Duplicate:
    def __init__(self, opt: Options, precomputed: "np.ndarray" = None,
                 hash_only: bool = False):
        """precomputed: per-record dup verdicts resolved ahead of time (the
        exact multi-host exchange, parallel/multihost.py) — no Bloom
        buffers are allocated and check_batch_* replays the verdicts in
        record order.  hash_only: expose the hash without buffers (the
        multi-host pre-pass)."""
        self.opt = opt
        buf_len_bytes = 1 << 29
        buf_num = 2
        lvl = opt.duplicate.accuracyLevel
        if lvl == 2:
            buf_len_bytes *= 2
        elif lvl == 3:
            buf_len_bytes *= 2
            buf_num *= 2
        elif lvl == 4:
            buf_len_bytes *= 4
            buf_num *= 2
        elif lvl == 5:
            buf_len_bytes *= 8
            buf_num *= 2
        elif lvl == 6:
            buf_len_bytes *= 8
            buf_num *= 3
        self.buf_len_bytes = buf_len_bytes
        self.buf_num = buf_num
        self.buf_len_bits = buf_len_bytes << 3
        self.offset_mask = PRIME_ARRAY_LEN * buf_num - 1
        self._pre = precomputed
        self._pre_off = 0
        if precomputed is None and not hash_only:
            self.bufs = [_acquire_buf(buf_len_bytes) for _ in range(buf_num)]
        else:
            self.bufs = []
        self.primes = _gen_primes(buf_num * PRIME_ARRAY_LEN).astype(np.int64)
        self.total_reads = 0
        self.dup_reads = 0
        self._gmat_cache = {}

    def _replay(self, B: int) -> np.ndarray:
        """Consume the next B precomputed verdicts (record order)."""
        v = self._pre[self._pre_off:self._pre_off + B]
        self._pre_off += B
        if len(v) < B:  # defensive: shorter pre-pass (should not happen)
            v = np.pad(v, (0, B - len(v)))
        dup = v.astype(bool)
        self.total_reads += B
        self.dup_reads += int(dup.sum())
        return dup

    def _prime_matrix(self, W: int) -> np.ndarray:
        """[W, buf_num] float64 prime multipliers (cached per width)."""
        cached = self._gmat_cache.get(W)
        if cached is not None:
            return cached
        x = np.arange(W, dtype=np.int64)
        G = np.empty((W, self.buf_num), np.float64)
        for i in range(self.buf_num):
            G[:, i] = self.primes[(x * self.buf_num + i) & self.offset_mask]
        self._gmat_cache[W] = G
        return G

    def _hash_positions(self, concat: np.ndarray, total_len: np.ndarray) -> np.ndarray:
        """concat: uint8[B, W] pair-concatenated sequences (0 pad);
        total_len: int32[B]. Returns positions int64[buf_num, B].

        Every term (code+pos)*prime is < 2^34 and the row sums stay < 2^44,
        so the whole hash is exact in float64 — one BLAS dgemm instead of
        per-buffer int64 broadcasting (~50x faster on the host)."""
        B, W = concat.shape
        codes = _BASE_CODE_F[concat]  # float64 [B, W]
        x = np.arange(W, dtype=np.float64)[None, :]
        mask = np.arange(W)[None, :] < total_len[:, None]
        vals = (codes + x) * mask
        sums = vals @ self._prime_matrix(W)  # [B, buf_num], exact integers
        return (sums.T.astype(np.int64)) % self.buf_len_bits

    def _apply(self, positions: np.ndarray) -> np.ndarray:
        """Test-and-set with first-wins order within the batch.
        Returns isDup bool[B] (last buffer's verdict, per the reference)."""
        from .io import native as native_mod
        lib = native_mod.get_lib()
        if lib is not None:
            B = positions.shape[1]
            is_dup = np.zeros(B, np.uint8)
            for i in range(self.buf_num):
                lib.dup_apply(self.bufs[i],
                              np.ascontiguousarray(positions[i]), B, is_dup)
            return is_dup.astype(bool)
        B = positions.shape[1]
        is_dup = np.zeros(B, bool)
        for i in range(self.buf_num):
            pos = positions[i]
            byte_pos = pos >> 3
            bit = (1 << (pos & 7)).astype(np.uint8)
            pre_set = (self.bufs[i][byte_pos] & bit) != 0
            # first occurrence within batch: stable unique on (byte_pos, bit)
            key = pos  # bit identity == full bit position
            order = np.argsort(key, kind="stable")
            sorted_key = key[order]
            dup_in_batch_sorted = np.zeros(B, bool)
            dup_in_batch_sorted[1:] = sorted_key[1:] == sorted_key[:-1]
            dup_in_batch = np.zeros(B, bool)
            dup_in_batch[order] = dup_in_batch_sorted
            is_dup = pre_set | dup_in_batch  # last buffer wins (reference quirk)
            np.bitwise_or.at(self.bufs[i], byte_pos, bit)
        return is_dup

    def _native_hash(self, b1, l1, b2=None, l2=None):
        """C++ single-pass hash (no concat materialization); falls back to
        the BLAS float64 path when the native library is unavailable."""
        from .io import native as native_mod
        if native_mod.get_lib() is None:
            return None
        return native_mod.dup_hash(b1, l1, b2, l2, self.primes,
                                   self.offset_mask, self.buf_num,
                                   self.buf_len_bits)

    def hash_positions_se(self, bases: np.ndarray,
                          lengths: np.ndarray) -> np.ndarray:
        """[buf_num, B] bit positions (the multi-host pre-pass uses the
        LAST buffer's row: only it decides the verdict, per the reference's
        isDup overwrite quirk)."""
        pos = self._native_hash(bases, lengths)
        if pos is None:
            pos = self._hash_positions(bases, lengths)
        return pos

    def hash_positions_pe(self, b1, l1, b2, l2) -> np.ndarray:
        B, L = b1.shape
        pos = self._native_hash(b1, l1, b2, l2)
        if pos is None:
            W = 2 * L
            concat = np.zeros((B, W), np.uint8)
            concat[:, :L] = b1
            x = np.arange(L)
            for_rows = l1[:, None] + x[None, :]
            np.put_along_axis(concat, np.minimum(for_rows, W - 1), np.where(
                x[None, :] < l2[:, None], b2, 0), axis=1)
            pos = self._hash_positions(concat, (l1 + l2).astype(np.int32))
        return pos

    def check_batch_se(self, bases: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        if self._pre is not None:
            return self._replay(len(lengths))
        dup = self._apply(self.hash_positions_se(bases, lengths))
        self.total_reads += len(lengths)
        self.dup_reads += int(dup.sum())
        return dup

    def check_batch_pe(self, b1: np.ndarray, l1: np.ndarray,
                       b2: np.ndarray, l2: np.ndarray) -> np.ndarray:
        """Pair hash = seq2intvector(r1) then seq2intvector(r2, posOffset=len1),
        equivalent to hashing the concatenated pair."""
        if self._pre is not None:
            return self._replay(len(l1))
        dup = self._apply(self.hash_positions_pe(b1, l1, b2, l2))
        self.total_reads += len(l1)
        self.dup_reads += int(dup.sum())
        return dup

    def get_dup_rate(self) -> float:
        if self.total_reads == 0:
            return 0.0
        return self.dup_reads / self.total_reads

    def release(self) -> None:
        """Return the bit buffers to the process-wide pool (re-zeroed on a
        background thread); the filter must not be used afterwards."""
        bufs, self.bufs = self.bufs, []
        _release_bufs(bufs)
