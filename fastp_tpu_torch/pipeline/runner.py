"""Streaming SE processor and the host helpers both processors share.

The port's counterpart of fastp_tpu/pipeline/runner.py: width rounding,
the index blacklist match, grouped adapter-slice recording (one function
for the SE and the PE processor), the overrepresented-sequence counter, a
BaseProcessor that keeps the host state, batch padding, the index-drop
masks and the stat printers, the single-end processor and the split-output
writer set.

The batch loop is a pipeline of three stages (BaseProcessor._run_batches):
a prep worker runs produce() -- read, host pre-ops, pad, submit -- up to
FASTP_TPU_PREFETCH batches ahead; ONE dispatch worker packs the inputs
(_dispatch, _dispatch_pe), queues the uploads and the step on the device's
side stream and starts the fetch, in input order; fetch workers wait for
each batch's event and unpack it; the calling thread takes the batches in
order and counts, records, routes and writes them.  The native tokenizer,
hashing, packers and serializer release the interpreter lock, as the waits
for the device do, so those parts overlap; the Python between torch calls
does not.  BaseProcessor also holds the devices of a split
(parallel/mesh.py) and the run accumulator: the batch's sums stay on the
device and come to the host once, at the end of the run.  The steps come
from pipeline/device.py:memo_step, so a resident server's jobs of one
configuration share them, with their stream, pinned buffers and CUDA
graphs; the worker pools, the accumulator and the packers' learned
dictionaries belong to the processor and end with the job.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import os
import resource
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from ..config import (Options, PASS_FILTER, FAILED_TYPES, FAIL_QUALITY,
                      FAIL_N_BASE, FAIL_LENGTH, FAIL_TOO_LONG, FAIL_COMPLEXITY)
from ..duplicate import Duplicate
from ..io import native as native_mod
from ..io.fastq import OutputWriter, open_batch_reader
from ..parallel import multihost
from ..report.filter_model import FilterResult
from ..report.htmlreport import HtmlReporter
from ..report.jsonreport import JsonReporter
from ..report.stats_model import Stats, cpp_num
from ..umi import UmiProcessor
from ..utils.log import loginfo
from ..utils.readname import first_index, fix_mgi, last_index
from .static_cfg import device_cfg_from_options

from .device import (build_se_step, length_dtype, make_aux, memo_step,
                     unpack_acc)


def _round_width(n: int) -> int:
    return max(32, -(-n // 32) * 32)


def _index_match(blacklist: List[str], target: bytes, threshold: int) -> bool:
    """reference: src/filter.cpp:242-258"""
    t = target.decode("latin-1")
    for item in blacklist:
        diff = 0
        ok = True
        for s in range(min(len(item), len(t))):
            if item[s] != t[s]:
                diff += 1
                if diff > threshold:
                    ok = False
                    break
        if ok and diff <= threshold:
            return True
    return False


def _padded_slice_matrix(ba: np.ndarray, rows: np.ndarray,
                         lo: np.ndarray, hi: np.ndarray):
    """(mat [n, maxL] u8 zero-padded, L [n]) for slices ba[rows, lo:hi]."""
    W = ba.shape[1]
    L = np.maximum(hi - lo, 0).astype(np.int64)
    maxL = int(L.max()) if L.size else 0
    if maxL == 0:
        return np.zeros((len(rows), 0), np.uint8), L
    j = np.arange(maxL)
    idx = np.clip(lo.astype(np.int64)[:, None] + j[None, :], 0, W - 1)
    mat = np.where(j[None, :] < L[:, None], ba[rows[:, None], idx], 0)
    return mat.astype(np.uint8, copy=False), L


def _unique_rows(mat: np.ndarray):
    """np.unique over whole rows via a void view; returns
    (first_indices, counts)."""
    m = np.ascontiguousarray(mat)
    if m.shape[1] == 0:
        return (np.zeros(1 if len(m) else 0, np.int64),
                np.array([len(m)] if len(m) else [], np.int64))
    v = m.view(np.dtype((np.void, m.shape[1]))).reshape(-1)
    _, first, counts = np.unique(v, return_index=True, return_counts=True)
    return first.astype(np.int64), counts.astype(np.int64)


def group_slices(ba: np.ndarray, rows: np.ndarray,
                 lo: np.ndarray, hi: np.ndarray):
    """Group the variable-length row slices ba[rows[k], lo[k]:hi[k]].

    Returns [(pos, bytes, count)] in first-occurrence order (pos = index
    within `rows`), so count-aware FilterResult adds replay the exact
    sequential insertion order (the slice length rides in the key header,
    so zero padding cannot alias across lengths)."""
    mat, L = _padded_slice_matrix(ba, rows, lo, hi)
    hdr = L.astype("<u2")[:, None].view(np.uint8).reshape(len(rows), 2)
    first, counts = _unique_rows(np.hstack([hdr, mat]))
    out = [(int(f), mat[f, :int(L[f])].tobytes(), int(c))
           for f, c in zip(first, counts)]
    out.sort(key=lambda t: t[0])
    return out


def group_pair_slices(ba1, lo1, hi1, ba2, lo2, hi2, rows):
    """Pair variant of group_slices: groups by the concatenated
    (slice1, slice2) content.  Returns [(pos, bytes1, bytes2, count)] in
    first-occurrence order."""
    m1, L1 = _padded_slice_matrix(ba1, rows, lo1, hi1)
    m2, L2 = _padded_slice_matrix(ba2, rows, lo2, hi2)
    hdr = np.stack([L1, L2], axis=1).astype("<u2").view(np.uint8) \
        .reshape(len(rows), 4)
    first, counts = _unique_rows(np.hstack([hdr, m1, m2]))
    out = [(int(f), m1[f, :int(L1[f])].tobytes(),
            m2[f, :int(L2[f])].tobytes(), int(c))
           for f, c in zip(first, counts)]
    out.sort(key=lambda t: t[0])
    return out


def record_adapter_hits(fr: FilterResult, bases: np.ndarray, frows, ps, lo, hi,
                        aseq: bytes, is_r2: bool, explicit=()):
    """By-sequence adapter recording (FilterResult::addAdapterTrimmed) for
    the rows `frows` of one mate, in row order.

    ps: the hit position per row (negative: the adapter is clipped at the
    read start, and the recorded string is the adapter's own prefix);
    lo/hi: the recorded slice of `bases` per row otherwise; `explicit`:
    (index into frows, string) for rows whose string the caller made
    itself.  The other rows are grouped by slice content (group_slices), or
    streamed to the native recorder in bulk between the explicit strings."""
    entries = []  # explicit strings: (idx, str, count)
    neg = ps < 0
    negrows = np.flatnonzero(neg)
    if negrows.size:  # adapter clipped at the read start
        uniq, first, counts = np.unique(ps[negrows], return_index=True,
                                        return_counts=True)
        for k in range(uniq.size):
            entries.append((int(negrows[first[k]]),
                            aseq[:len(aseq) + int(uniq[k])].decode(),
                            int(counts[k])))
    own = neg.copy()
    for j, text in explicit:
        entries.append((j, text, 1))
        own[j] = True
    nrm = np.flatnonzero(~own)
    entries.sort(key=lambda t: t[0])
    if fr._adrec is not None:
        # merged walk in row order: normal segments go to the native
        # recorder in bulk, explicit strings one by one
        start = 0
        for idx, text, c in entries + [(frows.size + 1, "", 0)]:
            seg = nrm[(nrm >= start) & (nrm < idx)]
            if seg.size:
                fr.add_adapter_trimmed_rows_bulk(
                    bases, frows[seg], lo[seg], hi[seg], is_r2)
            if text:
                fr.add_adapter_trimmed(text, is_r2, count=c)
            start = idx
    else:
        if nrm.size:
            for p0, bb, c in group_slices(bases, frows[nrm], lo[nrm], hi[nrm]):
                entries.append((int(nrm[p0]), bb.decode("latin-1"), c))
        entries.sort(key=lambda t: t[0])
        for _, text, c in entries:
            fr.add_adapter_trimmed(text, is_r2, count=c)


class _OverRepCounter:
    """Overrepresented-sequence counting on sampled reads
    (reference: src/stats.cpp:312-329).  Scanning runs in the native
    library when available; accumulated counts fold back into the Stats
    dicts via flush()."""

    def __init__(self, stats: Stats, opt: Options):
        self.stats = stats
        self.sampling = opt.overRepAnalysis.sampling
        self.enabled = opt.overRepAnalysis.enabled and len(stats.overrep) > 0
        self.eval_len = stats.evaluated_seq_len
        self._h = None
        if self.enabled:
            lib = native_mod.get_lib()
            if lib is not None:
                self._lib = lib
                self._keys = [k.encode("latin-1") for k in stats.overrep]
                lens = np.array([len(k) for k in self._keys], np.int32)
                offs = np.zeros(len(self._keys), np.int64)
                np.cumsum(lens[:-1], out=offs[1:])
                blob = np.frombuffer(b"".join(self._keys), np.uint8)
                steps = np.array([10, 20, 40, 100,
                                  min(150, self.eval_len - 2)], np.int32)
                self._h = lib.ora_create(blob, offs, lens, len(self._keys),
                                         self.eval_len, steps, len(steps))
                self._counts = np.zeros(len(self._keys), np.int64)
                self._dist = np.zeros((len(self._keys), self.eval_len), np.int64)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ora_destroy(self._h)
            self._h = None

    def _scan(self, seq: bytes):
        """Pure-Python scan of one read (fallback path)."""
        st = self.stats
        rlen = len(seq)
        steps = (10, 20, 40, 100, min(150, self.eval_len - 2))
        for step in steps:
            i = 0
            while i < rlen - step:
                k = seq[i:i + step].decode("latin-1")
                if k in st.overrep:
                    st.overrep[k] += 1
                    dist = st.overrep_dist[k]
                    for p in range(i, min(i + step, self.eval_len)):
                        dist[p] += 1
                    i += step
                i += 1

    def stat_read(self, seq: bytes, read_index: int):
        if not self.enabled or read_index % self.sampling != 0:
            return
        if self._h is not None:
            b = np.frombuffer(seq, np.uint8).reshape(1, -1)
            self._lib.ora_stat_batch(
                self._h, np.ascontiguousarray(b), b.shape[1],
                np.zeros(1, np.int32), np.array([len(seq)], np.int32),
                np.zeros(1, np.int32), 1, self._counts, self._dist)
        else:
            self._scan(seq)

    def stat_rows(self, bases: np.ndarray, start, rlen, rows: np.ndarray):
        """Scan the selected (already sampled) rows of a padded batch."""
        if not self.enabled or rows.size == 0:
            return
        if self._h is not None:
            self._lib.ora_stat_batch(
                self._h, np.ascontiguousarray(bases), bases.shape[1],
                np.ascontiguousarray(start, np.int32),
                np.ascontiguousarray(rlen, np.int32),
                np.ascontiguousarray(rows, np.int32), rows.size,
                self._counts, self._dist)
        else:
            for i in rows.tolist():
                s0 = int(start[i])
                self._scan(bases[i, s0:s0 + int(rlen[i])].tobytes())

    def flush(self):
        """Fold native accumulators into the Stats dicts (idempotent)."""
        if self._h is None or not self.enabled:
            return
        st = self.stats
        for ki, key in enumerate(self._keys):
            c = int(self._counts[ki])
            if c:
                k = key.decode("latin-1")
                st.overrep[k] += c
                st.overrep_dist[k] += self._dist[ki]
        self._counts[:] = 0
        self._dist[:] = 0


_KIND_NAMES = {"p3": "p3", "nib": "nib", True: "bq"}


def _warn_left_open(what: str, exc: Exception) -> None:
    """One stderr line for something an abandoned run could not close."""
    print("WARNING: abandoning the run: closing %s failed: %r" % (what, exc),
          file=sys.stderr)


class _LoopTimer:
    """The batch loop's wall split.  With FASTP_TPU_TIMING=1 report() writes
    it to stderr in fastp_tpu's words: the stages of the calling thread
    (fetch_wait, route, flush), produce() on the prep worker with its parts
    in brackets, the dispatch and fetch workers' times, and the process's
    CPU time against the loop's wall time.  Every key is added to by one
    thread only."""

    def __init__(self):
        self.on = bool(os.environ.get("FASTP_TPU_TIMING"))
        self.t = dict.fromkeys(("produce", "fetch_wait", "route", "flush",
                                "read", "dup", "pad", "submit"), 0.0)
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)
        self.wall0 = time.monotonic()

    def add(self, key: str, t0: float) -> float:
        now = time.monotonic()
        self.t[key] += now - t0
        return now

    def report(self, unit: str, n: int, t_dispatch: float, t_get: float):
        if not self.on:
            return
        t = self.t
        sys.stderr.write(
            "TIMING produce=%.2fs fetch_wait=%.2fs route=%.2fs "
            "flush=%.2fs %s=%d "
            "[read=%.2fs dup=%.2fs pad=%.2fs submit=%.2fs]\n"
            % (t["produce"], t["fetch_wait"], t["route"], t["flush"], unit,
               n, t["read"], t["dup"], t["pad"], t["submit"]))
        sys.stderr.write("TIMING workers dispatch=%.2fs device_get=%.2fs\n"
                         % (t_dispatch, t_get))
        # cpu close to wall: one core is saturated; cpu far below wall: the
        # loop waits (for the device or for files)
        ru1 = resource.getrusage(resource.RUSAGE_SELF)
        sys.stderr.write(
            "TIMING cpu user=%.2fs sys=%.2fs wall=%.2fs "
            "minflt=%d majflt=%d\n"
            % (ru1.ru_utime - self.ru0.ru_utime,
               ru1.ru_stime - self.ru0.ru_stime,
               time.monotonic() - self.wall0,
               ru1.ru_minflt - self.ru0.ru_minflt,
               ru1.ru_majflt - self.ru0.ru_majflt))


class BaseProcessor:
    """Host state shared by the processors: options, the static device
    config, UMI and duplicate handlers, the torch devices of the run (one,
    or the shards of a split: parallel/mesh.py:make_mesh) and the run
    accumulator."""

    def __init__(self, opt: Options, devices):
        self.opt = opt
        self.cfg = device_cfg_from_options(opt)
        self.devices = ([torch.device(d) for d in devices]
                        if isinstance(devices, (list, tuple))
                        else [torch.device(devices)])
        self.device = self.devices[0]
        self.n_dev = len(self.devices)
        # accumulate mode: the batch's sums (every stat_batch dict and
        # ACC_KEYS) stay on the device and are fetched once per run.  Off on
        # a split (there the sums are joined on the host), off with
        # FASTP_TPU_NO_ACCUM, and with merging only on the native routed
        # path: the per-row loop stats unmerged survivors on the host and
        # would count the device's post_um* dicts a second time.  The state
        # belongs to the processor: a resident server's next job starts
        # from zero.
        merge_ok = not opt.merge.enabled or native_mod.get_lib() is not None
        self._accum = (self.n_dev == 1 and merge_ok
                       and not os.environ.get("FASTP_TPU_NO_ACCUM"))
        self._acc_state = {}
        self.umi = UmiProcessor(opt)
        self.duplicate = None
        if opt.duplicate.enabled:
            # a shard of a sharded job replays verdicts resolved across all
            # shards (first occurrence by global record index)
            pre = (multihost.exact_dedup_verdicts(opt)
                   if multihost.active() else None)
            self.duplicate = Duplicate(opt, precomputed=pre)
        self.width = _round_width(max(opt.seqLen1, opt.seqLen2, 32))
        self.batches = 0
        # called after every batch the loop has written (cli.py's trace
        # window steps on it)
        self.on_batch = None
        # the pipeline's workers and their wall times
        self._pools = {}
        self._t_dispatch = self._t_get = 0.0
        self._t_lock = threading.Lock()
        # the input packers' state: learned quality dictionaries, and the
        # schemes a batch of this run has already fallen out of
        self._qdict = self._qdict2 = None
        self._nib_dead = self._p3_dead = False
        self.input_kinds = collections.Counter()   # batches per scheme

    def _wrap_step(self, build):
        """The run's step from build_se_step or build_pe_step, through the
        memo (pipeline/device.py:memo_step): on one device the step itself,
        on several the split of it."""
        memo = functools.partial(memo_step, build)
        if self.n_dev == 1:
            return memo(self.cfg, self.device)
        from ..parallel.mesh import build_sharded_step
        return build_sharded_step(memo, self.cfg, self.devices)

    def _step_for(self, packed):
        """The step for inputs packed as `packed` ("p3", "nib", True): the
        plain step's sibling in its memo entry, so it shares its stream,
        pinned buffers and adapters."""
        if not packed:
            return self.step
        return self.step.entry.step(packed)

    def _call_step(self, step, args):
        """Queue the step on one batch and start the fetch of its outputs;
        returns the pending fetch.  In accumulate mode the batch's sums
        leave the output dict as one int64 vector, which is added to the
        resident vector of the batch's width (a wider batch starts a new
        chain: the per-cycle sums change shape with it).  Runs on the one
        dispatch worker, so the chain's additions keep their order; the
        addition and the fetch are queued on the step's stream before its
        next run, which overwrites a graph's outputs."""
        with step.on_stream():
            dev_out = step.run(*args, accum=self._accum)
            if self._accum:
                ent = self._acc_state.get(dev_out.width)
                if ent is None:
                    self._acc_state[dev_out.width] = [dev_out.delta.clone(),
                                                      dev_out.acc_meta]
                else:
                    ent[0] += dev_out.delta
            return step.start_fetch(dev_out)

    def _fold_accs(self):
        """Fetch every accumulator chain (one transfer each: one per run
        unless the width grew) and return the dicts of sums, which the
        caller feeds through the same add_batch calls as a batch's.  Empty
        when accumulate mode is off."""
        chains = list(self._acc_state.values())
        self._acc_state = {}
        return [unpack_acc(self.step.fetch_vector(vec), meta)
                for vec, meta in chains]

    # --- packed inputs ----------------------------------------------------

    def _input_pack_on(self) -> bool:
        """Whether this run packs its inputs for the upload: on one device,
        where the native library loaded, unless FASTP_TPU_NO_INPUT_PACK is
        set.  The shards of a split take plain bytes (an exception list
        indexes the whole batch)."""
        return (self.n_dev == 1
                and not os.environ.get("FASTP_TPU_NO_INPUT_PACK")
                and native_mod.get_lib() is not None)

    def _try_pack_nib(self, bases, quals):
        """(packed_nibbles, exc_idx, exc_base, exc_qual) or None.

        4-bit packing (2-bit base + 2-bit learned qual dictionary) halves
        the bytes of the 1-byte scheme on binned-quality data.  The choice
        is sticky per run: once a batch falls back (N-rich, or a fifth
        quality value), nib stays off, because the dictionary is the
        run's."""
        if (os.environ.get("FASTP_TPU_NO_NIB") or self._nib_dead
                or bases.shape[1] % 2):
            return None
        if self._qdict is None:
            self._qdict = np.zeros(4, np.uint8)
            self._qdict_n = np.zeros(1, np.int32)
        res = native_mod.pack_nib(bases, quals, self._qdict, self._qdict_n)
        if res is None:
            self._nib_dead = True
            return None
        return res[:4]

    def _p3_off(self) -> bool:
        return bool(os.environ.get("FASTP_TPU_NO_NIB")
                    or os.environ.get("FASTP_TPU_NO_P3") or self._p3_dead)

    def _try_pack_p3(self, bases, quals):
        """(bplane, qplane, exc_idx, exc_base, exc_qual) or None.

        Planar 3-bit packing (a 2-bit base plane and a 1-bit qual plane
        over a two-entry learned dictionary) takes a quarter off the 4-bit
        scheme on two-level binned data (one dominant high quality and one
        low; the rare values ride the exception list).  Sticky per run like
        nib."""
        if self._p3_off() or bases.shape[1] % 8:
            return None
        if self._qdict2 is None:
            self._qdict2 = np.zeros(2, np.uint8)
            self._qdict2_n = np.zeros(1, np.int32)
        res = native_mod.pack_p3(bases, quals, self._qdict2, self._qdict2_n)
        if res is None:
            self._p3_dead = True
            return None
        return res[:5]

    def _learn_p3_dict(self, *quals):
        """Learn the two-entry p3 dictionary from the COMBINED histogram of
        both mates' first batches (the native learner's rule: the two most
        frequent values, the smaller winning a tie).  A dictionary from
        read 1 alone can starve read 2 when the mates' dominant quality
        bins differ: its exceptions overflow and p3 is off for the run."""
        if self._p3_off():
            return
        if self._qdict2 is None:
            self._qdict2 = np.zeros(2, np.uint8)
            self._qdict2_n = np.zeros(1, np.int32)
        if self._qdict2_n[0] >= 2:
            return
        hist = np.zeros(256, np.int64)
        for q in quals:
            hist += np.bincount(np.asarray(q, np.uint8).ravel(),
                                minlength=256)
        hist[0] = 0  # pad
        if not hist.any():
            return  # empty batch: the native learner handles it later
        q0 = int(np.argmax(hist))  # first max = smallest value, as native
        hist[q0] = 0
        q1 = int(np.argmax(hist)) if hist.any() else q0
        self._qdict2[0] = q0
        self._qdict2[1] = q1
        self._qdict2_n[0] = 2

    def _try_pack_inputs(self, bases, quals):
        """(packed, exc_idx, exc_base, exc_qual) or None: base and qual in
        one byte per position, exceptional bytes in an exact scatter
        list."""
        res = native_mod.pack_bq(bases, quals)
        return None if res is None else res[:4]

    def _dispatch_mates(self, mates, lengths, aux):
        """Pack the mates' (bases, quals) down the chain p3 -> nib -> one
        byte -> plain, taking the first scheme that holds every mate, and
        queue the step for it.  Returns the pending fetch."""
        W = mates[0][0].shape[1]
        lengths = [ln.astype(length_dtype(W)) for ln in lengths]
        if self._input_pack_on():
            if len(mates) > 1:
                self._learn_p3_dict(*(q for _, q in mates))
            for kind, pack in (("p3", self._try_pack_p3),
                               ("nib", self._try_pack_nib),
                               (True, self._try_pack_inputs)):
                packed = []
                for b, q in mates:
                    res = pack(b, q)
                    if res is None:
                        break
                    packed += res
                else:
                    qlut = {"p3": self._qdict2, "nib": self._qdict}.get(kind)
                    args = tuple(packed) + (
                        (qlut.copy(),) if qlut is not None else ())
                    self.input_kinds[_KIND_NAMES[kind]] += 1
                    return self._call_step(self._step_for(kind),
                                           args + tuple(lengths) + aux)
        self.input_kinds["plain"] += 1
        args = ()
        for (b, q), ln in zip(mates, lengths):
            args += (b, q, ln)
        return self._call_step(self.step, args + aux)

    # --- the pipelined batch loop -----------------------------------------

    def _pool(self, name: str, workers: int):
        pool = self._pools.get(name)
        if pool is None:
            pool = self._pools[name] = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="fastp_" + name)
        return pool

    def _prep_pool(self):
        """One worker that runs produce() ahead of the main loop: the host
        prep of the batches to come overlaps this batch's routing and the
        device's work.  One worker keeps the reader, the UMI and the
        duplicate state sequential."""
        return self._pool("prep", 1)

    def _upload_pool(self):
        """One worker for input packing, uploads and the step's launches.
        One worker keeps dispatch order = input order, and with it the
        order of the accumulator's additions and the kernel's launch
        count."""
        return self._pool("upload", 1)

    def _fetch_pool(self):
        """Workers that wait for a batch's fetch event and unpack its buffer
        (FASTP_TPU_FETCH_WORKERS, 2 unless set); the per-batch futures keep
        the order."""
        return self._pool("fetch", max(1, int(os.environ.get(
            "FASTP_TPU_FETCH_WORKERS", "2"))))

    def _batch_stream(self, produce, depth: int = None):
        """Yield produce()'s results with `depth` calls in flight on the
        prep worker; ends at the first None.  Depth bounds how many batches
        are under way at once, from produce to fetch (FASTP_TPU_PREFETCH, 3
        unless set, at least 1).  Up to `depth` calls are made past the end
        of the input; produce() answers those with None and starts
        nothing."""
        if depth is None:
            depth = max(1, int(os.environ.get("FASTP_TPU_PREFETCH", "3")))
        pool = self._prep_pool()
        q = collections.deque(pool.submit(produce) for _ in range(depth))
        while True:
            item = q.popleft().result()
            if item is None:
                for f in q:  # the speculative calls past the end
                    f.result()
                return
            q.append(pool.submit(produce))
            yield item

    def _submit_batch(self, dispatch_fn, *args):
        """Pipeline one batch: dispatch_fn(*args) on the dispatch worker,
        the wait for its fetch on a fetch worker.  Returns a future of the
        unpacked numpy dict; an exception of either worker comes out of its
        result()."""
        def _dispatch():
            t0 = time.monotonic()
            try:
                return dispatch_fn(*args)
            finally:
                self._t_dispatch += time.monotonic() - t0   # one worker

        disp = self._upload_pool().submit(_dispatch)

        def _fetch():
            pending = disp.result()
            t0 = time.monotonic()
            try:
                return pending.wait()
            finally:
                with self._t_lock:
                    self._t_get += time.monotonic() - t0

        return self._fetch_pool().submit(_fetch)

    def _close_pool(self):
        """End the workers (a resident server would otherwise keep three
        pools of threads per job): what is queued is dropped, what runs is
        waited for."""
        for name in ("prep", "upload", "fetch"):
            pool = self._pools.pop(name, None)
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)

    def _run_batches(self, produce, flush, open_things, unit: str) -> int:
        """The batch loop.  produce() reads and submits one batch and
        returns its item (None at the end); for every item, in input order,
        this thread waits for the fetched outputs (item.out),
        self._process_batch(item) counts and routes them, and
        flush(item, routed) hands the bytes to the writers.  Then the
        accumulator's chains are added (self._add_sums) and the workers
        ended.  When anything raises, in this thread or in a worker, the
        run is abandoned with that exception.  Returns the number of reads
        or pairs seen."""
        timer = _LoopTimer()

        def produce_timed():
            t0 = time.monotonic()
            try:
                return produce(timer)
            finally:
                timer.add("produce", t0)

        seen = 0
        try:
            for item in self._batch_stream(produce_timed):
                t0 = time.monotonic()
                item.out = item.pending.result()
                t0 = timer.add("fetch_wait", t0)
                routed = self._process_batch(item)
                t0 = timer.add("route", t0)
                flush(item, routed)
                timer.add("flush", t0)
                seen += item.B
                self.batches += 1
                self._log_progress(seen)
                if self.on_batch is not None:
                    self.on_batch()
            # accumulate mode: the run's sums arrive now
            for vals in self._fold_accs():
                self._add_sums(vals)
        except BaseException:
            self._abandon(open_things)
            raise
        timer.report(unit, seen, self._t_dispatch, self._t_get)
        self._close_pool()
        return seen

    def process(self) -> Dict:
        """Run the job.  FASTP_TPU_CPUPROFILE=<file> writes a cProfile dump
        of the calling thread (counting, routing, writing; the workers are
        not in it: FASTP_TPU_TIMING=1 has their wall split)."""
        prof_path = os.environ.get("FASTP_TPU_CPUPROFILE")
        if not prof_path:
            return self._process_inner()
        import cProfile
        prof = cProfile.Profile()
        prof.enable()
        try:
            return self._process_inner()
        finally:
            prof.disable()
            prof.dump_stats(prof_path)

    def _abandon(self, open_things):
        """A run that dies between batches: end the workers (first, so that
        none of them reads or dispatches any more), the writers' threads,
        give the Bloom buffers back and drop the accumulator, so that a
        resident server keeps none of them after a failed job.  The caller
        raises the job's own exception; a failure to end a worker or a
        writer on the way is reported on stderr."""
        try:
            self._close_pool()
        except Exception as exc:
            _warn_left_open("the workers", exc)
        for thing in open_things:
            try:
                thing.close()
            except Exception as exc:
                _warn_left_open(type(thing).__name__, exc)
        if self.duplicate is not None:
            self.duplicate.release()
        self._acc_state = {}

    def _pad_batch(self, arrays, B, target=None):
        """Pad batch-major arrays to a fixed row count (a multiple of the
        number of devices) and return them with the valid mask.  On the
        card every batch pads to the batch size, so every launch sees one
        shape; on the CPU small inputs pad to a bucket ladder instead, as
        fastp_tpu does there."""
        tgt = max(B, target or B)
        if self.device.type == "cpu":
            for bucket in (256, 1024, 4096):
                if B <= bucket:
                    tgt = bucket
                    break
        tgt = -(-tgt // self.n_dev) * self.n_dev
        pad = tgt - B
        if pad == 0:
            return arrays, np.ones(B, bool)
        out = [np.pad(a, [(0, pad)] + [(0, 0)] * (a.ndim - 1)) for a in arrays]
        valid = np.zeros(tgt, bool)
        valid[:B] = True
        return out, valid

    def _index_drop_mask(self, names1, names2=None) -> np.ndarray:
        n = len(names1)
        mask = np.zeros(n, bool)
        if not self.opt.indexFilter.enabled:
            return mask
        th = self.opt.indexFilter.threshold
        bl1 = self.opt.indexFilter.blacklist1
        bl2 = self.opt.indexFilter.blacklist2
        for i in range(n):
            if _index_match(bl1, first_index(names1[i]), th):
                mask[i] = True
            elif names2 is not None and _index_match(bl2, last_index(names2[i]), th):
                mask[i] = True
        return mask

    @staticmethod
    def _blacklist_blob(items):
        lens = np.array([len(s) for s in items], np.int32)
        offs = np.zeros(len(items), np.int64)
        if len(items) > 1:
            np.cumsum(lens[:-1], out=offs[1:])
        blob = np.frombuffer(b"".join(s.encode("latin-1") for s in items)
                             or b"\0", np.uint8)
        return blob, offs, lens

    def _index_drop_mask_batches(self, batch1, batch2=None) -> np.ndarray:
        """Native batched index-blacklist filter over the raw name buffers
        (reference: src/filter.cpp:224-258); Python fallback per name."""
        B = batch1.n
        if not self.opt.indexFilter.enabled:
            return np.zeros(B, bool)
        lib = native_mod.get_lib()
        if lib is None:
            return self._index_drop_mask(
                batch1.names, batch2.names if batch2 is not None else None)
        if not hasattr(self, "_bl_cache"):
            self._bl_cache = (
                self._blacklist_blob(self.opt.indexFilter.blacklist1),
                self._blacklist_blob(self.opt.indexFilter.blacklist2))
        (b1b, b1o, b1l), (b2b, b2o, b2l) = self._bl_cache
        nb1, noff1, nlen1 = batch1.name_buffers()
        drop = np.zeros(B, np.uint8)
        if batch2 is not None:
            nb2, noff2, nlen2 = batch2.name_buffers()
            nb2c = np.ascontiguousarray(nb2)
            noff2c = np.ascontiguousarray(noff2[:B], np.int64)
            nlen2c = np.ascontiguousarray(nlen2[:B], np.int32)
            p2 = (nb2c.ctypes.data_as(ctypes.c_void_p),
                  noff2c.ctypes.data_as(ctypes.c_void_p),
                  nlen2c.ctypes.data_as(ctypes.c_void_p))
        else:
            p2 = (None, None, None)
        lib.index_filter(
            np.ascontiguousarray(nb1),
            np.ascontiguousarray(noff1[:B], np.int64),
            np.ascontiguousarray(nlen1[:B], np.int32),
            p2[0], p2[1], p2[2],
            b1b, b1o, b1l, len(b1l), b2b, b2o, b2l, len(b2l),
            self.opt.indexFilter.threshold, B, drop)
        return drop.astype(bool)

    def _print_stats(self, st: Stats):
        st.summarize()
        sys.stderr.write("total reads: %d\n" % st.reads)
        sys.stderr.write("total bases: %d\n" % st.bases)
        for name, n in (("Q20", st.q20_total), ("Q30", st.q30_total),
                        ("Q40", st.q40_total)):
            sys.stderr.write("%s bases: %d(%s%%)\n" % (
                name, n, cpp_num(n * 100.0 / st.bases if st.bases
                                 else float("nan"))))

    def _print_filter_result(self):
        fr = self.filter_result
        opt = self.opt
        w = sys.stderr.write
        w("reads passed filter: %d\n" % fr.filter_read_stats[PASS_FILTER])
        w("reads failed due to low quality: %d\n" % fr.filter_read_stats[FAIL_QUALITY])
        w("reads failed due to too many N: %d\n" % fr.filter_read_stats[FAIL_N_BASE])
        if opt.lengthFilter.enabled:
            w("reads failed due to too short: %d\n" % fr.filter_read_stats[FAIL_LENGTH])
            if opt.lengthFilter.maxLength > 0:
                w("reads failed due to too long: %d\n" % fr.filter_read_stats[FAIL_TOO_LONG])
        if opt.complexityFilter.enabled:
            w("reads failed due to low complexity: %d\n" % fr.filter_read_stats[FAIL_COMPLEXITY])
        if opt.adapter.enabled:
            w("reads with adapter trimmed: %d\n" % fr.trimmed_adapter_reads)
            w("bases trimmed due to adapters: %d\n" % fr.trimmed_adapter_bases)
        if opt.polyXTrim.enabled:
            w("reads with polyX in 3' end: %d\n" % fr.get_total_polyx_trimmed_reads())
            w("bases trimmed in polyX tail: %d\n" % fr.get_total_polyx_trimmed_bases())
        if opt.correction.enabled:
            w("reads corrected by overlap analysis: %d\n" % fr.corrected_reads)
            w("bases corrected by overlap analysis: %d\n" % fr.get_total_corrected_bases())


class SingleEndProcessor(BaseProcessor):
    """reference: src/seprocessor.cpp:196-315"""

    def __init__(self, opt: Options, devices):
        super().__init__(opt, devices)
        self.step = self._wrap_step(build_se_step)
        self.pre_stats = Stats(opt, False, self.width)
        self.post_stats = Stats(opt, False, self.width)
        self.filter_result = FilterResult(opt, False)
        self.overrep_pre = _OverRepCounter(self.pre_stats, opt)
        self.overrep_post = _OverRepCounter(self.post_stats, opt)

    def _dispatch(self, bases_p, quals_p, lengths_p, pre_trim_p,
                  index_drop_p, dedup_p, valid):
        """Pack, upload and queue the step for one padded batch (on the
        dispatch worker).  Returns the pending fetch."""
        aux = make_aux(self.cfg, valid, pre_trim_p, None, index_drop_p,
                       dedup_p)
        return self._dispatch_mates([(bases_p, quals_p)], [lengths_p], aux)

    def _log_progress(self, seen: int):
        if self.opt.verbose and seen >= self._last_reported + 1000000:
            self._last_reported = seen
            loginfo("loaded %dM reads" % (seen // 1000000))

    def _process_inner(self) -> Dict:
        opt = self.opt
        reader = open_batch_reader(opt.in1, opt.phred64,
                                   getattr(opt, "shardRange1", None),
                                   getattr(opt, "shardRecRange", None))
        out_writer = failed_writer = split = None
        if opt.split.enabled:
            split = SplitWriterSet(opt)
        else:
            if opt.out1 or opt.outputToSTDOUT:
                out_writer = OutputWriter(opt.out1, opt.compression,
                                          opt.outputToSTDOUT,
                                          opt.writerBufferSize)
            if opt.failedOut:
                failed_writer = OutputWriter(opt.failedOut, opt.compression,
                                             buffer_size=opt.writerBufferSize)
        self._last_reported = 0
        state = SimpleNamespace(eof=False, read=0)

        def produce(timer):
            """Read one batch, run the host pre-ops and submit it; called
            ahead of the loop, on the prep worker.  The item carries the
            batch's starting read index and its width: this function runs
            ahead of whoever consumes the item."""
            if state.eof:
                return None
            n = opt.batchSize
            if opt.readsToProcess > 0:
                n = min(n, opt.readsToProcess - state.read)
                if n <= 0:
                    state.eof = True
                    return None
            t0 = time.monotonic()
            batch = reader.read_batch(n, self.width)
            t0 = timer.add("read", t0)
            if batch is None:
                state.eof = True
                return None
            B = batch.n
            self.width = batch.width
            index_drop = self._index_drop_mask_batches(batch)
            if opt.fixMGI:
                batch.set_names([fix_mgi(nm)[0] for nm in batch.names])
            if opt.umi.enabled:
                res = self.umi.process_batch_arrays(batch)
                if res is not None:
                    pre_trim = res[0]
                else:
                    names_u, _, pre_trim, _ = self.umi.process_batch(
                        batch.names, batch.seqs())
                    batch.set_names(names_u)
                    pre_trim = np.asarray(pre_trim, np.int32)
            else:
                pre_trim = np.zeros(B, np.int32)
            dedup_out = np.zeros(B, bool)
            if self.duplicate is not None:
                t0 = time.monotonic()
                dup = self.duplicate.check_batch_se(batch.bases,
                                                    batch.lengths)
                timer.add("dup", t0)
                if opt.duplicate.dedup:
                    dedup_out = dup
            t0 = time.monotonic()
            padded, valid = self._pad_batch(
                [batch.bases, batch.quals, batch.lengths, pre_trim,
                 index_drop, dedup_out], B, target=opt.batchSize)
            t0 = timer.add("pad", t0)
            pending = self._submit_batch(self._dispatch, *padded, valid)
            timer.add("submit", t0)
            item = SimpleNamespace(
                pending=pending, out=None, batch=batch, B=B, start=state.read,
                index_drop=index_drop, pre_trim=pre_trim,
                dedup_out=dedup_out)
            state.read += B
            return item

        def flush(item, routed):
            blob, failed, post_count = routed
            if split is not None:
                split.write1(blob, post_count if opt.split.byFileLines
                             else item.B)
            elif out_writer is not None:
                out_writer.write(blob)
            if failed_writer is not None:
                failed_writer.write(failed)

        open_things = [reader] + [w for w in (out_writer, failed_writer,
                                              split) if w is not None]
        reads_seen = self._run_batches(produce, flush, open_things, "reads")
        if opt.verbose:
            loginfo("batch loop done (%d reads)" % reads_seen)
        for thing in open_things:
            thing.close()
        return self._finish()

    def _add_sums(self, vals):
        """Add a dict of batch-reduced sums to the host's stats: a batch's
        output dict, or in accumulate mode the run's, at its end."""
        self.pre_stats.add_batch(vals["pre"])
        self.post_stats.add_batch(vals["post"])
        self.filter_result.add_polyx_trimmed(vals["polyx_reads"],
                                             vals["polyx_bases"])
        if "result_hist" in vals:
            # lean: the device histogram carries the filter-result counts
            self.filter_result.filter_read_stats += \
                vals["result_hist"].astype(np.int64)

    def _process_batch(self, item):
        """The consuming half of one batch, in input order on the calling
        thread: counting, adapter recording, overrepresentation sampling
        and serialization of the fetched outputs (item.out).  Returns
        (passing reads' FASTQ, --failed_out FASTQ, number of passing
        reads)."""
        opt = self.opt
        batch, B, out = item.batch, item.B, item.out
        index_drop, pre_trim, dedup_out = (item.index_drop, item.pre_trim,
                                           item.dedup_out)
        reads_seen = item.start
        bases, quals, lengths = batch.bases, batch.quals, batch.lengths
        # lean steps drop total_front when no front trim/cut can move the
        # window start on device: it is exactly the host pre-trim
        out.setdefault("total_front", pre_trim)

        if not self._accum:
            self._add_sums(out)
        # filter result counting (index-dropped and pad rows excluded); in
        # lean mode the device histogram carries the same counts
        if "result" in out:
            self.filter_result.add_filter_result_array(
                out["result"][:B][~index_drop], 1)
        if "ad_found" in out and out["ad_found"].any():
            self._record_adapters(out, bases)

        # overrepresentation sampling (pre on original, post on emitted)
        if self.overrep_pre.enabled:
            samp = self.overrep_pre.sampling
            rows = np.arange((-reads_seen) % samp, B, samp, dtype=np.int32)
            self.overrep_pre.stat_rows(bases, np.zeros(B, np.int32), lengths,
                                       rows)
        tf = out["total_front"]
        rlen = out["rlen"]
        emit = out["emit"][:B]
        if native_mod.get_lib() is not None:
            nbuf, noff, nlen = batch.name_buffers()
            sbuf, soff, slen = batch.strand_buffers()
            blob = native_mod.serialize(nbuf, noff, nlen, sbuf, soff, slen,
                                        bases, quals, tf[:B], rlen[:B], emit,
                                        batch.width)
        else:
            parts = []
            for i in np.flatnonzero(emit):
                s0 = int(tf[i])
                s1 = s0 + int(rlen[i])
                parts += [batch.name(i), b"\n", bases[i, s0:s1].tobytes(),
                          b"\n", batch.strand(i), b"\n",
                          quals[i, s0:s1].tobytes(), b"\n"]
            blob = b"".join(parts)
        if self.overrep_post.enabled:
            rows = np.flatnonzero(emit)
            sel = rows[np.arange(rows.size) % self.overrep_post.sampling == 0]
            self.overrep_post.stat_rows(bases, tf[:B], rlen[:B],
                                        sel.astype(np.int32))
        failed = []
        if opt.failedOut and not opt.split.enabled:
            # failed reads show the processed window when they survived
            # trimming, pristine bytes when trim killed them (the reference
            # mutates the Read in place: src/seprocessor.cpp:273)
            result, alive = out["result"], out["alive"]
            for i in np.flatnonzero(~emit & ~index_drop & ~dedup_out):
                if alive[i]:
                    s0 = int(tf[i])
                    s1 = s0 + int(rlen[i])
                else:
                    s0, s1 = int(pre_trim[i]), int(lengths[i])
                failed += [batch.name(i) + b" "
                           + FAILED_TYPES[int(result[i])].encode(), b"\n",
                           bases[i, s0:s1].tobytes(), b"\n", batch.strand(i),
                           b"\n", quals[i, s0:s1].tobytes(), b"\n"]
        return blob, b"".join(failed), int(emit.sum())

    def _record_adapters(self, out, bases: np.ndarray):
        """Adapter recording in row order (see record_adapter_hits)."""
        frows = np.flatnonzero(out["ad_found"])
        tfs = out["total_front"][frows].astype(np.int64)
        record_adapter_hits(
            self.filter_result, bases, frows,
            out["ad_pos"][frows].astype(np.int64),
            tfs + out["rlen_post_adapter"][frows].astype(np.int64),
            tfs + out["rlen_pre_adapter"][frows].astype(np.int64),
            self.cfg.adapter_seq1, False)

    def _finish(self) -> Dict:
        opt = self.opt
        self.overrep_pre.flush()
        self.overrep_post.flush()
        if multihost.active():
            # gather every shard's accumulators; only shard 0 reports
            if not multihost.merge_processor_stats(self, is_pe=False):
                if self.duplicate is not None:
                    self.duplicate.release()
                return {"pre": self.pre_stats, "post": self.post_stats,
                        "filter": self.filter_result, "dup_rate": 0.0,
                        "batches": self.batches,
                        "input_kinds": dict(self.input_kinds)}
        sys.stderr.write("Read1 before filtering:\n")
        self._print_stats(self.pre_stats)
        sys.stderr.write("\nRead1 after filtering:\n")
        self._print_stats(self.post_stats)
        sys.stderr.write("\nFiltering result:\n")
        self._print_filter_result()
        dup_rate = 0.0
        if opt.duplicate.enabled:
            dup_rate = self.duplicate.get_dup_rate()
            sys.stderr.write("\nDuplication rate (may be overestimated since "
                             "this is SE data): %s%%\n"
                             % cpp_num(dup_rate * 100.0))
        jr = JsonReporter(opt)
        jr.set_dup(dup_rate)
        jr.report(self.filter_result, self.pre_stats, self.post_stats)
        hr = HtmlReporter(opt)
        hr.set_dup(dup_rate)
        hr.report(self.filter_result, self.pre_stats, self.post_stats)
        if self.duplicate is not None:
            self.duplicate.release()
        return {"pre": self.pre_stats, "post": self.post_stats,
                "filter": self.filter_result, "dup_rate": dup_rate,
                "batches": self.batches,
                "input_kinds": dict(self.input_kinds)}


class SplitWriterSet:
    """Split-output rotation (reference: src/threadconfig.cpp:106-157).

    Emulates the reference's per-worker round-robin file numbering with
    `thread` virtual workers: worker t owns file numbers t+1, t+1+T, ...
    """

    def __init__(self, opt: Options, paired: bool = False):
        self.opt = opt
        self.paired = paired
        self.T = opt.thread
        self.next_worker = 0
        self.worker_split = list(range(1, self.T + 1))  # current file number per worker
        self.worker_count = [0] * self.T
        self._writers1 = [None] * self.T
        self._writers2 = [None] * self.T
        self.finished = [False] * self.T

    def _filename(self, number: int, base: str) -> str:
        num = str(number)
        if self.opt.split.digits > 0:
            num = num.zfill(self.opt.split.digits)
        dirname, fname = os.path.split(base)
        return os.path.join(dirname, "%s.%s" % (num, fname))

    def _open(self, t: int):
        opt = self.opt
        if opt.out1:
            self._writers1[t] = OutputWriter(
                self._filename(self.worker_split[t], opt.out1),
                opt.compression, buffer_size=opt.writerBufferSize)
        if self.paired and opt.out2:
            self._writers2[t] = OutputWriter(
                self._filename(self.worker_split[t], opt.out2),
                opt.compression, buffer_size=opt.writerBufferSize)

    def write1(self, blob: bytes, processed: int, blob2: bytes = None):
        t = self.next_worker
        self.next_worker = (self.next_worker + 1) % self.T
        if self.finished[t]:
            return
        if self._writers1[t] is None and self.opt.out1:
            self._open(t)
        if self._writers1[t] is not None:
            self._writers1[t].write(blob)
        if blob2 is not None and self._writers2[t] is not None:
            self._writers2[t].write(blob2)
        self._mark(t, processed)

    def _mark(self, t: int, count: int):
        """reference: src/threadconfig.cpp:127-147 (markProcessed): rotate
        to the worker's next file number, except in by-file-number mode
        when the quota is reached -- then the current (last) file keeps
        absorbing reads, and workers beyond number%T stop consuming (their
        reads are dropped, as the reference's stopped threads leave their
        remaining packs unconsumed)."""
        opt = self.opt
        self.worker_count[t] += count
        if self.worker_count[t] >= opt.split.size:
            if (opt.split.byFileLines
                    or (self.worker_split[t] - 1) + self.T < opt.split.number):
                self.worker_count[t] = 0
                self.worker_split[t] += self.T
                for writers in (self._writers1, self._writers2):
                    if writers[t]:
                        writers[t].close()
                        writers[t] = None
            elif (opt.split.number % self.T > 0
                    and t >= opt.split.number % self.T):
                self.finished[t] = True

    def close(self):
        for writers in (self._writers1, self._writers2):
            for w in writers:
                if w:
                    w.close()
        # fill the quota with empty files (reference: threadconfig.cpp:151-157)
        if self.opt.split.byFileNumber:
            for num in range(1, self.opt.split.number + 1):
                names = [self.opt.out1] if self.opt.out1 else []
                if self.paired and self.opt.out2:
                    names.append(self.opt.out2)
                for base in names:
                    f = self._filename(num, base)
                    if not os.path.exists(f):
                        open(f, "wb").close()
