"""Several processes on one input: same-host scale-out.

The reference scales with worker threads inside one process
(src/peprocessor.cpp:750-754); here `--local_processes N` (cli.py) starts N
processes of the port, each a shard of the job named by
FASTP_TPU_SHARD_INDEX and FASTP_TPU_SHARD_COUNT.  On a host with one card
they share it; the host stages of a batch then run in N interpreters at
once.  This module is the shards' side of that:

  * input: each process takes a byte range of the (uncompressed) FASTQ,
    aligned to record boundaries.  For PE, read1 boundaries are chosen by
    bytes and mapped to record indices (newline counts / 4), and read2
    ranges are derived from the same record indices, so every process sees
    matching pairs.  Well-formed 4-line records are assumed (the alignment
    uses the '@'-line / '+'-line structure), matching what every FASTQ
    byte-range sharder (seqkit split2 etc.) assumes.  Gzip input is sharded
    by record ranges instead.
  * output: per-shard files named like the reference's --split rotation
    ("0001."-prefixed, src/threadconfig.cpp:106-125), one shard per process.
  * stats: every process accumulates its local Stats/FilterResult; at the
    end the snapshots (report/stats_model.py:state_dict) are exchanged
    through files next to the JSON report and process 0 merges them
    (Stats::merge equivalent, src/stats.cpp:902-965) and writes the single
    JSON/HTML report.

Dedup/duplication analysis is EXACT across shards: a cheap pre-pass hashes
every shard's records, the per-record Bloom positions are exchanged, and
first-occurrence-wins is resolved by global record index
(exact_dedup_verdicts below) -- deterministic and byte-identical to the
single-process run, which the multi-threaded reference itself is not
(its shared filter is arrival-order dependent).

Shards of one job on several hosts, with the exchange over
torch.distributed, are not ported yet: without the two variables `active()`
is false.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import List, Optional, Tuple

import numpy as np

_CHUNK = 1 << 23


def _env_shard() -> Optional[Tuple[int, int]]:
    """(index, count) when this process is a shard of a same-host
    `--local_processes N` fan-out (cli.py spawns the children with these
    env vars; the reference self-spawns worker threads from -w N the same
    way, src/peprocessor.cpp:750-754).  None otherwise."""
    c = os.environ.get("FASTP_TPU_SHARD_COUNT")
    if c and int(c) > 1:
        return int(os.environ.get("FASTP_TPU_SHARD_INDEX", "0")), int(c)
    return None


def active() -> bool:
    return _env_shard() is not None


def process_index() -> int:
    e = _env_shard()
    return e[0] if e is not None else 0


def process_count() -> int:
    e = _env_shard()
    return e[1] if e is not None else 1


# ---------------------------------------------------------------------------
# input sharding


def _align_to_record(path: str, pos: int) -> int:
    """Smallest record start >= pos: a line starting with '@' whose
    line+2 starts with '+' (sequence lines cannot start with '@' or '+',
    so this disambiguates name lines from quality lines)."""
    size = os.path.getsize(path)
    if pos <= 0:
        return 0
    if pos >= size:
        return size
    with open(path, "rb") as f:
        window = 1 << 20
        while True:
            f.seek(pos)
            buf = f.read(window)
            nl = np.flatnonzero(np.frombuffer(buf, np.uint8) == 10)
            # line starts strictly after pos (skip the partial first line)
            starts = [int(p) + 1 for p in nl]
            for idx in range(len(starts) - 3):
                s = starts[idx]
                if s < len(buf) and buf[s:s + 1] == b"@":
                    s2 = starts[idx + 2]
                    if s2 < len(buf) and buf[s2:s2 + 1] == b"+":
                        return pos + s
            if pos + len(buf) >= size:
                return size
            window *= 2


def _newlines_before(path: str, targets: List[int]) -> List[int]:
    """Number of newlines in path[0:t) for each ascending byte offset t."""
    out = []
    ti = 0
    count = 0
    base = 0
    with open(path, "rb") as f:
        while ti < len(targets):
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            nl = np.flatnonzero(np.frombuffer(chunk, np.uint8) == 10)
            while ti < len(targets) and targets[ti] <= base + len(chunk):
                out.append(count + int(np.searchsorted(nl, targets[ti] - base)))
                ti += 1
            count += len(nl)
            base += len(chunk)
    while len(out) < len(targets):
        out.append(count)
    return out


def _offset_after_lines(path: str, line_targets: List[int]) -> List[int]:
    """Byte offset just after the k-th newline (ascending k, 1-based);
    k == 0 maps to offset 0."""
    out = []
    ti = 0
    count = 0
    base = 0
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        while ti < len(line_targets) and line_targets[ti] == 0:
            out.append(0)
            ti += 1
        while ti < len(line_targets):
            chunk = f.read(_CHUNK)
            if not chunk:
                break
            nl = np.flatnonzero(np.frombuffer(chunk, np.uint8) == 10)
            while (ti < len(line_targets)
                   and line_targets[ti] <= count + len(nl)):
                idx = line_targets[ti] - count - 1
                out.append(base + int(nl[idx]) + 1)
                ti += 1
            count += len(nl)
            base += len(chunk)
    while len(out) < len(line_targets):
        out.append(size)
    return out


def shard_ranges(path1: str, path2: Optional[str], n: int):
    """((start1, end1) per shard, (start2, end2) per shard or None)."""
    size1 = os.path.getsize(path1)
    bounds1 = [_align_to_record(path1, size1 * k // n) for k in range(n)]
    bounds1.append(size1)
    # enforce monotonicity (tiny files can align several shards to the same
    # record; later shards then get empty ranges)
    for k in range(1, n + 1):
        bounds1[k] = max(bounds1[k], bounds1[k - 1])
    ranges1 = [(bounds1[k], bounds1[k + 1]) for k in range(n)]
    if not path2:
        return ranges1, None
    recs = [c // 4 for c in _newlines_before(path1, bounds1[1:n])]
    bounds2 = [0] + _offset_after_lines(path2, [4 * r for r in recs])
    bounds2.append(os.path.getsize(path2))
    for k in range(1, n + 1):
        bounds2[k] = max(bounds2[k], bounds2[k - 1])
    ranges2 = [(bounds2[k], bounds2[k + 1]) for k in range(n)]
    return ranges1, ranges2


def shard_filename(path: str, index: int, digits: int = 4) -> str:
    """Reference --split naming: '0001.name' (src/threadconfig.cpp:106-125),
    shard numbers are 1-based."""
    num = str(index + 1).zfill(digits)
    dirname, fname = os.path.split(path)
    out = "%s.%s" % (num, fname)
    return os.path.join(dirname, out) if dirname else out


def shard_options(opt) -> None:
    """Rewrite Options in place for this process's shard: input byte
    ranges + per-shard output names.  Reports stay unsharded (process 0
    writes the merged report)."""
    from ..config import error_exit
    k = process_index()
    n = process_count()
    # per-JOB exchange-round counter: a resident server may have served
    # earlier exchanging jobs, and shards on fresh vs warm servers must
    # still agree on round numbering
    _exchange_round[0] = 0
    if opt.inputFromSTDIN or opt.in1 in ("/dev/stdin", "-"):
        error_exit("input sharding does not support STDIN input")
    if opt.split.enabled:
        error_exit("--split cannot be combined with input sharding "
                   "(outputs are already sharded per process)")
    if opt.in1.endswith(".gz") or (opt.in2 and opt.in2.endswith(".gz")):
        # gzip streams are not byte-addressable: shard by RECORD ranges.
        # Every process streams the gz and bulk-skips to its contiguous
        # range (decompress is ~10x faster than the pipeline, so the
        # skipped prefix costs little), which keeps concatenated shard
        # outputs byte-identical to the single-process run.  R2 shares
        # R1's record indices, so pairs never split.
        from ..io.fastq import count_records
        n_rec = count_records(opt.in1)
        if opt.interleavedInput:
            pairs = n_rec // 2
            bounds = [2 * (pairs * i // n) for i in range(n)]
        else:
            bounds = [n_rec * i // n for i in range(n)]
        bounds.append(None)  # last shard reads to EOF
        opt.shardRecRange = (bounds[k], bounds[k + 1])
        opt.shardRange1 = None
        opt.shardRange2 = None
    elif opt.interleavedInput:
        r1, _ = shard_ranges(opt.in1, None, n)
        # align interleaved boundaries to an even record index
        # (pairs must not straddle shards)
        recs = [c // 4 for c in _newlines_before(opt.in1, [b for b, _ in r1])]
        evens = [4 * (r + (r & 1)) for r in recs]
        bounds = _offset_after_lines(opt.in1, evens)
        bounds.append(os.path.getsize(opt.in1))
        for i in range(1, n + 1):
            bounds[i] = max(bounds[i], bounds[i - 1])
        opt.shardRange1 = (bounds[k], bounds[k + 1])
        opt.shardRange2 = None
    else:
        r1, r2 = shard_ranges(opt.in1, opt.in2 or None, n)
        opt.shardRange1 = r1[k]
        opt.shardRange2 = r2[k] if r2 else None
    for attr in ("out1", "out2", "unpaired1", "unpaired2", "failedOut",
                 "overlappedOut"):
        v = getattr(opt, attr)
        if v:
            setattr(opt, attr, shard_filename(v, k))
    if opt.merge.out:
        opt.merge.out = shard_filename(opt.merge.out, k)


# ---------------------------------------------------------------------------
# exact cross-shard dedup


def exact_dedup_verdicts(opt) -> Optional[np.ndarray]:
    """Exact cross-shard duplicate verdicts for THIS shard's records.

    The reference shares one atomically-updated filter across threads
    (reference: src/duplicate.cpp:154-167), which makes its multi-threaded
    verdicts arrival-order nondeterministic.  Here every process hashes its
    shard in a cheap pre-pass (tokenize + hash only), the per-record bit
    positions are allgathered, and first-occurrence-wins is resolved by
    GLOBAL record index — deterministic and byte-identical to the
    single-process run.  Only the LAST Bloom buffer's position decides a
    verdict (the reference's isDup overwrite quirk), so one u64 per record
    is exchanged.

    Returns verdicts aligned with this shard's record order, or None when
    dedup is off or the job is not sharded.
    """
    if not (opt.duplicate.enabled and active()):
        return None
    from ..duplicate import Duplicate
    from ..io.fastq import open_batch_reader
    hasher = Duplicate(opt, hash_only=True)
    positions: List[np.ndarray] = []
    n_batch = max(opt.batchSize, 4096)
    if opt.in2 or opt.interleavedInput:
        if opt.interleavedInput:
            from ..pipeline.pe_runner import _InterleavedPairSource
            src = _InterleavedPairSource(open_batch_reader(
                opt.in1, opt.phred64, getattr(opt, "shardRange1", None),
                getattr(opt, "shardRecRange", None)))
            read_pair = lambda: src.read_pair_batch(n_batch, 192)
        else:
            r1 = open_batch_reader(opt.in1, opt.phred64,
                                   getattr(opt, "shardRange1", None),
                                   getattr(opt, "shardRecRange", None))
            r2 = open_batch_reader(opt.in2, opt.phred64,
                                   getattr(opt, "shardRange2", None),
                                   getattr(opt, "shardRecRange", None))
            read_pair = lambda: (r1.read_batch(n_batch, 192),
                                 r2.read_batch(n_batch, 192))
        while True:
            b1, b2 = read_pair()
            if b1 is None or b2 is None:
                break
            m = min(b1.n, b2.n)  # unmatched tails are ignored (main pass
            b1, b2 = b1.head(m), b2.head(m)  # prints the reference warning)
            if b1.width != b2.width:
                w = max(b1.width, b2.width)
                b1, b2 = b1.widen(w), b2.widen(w)
            pos = hasher.hash_positions_pe(b1.bases, b1.lengths,
                                           b2.bases, b2.lengths)
            positions.append(pos[-1].astype(np.uint64))
    else:
        r1 = open_batch_reader(opt.in1, opt.phred64,
                               getattr(opt, "shardRange1", None),
                               getattr(opt, "shardRecRange", None))
        while True:
            b = r1.read_batch(n_batch, 192)
            if b is None:
                break
            pos = hasher.hash_positions_se(b.bases, b.lengths)
            positions.append(pos[-1].astype(np.uint64))
    mine = (np.concatenate(positions) if positions
            else np.zeros(0, np.uint64))
    exchange_dir = os.path.dirname(os.path.abspath(opt.jsonFile)) or "."
    states = allgather_state({"pos": mine}, exchange_dir)
    shard_pos = [np.asarray(s["pos"], np.uint64) for s in states]
    all_pos = np.concatenate(shard_pos)
    # byte-range shards are ordered, so concatenation order == global
    # record order; a stable sort keeps first occurrences first
    order = np.argsort(all_pos, kind="stable")
    sp = all_pos[order]
    dup_sorted = np.zeros(len(sp), bool)
    dup_sorted[1:] = sp[1:] == sp[:-1]
    dup = np.empty(len(sp), bool)
    dup[order] = dup_sorted
    start = sum(len(shard_pos[i]) for i in range(process_index()))
    return dup[start:start + len(mine)]


# ---------------------------------------------------------------------------
# stats exchange


_exchange_round = [0]


def _allgather_bytes_files(payload: bytes, exchange_dir: str) -> List[bytes]:
    """Exchange through files: write <dir>/.fastp_shard.<round>.<k>,
    poll for every shard, then read them all (process 0 cleans up).

    Every process performs the run's exchanges in the same order (dedup
    pre-pass, then final stats), so a per-process round counter keeps the
    rounds' files distinct — without it a fast shard could publish round
    2's payload before process 0 finished deleting round 1's files and
    lose it to that cleanup."""
    k = process_index()
    n = process_count()
    rnd = _exchange_round[0]
    _exchange_round[0] += 1
    os.makedirs(exchange_dir, exist_ok=True)
    mine = os.path.join(exchange_dir, ".fastp_shard.%d.%d" % (rnd, k))
    tmp = mine + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.rename(tmp, mine)
    paths = [os.path.join(exchange_dir, ".fastp_shard.%d.%d" % (rnd, i))
             for i in range(n)]
    deadline = time.time() + 600
    while any(not os.path.exists(p) for p in paths):
        if time.time() > deadline:
            raise TimeoutError("timed out waiting for shard stats files")
        time.sleep(0.05)
    out = []
    for p in paths:
        with open(p, "rb") as f:
            out.append(f.read())
    # all processes have read everything once every done-marker exists;
    # give laggards a beat, then process 0 cleans up
    marker = os.path.join(exchange_dir, ".fastp_shard_done.%d.%d" % (rnd, k))
    open(marker, "wb").close()
    if k == 0:
        markers = [os.path.join(exchange_dir,
                                ".fastp_shard_done.%d.%d" % (rnd, i))
                   for i in range(n)]
        deadline = time.time() + 600
        while any(not os.path.exists(p) for p in markers):
            if time.time() > deadline:
                break
            time.sleep(0.05)
        for p in paths + markers:
            try:
                os.unlink(p)
            except OSError:
                pass
    return out


def allgather_state(state: dict, exchange_dir: str) -> List[dict]:
    """Every shard's `state`, in shard order.  The shards of
    --local_processes share one host (the launcher started them), so the
    file exchange is always valid."""
    payload = pickle.dumps(state, protocol=pickle.HIGHEST_PROTOCOL)
    return [pickle.loads(d)
            for d in _allgather_bytes_files(payload, exchange_dir)]


def merge_processor_stats(proc, is_pe: bool) -> bool:
    """Allgather per-shard accumulators and merge into this process's
    processor.  Returns True when this process (0) should write reports."""
    state = {
        "filter": proc.filter_result.state_dict(),
    }
    if is_pe:
        state["pre1"] = proc.pre_stats1.state_dict()
        state["post1"] = proc.post_stats1.state_dict()
        state["pre2"] = proc.pre_stats2.state_dict()
        state["post2"] = proc.post_stats2.state_dict()
        state["insert_hist"] = proc.insert_hist
    else:
        state["pre"] = proc.pre_stats.state_dict()
        state["post"] = proc.post_stats.state_dict()
    if proc.duplicate is not None:
        state["dup"] = (proc.duplicate.total_reads, proc.duplicate.dup_reads)
    exchange_dir = os.path.dirname(os.path.abspath(proc.opt.jsonFile)) or "."
    states = allgather_state(state, exchange_dir)
    if process_index() != 0:
        return False
    me = process_index()
    for i, st in enumerate(states):
        if i == me:
            continue
        proc.filter_result.merge_state(st["filter"])
        if is_pe:
            proc.pre_stats1.merge_state(st["pre1"])
            proc.post_stats1.merge_state(st["post1"])
            proc.pre_stats2.merge_state(st["pre2"])
            proc.post_stats2.merge_state(st["post2"])
            h = st["insert_hist"]
            proc.insert_hist[:len(h)] += h
        else:
            proc.pre_stats.merge_state(st["pre"])
            proc.post_stats.merge_state(st["post"])
        if proc.duplicate is not None and "dup" in st:
            proc.duplicate.total_reads += st["dup"][0]
            proc.duplicate.dup_reads += st["dup"][1]
    return True
