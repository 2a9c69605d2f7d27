"""Per-batch SE and PE device steps in PyTorch, and their transfers.

Counterparts of fastp_tpu/pipeline/device.py:build_se_step and
build_pe_step, lean or not as cfg.lean says: the reference order of
src/seprocessor.cpp:196-315 and src/peprocessor.cpp:361-600 (stats,
trim/cut, polyG, overlap analysis, correction, adapter trimming, polyX,
merging, filters, stats, histograms).  A step returns a numpy dict with the
keys and value semantics that fastp_tpu.pipeline.device.unpack_from_host
yields for the same cfg.

A step has three parts (class Step): `run` queues the upload and the device
work of a batch and returns tensors on the device, `start_fetch` narrows and
packs them into ONE uint8 buffer (_slim_outputs, pack_for_host) and queues
its copy to the host, and the pending fetch's `wait` unpacks it
(unpack_from_host).  On a card all of it is queued on one side stream, the
uploads leave from pinned staging buffers and the fetch lands in a pinned
buffer behind an event (class StepIO), so the caller's threads never wait
for the whole device.  Between `run` and `start_fetch` a caller may keep
some of the tensors on the device: the run accumulator (pipeline/runner.py)
takes the batch's sums out and adds them to a resident vector, and the
split over several devices (parallel/mesh.py) runs every shard before it
fetches any.  A step built with `rowwise=True` is a shard of such a split:
its correction deltas are per row (ops/correct.py:extract_deltas), so
nothing in it depends on rows that another device holds.

Inputs arrive plain (uint8 bases and quals) or packed by io/native.py at 8,
4 or 3 bits per position with an exception list (`packed=`); a packed
step decodes them first (_unpack_bq, _unpack_nib, _unpack_p3: plain PyTorch,
as they are plain XLA code in fastp_tpu).

fastp_tpu jits its step once per configuration and keeps it
(functools.lru_cache on build_se_step and build_pe_step), and a batch is
one dispatch of that executable.  Here memo_step keeps up to MEMO_ENTRIES
configurations, each with its StepIO and one step per input scheme, so a
resident server's later jobs reuse them; and on a card a step is a CUDA
graph (class _Graph): the first batch of a shape runs the step eagerly and
captures it -- the decode of the inputs, the step, the batch's sums as one
vector for the run accumulator, and the narrowing and packing of the rest
into one buffer -- and every batch after that is one copy up, one replay
and the copy of the buffer down.  The eager step stays: on the CPU, and on
a card where the builder is asked for it (graph=False).
"""
from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

import numpy as np
import torch

from ..config import PASS_FILTER, FILTER_RESULT_TYPES
from .static_cfg import DeviceCfg

from ..ops import adapter as adapter_ops
from ..ops import correct as correct_ops
from ..ops import filter as filter_ops
from ..ops import merge as merge_ops
from ..ops import overlap as overlap_ops
from ..ops import polyx as polyx_ops
from ..ops import stats as stats_ops
from ..ops import launches
from ..ops import trim as trim_ops
from ..ops.common import I32, device_table, roll_front, scatter_count


class _FilterCfgView:
    """Adapter of DeviceCfg attribute names for ops.filter/trim."""

    def __init__(self, cfg: DeviceCfg):
        for k in ("enabledFront", "enabledTail", "enabledRight",
                  "windowSizeFront", "qualityFront", "windowSizeTail",
                  "qualityTail", "windowSizeRight", "qualityRight",
                  "qualfilter_enabled", "qualifiedQual",
                  "unqualifiedPercentLimit", "avgQualReq", "nBaseLimit",
                  "lengthFilter_enabled", "requiredLength", "maxLength",
                  "complexity_enabled", "complexity_threshold_percent"):
            setattr(self, k, getattr(cfg, k))


def _multi_fasta_match_req(n: int) -> int:
    """reference: src/adaptertrimmer.cpp:48-52"""
    if n > 256:
        return 6
    if n > 16:
        return 5
    return 4


def aux_arg_names(cfg: DeviceCfg):
    """Trailing per-batch aux args, statically derived from cfg (the
    fastp_tpu step's signature: masks dead by configuration are left out,
    and the valid mask is a prefix given by its count)."""
    names = []
    if cfg.has_pretrim:
        names += ["pre_trim1", "pre_trim2"] if cfg.paired else ["pre_trim"]
    if cfg.has_index_drop:
        names.append("index_drop")
    if cfg.has_dedup:
        names.append("dedup_out")
    names.append("nvalid")
    return tuple(names)


def make_aux(cfg: DeviceCfg, valid_or_n, pre_trim1=None, pre_trim2=None,
             index_drop=None, dedup_out=None):
    """Host-side aux tuple for the step (numpy).  Pre-trims travel as int16
    (UMI splices are short)."""
    out = []
    if cfg.has_pretrim:
        out.append(np.asarray(pre_trim1, np.int16))
        if cfg.paired:
            out.append(np.asarray(pre_trim2, np.int16))
    if cfg.has_index_drop:
        out.append(np.asarray(index_drop, bool))
    if cfg.has_dedup:
        out.append(np.asarray(dedup_out, bool))
    n = (valid_or_n if isinstance(valid_or_n, (int, np.integer))
         else int(valid_or_n.sum()))
    out.append(np.int32(n))
    return tuple(out)


def _expand_aux(cfg: DeviceCfg, B: int, aux, up, device):
    """(pre1, pre2, index_drop, dedup_out, valid) tensors from the aux
    tuple; `up` is the run's upload (StepIO.upload).  The count of valid
    rows goes up with the other aux arguments and the mask is made on the
    device, so that a captured step reads each batch's own count."""
    d = dict(zip(aux_arg_names(cfg), aux))

    def put(key, dtype):
        if key not in d:
            return torch.zeros(B, dtype=dtype, device=device)
        return up(d[key], dtype)

    pre1 = put("pre_trim1" if "pre_trim1" in d else "pre_trim", I32)
    pre2 = put("pre_trim2", I32)
    valid = (torch.arange(B, dtype=I32, device=device)
             < up(d["nvalid"], I32).reshape(()))
    return pre1, pre2, put("index_drop", torch.bool), \
        put("dedup_out", torch.bool), valid


def _trim_one_end(bases, quals, lengths, pre_trim, cfg: DeviceCfg, is_r2: bool):
    """UMI pre-trim roll + trimAndCut + window roll. Returns
    (w_bases, w_quals, rlen, alive, front_trimmed, total_front)."""
    b1 = roll_front(bases, pre_trim)
    q1 = roll_front(quals, pre_trim)
    l1 = lengths.to(I32) - pre_trim
    fr = cfg.front2 if is_r2 else cfg.front1
    tl = cfg.tail2 if is_r2 else cfg.tail1
    front, rlen, alive = trim_ops.trim_and_cut(b1, q1, l1, fr, tl,
                                               _FilterCfgView(cfg))
    w_b = roll_front(b1, front)
    w_q = roll_front(q1, front)
    # frontTrimmed is 0 on the identity/resize-only paths
    any_cut = cfg.enabledFront or cfg.enabledTail or cfg.enabledRight
    front_trimmed = torch.zeros_like(front) if fr == 0 and not any_cut else front
    return (w_b, w_q, torch.where(alive, rlen, 0), alive, front_trimmed,
            pre_trim + front)


def _apply_seq_adapters(w_b, rlen, alive, cfg: DeviceCfg, adapter, has_seq,
                        fasta, ov_trimmed=None):
    """Adapter by sequence, then the FASTA list in list order, each on the
    length the previous one left and gated by `alive` only.  Returns
    (rlen', info dict); the FASTA trims are not recorded in it."""
    B = w_b.shape[0]
    out = {"rlen_pre_adapter": rlen}
    if cfg.adapter_enabled and has_seq and adapter.shape[0] > 0:
        new_len, found, fpos = adapter_ops.trim_by_sequence(w_b, rlen, adapter)
        found = found & alive
        if ov_trimmed is not None:
            found = found & ~ov_trimmed
        rlen = torch.where(found, new_len, rlen)
        out["ad_found"] = found
        out["ad_pos"] = fpos
    else:
        out["ad_found"] = torch.zeros(B, dtype=torch.bool, device=w_b.device)
        out["ad_pos"] = torch.zeros(B, dtype=I32, device=w_b.device)
    out["rlen_post_adapter"] = rlen
    if cfg.adapter_enabled and fasta:
        mreq = _multi_fasta_match_req(len(fasta))
        for a in fasta:
            new_len, found, _ = adapter_ops.trim_by_sequence(w_b, rlen, a, mreq)
            rlen = torch.where(found & alive, new_len, rlen)
    return rlen, out


def _apply_polyx_maxlen(w_b, rlen, alive, cfg: DeviceCfg, is_r2: bool):
    """polyX trimming + maxLen resize. Returns (rlen', polyx_reads, polyx_bases)."""
    if cfg.polyx_enabled:
        new_len, has_poly, poly, nbases = polyx_ops.trim_polyx(
            w_b, rlen, cfg.polyx_min_len)
        has_poly = has_poly & alive
        rlen = torch.where(has_poly, new_len, rlen)
        polyx_reads, polyx_bases = scatter_count(
            torch.where(has_poly, poly, 4), 4, has_poly,
            torch.where(has_poly, nbases, 0))
    else:
        polyx_reads = polyx_bases = torch.zeros(4, dtype=torch.int64,
                                                device=w_b.device)
    max_len = cfg.maxLen2 if is_r2 else cfg.maxLen1
    if max_len > 0:
        rlen = torch.where(alive & (rlen > max_len), max_len, rlen)
    return rlen, polyx_reads, polyx_bases


# batch-reduced outputs that are pure sums (with every stat_batch dict):
# the run accumulator keeps them on the device, and the join of a split
# batch adds them up (fastp_tpu/pipeline/device.py:_ACC_KEYS)
ACC_KEYS = ("isize_hist", "corr_matrix", "polyx_reads", "polyx_bases",
            "result_hist")
# every output that is reduced over the batch and not per read; what a leaf
# is goes BY KEY, never by its length (a 128-row batch's per-read leaves are
# as long as the quality histogram)
REDUCED_KEYS = ACC_KEYS + ("corrected_reads", "um_both_pass", "c1_count",
                           "c2_count")
# the unsplit step's batch-level correction lists and a shard's per-row
# delta matrices: packed by name
_LIST_KEYS = tuple(side + f for side in ("c1", "c2")
                   for f in ("_rows", "_pos", "_base", "_qual",
                             "k_pos", "k_u8"))

# traffic of this process's steps, both ways: transfers made and bytes moved
# (`fetches`, `bytes`: device to host; `uploads`, `upload_bytes`: host to
# device)
fetch_stats = {"fetches": 0, "bytes": 0, "uploads": 0, "upload_bytes": 0}
_stats_lock = threading.Lock()


def _count(kind: str, nbytes: int):
    n, b = (("fetches", "bytes") if kind == "fetch"
            else ("uploads", "upload_bytes"))
    with _stats_lock:
        fetch_stats[n] += 1
        fetch_stats[b] += int(nbytes)


# per-read fields whose values lie in [-64, 191] whenever the padded width
# is <= 190: these travel as bias-64 int8 (half of int16).  ov_offset (down
# to -(W - overlapRequire)) and ad_pos (down to -adapter length) stay int16.
_I8_KEYS = frozenset((
    "rlen", "rlen1", "rlen2", "total_front", "total_front1", "total_front2",
    "result", "result1", "result2", "rlen_pre_adapter", "rlen_post_adapter",
    "rlen1_pre_adapter", "rlen1_post_adapter", "rlen2_pre_adapter",
    "rlen2_post_adapter", "rlen1_pre_ovtrim", "rlen2_pre_ovtrim",
    "ov_olen", "ov_diff"))
_I8_BIAS = 64
_WIDE_INTS = (torch.int32, torch.int64)


def _max_adapter_len(cfg: DeviceCfg) -> int:
    lens = [len(cfg.adapter_seq1), len(cfg.adapter_seq2)]
    lens += [len(a) for a in cfg.fasta_adapters]
    return max(lens)


def _extra_i8_keys(cfg: DeviceCfg):
    """ad_pos ranges over [-adapter_len, width): bias-64 int8 covers
    [-64, 191], so it is byte-sized whenever every adapter has at most 64
    bases (width <= 190 is checked per batch in _slim_outputs)."""
    if _max_adapter_len(cfg) <= 64:
        return ("ad_pos", "ad_pos1", "ad_pos2")
    return ()


def _per_read(k, v, B: int) -> bool:
    return (not isinstance(v, dict) and k not in REDUCED_KEYS
            and k not in _LIST_KEYS and v.ndim == 1 and v.shape[0] == B)


def _slim_outputs(out: dict, B: int, L: int, extra_i8=()):
    """Narrow the [B] integer per-read outputs to int16 -- and those whose
    range is a byte's (_I8_KEYS, `extra_i8`) to bias-64 int8 -- when the read
    width proves that they fit; the per-read vectors are most of what a
    batch sends to the host.  The row lists of the sparse corrections are
    narrowed by pack_for_host.  FASTP_TPU_NO_SLIM=1 leaves every type as the
    step made it."""
    if L > 32000 or os.environ.get("FASTP_TPU_NO_SLIM"):
        return out
    # the bias is undone by unpack_from_host, which FASTP_TPU_NO_PACK bypasses
    use_i8 = L <= 190 and not os.environ.get("FASTP_TPU_NO_PACK")
    for k, v in list(out.items()):
        if _per_read(k, v, B) and v.dtype in _WIDE_INTS:
            if use_i8 and (k in _I8_KEYS or k in extra_i8):
                # subtract in the wide signed type, then narrow
                out[k] = (v - _I8_BIAS).to(torch.int8)
            else:
                out[k] = v.to(torch.int16)
    return out


def _mega_pack(out: dict, layout: dict):
    """Every tensor of `out`, bit-cast to bytes and concatenated into ONE
    uint8 buffer, so that a batch costs one device-to-host copy.  Each part
    is cast before the concatenation (a tensor of its own is contiguous and
    aligned; an offset inside the buffer need not be).  layout["mega"]
    records (key, numpy dtype name, shape, byte offset, bytes)."""
    meta = []
    parts = []
    off = 0
    for k in sorted(out):
        v = out[k]
        name = layout.get("as", {}).get(k) or _NP_NAME[v.dtype]
        flat = v.contiguous().reshape(-1).view(torch.uint8)
        n = int(flat.shape[0])
        meta.append((k, name, tuple(v.shape), off, n))
        off += n
        parts.append(flat)
    layout["mega"] = meta
    dev = parts[0].device if parts else None
    return {"_blob": (torch.cat(parts) if parts
                      else torch.zeros(0, dtype=torch.uint8, device=dev))}


_NP_NAME = {torch.bool: "bool", torch.uint8: "uint8", torch.int8: "int8",
            torch.int16: "int16", torch.int32: "int32", torch.int64: "int64"}


def pack_for_host(out: dict, B: int, layout: dict, width: int = 0):
    """Merge a step's outputs (what the run accumulator left of them) into
    ONE uint8 buffer for the host, and record in `layout` what
    unpack_from_host needs to take it apart again.

    The sparse correction lists become three matrices (rows as 16 bits and
    window positions as 8 where the batch's shape proves the range), the
    [B] per-read vectors are stacked by type, the [B] bool flags are packed
    eight to a byte (flag j of a group in bit j), and every stats dict is
    one flat vector.  Sums travel as int32 while a batch's largest possible
    sum fits, else as int64.  FASTP_TPU_NO_PACK=1 returns `out` as it is:
    every leaf is then a transfer of its own."""
    if os.environ.get("FASTP_TPU_NO_PACK"):
        layout["packed"] = False
        return out
    layout["packed"] = True
    layout["as"] = {}
    # a batch's sums are bounded by rows x positions x the largest quality
    sum_dtype = (torch.int32 if B * max(width, 1) * 2 * 128 < 2 ** 31
                 else torch.int64)
    # 0) sparse correction lists + scalar counters -> four buffers
    if "c1_rows" in out:
        rows = torch.stack([out.pop("c1_rows"), out.pop("c2_rows")])
        pos = torch.stack([out.pop("c1_pos"), out.pop("c2_pos")])
        if B <= 65535 and 0 < width <= 65535:
            # rows <= B (B is the sentinel) fit 16 bits, window positions
            # < width fit 8 or 16; torch has little arithmetic on uint16, so
            # the bits travel in an int16 and the host reads them unsigned
            out["_corr_rows"] = rows.to(torch.int16)
            layout["as"]["_corr_rows"] = "uint16"
            if width <= 255:
                out["_corr_pos"] = pos.to(torch.uint8)
            else:
                out["_corr_pos"] = pos.to(torch.int16)
                layout["as"]["_corr_pos"] = "uint16"
        else:
            out["_corr_rows"] = rows.to(torch.int32)
            out["_corr_pos"] = pos.to(torch.int32)
        out["_corr_u8"] = torch.stack([out.pop(k) for k in (
            "c1_base", "c1_qual", "c2_base", "c2_qual")])
        out["_corr_n"] = torch.stack([
            out.pop(k).reshape(()).to(torch.int32)
            for k in ("c1_count", "c2_count", "corrected_reads")])
    # 1) [B] per-read vectors -> one [K, B] matrix per type
    for name, dtype in (("i16", torch.int16), ("i8", torch.int8),
                        ("i32", torch.int32)):
        keys = sorted(k for k, v in out.items()
                      if _per_read(k, v, B) and v.dtype == dtype)
        if keys:
            out["_" + name] = torch.stack([out.pop(k) for k in keys])
        layout[name + "_keys"] = keys
    # 2) [B] bool flags -> bit-packed [ceil(K/8), B] uint8
    b_keys = sorted(k for k, v in out.items()
                    if _per_read(k, v, B) and v.dtype == torch.bool)
    if b_keys:
        rows = [out.pop(k).view(torch.uint8) for k in b_keys]
        words = []
        for w0 in range(0, len(rows), 8):
            chunk = rows[w0:w0 + 8]
            bits = chunk[0]
            for j in range(1, len(chunk)):
                bits = bits | (chunk[j] << j)
            words.append(bits)
        out["_bool"] = torch.stack(words)
    layout["bool_keys"] = b_keys
    # 3) every stats dict -> one flat vector (+ per-key shape table: the
    #    merged stream's stats are wider than the others)
    stat_keys = sorted(k for k, v in out.items() if isinstance(v, dict))
    stats_shapes = {}
    for k in stat_keys:
        d = out.pop(k)
        dkeys = sorted(d)
        stats_shapes[k] = [(dk, tuple(d[dk].shape)) for dk in dkeys]
        out["_stats_" + k] = torch.cat(
            [d[dk].reshape(-1).to(sum_dtype) for dk in dkeys])
    layout["stat_keys"] = stat_keys
    layout["stats_shapes"] = stats_shapes
    # 4) the other sums of the batch, where the accumulator left them
    for k in REDUCED_KEYS:
        if k in out:
            out[k] = out[k].to(sum_dtype)
    return _mega_pack(out, layout)


def unpack_from_host(out: dict, layout: dict) -> dict:
    """Inverse of pack_for_host on fetched numpy arrays: the dict the host
    loop reads.  Narrowed integers stay narrow (int16), biased ones come
    back unbiased, bit-packed flags as bool arrays.  The values are views of
    the fetched buffer, at whatever alignment their offset gives them."""
    out = dict(out)
    if not layout.get("packed"):
        return out
    blob = out.pop("_blob")
    for k, dt, shp, off, n in layout["mega"]:
        out[k] = blob[off:off + n].view(np.dtype(dt)).reshape(shp)
    if "_corr_rows" in out:
        m = out.pop("_corr_rows").astype(np.int32)
        out["c1_rows"], out["c2_rows"] = m[0], m[1]
        m = out.pop("_corr_pos").astype(np.int32)
        out["c1_pos"], out["c2_pos"] = m[0], m[1]
        m = out.pop("_corr_u8")
        for j, k in enumerate(("c1_base", "c1_qual", "c2_base", "c2_qual")):
            out[k] = m[j]
        m = out.pop("_corr_n")
        out["c1_count"], out["c2_count"], out["corrected_reads"] = \
            m[0], m[1], m[2]
    for name in ("i16", "i32"):
        if "_" + name in out:
            m = out.pop("_" + name)
            for j, k in enumerate(layout[name + "_keys"]):
                out[k] = m[j]
    if "_i8" in out:
        m = out.pop("_i8").astype(np.int16)
        for j, k in enumerate(layout["i8_keys"]):
            out[k] = m[j] + _I8_BIAS
    if "_bool" in out:
        m = out.pop("_bool")
        for j, k in enumerate(layout["bool_keys"]):
            out[k] = ((m[j // 8] >> (j % 8)) & 1).astype(bool)
    for k in layout["stat_keys"]:
        vec = out.pop("_stats_" + k)
        d = {}
        off = 0
        for dk, shp in layout["stats_shapes"][k]:
            n = int(np.prod(shp, dtype=np.int64))
            d[dk] = vec[off:off + n].reshape(shp)
            off += n
        out[k] = d
    return out


def acc_delta(sums: dict):
    """One int64 vector of a batch's sums (stats dicts and ACC_KEYS leaves,
    in insertion order) for the run accumulator, and what unpack_acc needs
    to take such a vector apart: [(path, shape)], path being (key,) or
    (key, subkey).  The accumulator counts in int64 whatever the leaf's own
    type: a run's counts pass 2**31."""
    leaves = []
    for k, v in sums.items():
        if isinstance(v, dict):
            leaves += [((k, dk), dv) for dk, dv in v.items()]
        else:
            leaves.append(((k,), v))
    meta = [(path, tuple(t.shape)) for path, t in leaves]
    return torch.cat([t.reshape(-1).to(torch.int64) for _, t in leaves]), meta


def unpack_acc(vec: np.ndarray, meta) -> dict:
    """The dict of sums from a fetched accumulator vector (see acc_delta)."""
    res: dict = {}
    off = 0
    for path, shape in meta:
        n = int(np.prod(shape, dtype=np.int64))
        val = vec[off:off + n].reshape(shape)
        off += n
        if len(path) == 2:
            res.setdefault(path[0], {})[path[1]] = val
        else:
            res[path[0]] = val
    return res


def length_dtype(width: int):
    """The type the per-read lengths are uploaded in: int16 halves the bytes
    whenever a row fits."""
    return np.int16 if width <= 32000 else np.int32


# --- packed inputs: the device half of io/native.py's packers --------------

def _scatter_exceptions(b, q, idx, base, qual):
    """Write the exception list's raw (base, qual) bytes at flat positions
    `idx` of the [B, W] arrays.  Unused slots of the list hold an index past
    the end (the native packers pad with B*W): every index outside the array
    goes to one spare element that is cut off again, so the scatter itself
    never sees an index out of range."""
    B, W = b.shape
    n = B * W
    idx = idx.to(torch.int64)
    idx = torch.where((idx < 0) | (idx > n), n, idx)
    spare = torch.zeros(1, dtype=torch.uint8, device=b.device)
    bf = torch.cat([b.reshape(-1), spare])
    qf = torch.cat([q.reshape(-1), spare])
    bf[idx] = base
    qf[idx] = qual
    return bf[:n].reshape(B, W), qf[:n].reshape(B, W)


def _base_lut(device, with_n: bool = False):
    codes = [65, 67, 71, 84] + ([78] if with_n else [])
    return device_table("acgtn" if with_n else "acgt", device,
                        lambda: torch.tensor(codes, dtype=torch.uint8))


def _mask_pad(b, q, lengths):
    W = b.shape[1]
    m = (torch.arange(W, dtype=I32, device=b.device)[None, :]
         < lengths.to(I32)[:, None])
    zero = torch.zeros((), dtype=torch.uint8, device=b.device)
    return torch.where(m, b, zero), torch.where(m, q, zero)


def _unpack_nib(p, qlut, lengths, idx, base, qual):
    """Invert the host 4-bit packer (io/native.py:pack_nib): each nibble is
    qcode*4 + bcode, the low nibble the even position; bases decode through
    the fixed ACGT table and quals through the run's learned dictionary
    qlut (u8[4]); the pad is zeroed again from the lengths; exceptions
    scatter their raw (base, qual) bytes back in."""
    B, Wh = p.shape
    W = Wh * 2
    codes = torch.stack([p & 15, p >> 4], dim=-1).reshape(B, W)
    b = _base_lut(p.device)[(codes & 3).long()]
    q = qlut[(codes >> 2).long()]
    b, q = _mask_pad(b, q, lengths)
    return _scatter_exceptions(b, q, idx, base, qual)


def _unpack_p3(bp, qp, qlut, lengths, idx, base, qual):
    """Invert the host 3-bit planar packer (io/native.py:pack_p3): bp holds
    2-bit base codes (four positions to a byte, position 0 in bits 0-1)
    decoding through the fixed ACGT table; qp holds one bit per position
    (eight to a byte, position 0 in bit 0) indexing the two-entry learned
    dictionary qlut (u8[2]); the pad is zeroed again from the lengths;
    exceptions scatter their raw (base, qual) bytes back in."""
    B, Wb = bp.shape
    W = Wb * 4
    bcodes = torch.stack([(bp >> (2 * k)) & 3 for k in range(4)],
                         dim=-1).reshape(B, W)
    b = _base_lut(bp.device)[bcodes.long()]
    qbits = torch.stack([(qp >> k) & 1 for k in range(8)],
                        dim=-1).reshape(B, W)
    q = qlut[qbits.long()]
    b, q = _mask_pad(b, q, lengths)
    return _scatter_exceptions(b, q, idx, base, qual)


def _unpack_bq(p, idx, base, qual):
    """Invert the host packer (io/native.py:pack_bq): a byte holds
    (q-33)*5 + code, 255 is the pad; exceptions scatter their raw
    (base, qual) bytes back in."""
    is_pad = p == 255
    zero = torch.zeros((), dtype=torch.uint8, device=p.device)
    q = torch.where(is_pad, zero, p // 5 + 33)
    b = torch.where(is_pad, zero, _base_lut(p.device, True)[(p % 5).long()])
    return _scatter_exceptions(b, q, idx, base, qual)


# arrays of one mate in a packed step's arguments, before the dictionary
# and the lengths
_PACKED_ARITY = {"p3": 5, "nib": 4, True: 4}


def _decode_inputs(packed, mates: int, args, up):
    """The head of a step with packed inputs.  `args` holds, per mate, the
    packed arrays with their exception list -- (bplane, qplane, idx, base,
    qual) for "p3", (nibbles, idx, base, qual) for "nib", (bytes, idx,
    base, qual) for True -- then the learned dictionary ("p3" and "nib"),
    then the lengths per mate, then the aux tuple.  Returns the flat list
    [bases, quals, lengths] per mate, on the device, and the aux tuple."""
    k = _PACKED_ARITY[packed]
    pos = mates * k
    qlut = None
    if packed in ("p3", "nib"):
        qlut = up(args[pos], torch.uint8)
        pos += 1
    lengths = [up(a, I32) for a in args[pos:pos + mates]]
    aux = args[pos + mates:]
    res = []
    for m in range(mates):
        part = args[m * k:(m + 1) * k]
        exc = (up(part[-3], I32), up(part[-2], torch.uint8),
               up(part[-1], torch.uint8))
        if packed == "p3":
            b, q = _unpack_p3(up(part[0], torch.uint8),
                              up(part[1], torch.uint8), qlut, lengths[m], *exc)
        elif packed == "nib":
            b, q = _unpack_nib(up(part[0], torch.uint8), qlut, lengths[m],
                               *exc)
        else:
            b, q = _unpack_bq(up(part[0], torch.uint8), *exc)
        res += [b, q, lengths[m]]
    return res, aux


# --- the transfers: one side stream, pinned buffers, events ----------------

_NP_TO_TORCH = {np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
                np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
                np.dtype(np.int32): torch.int32,
                np.dtype(np.int64): torch.int64}
_STAGE_CHUNK = 8 << 20    # bytes of a pinned staging chunk, at least
_STAGE_SLOTS = 3


class _StageSlot:
    """Pinned host memory for one batch's uploads: chunks that are filled
    front to back, and the event after the batch's last copy."""

    def __init__(self):
        self.chunks = []
        self.cur = 0
        self.off = 0
        self.event = None

    def reset(self):
        self.cur = self.off = 0

    def reserve(self, nbytes: int):
        """A pinned uint8 tensor of `nbytes` that nothing else uses until
        the slot is reset."""
        while True:
            if self.cur == len(self.chunks):
                self.chunks.append(torch.empty(
                    max(_STAGE_CHUNK, nbytes), dtype=torch.uint8,
                    pin_memory=True))
                self.off = 0
            chunk = self.chunks[self.cur]
            if self.off + nbytes <= chunk.numel():
                start = self.off
                self.off = -(-(start + nbytes) // 64) * 64
                return chunk[start:start + nbytes]
            self.cur += 1
            self.off = 0


class StepIO:
    """What the steps of one configuration share on one device: the
    adapters (uploaded once), and on a card ONE side stream on which every
    upload, step, pack and fetch of a run is queued, a ring of pinned
    staging slots for the uploads, a pool of pinned buffers for the fetches
    and the memory pool of the steps' CUDA graphs.  On the CPU the same
    calls copy nothing and wait for nothing.  A memo entry (memo_step) owns
    one, and the runs of its configuration use it one after the other.

    A staging slot is refilled only after the event behind its batch's last
    copy; a fetch buffer goes back to the pool only after the host has
    copied its bytes out.  The graphs share one memory pool: they replay on
    this one stream, one at a time, and each keeps its static inputs and
    outputs alive, so no graph's replay writes where another's results
    wait."""

    def __init__(self, cfg: DeviceCfg, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.extra_i8 = _extra_i8_keys(cfg)

        def put(a):
            return torch.tensor(np.frombuffer(a, np.uint8).copy(),
                                dtype=torch.uint8, device=self.device)
        self.adapters = (put(cfg.adapter_seq1), put(cfg.adapter_seq2))
        self.fasta = tuple(put(a) for a in cfg.fasta_adapters)
        self.stream = None
        self._slots = []
        self._slot = None
        self._next = 0
        self._pinned = []
        self._lock = threading.Lock()
        self.pool = None
        if self.cuda:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
            # the adapters were copied on the stream current here
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
            self._slots = [_StageSlot() for _ in range(_STAGE_SLOTS)]

    def on_stream(self):
        """Context in which device work is queued on the run's stream (the
        current stream is a property of the calling thread)."""
        if self.cuda:
            return torch.cuda.stream(self.stream)
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def staging(self):
        """One batch's uploads: takes the next staging slot (waiting until
        the copies that last read it are done) and marks its end."""
        if not self.cuda:
            yield
            return
        slot = self._slots[self._next]
        self._next = (self._next + 1) % len(self._slots)
        if slot.event is not None:
            slot.event.synchronize()
        slot.reset()
        self._slot = slot
        try:
            yield
        finally:
            self._slot = None
            if slot.event is None:
                slot.event = torch.cuda.Event()
            slot.event.record(self.stream)

    def upload(self, x, dtype=None):
        """`x` (numpy array or tensor) on the device as `dtype` (None: the
        type the host holds it in).  On a card the bytes go through the
        batch's pinned staging slot in the host's type, without waiting, and
        widen on the device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=dtype)
        a = np.ascontiguousarray(x)
        _count("upload", a.nbytes)
        if not self.cuda or a.nbytes == 0:
            return torch.as_tensor(a).to(device=self.device, dtype=dtype)
        host = self._slot.reserve(a.nbytes)
        host.numpy()[:] = a.reshape(-1).view(np.uint8)
        dev = host.to(self.device, non_blocking=True)
        return dev.view(_NP_TO_TORCH[a.dtype]).reshape(a.shape).to(
            dtype=dtype)

    def upload_into(self, buf, offsets, arrays):
        """A batch's arrays into the device buffer `buf` at `offsets`, as ONE
        copy from the batch's pinned staging slot (a captured step's static
        inputs)."""
        host = self._slot.reserve(buf.numel())
        flat = host.numpy()
        for a, off in zip(arrays, offsets):
            _count("upload", a.nbytes)
            flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        buf.copy_(host, non_blocking=True)

    def take_pinned(self, nbytes: int):
        with self._lock:
            for i, buf in enumerate(self._pinned):
                if buf.numel() >= nbytes:
                    return self._pinned.pop(i)
        return torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)

    def give_pinned(self, buf):
        with self._lock:
            self._pinned.append(buf)


class StepOut(dict):
    """A step's outputs as tensors on the device, with the batch's padded
    row count and read width.  A run with `accum` has taken the batch's
    sums out of the dict, as one int64 vector (`delta`, taken apart by
    unpack_acc with `acc_meta`).  `layout` is set where the rest is packed
    for the host already: the static outputs of a CUDA graph's replay."""

    def __init__(self, out=(), rows: int = 0, width: int = 0):
        super().__init__(out)
        self.rows = rows
        self.width = width
        self.delta = self.acc_meta = None
        self.layout = None


def _take_sums(out: StepOut):
    """Move the batch's sums (every stats dict and ACC_KEYS leaf) out of
    `out` into out.delta and out.acc_meta (see acc_delta)."""
    sums = {k: out.pop(k) for k in list(out)
            if isinstance(out[k], dict) or k in ACC_KEYS}
    out.delta, out.acc_meta = acc_delta(sums)


def _for_host(out: StepOut, extra_i8) -> StepOut:
    """The device half of a fetch: the outputs narrowed and packed into one
    buffer (_slim_outputs, pack_for_host); the result carries the layout
    and what _take_sums left on `out`."""
    layout = {}
    packed = StepOut(pack_for_host(
        _slim_outputs(dict(out), out.rows, out.width, extra_i8), out.rows,
        layout, out.width), out.rows, out.width)
    packed.delta, packed.acc_meta = out.delta, out.acc_meta
    packed.layout = layout
    return packed


class PendingFetch:
    """A batch's outputs on their way to the host: slimmed, packed into one
    buffer and, on a card, being copied into a pinned buffer behind an
    event.  wait() blocks on that event only -- not on the device, which may
    already run the next batch's step -- and returns the numpy dict.  The
    static outputs of a graph's replay are copied here, on the run's stream,
    so the copy is queued before the graph's next replay."""

    def __init__(self, io: StepIO, out: StepOut):
        self.io = io
        self.event = self.pinned = None
        if out.layout is None:
            out = _for_host(out, io.extra_i8)
        self.layout = out.layout
        self.dev = dict(out)
        if self.layout["packed"]:
            blob = self.dev["_blob"]
            self.nbytes = blob.numel()
            _count("fetch", self.nbytes)
            if io.cuda:
                self.pinned = io.take_pinned(self.nbytes)
                self.pinned[:self.nbytes].copy_(blob, non_blocking=True)
        elif io.cuda:
            # unpacked leaves (FASTP_TPU_NO_PACK) are read by wait(), after
            # the stream has moved on: copies of their own
            self.dev = {k: ({dk: dv.clone() for dk, dv in v.items()}
                            if isinstance(v, dict) else v.clone())
                        for k, v in self.dev.items()}
        if io.cuda:
            self.event = torch.cuda.Event()
            self.event.record(io.stream)

    def wait(self) -> dict:
        if self.event is not None:
            self.event.synchronize()
        if not self.layout["packed"]:
            host = {}
            for k, v in self.dev.items():
                if isinstance(v, dict):
                    host[k] = {dk: self._leaf(dv) for dk, dv in v.items()}
                else:
                    host[k] = self._leaf(v)
        elif self.pinned is not None:
            # the values are views: copy the bytes out, and the pinned
            # buffer is free for another batch
            host = {"_blob": self.pinned[:self.nbytes].numpy().copy()}
            self.io.give_pinned(self.pinned)
            self.pinned = None
        else:
            host = {"_blob": self.dev["_blob"].numpy()}
        self.dev = None
        return unpack_from_host(host, self.layout)

    @staticmethod
    def _leaf(t):
        a = t.cpu().numpy()
        _count("fetch", a.nbytes)
        return a


# the captures of this process, in order: (key of the graph in its step,
# seconds of the capture, bytes it added to the card's reserved memory,
# {kernel: launches per replay}, seconds of the warm-up runs)
graph_log = []
GRAPH_WARMUPS = 2     # eager runs of a new shape before its capture


class _Graph:
    """A step captured as a CUDA graph for one shape of its arguments.

    The arguments of a batch lie at fixed offsets of one device buffer (the
    static inputs: one copy up per batch); the graph holds the whole device
    side of a batch -- the step on views of that buffer, with `accum` the
    batch's sums as one vector, and _for_host -- and its static outputs are
    the packed buffer and that vector.  The eager warm-up runs make what a
    capture may not (the kernels' libraries, the ops' lookup tables); their
    kernel launches and the capture's are not counted, and `launches` keeps
    what the capture launched of each kernel, which each replay counts
    (ops/launches.py).  A capture that fails raises."""

    def __init__(self, step, arrays, accum: bool, key):
        io = step.io
        self.offsets, total = [], 0
        for a in arrays:
            self.offsets.append(total)
            total = -(-(total + a.nbytes) // 64) * 64
        self.static_in = torch.empty(total, dtype=torch.uint8,
                                     device=io.device)
        views = [self.static_in[off:off + a.nbytes]
                 .view(_NP_TO_TORCH[a.dtype]).reshape(a.shape)
                 for a, off in zip(arrays, self.offsets)]

        def device_side():
            out = step._body(*views)
            if accum:
                _take_sums(out)
            return _for_host(out, io.extra_i8)

        self.load(io, arrays)
        t0 = time.perf_counter()
        # the stream the graph replays on: stat_batch's accumulator belongs
        # to it (ops/stats_cuda.py:accumulator)
        self.stream = torch.cuda.current_stream(io.device)
        self.graph = torch.cuda.CUDAGraph()
        with launches.uncounted() as tally:
            for _ in range(GRAPH_WARMUPS):
                device_side()
            tally.update(launches.zero_tally())
            t1 = time.perf_counter()
            reserved = torch.cuda.memory_reserved(io.device)
            self.graph.capture_begin(pool=io.pool,
                                     capture_error_mode="thread_local")
            try:
                self.out = device_side()
            except BaseException:
                with contextlib.suppress(Exception):
                    self.graph.capture_end()   # the first error stands
                raise
            self.graph.capture_end()
        self.launches = dict(tally)
        self.pool_bytes = torch.cuda.memory_reserved(io.device) - reserved
        graph_log.append((key, time.perf_counter() - t1, self.pool_bytes,
                          self.launches, t1 - t0))

    def load(self, io, arrays):
        with io.staging():
            io.upload_into(self.static_in, self.offsets, arrays)


class Step:
    """A device step in three parts: run(*args) queues the uploads and the
    device work of a batch and returns a StepOut with nothing waited for;
    start_fetch(out) packs such a dict (or what a caller left of it) and
    queues its copy to the host; the PendingFetch's wait() gives the numpy
    dict.  fetch(out) does the last two at once, step(*args) all three.

    `body(*args)` is the device work of a batch on its arguments as tensors
    on the device, in the types the host gave them.  With `graph` (the
    default on a card; CUDA only) run() captures the device work once per
    shape of the arguments, per `accum` and per `shard`, and replays it:
    every batch's StepOut is then the same static outputs, which the caller
    reads (adds, copies) on the step's stream before it runs the step
    again.  Without it run() launches every op from Python."""

    def __init__(self, body, io: StepIO, graph=None):
        self._body = body
        self.io = io
        self.graph = io.cuda if graph is None else bool(graph)
        if self.graph and not io.cuda:
            raise ValueError("a CUDA graph needs a CUDA device, not %s"
                             % io.device)
        self._graphs = {}
        self.entry = None    # the memo entry that keeps the step

    def on_stream(self):
        return self.io.on_stream()

    def run(self, *args, accum: bool = False, shard: int = 0) -> StepOut:
        """Queue one batch.  With `accum` the batch's sums leave the dict as
        StepOut.delta; `shard` is the index of a split's shard (shards on
        one device share a step, and each needs a graph of its own)."""
        io = self.io
        with torch.no_grad(), io.on_stream():
            if not self.graph:
                with io.staging():
                    dev = [io.upload(a) for a in args]
                out = self._body(*dev)
                if accum:
                    _take_sums(out)
                return out
            # a scalar goes up as one element, as StepIO.upload sends it
            arrays = [np.ascontiguousarray(a) for a in args]
            key = (tuple((a.dtype.str, a.shape) for a in arrays), accum,
                   shard)
            g = self._graphs.get(key)
            if g is None:
                g = self._graphs[key] = _Graph(self, arrays, accum, key)
            else:
                g.load(io, arrays)
            if io.cuda and torch.cuda.current_stream(io.device) != g.stream:
                raise RuntimeError("a step's CUDA graph replays on the stream "
                                   "it was captured on")
            g.graph.replay()
        launches.count_replayed(g.launches)
        return g.out

    def start_fetch(self, out: StepOut) -> PendingFetch:
        with torch.no_grad(), self.io.on_stream():
            return PendingFetch(self.io, out)

    def fetch(self, out: StepOut) -> dict:
        return self.start_fetch(out).wait()

    def fetch_vector(self, vec) -> np.ndarray:
        """A device vector on the host, copied on the run's stream (the run
        accumulator, once per run)."""
        with self.io.on_stream():
            host = vec.cpu().numpy()
        _count("fetch", host.nbytes)
        return host

    def __call__(self, *args):
        return self.fetch(self.run(*args))


# --- the memo: a step per configuration, kept ------------------------------

# the environment variables a step reads while it runs (or is captured): a
# job that sets one gets a step of its own
STEP_ENV = ("FASTP_TPU_CORR_K", "FASTP_TPU_CORR_CAP", "FASTP_TPU_NO_SLIM",
            "FASTP_TPU_NO_PACK")
MEMO_ENTRIES = 16     # fastp_tpu: functools.lru_cache(maxsize=16)
_memo = collections.OrderedDict()
_memo_lock = threading.Lock()


class _Entry:
    """One configuration on one device: its StepIO and its steps, one per
    input scheme, built at first use."""

    def __init__(self, build, cfg, device, rowwise: bool):
        self.build, self.cfg, self.rowwise = build, cfg, rowwise
        self.io = StepIO(cfg, device)
        self.steps = {}
        self._lock = threading.Lock()

    def step(self, packed) -> Step:
        with self._lock:
            step = self.steps.get(packed)
            if step is None:
                kw = {"rowwise": True} if self.rowwise else {}
                step = self.build(self.cfg, self.io.device, packed=packed,
                                  io=self.io, **kw)
                step.entry = self
                self.steps[packed] = step
            return step


def memo_step(build, cfg: DeviceCfg, device, packed=False,
              rowwise: bool = False) -> Step:
    """The Step `build` (build_se_step or build_pe_step) makes for this key,
    built once and kept: the counterpart of fastp_tpu's lru_cache on its
    builders.  The key is the builder, `cfg`, the device, `rowwise` and the
    values of STEP_ENV; `packed` picks the entry's step for that input
    scheme.  Its steps are graphs on a card (see Step).  At most MEMO_ENTRIES entries are kept, the least
    recently used goes first.  An entry (its stream, staging ring, pinned
    buffers, adapters and graphs) serves one run at a time; what belongs to
    a run -- the accumulator, the learned quality dictionaries, the schemes
    a run fell out of -- stays on its processor."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (build.__name__, cfg, device, rowwise,
           tuple(os.environ.get(k) for k in STEP_ENV))
    with _memo_lock:
        entry = _memo.get(key)
        if entry is None:
            entry = _memo[key] = _Entry(build, cfg, device, rowwise)
            while len(_memo) > MEMO_ENTRIES:
                _memo.popitem(last=False)
        else:
            _memo.move_to_end(key)
    return entry.step(packed)


def _result_hist(result, counted, weight: int):
    """The counting histogram the host would build over the counted rows."""
    return weight * scatter_count(torch.where(counted, result, 0),
                                  FILTER_RESULT_TYPES, counted)[0]


def build_se_step(cfg: DeviceCfg, device, packed=False, io: StepIO = None,
                  graph=None):
    """The SE step for `cfg` on `device` ("cuda", "cpu" or a torch.device).

    The returned Step takes (bases, quals, lengths, *aux) as numpy arrays
    or tensors -- uint8[B, L] bases/quals, int[B] lengths, aux as make_aux
    builds it -- or, with `packed` ("p3", "nib" or True), the arguments
    _decode_inputs names, and returns the numpy output dict.  It launches no
    hand-written kernel: the SE path has no overlap analysis.  No output of
    it looks across rows, so the same step serves as a shard of a split.
    `io`: the StepIO of another step of the run, to share its stream,
    buffers and adapters.  `graph`: see Step (None: a CUDA graph on a card,
    the eager step on the CPU; False: the eager step on a card too)."""
    io = io or StepIO(cfg, device)
    device, adapters, fasta, upload = io.device, io.adapters, io.fasta, io.upload
    fview = _FilterCfgView(cfg)

    def body(*args):
        if packed:
            (bases, quals, lengths), aux = _decode_inputs(
                packed, 1, args, upload)
        else:
            aux = args[3:]
            bases, quals = (upload(a, torch.uint8) for a in args[:2])
            lengths = upload(args[2], I32)
        B, L = bases.shape
        pre_trim, _, index_drop, dedup_out, valid = _expand_aux(
            cfg, B, aux, upload, device)
        return StepOut(se_step(bases, quals, lengths, pre_trim,
                               index_drop, dedup_out, valid), B, L)

    def se_step(bases, quals, lengths, pre_trim, index_drop, dedup_out, valid):
        pre = stats_ops.stat_batch(bases, quals, lengths, valid)
        w_b, w_q, rlen, alive, _, total_front = _trim_one_end(
            bases, quals, lengths, pre_trim, cfg, False)
        alive = alive & ~index_drop & valid
        if cfg.polyg_enabled:
            rlen = torch.where(
                alive, polyx_ops.trim_polyg(w_b, rlen, cfg.polyg_min_len), rlen)
        rlen, ad = _apply_seq_adapters(w_b, rlen, alive, cfg, adapters[0],
                                       cfg.has_seq1, fasta)
        rlen, polyx_reads, polyx_bases = _apply_polyx_maxlen(
            w_b, rlen, alive, cfg, False)
        result = filter_ops.pass_filter(w_b, w_q, rlen, alive, fview)
        emit = (result == PASS_FILTER) & alive & ~dedup_out
        out = {
            "pre": pre,
            "post": stats_ops.stat_batch(w_b, w_q, rlen, emit),
            "total_front": total_front,
            "rlen": rlen,
            "result": result,
            "alive": alive,
            "emit": emit,
            "ad_found": ad["ad_found"],
            "ad_pos": ad["ad_pos"],
            "rlen_pre_adapter": ad["rlen_pre_adapter"],
            "rlen_post_adapter": ad["rlen_post_adapter"],
            "polyx_reads": polyx_reads,
            "polyx_bases": polyx_bases,
        }
        if cfg.lean:
            # the lean reductions and deletions of fastp_tpu's step
            # (device.py:593-609): result codes reduce to the counting
            # histogram; alive only feeds --failed_out
            out["result_hist"] = _result_hist(result, valid & ~index_drop, 1)
            del out["result"], out["alive"]
            if not cfg.adapter_enabled:
                for k in ("ad_found", "ad_pos", "rlen_pre_adapter",
                          "rlen_post_adapter"):
                    del out[k]
            if cfg.front1 == 0 and not cfg.enabledFront:
                del out["total_front"]
        return out

    return Step(body, io, graph)


def build_pe_step(cfg: DeviceCfg, device, rowwise: bool = False,
                  packed=False, io: StepIO = None, graph=None):
    """The PE step for `cfg` on `device` ("cuda", "cpu" or a torch.device).

    The adapter bytes are uploaded once here.  The returned Step takes
    (b1, q1, l1, b2, q2, l2, *aux) as numpy arrays or tensors -- uint8[B, L]
    bases/quals, int[B] lengths, aux as make_aux builds it -- or, with
    `packed` ("p3", "nib" or True), the arguments _decode_inputs names, and
    returns the numpy output dict.  With `rowwise` the correction deltas
    come per row (keys c1k_*, c2k_*: up to FASTP_TPU_CORR_K of them, 12
    unless set) and not as the batch's sparse list (keys c1_*, c2_*).
    `io`: the StepIO of another step of the run, to share its stream,
    buffers and adapters.  `graph`: as for build_se_step."""
    io = io or StepIO(cfg, device)
    device, adapters, fasta, upload = io.device, io.adapters, io.fasta, io.upload
    fview = _FilterCfgView(cfg)

    def body(*args):
        if packed:
            ins, aux = _decode_inputs(packed, 2, args, upload)
        else:
            aux = args[6:]
            ins = [upload(a, I32 if k % 3 == 2 else torch.uint8)
                   for k, a in enumerate(args[:6])]
        B, L = ins[0].shape
        return StepOut(pe_step(*ins, *_expand_aux(cfg, B, aux, upload,
                                                  device)), B, L)

    def pe_step(b1, q1, l1, b2, q2, l2, pre_trim1, pre_trim2, index_drop,
                dedup_out, valid):
        B, L = b1.shape
        pre1 = stats_ops.stat_batch(b1, q1, l1, valid)
        pre2 = stats_ops.stat_batch(b2, q2, l2, valid)

        w1, wq1, rlen1, alive1, ft1, tf1 = _trim_one_end(b1, q1, l1, pre_trim1, cfg, False)
        w2, wq2, rlen2, alive2, ft2, tf2 = _trim_one_end(b2, q2, l2, pre_trim2, cfg, True)
        alive1 = alive1 & ~index_drop & valid
        alive2 = alive2 & ~index_drop & valid
        both = alive1 & alive2

        if cfg.polyg_enabled:
            rlen1 = torch.where(both, polyx_ops.trim_polyg(w1, rlen1, cfg.polyg_min_len), rlen1)
            rlen2 = torch.where(both, polyx_ops.trim_polyg(w2, rlen2, cfg.polyg_min_len), rlen2)

        out = {}
        corr_matrix = torch.zeros(64, dtype=torch.int64, device=device)
        ov_trimmed = torch.zeros(B, dtype=torch.bool, device=device)
        rlen1_pre_ovtrim = rlen1
        rlen2_pre_ovtrim = rlen2

        need_ov = cfg.adapter_enabled or cfg.correction_enabled
        ov = overlap_ops.analyze(w1, rlen1, w2, rlen2, cfg.overlap_diff_limit,
                                 cfg.overlap_require, cfg.overlap_diff_pct,
                                 cfg.allow_gap_overlap and need_ov)
        ov_ok = ov["overlapped"] & both

        # insert size (reference: statInsertSize, src/peprocessor.cpp:698-711)
        isize = torch.where(
            ov_ok,
            torch.where(ov["offset"] > 0,
                        rlen1 + rlen2 - ov["overlap_len"] + ft1 + ft2,
                        ov["overlap_len"] + ft1 + ft2),
            cfg.insert_size_max).clamp(max=cfg.insert_size_max)
        isize_hist = scatter_count(torch.where(both, isize, cfg.insert_size_max),
                                   cfg.insert_size_max + 1, both)[0]

        if cfg.correction_enabled:
            (w1, wq1, w2, wq2, corr_matrix, corrected, r1c, r2c, masks) = \
                correct_ops.correct_by_overlap(
                    w1, wq1, rlen1, w2, wq2, rlen2,
                    ov_ok & ~ov["has_gap"], ov["offset"], ov["overlap_len"],
                    ov["diff"])
            sides = (("c1", masks["mask1"], w1, wq1),
                     ("c2", masks["mask2"], w2, wq2))
            if rowwise:
                # a shard of a split batch: per-row deltas as [K, B] and
                # [2K, B] (bases, then quals); rows with more than K take
                # the host's exact recomputation
                K = int(os.environ.get("FASTP_TPU_CORR_K", "12"))
                ldt = torch.int16 if L <= 32000 else I32
                for side, mask, wb, wq in sides:
                    pos, base, qual, cnt = correct_ops.extract_deltas(
                        mask, wb, wq, K)
                    out[side + "k_pos"] = pos.T.to(ldt)
                    out[side + "k_u8"] = torch.cat([base, qual], 1).T
                    out[side + "k_cnt"] = cnt
            else:
                # slot budget of the sparse correction lists (fastp_tpu's
                # B//8; FASTP_TPU_CORR_CAP is the test hook that forces the
                # overflow path)
                corr_c = (int(os.environ.get("FASTP_TPU_CORR_CAP", "0"))
                          or max(2048, B // 8))
                for side, mask, wb, wq in sides:
                    (out[side + "_rows"], out[side + "_pos"],
                     out[side + "_base"], out[side + "_qual"],
                     out[side + "_count"]) = \
                        correct_ops.extract_deltas_sparse(mask, wb, wq, corr_c)
            # corrected-read counter (reference: src/peprocessor.cpp:440-443)
            corr_any = corrected > 0
            both_c = r1c & r2c
            out["corrected_reads"] = (2 * (corr_any & both_c).sum(dtype=I32)
                                      + (corr_any & ~both_c).sum(dtype=I32))

        if cfg.adapter_enabled:
            nl1, nl2, ov_trimmed = adapter_ops.trim_by_overlap(
                rlen1, rlen2, ov_ok, ov["offset"], ov["overlap_len"], ft1, ft2)
            rlen1 = torch.where(both, nl1, rlen1)
            rlen2 = torch.where(both, nl2, rlen2)
            ov_trimmed = ov_trimmed & both

        rlen1, ad1 = _apply_seq_adapters(w1, rlen1, both, cfg, adapters[0],
                                         cfg.has_seq1, fasta, ov_trimmed)
        rlen2, ad2 = _apply_seq_adapters(w2, rlen2, both, cfg, adapters[1],
                                         cfg.has_seq2, fasta, ov_trimmed)

        # overlapped_out: re-analysis with diff percent 0 on the
        # adapter-trimmed (pre-polyX) reads (src/peprocessor.cpp:461-468);
        # on the card the overlap kernel's second launch of the batch
        if cfg.overlapped_out:
            ov0 = overlap_ops.analyze(w1, rlen1, w2, rlen2,
                                      cfg.overlap_diff_limit,
                                      cfg.overlap_require, 0.0)
            out["ov0_ok"] = ov0["overlapped"] & both
            out["ov0_offset"] = ov0["offset"]
            out["ov0_len"] = ov0["overlap_len"]

        rlen1, px_r1, px_b1 = _apply_polyx_maxlen(w1, rlen1, both, cfg, False)
        rlen2, px_r2, px_b2 = _apply_polyx_maxlen(w2, rlen2, both, cfg, True)

        # merge-mode overlap analysis on the final trimmed reads, always
        # ungapped; on the card another launch of the overlap kernel
        if cfg.merge_enabled:
            ovm = overlap_ops.analyze(w1, rlen1, w2, rlen2,
                                      cfg.overlap_diff_limit,
                                      cfg.overlap_require, cfg.overlap_diff_pct)
            ovm_ok = ovm["overlapped"] & both
            m_seq, m_qual, m_len, m_len1, m_len2 = merge_ops.merge_pairs(
                w1, wq1, rlen1, w2, wq2, rlen2, ovm_ok, ovm["offset"],
                ovm["overlap_len"], out_width=2 * L)
            m_result = filter_ops.pass_filter(m_seq, m_qual, m_len, ovm_ok,
                                              fview)
            m_emit = ovm_ok & (m_result == PASS_FILTER)
            out.update({
                "merged_ok": ovm_ok, "m_len": m_len, "m_len1": m_len1,
                "m_len2": m_len2, "m_result": m_result, "m_emit": m_emit,
                "ovm_olen": ovm["overlap_len"],
                "post_merged": stats_ops.stat_batch(m_seq, m_qual, m_len,
                                                    m_emit),
            })

        result1 = filter_ops.pass_filter(w1, wq1, rlen1, alive1, fview)
        result2 = filter_ops.pass_filter(w2, wq2, rlen2, alive2, fview)
        pass1 = (result1 == PASS_FILTER) & alive1
        pass2 = (result2 == PASS_FILTER) & alive2
        emit_pair = pass1 & pass2 & ~dedup_out & ~index_drop
        if cfg.merge_enabled and cfg.merge_include_unmerged:
            # per-mate post stats of the unmerged survivors, which the host
            # adds into the merged-stream stats (src/peprocessor.cpp:503,513)
            not_merged = ~ovm_ok & ~dedup_out & alive1 & alive2
            out["post_um1"] = stats_ops.stat_batch(w1, wq1, rlen1,
                                                   not_merged & pass1)
            out["post_um2"] = stats_ops.stat_batch(w2, wq2, rlen2,
                                                   not_merged & pass2)
        out.update({
            "pre1": pre1, "pre2": pre2,
            "post1": stats_ops.stat_batch(w1, wq1, rlen1, emit_pair),
            "post2": stats_ops.stat_batch(w2, wq2, rlen2, emit_pair),
            "ov_offset": ov["offset"], "ov_olen": ov["overlap_len"],
            "ov_ok": ov_ok, "ov_hasgap": ov["has_gap"], "ov_diff": ov["diff"],
            "total_front1": tf1, "total_front2": tf2,
            "rlen1": rlen1, "rlen2": rlen2,
            "result1": result1, "result2": result2,
            "alive1": alive1, "alive2": alive2,
            "pass1": pass1, "pass2": pass2,
            "emit_pair": emit_pair,
            "ov_trimmed": ov_trimmed,
            "rlen1_pre_ovtrim": rlen1_pre_ovtrim,
            "rlen2_pre_ovtrim": rlen2_pre_ovtrim,
            "ad_found1": ad1["ad_found"], "ad_pos1": ad1["ad_pos"],
            "ad_found2": ad2["ad_found"], "ad_pos2": ad2["ad_pos"],
            "rlen1_pre_adapter": ad1["rlen_pre_adapter"],
            "rlen2_pre_adapter": ad2["rlen_pre_adapter"],
            "polyx_reads": px_r1 + px_r2,
            "polyx_bases": px_b1 + px_b2,
            "isize_hist": isize_hist,
            "corr_matrix": corr_matrix,
        })
        if cfg.lean:
            # the lean reductions and deletions of fastp_tpu's step
            # (device.py:908-983): the result histogram route_pe would
            # build; the per-read overlap fields reduce to a corr_able bit
            counted = valid & ~index_drop
            worst = torch.maximum(result1, result2)
            if cfg.merge_enabled:
                # route_pe's three row classes: merged rows count m_result
                # x2 (merged_ok already embeds counted); include_unmerged
                # rows count result1 and result2 x1 each; the rest count
                # max(r1, r2) x2
                mm = ovm_ok
                um = (alive1 & alive2 & ~mm if cfg.merge_include_unmerged
                      else torch.zeros_like(mm))
                normal = counted & ~(mm | um)
                hist = (_result_hist(m_result, mm, 2)
                        + _result_hist(result1, um, 1)
                        + _result_hist(result2, um, 1)
                        + _result_hist(worst, normal, 2))
                if cfg.merge_include_unmerged:
                    r1ok = alive1 & (result1 == PASS_FILTER)
                    r2ok = alive2 & (result2 == PASS_FILTER)
                    out["um_emit1"] = um & r1ok & ~dedup_out
                    out["um_emit2"] = um & r2ok & ~dedup_out
                    out["um_both_pass"] = (um & r1ok & r2ok).sum(
                        dtype=I32)[None]
                # route_pe derives the rest from m_emit, normal and pass*
                out["normal"] = normal
                for k in ("m_result", "m_len", "merged_ok", "post1", "post2"):
                    del out[k]
                out["result_hist"] = hist
            else:
                out["result_hist"] = _result_hist(worst, counted, 2)
            for k in ("result1", "result2", "alive1", "alive2", "emit_pair"):
                del out[k]
            if cfg.correction_enabled:
                out["corr_able"] = (ov_ok & ~ov["has_gap"]
                                    & (ov["diff"] != 0))
            for k in ("ov_offset", "ov_olen", "ov_diff", "ov_ok",
                      "ov_hasgap"):
                del out[k]
            if not (cfg.adapter_enabled or cfg.correction_enabled):
                del out["rlen1_pre_ovtrim"], out["rlen2_pre_ovtrim"]
            if not cfg.adapter_enabled:
                for k in ("ov_trimmed", "ad_found1", "ad_pos1", "ad_found2",
                          "ad_pos2", "rlen1_pre_adapter", "rlen2_pre_adapter"):
                    del out[k]
            # total_front is the host-known pre-trim unless a front trim/cut
            # can move the window start on device
            if cfg.front1 == 0 and not cfg.enabledFront:
                del out["total_front1"]
            if cfg.front2 == 0 and not cfg.enabledFront:
                del out["total_front2"]
        return out

    return Step(body, io, graph)
