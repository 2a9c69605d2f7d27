"""Per-batch SE and PE device steps in PyTorch.

Counterparts of fastp_tpu/pipeline/device.py:build_se_step and
build_pe_step for plain (uint8) inputs, lean or not as cfg.lean says: the
reference order of src/seprocessor.cpp:196-315 and
src/peprocessor.cpp:361-600 (stats, trim/cut, polyG, overlap analysis,
correction, adapter trimming, polyX, merging, filters, stats, histograms).
A step returns a numpy dict with the keys and value semantics that
fastp_tpu.pipeline.device.unpack_from_host yields for the same cfg.

A step has two halves: `run` queues the upload and the device work of a
batch and returns tensors on the device, `fetch` copies them to the host in
one transfer.  Between the two a caller may keep some of the tensors on the
device: the run accumulator (pipeline/runner.py) takes the batch's sums out
and adds them to a resident vector, and the split over several devices
(parallel/mesh.py) runs every shard before it fetches any.  A step built
with `rowwise=True` is a shard of such a split: its correction deltas are
per row (ops/correct.py:extract_deltas), so nothing in it depends on rows
that another device holds.
Integers may be wider than the JAX step's slimmed int8/int16 transfer
types, and int8-biased fields come back unbiased, as unpack_from_host
gives them.
"""
from __future__ import annotations

import os

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
from ..ops import trim as trim_ops
from ..ops.common import I32, roll_front, scatter_count


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
    """Host-side aux tuple for the step (numpy)."""
    out = []
    if cfg.has_pretrim:
        out.append(np.asarray(pre_trim1, np.int32))
        if cfg.paired:
            out.append(np.asarray(pre_trim2, np.int32))
    if cfg.has_index_drop:
        out.append(np.asarray(index_drop, bool))
    if cfg.has_dedup:
        out.append(np.asarray(dedup_out, bool))
    n = (valid_or_n if isinstance(valid_or_n, (int, np.integer))
         else int(valid_or_n.sum()))
    out.append(np.int32(n))
    return tuple(out)


def _expand_aux(cfg: DeviceCfg, B: int, aux, device):
    """(pre1, pre2, index_drop, dedup_out, valid) tensors from the aux tuple."""
    d = dict(zip(aux_arg_names(cfg), aux))

    def put(key, dtype):
        if key not in d:
            return torch.zeros(B, dtype=dtype, device=device)
        return torch.as_tensor(np.asarray(d[key]), device=device).to(dtype)

    pre1 = put("pre_trim1" if "pre_trim1" in d else "pre_trim", I32)
    pre2 = put("pre_trim2", I32)
    valid = torch.arange(B, dtype=I32, device=device) < int(d["nvalid"])
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

# device-to-host traffic of this process's steps: transfers made and bytes
# moved (every leaf travels as int64)
fetch_stats = {"fetches": 0, "bytes": 0}


def flat_leaves(out: dict):
    """[(path, tensor)] of a (one-level nested) dict, in insertion order;
    path is (key,) or (key, subkey)."""
    leaves = []
    for k, v in out.items():
        if isinstance(v, dict):
            leaves += [((k, dk), dv) for dk, dv in v.items()]
        else:
            leaves.append(((k,), v))
    return leaves


def flatten_int64(leaves):
    """One int64 vector of every leaf's values, and what unflatten needs to
    take it apart again: [(path, shape, torch dtype)]."""
    meta = [(path, tuple(t.shape), t.dtype) for path, t in leaves]
    return torch.cat([t.reshape(-1).to(torch.int64) for _, t in leaves]), meta


def unflatten_host(flat, meta) -> dict:
    """Copy `flat` to the host in ONE transfer and split it by `meta` into
    a (one-level nested) numpy dict."""
    host = flat.cpu().numpy()
    fetch_stats["fetches"] += 1
    fetch_stats["bytes"] += host.nbytes
    res: dict = {}
    off = 0
    for path, shape, dtype in meta:
        n = int(np.prod(shape, dtype=np.int64))
        np_dtype = {torch.bool: np.bool_, torch.uint8: np.uint8,
                    torch.int16: np.int16,
                    torch.int32: np.int32}.get(dtype, np.int64)
        val = host[off:off + n].reshape(shape).astype(np_dtype)
        off += n
        if len(path) == 2:
            res.setdefault(path[0], {})[path[1]] = val
        else:
            res[path[0]] = val
    return res


def _to_host(out: dict) -> dict:
    """Copy every tensor of a (one-level nested) dict to numpy with ONE
    device-to-host transfer: flatten to int64, concatenate, split."""
    return unflatten_host(*flatten_int64(flat_leaves(out)))


class Step:
    """A device step in two halves: run(*args) returns the output dict as
    tensors on the device with nothing waited for, fetch(out) copies such a
    dict (or what a caller left of it) to numpy; step(*args) does both."""

    def __init__(self, run):
        self.run = run

    fetch = staticmethod(_to_host)

    def __call__(self, *args):
        return self.fetch(self.run(*args))


def _step_io(cfg: DeviceCfg, device):
    """(torch.device, the two adapters and the FASTA list uploaded once,
    upload(x, dtype))."""
    device = torch.device(device)

    def put(a):
        return torch.tensor(np.frombuffer(a, np.uint8).copy(),
                            dtype=torch.uint8, device=device)
    adapters = (put(cfg.adapter_seq1), put(cfg.adapter_seq2))
    fasta = tuple(put(a) for a in cfg.fasta_adapters)

    def upload(x, dtype):
        return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                               else x).to(device=device, dtype=dtype)
    return device, adapters, fasta, upload


def _result_hist(result, counted, weight: int):
    """The counting histogram the host would build over the counted rows."""
    return weight * scatter_count(torch.where(counted, result, 0),
                                  FILTER_RESULT_TYPES, counted)[0]


def build_se_step(cfg: DeviceCfg, device):
    """The SE step for `cfg` on `device` ("cuda", "cpu" or a torch.device).

    The returned Step takes (bases, quals, lengths, *aux) as numpy arrays
    or tensors -- uint8[B, L] bases/quals, int[B] lengths, aux as make_aux
    builds it -- and returns the numpy output dict.  It launches no
    hand-written kernel: the SE path has no overlap analysis.  No output of
    it looks across rows, so the same step serves as a shard of a split."""
    device, adapters, fasta, upload = _step_io(cfg, device)
    fview = _FilterCfgView(cfg)

    def run(bases, quals, lengths, *aux):
        with torch.no_grad():
            pre_trim, _, index_drop, dedup_out, valid = _expand_aux(
                cfg, len(lengths), aux, device)
            return se_step(upload(bases, torch.uint8),
                           upload(quals, torch.uint8),
                           upload(lengths, I32), pre_trim,
                           index_drop, dedup_out, valid)

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

    return Step(run)


def build_pe_step(cfg: DeviceCfg, device, rowwise: bool = False):
    """The PE step for `cfg` on `device` ("cuda", "cpu" or a torch.device).

    The adapter bytes are uploaded once here.  The returned Step takes
    (b1, q1, l1, b2, q2, l2, *aux) as numpy arrays or tensors -- uint8[B, L]
    bases/quals, int[B] lengths, aux as make_aux builds it -- and returns
    the numpy output dict.  With `rowwise` the correction deltas come per
    row (keys c1k_*, c2k_*: up to FASTP_TPU_CORR_K of them, 12 unless set)
    and not as the batch's sparse list (keys c1_*, c2_*)."""
    device, adapters, fasta, upload = _step_io(cfg, device)
    fview = _FilterCfgView(cfg)

    def run(b1, q1, l1, b2, q2, l2, *aux):
        with torch.no_grad():
            return pe_step(upload(b1, torch.uint8), upload(q1, torch.uint8),
                           upload(l1, I32), upload(b2, torch.uint8),
                           upload(q2, torch.uint8), upload(l2, I32),
                           *_expand_aux(cfg, len(l1), aux, device))

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

    return Step(run)
