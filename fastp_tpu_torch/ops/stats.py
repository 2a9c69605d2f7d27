"""Per-cycle quality/content statistics (reference: src/stats.cpp:232-332).

Counterpart of fastp_tpu/ops/stats.py.  The JAX version avoids scatters
(one-hot equality reductions and a bf16 one-hot matmul for the 5-mer
histogram).  `stat_batch` runs the plain PyTorch version below
(`stat_batch_plain`, where every histogram is an exact int64 `index_add_`
scatter with a dump bin for masked-out positions) for CPU tensors and the
hand-written CUDA kernel (ops/stats_cuda.py, csrc/stat_batch.cu) for CUDA
tensors; any other device raises.
"""
from __future__ import annotations

import torch

from .common import I32, pos_iota, base_slot, base2val, scatter_count
from .stats_cuda import stat_batch_cuda

Q20_CHAR = ord('5')
Q30_CHAR = ord('?')
KMER_BINS = 2 << 10  # mKmerBufLen = 2<<(5*2) = 2048 (only 1024 used by 10-bit keys)


def _shift_right(a, k: int, fill):
    B, L = a.shape
    return torch.cat([torch.full((B, k), fill, dtype=a.dtype, device=a.device),
                      a[:, :L - k]], 1)


def stat_batch(bases, quals, lengths, include):
    """include: bool[B] -- which reads contribute (e.g. post-filter pass).

    Returns a dict of int64 accumulators for one batch (the keys and
    shapes of fastp_tpu.ops.stats.stat_batch): the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    if bases.device.type == "cpu":
        return stat_batch_plain(bases, quals, lengths, include)
    if bases.device.type == "cuda":
        return stat_batch_cuda(bases, quals, lengths, include)
    raise ValueError("stat_batch runs on cpu or cuda, not %s" % bases.device)


def stat_batch_plain(bases, quals, lengths, include):
    """stat_batch in plain PyTorch: the CPU's version and the reference of
    the CUDA kernel."""
    B, L = bases.shape
    dev = bases.device
    rlen = lengths.to(I32)
    pos = pos_iota(B, L, dev)
    in_read = (pos < rlen[:, None]) & include[:, None]
    q = quals.to(I32)
    qm33 = torch.where(in_read, q - 33, 0)
    slot = base_slot(bases)

    # per-(slot, cycle) sums: one scatter of four weight channels
    cyc = scatter_count(torch.where(in_read, slot * L + pos, 8 * L), 8 * L,
                        in_read, in_read & (q >= Q20_CHAR),
                        in_read & (q >= Q30_CHAR), qm33).reshape(4, 8, L)

    qual_hist = scatter_count(torch.where(in_read, q.clamp(0, 127), 128), 128,
                              in_read)[0]

    # 5-mer keys: kmer[p] = sum_k v[p-k] << 2k over the 5 bases ending at p
    val = base2val(bases)
    v = torch.where(val >= 0, val, 0)
    ok = (val >= 0) & (pos < rlen[:, None])
    kmer = v
    valid = ok
    for k in range(1, 5):
        kmer = kmer + (_shift_right(v, k, 0) << (2 * k))
        valid = valid & _shift_right(ok, k, False)
    valid = valid & (pos >= 4) & include[:, None]
    kmer_counts = torch.zeros(KMER_BINS, dtype=torch.int64, device=dev)
    kmer_counts[:1024] = scatter_count(torch.where(valid, kmer, 1024), 1024,
                                       valid)[0]

    return {
        "cycle_q20": cyc[1],
        "cycle_q30": cyc[2],
        "cycle_content": cyc[0],
        "cycle_qual": cyc[3],
        "cycle_total_base": in_read.sum(0, dtype=torch.int64),
        "cycle_total_qual": qm33.sum(0, dtype=torch.int64),
        "qual_hist": qual_hist,
        "kmer": kmer_counts,
        "reads": include.sum(dtype=torch.int64),
        "length_sum": torch.where(include, rlen, 0).sum(dtype=torch.int64),
    }
