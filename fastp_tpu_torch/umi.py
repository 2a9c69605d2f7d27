"""UMI preprocessing (reference: src/umiprocessor.cpp:11-83).

All name edits happen on the host; read-head trimming is returned as a
per-read pre-trim amount the device pipeline applies before trimAndCut.
trimFront clamps to length-1 (reference: src/read.cpp:69-73).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from .config import (Options, UMI_LOC_INDEX1, UMI_LOC_INDEX2, UMI_LOC_READ1,
                     UMI_LOC_READ2, UMI_LOC_PER_INDEX, UMI_LOC_PER_READ)
from .utils.readname import first_index, last_index


class UmiProcessor:
    def __init__(self, opt: Options):
        self.opt = opt

    def _add_umi_to_name(self, name: bytes, umi: bytes) -> bytes:
        """reference: src/umiprocessor.cpp:63-83"""
        u = self.opt.umi
        delim = u.delimiter.encode()
        if not u.prefix:
            tag = delim + umi
        else:
            tag = delim + u.prefix.encode() + b"_" + umi
        space = name.find(b" ")
        if space == -1:
            return name + tag
        return name[:space] + tag + name[space:]

    def process_batch_arrays(self, batch1, batch2=None):
        """Native batched UMI path straight on the batch buffers: extracts
        UMIs, rebuilds all names in one C pass, installs them as (blob,
        offset, length) tables, and returns (pre_trim1, pre_trim2) int32
        arrays.  Returns None when the native library is unavailable."""
        from .io import native as native_mod
        if native_mod.get_lib() is None:
            return None
        u = self.opt.umi
        B = batch1.n
        nb1, noff1, nlen1 = batch1.name_buffers()
        if batch2 is not None:
            nb2, noff2, nlen2 = batch2.name_buffers()
            nb2v, noff2v, nlen2v = nb2, noff2[:B], nlen2[:B]
            b2, l2 = batch2.bases, batch2.lengths
        else:
            nb2v = noff2v = nlen2v = None
            b2 = l2 = None
        r1, r2, pre1, pre2 = native_mod.umi_process(
            nb1, noff1[:B], nlen1[:B], nb2v, noff2v, nlen2v,
            batch1.bases, batch1.lengths, b2, l2, batch1.width,
            u.location, u.length, u.skip,
            u.prefix.encode(), u.delimiter.encode())
        batch1.set_name_buffers(*r1)
        if batch2 is not None and r2 is not None:
            batch2.set_name_buffers(*r2)
        return pre1, pre2

    def process_batch(self, names1: List[bytes], seqs1: List[bytes],
                      names2: Optional[List[bytes]] = None,
                      seqs2: Optional[List[bytes]] = None):
        """Returns (new_names1, new_names2, pre_trim1, pre_trim2)."""
        u = self.opt.umi
        n = len(names1)
        pre1 = [0] * n
        pre2 = [0] * n
        out1 = list(names1)
        out2 = list(names2) if names2 is not None else None
        if not u.enabled:
            return out1, out2, pre1, pre2

        for i in range(n):
            name1 = out1[i]
            name2 = out2[i] if out2 is not None else None
            umi = b""
            if u.location == UMI_LOC_INDEX1:
                umi = first_index(name1)
            elif u.location == UMI_LOC_INDEX2 and name2 is not None:
                umi = last_index(name2)
            elif u.location == UMI_LOC_READ1:
                seq = seqs1[i]
                umi = seq[:min(len(seq), u.length)]
                pre1[i] = max(0, min(len(seq) - 1, len(umi) + u.skip))
            elif u.location == UMI_LOC_READ2 and name2 is not None:
                seq = seqs2[i]
                umi = seq[:min(len(seq), u.length)]
                pre2[i] = max(0, min(len(seq) - 1, len(umi) + u.skip))
            elif u.location == UMI_LOC_PER_INDEX:
                merged = first_index(name1)
                if name2 is not None:
                    merged = merged + b"_" + last_index(name2)
                name1 = self._add_umi_to_name(name1, merged)
                if name2 is not None:
                    name2 = self._add_umi_to_name(name2, merged)
            elif u.location == UMI_LOC_PER_READ:
                seq1 = seqs1[i]
                umi1 = seq1[:min(len(seq1), u.length)]
                merged = umi1
                pre1[i] = max(0, min(len(seq1) - 1, len(umi1) + u.skip))
                if name2 is not None:
                    seq2 = seqs2[i]
                    umi2 = seq2[:min(len(seq2), u.length)]
                    merged = merged + b"_" + umi2
                    pre2[i] = max(0, min(len(seq2) - 1, len(umi2) + u.skip))
                name1 = self._add_umi_to_name(name1, merged)
                if name2 is not None:
                    name2 = self._add_umi_to_name(name2, merged)

            if u.location not in (UMI_LOC_PER_INDEX, UMI_LOC_PER_READ):
                if umi:
                    name1 = self._add_umi_to_name(name1, umi)
                    if name2 is not None:
                        name2 = self._add_umi_to_name(name2, umi)
            out1[i] = name1
            if out2 is not None and name2 is not None:
                out2[i] = name2
        return out1, out2, pre1, pre2
