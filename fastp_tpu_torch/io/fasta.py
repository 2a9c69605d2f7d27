"""Minimal FASTA reader for --adapter_fasta (reference: src/fastareader.cpp)."""
from __future__ import annotations

from typing import Dict


def read_fasta(filename: str, force_upper: bool = True) -> Dict[str, str]:
    contigs: Dict[str, str] = {}
    name = None
    seq_parts = []
    with open(filename, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    contigs[name] = "".join(seq_parts)
                name = line[1:].split()[0] if len(line) > 1 else ""
                seq_parts = []
            else:
                s = "".join(c for c in line if c.isalpha() or c in "-*")
                if force_upper:
                    s = s.upper()
                seq_parts.append(s)
    if name is not None:
        contigs[name] = "".join(seq_parts)
    return contigs
