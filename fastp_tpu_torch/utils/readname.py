"""Host-side read-name utilities (reference: src/read.cpp:75-100, 179-190)."""
from __future__ import annotations


def last_index(name: bytes) -> bytes:
    """reference: src/read.cpp:75-85 (Read::lastIndex)."""
    n = len(name)
    if n < 5:
        return b""
    for i in range(n - 3, -1, -1):
        c = name[i:i + 1]
        if c == b":" or c == b"+":
            return name[i + 1:]
    return b""


def first_index(name: bytes) -> bytes:
    """reference: src/read.cpp:87-100 (Read::firstIndex)."""
    n = len(name)
    end = n
    if n < 5:
        return b""
    for i in range(n - 3, -1, -1):
        c = name[i:i + 1]
        if c == b"+":
            end = i - 1
        if c == b":":
            # substr(i+1, end-i) -> length end-i
            return name[i + 1:i + 1 + (end - i)]
    return b""


def fix_mgi(name: bytes):
    """reference: src/read.cpp:179-190. Returns (new_name, changed)."""
    if len(name) >= 2 and name[-1:] in (b"1", b"2") and name[-2:-1] == b"/":
        return name[:-2] + b" " + name[-2:], True
    return name, False
