"""ctypes bindings for the native host hot paths (fastp_tpu_torch/native/fastq_native.cpp).

The port's own copy of fastp_tpu/io/native.py.  The shared library is
compiled on demand with g++ (no pip deps) into `fastp_tpu_torch/_build/`
under a name that carries the hash of its sources and of the host's name, so
it is never the file fastp_tpu builds for itself nor one built on another
machine; the compiler writes a temporary file that is
then renamed into place, so a process that loads the library while another
builds it never sees a half-written file.  Callers fall back to the
pure-Python implementations when a toolchain is unavailable (``get_lib()``
returns None).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import sys
import tempfile
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_PKG, "native")
_BUILD_DIR = os.path.join(_PKG, "_build")
_SRC = os.path.join(_NATIVE_DIR, "fastq_native.cpp")
_SRCS = [_SRC, os.path.join(_NATIVE_DIR, "route_native.cpp")]
_LIB_STEM = "libfastq_native_torch"

_lock = threading.Lock()
_lib = None
_lib_tried = False

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


def _build(lib_path: str) -> bool:
    """Compile the sources to a temporary file beside `lib_path`, then
    rename it into place (atomic on one filesystem)."""
    base = (["g++", "-std=c++17", "-O3", "-fPIC", "-shared", "-march=native"]
            + [s for s in _SRCS if os.path.exists(s)])
    # prefer libdeflate-backed gzip (reference: src/writer.cpp:110-133);
    # fall back to a zlib-only build when the library is absent
    base += ["-lz"]  # streaming-inflate fallback of the gzip reader
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(lib_path))
    os.close(fd)
    try:
        for extra in (["-DHAVE_LIBDEFLATE", "-ldeflate"], []):
            try:
                r = subprocess.run(base + extra + ["-o", tmp],
                                   capture_output=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired):
                return False
            if r.returncode == 0:
                os.replace(tmp, lib_path)
                return True
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    sys.stderr.write("fastp_tpu_torch: native build failed, using Python "
                     "path:\n" + r.stderr.decode(errors="replace")[-2000:]
                     + "\n")
    return False


def _lib_path() -> str:
    """Path of the library for the current sources: the package's build
    directory where that is writable (or already holds the library), else
    a cache directory under the system's temporary directory."""
    # the build is for this host's CPU (-march=native) and links what this
    # host has, so the host's name is part of the key: a build directory
    # copied from, or shared with, another machine is not reused
    digest = hashlib.sha256(("%s %s " % (platform.node(),
                                         platform.machine())).encode())
    for s in _SRCS:
        if os.path.exists(s):
            with open(s, "rb") as f:
                digest.update(f.read())
    name = "%s-%s.so" % (_LIB_STEM, digest.hexdigest()[:16])
    cand = os.path.join(_BUILD_DIR, name)
    if os.path.exists(cand):
        return cand
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
    except OSError:
        pass
    if os.access(_BUILD_DIR, os.W_OK):
        return cand
    cache = os.path.join(tempfile.gettempdir(), "fastp_tpu_torch_native")
    os.makedirs(cache, exist_ok=True)
    return os.path.join(cache, name)


def _bind(lib):
    lib.fq_tokenize.restype = ctypes.c_int64
    lib.fq_tokenize.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int, _u8p, _u8p, _i32p, _i64p, _i32p, _i64p, _i32p,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32)]
    lib.fq_serialize.restype = ctypes.c_int64
    lib.fq_serialize.argtypes = [
        _u8p, _i64p, _i32p, _u8p, _i64p, _i32p,
        _u8p, _u8p, _i32p, _i32p, _u8p,
        ctypes.c_int64, ctypes.c_int64, _u8p]
    lib.dup_hash.restype = None
    lib.dup_hash.argtypes = [
        _u8p, _i32p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        _i64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64, _i64p]
    lib.dup_apply.restype = None
    lib.dup_apply.argtypes = [_u8p, _i64p, ctypes.c_int64, _u8p]
    lib.pack_bq.restype = ctypes.c_int64
    lib.pack_bq.argtypes = [
        _u8p, _u8p, ctypes.c_int64, _u8p, ctypes.c_int64,
        _i32p, _u8p, _u8p]
    lib.pack_nib.restype = ctypes.c_int64
    lib.pack_nib.argtypes = [
        _u8p, _u8p, ctypes.c_int64, _u8p, _i32p, _u8p, ctypes.c_int64,
        _i32p, _u8p, _u8p]
    lib.pack_p3.restype = ctypes.c_int64
    lib.pack_p3.argtypes = [
        _u8p, _u8p, ctypes.c_int64, _u8p, _i32p, _u8p, _u8p,
        ctypes.c_int64, _i32p, _u8p, _u8p]
    lib.known_adapter_scan.restype = ctypes.c_int32
    lib.known_adapter_scan.argtypes = [
        _u8p, _i32p, ctypes.c_int64, ctypes.c_int64,
        _u8p, _i64p, _i32p, ctypes.c_int32,
        _i64p, _i64p, ctypes.POINTER(ctypes.c_int64)]
    lib.seed_histogram.restype = None
    lib.seed_histogram.argtypes = [
        _u8p, _i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, _u32p]
    lib.collect_seed_hits.restype = ctypes.c_int64
    lib.collect_seed_hits.argtypes = [
        _u8p, _i32p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
        _i32p, _i32p]
    _side = [_u8p, _i64p, _i32p, _u8p, _i64p, _i32p,  # name/strand buffers
             _u8p, _u8p]                              # bases/quals
    lib.fq_emit_routed.restype = ctypes.c_int64
    lib.fq_emit_routed.argtypes = (
        _side + [_i32p, _i32p, _i32p, _i32p]          # tf/rlen/pre/lraw 1
        + _side + [_i32p, _i32p, _i32p, _i32p]        # tf/rlen/pre/lraw 2
        + [ctypes.c_int64, ctypes.c_int64,            # B, W
           _u8p, _i32p, _u8p, _i32p,                  # emitA/tagA/emitB/tagB
           _u8p, _i64p, _i32p, _u8p])                 # tag table, out
    lib.index_filter.restype = None
    lib.index_filter.argtypes = [
        _u8p, _i64p, _i32p,                                 # names 1
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # names 2 (opt)
        _u8p, _i64p, _i32p, ctypes.c_int32,                 # blacklist 1
        _u8p, _i64p, _i32p, ctypes.c_int32,                 # blacklist 2
        ctypes.c_int, ctypes.c_int64, _u8p]                 # threshold, B, out
    lib.gzip_compress.restype = ctypes.c_int64
    lib.gzip_compress.argtypes = [_u8p, ctypes.c_int64, ctypes.c_int,
                                  _u8p, ctypes.c_int64]
    lib.gz_reader_create.restype = ctypes.c_void_p
    lib.gz_reader_create.argtypes = []
    lib.gz_reader_destroy.restype = None
    lib.gz_reader_destroy.argtypes = [ctypes.c_void_p]
    lib.gz_reader_inflate.restype = ctypes.c_int64
    lib.gz_reader_inflate.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int64, ctypes.c_int,
        _u8p, ctypes.c_int64, _i64p]
    lib.gzip_compress_bound.restype = ctypes.c_int64
    lib.gzip_compress_bound.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.ora_create.restype = ctypes.c_void_p
    lib.ora_create.argtypes = [_u8p, _i64p, _i32p, ctypes.c_int64,
                               ctypes.c_int, _i32p, ctypes.c_int]
    lib.ora_destroy.restype = None
    lib.ora_destroy.argtypes = [ctypes.c_void_p]
    lib.ora_stat_batch.restype = None
    lib.ora_stat_batch.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int64,
        _i32p, _i32p, _i32p, ctypes.c_int64, _i64p, _i64p]
    lib.umi_process.restype = ctypes.c_int64
    lib.umi_process.argtypes = [
        _u8p, _i64p, _i32p,                                # name buffers 1
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, # name buffers 2
        _u8p, _i32p, ctypes.c_void_p, ctypes.c_void_p,     # bases/len 1, 2
        ctypes.c_int64, ctypes.c_int64,                    # B, W
        ctypes.c_int, ctypes.c_int, ctypes.c_int,          # loc, umi_len, skip
        _u8p, ctypes.c_int, _u8p, ctypes.c_int,            # prefix, delim
        _u8p, _i64p, _i32p, _u8p, _i64p, _i32p,            # out1, out2
        _i32p, _i32p, ctypes.POINTER(ctypes.c_int64)]      # pre1, pre2, w2
    lib.adrec_create.restype = ctypes.c_void_p
    lib.adrec_create.argtypes = []
    lib.adrec_free.restype = None
    lib.adrec_free.argtypes = [ctypes.c_void_p]
    lib.adrec_add_one.restype = None
    lib.adrec_add_one.argtypes = [ctypes.c_void_p, _u8p, ctypes.c_int64,
                                  ctypes.c_int32, ctypes.c_int64]
    lib.adrec_add_pairs.restype = None
    lib.adrec_add_pairs.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int64, _u8p, ctypes.c_int64,
        _i64p, _i64p, _i64p, _i64p, _i64p, ctypes.c_int64]
    lib.adrec_add_rows.restype = None
    lib.adrec_add_rows.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int64,
        _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int32]
    lib.adrec_add_pair_strs.restype = None
    lib.adrec_add_pair_strs.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int64, _u8p, ctypes.c_int64,
        ctypes.c_int64]
    lib.adrec_export_size.restype = None
    lib.adrec_export_size.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
    lib.adrec_export.restype = None
    lib.adrec_export.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                 _u8p, _i64p, _i64p]
    lib.fq_emit_merged.restype = ctypes.c_int64
    lib.fq_emit_merged.argtypes = (
        _side + [_i32p, _i32p]                        # tf/rlen 1
        + _side + [_i32p, _i32p]                      # tf/rlen 2
        + [ctypes.c_int64, ctypes.c_int64,            # B, W
           _u8p, _i32p, _i32p, _i32p,                 # m_emit/m_len1/m_len2/ol
           _u8p, _u8p, _u8p])                         # umA, umB, out
    return lib


def get_lib():
    """The loaded native library, or None if unavailable.  The variable
    FASTP_TPU_NO_NATIVE is read at every call, not once per process: in a
    resident server it belongs to the job that sent it."""
    global _lib, _lib_tried
    if os.environ.get("FASTP_TPU_NO_NATIVE"):
        return None
    if _lib is not None or _lib_tried:
        return _lib
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        if not os.path.exists(_SRC):
            return None
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            _lib = _bind(ctypes.CDLL(path))
        except OSError:
            _lib = None
    return _lib


def tokenize(buf: np.ndarray, is_final: bool, max_records: int, width: int,
             phred64: bool):
    """Parse FASTQ records from ``buf`` into padded arrays.

    Returns (n, bases, quals, lengths, name_off, name_len, strand_off,
    strand_len, consumed, stopped, need_wider); offsets index into ``buf``.
    """
    lib = get_lib()
    assert lib is not None
    B = max_records
    bases = np.empty((B, width), np.uint8)
    quals = np.empty((B, width), np.uint8)
    lengths = np.empty((B,), np.int32)
    name_off = np.empty((B,), np.int64)
    name_len = np.empty((B,), np.int32)
    strand_off = np.empty((B,), np.int64)
    strand_len = np.empty((B,), np.int32)
    consumed = ctypes.c_int64(0)
    stopped = ctypes.c_int32(0)
    need_wider = ctypes.c_int32(0)
    n = lib.fq_tokenize(buf, buf.size, int(is_final), B, width, int(phred64),
                        bases, quals, lengths, name_off, name_len,
                        strand_off, strand_len,
                        ctypes.byref(consumed), ctypes.byref(stopped),
                        ctypes.byref(need_wider))
    return (int(n), bases, quals, lengths, name_off, name_len,
            strand_off, strand_len, int(consumed.value),
            bool(stopped.value), int(need_wider.value))


def dup_hash(b1, l1, b2, l2, primes, offset_mask: int, buf_num: int,
             buf_len_bits: int):
    """Bloom-filter hash positions [buf_num, B] (b2/l2 None for SE)."""
    lib = get_lib()
    assert lib is not None
    B, W = b1.shape
    out = np.empty((buf_num, B), np.int64)
    b1c = np.ascontiguousarray(b1)
    l1c = np.ascontiguousarray(l1, dtype=np.int32)
    if b2 is None:
        b2p = None
        l2p = None
    else:
        b2c = np.ascontiguousarray(b2)
        l2c = np.ascontiguousarray(l2, dtype=np.int32)
        b2p = b2c.ctypes.data_as(ctypes.c_void_p)
        l2p = l2c.ctypes.data_as(ctypes.c_void_p)
    lib.dup_hash(b1c, l1c, b2p, l2p, B, W,
                 np.ascontiguousarray(primes, dtype=np.int64),
                 offset_mask, buf_num, buf_len_bits, out)
    return out


PACK_EXC_CAP = 2048


def pack_bq(bases: np.ndarray, quals: np.ndarray):
    """Pack [B, W] base/qual arrays into one [B, W] byte array for upload.

    Returns (packed, exc_idx[i32 E], exc_base[u8 E], exc_qual[u8 E], n_exc)
    or None when the input has too many non-ACGTN/odd-qual bytes (caller
    uses the raw two-tensor path)."""
    lib = get_lib()
    assert lib is not None
    packed = np.empty_like(bases)
    exc_idx = np.zeros(PACK_EXC_CAP, np.int32)
    exc_base = np.zeros(PACK_EXC_CAP, np.uint8)
    exc_qual = np.zeros(PACK_EXC_CAP, np.uint8)
    n = lib.pack_bq(np.ascontiguousarray(bases),
                    np.ascontiguousarray(quals),
                    bases.size, packed, PACK_EXC_CAP,
                    exc_idx, exc_base, exc_qual)
    if n < 0:
        return None
    # sentinel for unused slots: out-of-range index (device scatter drops)
    if n < PACK_EXC_CAP:
        exc_idx[n:] = bases.size
    return packed, exc_idx, exc_base, exc_qual, int(n)


def nib_exc_cap(n: int) -> int:
    """Exception capacity for pack_nib: a fixed function of the element
    count so the device-step shape is stable per batch shape.  Sized for
    ~0.8% exceptional positions (N bases dominate on real data); rounded
    to a 1024 multiple so a dp mesh can shard the list."""
    return max(4096, -(-(n // 128) // 1024) * 1024)


def pack_nib(bases: np.ndarray, quals: np.ndarray,
             qdict: np.ndarray, qdict_n: np.ndarray):
    """Pack [B, W] base/qual arrays into a [B, W//2] nibble array.

    qdict (u8[4]) / qdict_n (i32[1]) persist across batches (the qual
    dictionary is learned first-come and stays stable for the run).
    Returns (packed, exc_idx, exc_base, exc_qual, n_exc) or None when the
    batch has too many non-ACGT/5th-qual positions for the fixed-capacity
    exception list (caller falls back to the 1-byte/position scheme)."""
    lib = get_lib()
    assert lib is not None
    B, W = bases.shape
    cap = nib_exc_cap(bases.size)
    packed = np.empty((B, W // 2), np.uint8)  # pack_nib zero-fills
    exc_idx = np.zeros(cap, np.int32)
    exc_base = np.zeros(cap, np.uint8)
    exc_qual = np.zeros(cap, np.uint8)
    n = lib.pack_nib(np.ascontiguousarray(bases),
                     np.ascontiguousarray(quals),
                     bases.size, qdict, qdict_n, packed, cap,
                     exc_idx, exc_base, exc_qual)
    if n < 0:
        return None
    if n < cap:
        exc_idx[n:] = bases.size
    return packed, exc_idx, exc_base, exc_qual, int(n)


def pack_p3(bases: np.ndarray, quals: np.ndarray,
            qdict: np.ndarray, qdict_n: np.ndarray):
    """Pack [B, W] base/qual arrays into planar 3 bits/position: a
    [B, W//4] 2-bit base plane + a [B, W//8] 1-bit qual plane over a
    2-entry learned qual dictionary (qdict u8[2] / qdict_n i32[1] persist
    across batches; the dict is learned from the first batch's qual
    histogram, top-2 by count).  Returns (bplane, qplane, exc_idx,
    exc_base, exc_qual, n_exc) or None when the exception list overflows
    (3+ frequent qual values / N-rich input: caller falls back to
    pack_nib's 4-bit scheme).  W must be a multiple of 8."""
    lib = get_lib()
    assert lib is not None
    B, W = bases.shape
    assert W % 8 == 0
    cap = nib_exc_cap(bases.size)
    bplane = np.empty((B, W // 4), np.uint8)  # pack_p3 zero-fills
    qplane = np.empty((B, W // 8), np.uint8)
    exc_idx = np.zeros(cap, np.int32)
    exc_base = np.zeros(cap, np.uint8)
    exc_qual = np.zeros(cap, np.uint8)
    n = lib.pack_p3(np.ascontiguousarray(bases),
                    np.ascontiguousarray(quals),
                    bases.size, qdict, qdict_n, bplane, qplane, cap,
                    exc_idx, exc_base, exc_qual)
    if n < 0:
        return None
    if n < cap:
        exc_idx[n:] = bases.size
    return bplane, qplane, exc_idx, exc_base, exc_qual, int(n)


def umi_process(nb1, noff1, nlen1, nb2, noff2, nlen2,
                bases1, len1, bases2, len2, W,
                loc, umi_len, skip, prefix: bytes, delim: bytes):
    """Batched UMI name splicing. Returns
    ((blob1, off1, lens1), (blob2, off2, lens2) or None, pre1, pre2)."""
    lib = get_lib()
    assert lib is not None
    B = len(nlen1)
    # worst-case tag: delim + prefix + '_' + umi1 + '_' + umi2, where an
    # index-derived UMI can be as long as the whole read name and a
    # read-derived UMI at most umi_len; bound by the larger of the two
    max_n1 = int(np.asarray(nlen1).max(initial=0))
    max_n2 = int(np.asarray(nlen2).max(initial=0)) if nlen2 is not None else 0
    extra = (len(delim) + len(prefix) + 3
             + max(umi_len, max_n1) + max(umi_len, max_n2))
    cap1 = int(np.asarray(nlen1).sum()) + B * extra + 64
    out1 = np.empty(cap1, np.uint8)
    ooff1 = np.empty(B, np.int64)
    olen1 = np.empty(B, np.int32)
    pre1 = np.zeros(B, np.int32)
    pre2 = np.zeros(B, np.int32)
    has2 = nb2 is not None
    if has2:
        cap2 = int(np.asarray(nlen2).sum()) + B * extra + 64
        out2 = np.empty(cap2, np.uint8)
        ooff2 = np.empty(B, np.int64)
        olen2 = np.empty(B, np.int32)
        nb2c = np.ascontiguousarray(nb2)
        noff2c = np.ascontiguousarray(noff2, np.int64)
        nlen2c = np.ascontiguousarray(nlen2, np.int32)
        b2c = np.ascontiguousarray(bases2)
        l2c = np.ascontiguousarray(len2, np.int32)
        p2 = (nb2c.ctypes.data_as(ctypes.c_void_p),
              noff2c.ctypes.data_as(ctypes.c_void_p),
              nlen2c.ctypes.data_as(ctypes.c_void_p),
              b2c.ctypes.data_as(ctypes.c_void_p),
              l2c.ctypes.data_as(ctypes.c_void_p))
    else:
        out2 = np.empty(1, np.uint8)
        ooff2 = np.zeros(B, np.int64)
        olen2 = np.zeros(B, np.int32)
        p2 = (None, None, None, None, None)
    w2 = ctypes.c_int64(0)
    pfx = np.frombuffer(prefix or b"\0", np.uint8)
    dlm = np.frombuffer(delim or b"\0", np.uint8)
    w1 = lib.umi_process(
        np.ascontiguousarray(nb1), np.ascontiguousarray(noff1, np.int64),
        np.ascontiguousarray(nlen1, np.int32),
        p2[0], p2[1], p2[2],
        np.ascontiguousarray(bases1), np.ascontiguousarray(len1, np.int32),
        p2[3], p2[4],
        B, W, loc, umi_len, skip,
        pfx, len(prefix), dlm, len(delim),
        out1, ooff1, olen1, out2, ooff2, olen2,
        pre1, pre2, ctypes.byref(w2))
    r1 = (out1[:int(w1)], ooff1, olen1)
    r2 = (out2[:int(w2.value)], ooff2, olen2) if has2 else None
    return r1, r2, pre1, pre2


def gzip_compress(blob: bytes, level: int):
    """One whole gzip member via libdeflate (reference writer semantics,
    src/writer.cpp:110-133). Returns bytes or None when unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    bound = lib.gzip_compress_bound(len(blob), level)
    if bound <= 0:
        return None
    src = np.frombuffer(blob, np.uint8)
    out = np.empty(int(bound), np.uint8)
    n = lib.gzip_compress(src, len(blob), level, out, int(bound))
    if n <= 0:
        return None
    return out[:int(n)].tobytes()


def serialize(namebuf, name_off, name_len, strandbuf, strand_off, strand_len,
              seqsrc, qualsrc, start, rlen, emit, width) -> bytes:
    lib = get_lib()
    assert lib is not None
    n = len(name_len)
    # +64: the chunked emitters may overcopy up to 31B past the last field
    cap = int(name_len.sum()) + int(strand_len.sum()) + 2 * width * n + 8 * n + 64
    out = np.empty((cap,), np.uint8)
    w = lib.fq_serialize(namebuf, name_off, name_len,
                         strandbuf, strand_off, strand_len,
                         np.ascontiguousarray(seqsrc),
                         np.ascontiguousarray(qualsrc),
                         np.ascontiguousarray(start, dtype=np.int32),
                         np.ascontiguousarray(rlen, dtype=np.int32),
                         np.ascontiguousarray(emit, dtype=np.uint8),
                         n, width, out)
    return out[:int(w)].tobytes()


class AdapterRecorder:
    """Native adapter-count maps (reference: src/filterresult.cpp:115-183).

    Owns the two insertion-ordered count maps; all mutations go through
    native code so the per-row PE read-through recording costs no Python.
    export() rebuilds the plain dicts for reports/state_dict."""

    def __init__(self):
        self._lib = get_lib()
        assert self._lib is not None
        self._h = self._lib.adrec_create()

    def add_one(self, adapter_bytes: bytes, is_r2: bool, count: int):
        buf = np.frombuffer(adapter_bytes, np.uint8)
        self._lib.adrec_add_one(self._h, buf, len(adapter_bytes),
                                int(is_r2), count)

    def add_rows(self, ba, rows, lo, hi, is_r2: bool):
        n = len(rows)
        if n == 0:
            return
        self._lib.adrec_add_rows(
            self._h, np.ascontiguousarray(ba), ba.shape[1],
            np.ascontiguousarray(rows, np.int64),
            np.ascontiguousarray(lo, np.int64),
            np.ascontiguousarray(hi, np.int64), n, int(is_r2))

    def add_pair_strs(self, a1: bytes, a2: bytes, count: int):
        b1 = np.frombuffer(a1, np.uint8) if a1 else np.zeros(1, np.uint8)
        b2 = np.frombuffer(a2, np.uint8) if a2 else np.zeros(1, np.uint8)
        self._lib.adrec_add_pair_strs(self._h, b1, len(a1), b2, len(a2),
                                      count)

    def add_pairs(self, ba1, lo1, hi1, ba2, lo2, hi2, rows):
        n = len(rows)
        if n == 0:
            return
        self._lib.adrec_add_pairs(
            self._h, np.ascontiguousarray(ba1), ba1.shape[1],
            np.ascontiguousarray(ba2), ba2.shape[1],
            np.ascontiguousarray(rows, np.int64),
            np.ascontiguousarray(lo1, np.int64),
            np.ascontiguousarray(hi1, np.int64),
            np.ascontiguousarray(lo2, np.int64),
            np.ascontiguousarray(hi2, np.int64), n)

    def export(self, is_r2: bool) -> dict:
        import ctypes as _ct
        ne = _ct.c_int64(0)
        nb = _ct.c_int64(0)
        self._lib.adrec_export_size(self._h, int(is_r2),
                                    _ct.byref(ne), _ct.byref(nb))
        ne, nb = int(ne.value), int(nb.value)
        if ne == 0:
            return {}
        keys = np.empty(nb, np.uint8)
        lens = np.empty(ne, np.int64)
        counts = np.empty(ne, np.int64)
        self._lib.adrec_export(self._h, int(is_r2), keys, lens, counts)
        blob = keys.tobytes().decode("latin-1")
        out = {}
        off = 0
        for i in range(ne):
            L = int(lens[i])
            out[blob[off:off + L]] = int(counts[i])
            off += L
        return out

    def __del__(self):
        try:
            if self._h:
                self._lib.adrec_free(self._h)
                self._h = None
        except Exception:
            pass
