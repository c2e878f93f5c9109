"""ctypes bindings to the native C++ runtime (native/build/libswipetpu.so).

The native library provides the gapped aligner (region reverse pass +
Myers-Miller traceback) and the LPT lane packer.  It is built from
native/*.cc at first use (or by ``make -C native``); without a C++
compiler the pure-NumPy implementations in :mod:`swipe_tpu.align` and
:mod:`swipe_tpu.batching` are used instead.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False
_MALLOC_TUNED = False


def tune_malloc() -> bool:
    """Keep large allocations on the reusable brk heap (glibc mallopt).

    glibc serves big numpy buffers via mmap and unmaps them on free, so
    every multi-MB temporary pays kernel page faults again on the next
    allocation.  On virtualized hosts those faults are the dominant cost
    of the host-side phases (measured on the round-4 box: first-touch of
    fresh pages ~34 ms/MB vs ~0.35 ms/MB copying into reused heap — a
    50 MB ingest temporary cost 1.7 s to allocate and 17 ms to fill).
    Raising M_MMAP_THRESHOLD keeps those buffers in the heap, where freed
    chunks are reused without refaulting.  Best-effort and idempotent;
    returns True when the knob was applied.  The reference never needs
    this because it mmaps its database once and reuses fixed per-thread
    buffers (/root/reference/database.cc:1342-1349).
    """
    global _MALLOC_TUNED
    if _MALLOC_TUNED:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6")
        M_MMAP_THRESHOLD = -3
        _MALLOC_TUNED = bool(libc.mallopt(M_MMAP_THRESHOLD, 1 << 30))
    except (OSError, AttributeError):
        _MALLOC_TUNED = False
    return _MALLOC_TUNED

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
_SO = os.path.join(_NATIVE, "build", "libswipetpu.so")
_SOURCES = [os.path.join(_NATIVE, f) for f in ("aligner.cc", "packer.cc")]


def build() -> str | None:
    """Compile native/*.cc into native/build/libswipetpu.so unless it is
    up to date (the same command as ``make -C native``).  Runs under a
    file lock so concurrent test workers build once.  Returns the path,
    or None when no C++ compiler is available or the build fails — the
    NumPy implementations then serve (this library is optional)."""
    import fcntl
    import subprocess

    def fresh():
        return os.path.exists(_SO) and os.path.getmtime(_SO) >= max(
            os.path.getmtime(f) for f in _SOURCES)

    if fresh():
        return _SO
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    with open(_SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh():
            return _SO
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = [os.environ.get("CXX", "g++"), "-O3", "-march=native",
               "-fPIC", "-std=c++17", "-shared", "-o", tmp, *_SOURCES]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError:
            return None
        if res.returncode != 0:
            import sys
            sys.stderr.write("swipe_tpu: native build failed, using the "
                             "NumPy paths:\n" + res.stderr[-2000:])
            return None
        os.replace(tmp, _SO)
    return _SO


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    lib.swtpu_align.restype = ctypes.c_long
    lib.swtpu_align.argtypes = [
        ctypes.POINTER(ctypes.c_int8), ctypes.c_long,   # a, M
        ctypes.POINTER(ctypes.c_int8), ctypes.c_long,   # b, N
        ctypes.POINTER(ctypes.c_long),                  # matrix 32x32
        ctypes.c_long, ctypes.c_long,                   # q, r
        ctypes.c_long,                                  # hint flag
        ctypes.POINTER(ctypes.c_long),                  # inout coords[5]
        ctypes.c_char_p, ctypes.c_long,                 # ops buf, cap
    ]
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.swtpu_pack_plan.restype = ctypes.c_int64
    lib.swtpu_pack_plan.argtypes = [
        ctypes.c_int64, i64p, i64p,                 # nseq lens order
        ctypes.c_int64, ctypes.c_int64,             # nlanes maxblk
        ctypes.c_int64,                             # block
        i32p, i32p, i64p, i64p,                     # chunk lane blk nb
    ]
    lib.swtpu_pack_fill.restype = None
    lib.swtpu_pack_fill.argtypes = [
        ctypes.c_int64, i64p,                       # nmember seqidx
        i8p, i64p,                                  # blob offs
        i32p, i64p,                                 # lane startblk
        ctypes.c_int64, ctypes.c_int64,             # block ncols
        ctypes.c_int8,                              # pad
        i8p, i8p,                                   # data_t start
        ctypes.c_int64, ctypes.c_int64,             # nlanes nblocks
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def pack_available() -> bool:
    return available()


def pack_plan(lens: np.ndarray, order: np.ndarray, nlanes: int,
              max_blocks: int, block: int):
    """LPT chunk plan (native/packer.cc swtpu_pack_plan): returns
    (nchunks, chunk_id[nseq], lane[nseq], start_block[nseq],
    chunk_nblocks[nchunks]) — bit-identical to pack_stream's Python
    assignment loop."""
    import ctypes as ct
    lib = _load()
    n = len(lens)
    lens64 = np.ascontiguousarray(lens, dtype=np.int64)
    order64 = np.ascontiguousarray(order, dtype=np.int64)
    chunk_id = np.empty(n, dtype=np.int32)
    lane = np.empty(n, dtype=np.int32)
    startblk = np.empty(n, dtype=np.int64)
    chunk_nblocks = np.empty(max(n, 1), dtype=np.int64)
    p = lambda a, t: a.ctypes.data_as(ct.POINTER(t))
    nchunks = lib.swtpu_pack_plan(
        n, p(lens64, ct.c_int64), p(order64, ct.c_int64),
        nlanes, max_blocks, block,
        p(chunk_id, ct.c_int32), p(lane, ct.c_int32),
        p(startblk, ct.c_int64), p(chunk_nblocks, ct.c_int64))
    return int(nchunks), chunk_id, lane, startblk, chunk_nblocks[:nchunks]


def pack_fill(seqidx: np.ndarray, blob: np.ndarray, offs: np.ndarray,
              lane: np.ndarray, startblk: np.ndarray, block: int,
              pad: int, data_t: np.ndarray, start: np.ndarray) -> None:
    """Fill one chunk's lane-major plane + start mask (swtpu_pack_fill).
    ``seqidx``/``lane``/``startblk`` are the chunk's members in flush
    order; data_t may be uninitialized (every byte is written)."""
    import ctypes as ct
    lib = _load()
    nblocks, nlanes = start.shape
    p = lambda a, t: a.ctypes.data_as(ct.POINTER(t))
    lib.swtpu_pack_fill(
        len(seqidx), p(seqidx, ct.c_int64),
        p(blob, ct.c_int8), p(offs, ct.c_int64),
        p(lane, ct.c_int32), p(startblk, ct.c_int64),
        block, data_t.shape[1], pad,
        p(data_t, ct.c_int8), p(start, ct.c_int8), nlanes, nblocks)


def align(a, b, matrix, q, r, hint=None):
    """Native gapped alignment; same contract as align.align_py."""
    lib = _load()
    a8 = np.ascontiguousarray(np.asarray(a), dtype=np.int8)
    b8 = np.ascontiguousarray(np.asarray(b), dtype=np.int8)
    m64 = np.ascontiguousarray(np.asarray(matrix), dtype=np.int64).reshape(-1)
    coords = np.zeros(5, dtype=np.int64)  # score, ab, bb, ae, be
    if hint is not None:
        coords[0], coords[3], coords[4] = hint
    # op string is <= 2*(M+N): runs of "X<len>" with sum(len) <= M+N and
    # digits(len) <= len.  (The old 16x cap zeroed multi-GB buffers for
    # chromosome-scale subjects on the hint-less blastn -S 2 path.)
    cap = 2 * (len(a8) + len(b8)) + 64
    buf = ctypes.create_string_buffer(cap)
    rc = lib.swtpu_align(
        a8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(a8),
        b8.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(b8),
        m64.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        q, r, 1 if hint is not None else 0,
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        buf, cap,
    )
    if rc < 0:
        raise RuntimeError("Internal error in align function.")
    return (int(coords[0]), int(coords[1]), int(coords[2]),
            int(coords[3]), int(coords[4]), buf.value.decode())
