"""The Hopper stream-scoring kernel (native/sw_stream.cu) as a JAX op.

The kernel has the exact contract of the lax twins in ``ops.sw_stream``
(``sw_scores_stream_lax`` and ``sw_scores_stream_lax_carry``): the same
inputs, the same per-block score dumps and the same ``(h, e, s)`` carry
state in the ``[nq, qlen_pad, nseqs]`` layout.  This module builds the
shared library from source with ``nvcc`` at first use (or by
``make -C native cuda``), registers it with ``jax.ffi`` and wraps the call:
the database chunk is handed over lane-major, the thread layout is chosen
from the query length (:func:`kernel_config`), and queries taller than
one strip of rows are scored in column pieces so that the strip boundary
kept in device memory stays bounded.

A missing compiler or a failed build raises with the compiler's message;
there is no fallback to the lax twin.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess

import numpy as np

__all__ = ["build", "kernel_config", "piece_columns",
           "sw_scores_stream_cuda", "LIBRARY", "SOURCE"]

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "native")
SOURCE = os.path.join(_NATIVE, "sw_stream.cu")
LIBRARY = os.path.join(_NATIVE, "build", "libswipe_sw_cuda.so")
TARGET = "swipe_sw_stream"
CUDA_HOME = "/usr/local/cuda"

# the boundary scratch of a multi-strip call holds 16 bytes per
# (query, lane, column); longer chunks are scored in column pieces
BND_BYTES = 1 << 30

_registered = False


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build_command(nvcc: str, out: str) -> list[str]:
    import jax.ffi
    return [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-I", jax.ffi.include_dir(), "-o", out,
            SOURCE]


def build(nvcc: str | None = None, force: bool = False) -> str:
    """Compile native/sw_stream.cu into LIBRARY unless it is up to date.

    Several processes may start at once (test workers, one process per
    card): the build runs under a file lock and lands by rename.
    Raises RuntimeError with the compiler's output when it fails."""
    nvcc = nvcc or _nvcc()
    os.makedirs(os.path.dirname(LIBRARY), exist_ok=True)

    def fresh():
        return (os.path.exists(LIBRARY) and
                os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE))

    if fresh() and not force:
        return LIBRARY
    with open(LIBRARY + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if fresh() and not force:
            return LIBRARY
        tmp = f"{LIBRARY}.{os.getpid()}.tmp"
        cmd = build_command(nvcc, tmp)
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as exc:
            raise RuntimeError(
                f"cannot build the CUDA stream kernel: {' '.join(cmd)}: "
                f"{exc}") from exc
        if res.returncode != 0:
            raise RuntimeError(
                "nvcc failed building the CUDA stream kernel "
                f"(exit {res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}{res.stderr}")
        os.replace(tmp, LIBRARY)
        with open(LIBRARY + ".log", "w") as log:
            log.write(res.stdout + res.stderr)
    return LIBRARY


def _register() -> None:
    global _registered
    if _registered:
        return
    import ctypes

    import jax.ffi
    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.SwStream),
                                platform="CUDA")
    _registered = True


def kernel_config(qlen_pad: int) -> tuple[int, int, int]:
    """(threads per (query, lane) pair, query rows per thread, strips).

    Short queries take sub-warp groups so that one thread still holds
    eight rows; a warp covers up to 1024 rows; taller queries run strips
    of 512 rows one after another."""
    if qlen_pad <= 64:
        return 8, 8, 1
    if qlen_pad <= 128:
        return 16, 8, 1
    if qlen_pad <= 256:
        return 32, 8, 1
    if qlen_pad <= 512:
        return 32, 16, 1
    if qlen_pad <= 1024:
        return 32, 32, 1
    return 32, 16, -(-qlen_pad // 512)


def piece_columns(nq: int, nseqs: int, qlen_pad: int, L: int) -> int:
    """Columns per launch for an ``L``-column chunk: all of them, or
    fewer for queries of several strips whose boundary scratch would pass
    BND_BYTES."""
    if kernel_config(qlen_pad)[2] == 1:
        return L
    return min(L, max(16, BND_BYTES // (16 * max(nq * nseqs, 1))
                      // 16 * 16))


def _ffi_call(qcodes, qlens, matrix8, pad_pen, db_t, start_t, h, e, s, *,
              gapopenextend, gapextend, group, rows, nstrips, carry_in,
              carry_out):
    """One launch of the kernel on lane-major inputs; returns
    (dumps, h, e, s), with the state outputs of shape (1,) unless
    ``carry_out``."""
    import jax
    import jax.numpy as jnp

    _register()
    nq, qlen_pad = qcodes.shape
    nseqs, L = db_t.shape
    i32 = jnp.int32
    state = ((nq, qlen_pad, nseqs), (nq, qlen_pad, nseqs), (nq, nseqs)) \
        if carry_out else ((1,), (1,), (1,))
    bnd = (4 * nq * nseqs * L,) if nstrips > 1 else (4,)
    out = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((nq, L // 16, nseqs), i32),
         *(jax.ShapeDtypeStruct(sh, i32) for sh in state),
         jax.ShapeDtypeStruct(bnd, i32)),
    )(qcodes, qlens, matrix8, pad_pen, db_t, start_t, h, e, s,
      gapopenextend=np.int32(gapopenextend), gapextend=np.int32(gapextend),
      group=np.int32(group), rows=np.int32(rows),
      nstrips=np.int32(nstrips), carry_in=np.int32(carry_in),
      carry_out=np.int32(carry_out))
    return out[:4]


def sw_scores_stream_cuda(qcodes, qlens, matrix8, db, start, state=None, *,
                          gapopenextend: int, gapextend: int,
                          carry_out: bool = False):
    """Score a lane-packed chunk on the card.

    qcodes/qlens: build_qcodes; matrix8: [32, 32] int8 (build_matrix8);
    db: [L, nseqs] int8; start: [L // 16, nseqs]; ``state``: the
    ``(h, e, s)`` carry of the previous chunk of a series, or None for a
    fresh chunk.  Returns the dumps ``[nq, L // 16, nseqs]`` and, with
    ``carry_out``, the state after the chunk: ``(dumps, h, e, s)``.
    Traceable: call it inside ``jit`` and ``shard_map``."""
    import jax.numpy as jnp

    nq, qlen_pad = qcodes.shape
    L, nseqs = db.shape
    if L % 16:
        raise ValueError(f"db length {L} not a multiple of 16")
    if matrix8.dtype != jnp.int8:
        raise ValueError("the CUDA stream kernel takes an int8 matrix")
    group, rows, nstrips = kernel_config(qlen_pad)
    qcodes = qcodes.astype(jnp.int32)
    qlens = qlens.astype(jnp.int32)
    pad_pen = jnp.minimum(jnp.min(matrix8.astype(jnp.int32)), -1)[None]
    db_t = db.astype(jnp.int8).T
    start_t = (start != 0).astype(jnp.int8).T
    dummy = jnp.zeros((1,), jnp.int32)
    carry_in = state is not None
    h, e, s = state if carry_in else (dummy, dummy, dummy)
    kw = dict(gapopenextend=gapopenextend, gapextend=gapextend,
              group=group, rows=rows, nstrips=nstrips)
    # column pieces bound the strip-boundary scratch of tall queries
    piece = piece_columns(nq, nseqs, qlen_pad, L)
    if piece >= L:
        dumps, h2, e2, s2 = _ffi_call(
            qcodes, qlens, matrix8, pad_pen, db_t, start_t, h, e, s,
            carry_in=carry_in, carry_out=carry_out, **kw)
        return (dumps, h2, e2, s2) if carry_out else dumps
    parts = []
    for c0 in range(0, L, piece):
        c1 = min(c0 + piece, L)
        more = c1 < L
        dumps, h2, e2, s2 = _ffi_call(
            qcodes, qlens, matrix8, pad_pen, db_t[:, c0:c1],
            start_t[:, c0 // 16:c1 // 16], h, e, s, carry_in=carry_in,
            carry_out=carry_out or more, **kw)
        parts.append(dumps)
        if more:
            h, e, s = h2, e2, s2
            carry_in = True
    dumps = jnp.concatenate(parts, axis=1)
    return (dumps, h2, e2, s2) if carry_out else dumps


if __name__ == "__main__":
    print(build(force=True))
