"""Lane-stream Smith-Waterman scoring: the search's one scoring route.

This is the analog of the reference's inner loop and channel machine
(/root/reference/search7.cc:585-645, lane refill :830-957): database
columns stream through the kernel and each lane holds a concatenation of
database sequences (batching.pack_stream).  Where SWIPE refills a SIMD
lane the moment its sequence ends, the packer pads each sequence to
KSEG-column blocks and a per-(block, lane) start mask resets that lane's
H/E/S state — SWIPE's ``domasked`` trick (search7.cc:671-753) with the
mask streamed instead of computed.  The recurrence per cell is the
reference's ONESTEP:

    E = max(E_left - R, H_left - Q)    (db-gap chain, along columns)
    F = max(F_up - R, H_up - Q)        (query-gap chain, along rows)
    H = max(diag + profile, E, F, 0)
    S = max(S, H)

Per (query, lane) the state is H/E of the last processed column for every
query row (the ``hearray`` of swipe.cc:1240) and the running maximum S,
laid out ``[nq, qlen_pad, nseqs]`` / ``[nq, nseqs]``.  After every block
the running maxima are dumped; a lane's sequence score is S at its final
block, recovered with one device-side gather (gather_scores).  A chunk of
a carry or flow series takes the previous chunk's state and returns its
own (sw_scores_stream_carry), so sequences longer than a chunk stream
through with O(qlen) state.

The scoring call is picked from the platform (stream_kernel): on an
NVIDIA GPU the CUDA kernel of ops.sw_cuda, elsewhere the lax twins
below, which are also the kernel's exact oracle.  Arithmetic is exact
int32 on both; ``clamp`` (lax twins only) reproduces the saturating lower
tiers of the reference's 7->16->63-bit cascade, whose counters
pipeline._count_tiers derives from the exact scores.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .sw_segment import NEG_INF, PAD_SYMBOL

__all__ = ["sw_scores_stream", "sw_scores_stream_carry",
           "sw_scores_stream_lax", "sw_scores_stream_lax_carry",
           "stream_kernel", "forced_kernel", "gather_scores", "build_matrix8",
           "build_matrix_wide", "stream_matrix", "build_qcodes",
           "make_stream_state",
           "permute_stream_state", "KSEG"]

KSEG = 16   # db columns per dumped block = lane-refill granularity


def build_matrix8(matrix: np.ndarray) -> np.ndarray:
    """[32, 32] int8 score matrix with the PAD row/column forced to -128."""
    m = np.asarray(matrix, dtype=np.int64)
    if m.min() < -128 or m.max() > 127:
        raise ValueError("score matrix must fit int8 for the stream kernel")
    m8 = m.astype(np.int8).copy()
    m8[PAD_SYMBOL, :] = -128
    m8[:, PAD_SYMBOL] = -128
    return m8


def build_matrix_wide(matrix: np.ndarray) -> np.ndarray:
    """[32, 32] int32 matrix for the lax twins when scores exceed int8:
    the PAD row/column only needs to be strictly negative (padding can
    then never raise the running max; see _stream_lax_core)."""
    m = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    m32 = m.astype(np.int32).copy()
    pad = int(min(m.min(), -1))
    m32[PAD_SYMBOL, :] = pad
    m32[:, PAD_SYMBOL] = pad
    return m32


def stream_matrix(matrix: np.ndarray) -> np.ndarray:
    """The matrix the stream route scores with: int8 (build_matrix8) when
    it fits, which the CUDA kernel takes, else int32 (build_matrix_wide),
    which routes the call to the lax twin (see _resolve)."""
    m = np.asarray(matrix)
    if m.min() >= -128 and m.max() <= 127:
        return build_matrix8(m)
    return build_matrix_wide(m)


def build_qcodes(queries: list[np.ndarray], qlen_pad: int
                 ) -> tuple[np.ndarray, np.ndarray]:
    """([NQ, qlen_pad] int32 codes, [NQ] int32 lengths) for the kernel."""
    nq = len(queries)
    qc = np.full((nq, qlen_pad), PAD_SYMBOL, dtype=np.int32)
    ql = np.zeros((nq,), dtype=np.int32)
    for n, q in enumerate(queries):
        L = len(q)
        if L > qlen_pad:
            raise ValueError(f"query {n} longer than qlen_pad ({L})")
        qc[n, :L] = np.asarray(q, dtype=np.int32)
        ql[n] = L
    return qc, ql


_forced_kernel: str | None = None


def stream_kernel(platform: str | None = None) -> str:
    """Scoring kernel of the stream route for a JAX platform: "cuda" on
    an NVIDIA GPU, "lax" (the lax twins) anywhere else.  With no platform
    given, a kernel set by :func:`forced_kernel` wins."""
    if platform is None:
        if _forced_kernel is not None:
            return _forced_kernel
        platform = jax.default_backend()
    return "cuda" if platform in ("gpu", "cuda") else "lax"


@contextlib.contextmanager
def forced_kernel(kernel: str):
    """Within the block, :func:`stream_kernel` answers ``kernel`` ("cuda"
    or "lax") whatever the platform.  For cross-checks of the CUDA kernel
    against the lax twin on one card: an engine takes its kernel when it
    is built, so build it inside the block."""
    global _forced_kernel
    if kernel not in ("cuda", "lax"):
        raise ValueError(f"unknown stream kernel {kernel!r}")
    prev, _forced_kernel = _forced_kernel, kernel
    try:
        yield
    finally:
        _forced_kernel = prev


def _resolve(kernel: str | None, matrix) -> str:
    kernel = kernel or stream_kernel()
    if kernel not in ("cuda", "lax"):
        raise ValueError(f"unknown stream kernel {kernel!r}")
    # the CUDA kernel keeps an int8 profile; wider matrices
    # (build_matrix_wide) score on the lax twin
    if kernel == "cuda" and matrix.dtype != jnp.int8:
        return "lax"
    return kernel


@functools.partial(
    jax.jit, static_argnames=("gapopenextend", "gapextend", "kernel"))
def sw_scores_stream(qcodes: jax.Array, qlens: jax.Array, matrix: jax.Array,
                     db: jax.Array, start: jax.Array, *,
                     gapopenextend: int, gapextend: int,
                     kernel: str | None = None) -> jax.Array:
    """Score queries against a lane-packed db chunk.

    qcodes: [NQ, QLEN] int32 query codes, PAD_SYMBOL padded (build_qcodes)
    qlens:  [NQ] int32 true query lengths
    matrix: [32, 32] int8 (build_matrix8) or int32 (build_matrix_wide)
    db:     [L, NSEQS] int8 lane-packed chunk (batching.pack_stream);
            L a multiple of KSEG
    start:  [L // KSEG, NSEQS] — nonzero where a lane begins a new
            sequence at that block
    kernel: "cuda" or "lax"; None picks by platform (stream_kernel)
    Returns [NQ, L // KSEG, NSEQS] int32: each lane's running max score
    after every block; a sequence's score is the value at its end block
    (gather_scores).
    """
    if _resolve(kernel, matrix) == "cuda":
        from .sw_cuda import sw_scores_stream_cuda
        return sw_scores_stream_cuda(qcodes, qlens, matrix, db, start,
                                     gapopenextend=gapopenextend,
                                     gapextend=gapextend)
    return sw_scores_stream_lax(qcodes, qlens, matrix, db, start,
                                gapopenextend=gapopenextend,
                                gapextend=gapextend)


@functools.partial(
    jax.jit, static_argnames=("gapopenextend", "gapextend", "kernel",
                              "carry_in", "carry_out"))
def sw_scores_stream_carry(qcodes: jax.Array, qlens: jax.Array,
                           matrix: jax.Array, db: jax.Array,
                           start: jax.Array, h: jax.Array, e: jax.Array,
                           s: jax.Array, *, gapopenextend: int,
                           gapextend: int, kernel: str | None = None,
                           carry_in: bool = True, carry_out: bool = True):
    """sw_scores_stream over ONE chunk of a carry or flow series.

    h/e: [NQ, QLEN, NSEQS] int32, s: [NQ, NSEQS] int32 — the per-lane DP
    state left by the previous chunk (make_stream_state for the first).
    Returns (scores [NQ, nblocks, NSEQS], h', e', s'); thread the state
    into the next chunk of the series.  Lanes that begin a new sequence
    at a chunk boundary reset on the start mask; only cut (continuing)
    lanes consume the carried state.

    ``carry_in=False`` scores the chunk from fresh state (h/e/s give the
    shape only); with ``carry_out=False`` no state is produced and the
    INPUT state is returned unchanged — do not thread it further.
    """
    if _resolve(kernel, matrix) == "cuda":
        from .sw_cuda import sw_scores_stream_cuda
        res = sw_scores_stream_cuda(
            qcodes, qlens, matrix, db, start,
            (h, e, s) if carry_in else None, gapopenextend=gapopenextend,
            gapextend=gapextend, carry_out=carry_out)
        return res if carry_out else (res, h, e, s)
    st = (h, e, s) if carry_in else make_stream_state(*h.shape)
    out, h2, e2, s2 = sw_scores_stream_lax_carry(
        qcodes, qlens, matrix, db, start, *st,
        gapopenextend=gapopenextend, gapextend=gapextend)
    return (out, h2, e2, s2) if carry_out else (out, h, e, s)


def make_stream_state(nq: int, qlen_pad: int, nseqs: int):
    """Fresh (h, e, s) carry state for a carry or flow series."""
    return (jnp.zeros((nq, qlen_pad, nseqs), jnp.int32),
            jnp.full((nq, qlen_pad, nseqs), NEG_INF, jnp.int32),
            jnp.zeros((nq, nseqs), jnp.int32))


@jax.jit
def permute_stream_state(h: jax.Array, e: jax.Array, s: jax.Array,
                         carry_src: jax.Array):
    """Gather a carry state across lanes by FlowChunk.carry_src.

    Between two chunks of a FLOW series (batching.pack_stream_flow) a cut
    sequence may continue on a different lane; this reindexes the carried
    per-lane DP state so lane i of the next launch holds the state of
    lane carry_src[i].  Fresh lanes (carry_src < 0) receive lane 0's
    state, which the next chunk's block-0 start mask discards anyway.
    The output's lane count is ``len(carry_src)`` — drain chunks narrow
    the state by passing a shorter carry_src.
    """
    src = jnp.where(carry_src < 0, 0, carry_src)
    return h[..., src], e[..., src], s[..., src]


@jax.jit
def gather_scores(out: jax.Array, end_block: jax.Array, lane: jax.Array
                  ) -> jax.Array:
    """[NQ, nseq] scores from the per-block dump (device-side gather).

    out: [NQ, nblocks, NSEQS] from sw_scores_stream; end_block/lane: [nseq]
    int32 per-sequence coordinates from batching.pack_stream.
    """
    return out[:, end_block, lane]


def _stream_lax_core(qcodes, qlens, matrix, db, start, h0, e0, s0, *,
                     gapopenextend: int, gapextend: int,
                     clamp: int | None):
    """Shared lax.scan implementation: returns (dumps, h, e, s)."""
    nq, qlen_pad = qcodes.shape
    L, nseqs = db.shape
    if L % KSEG:
        raise ValueError(f"db length {L} not a multiple of {KSEG}")
    Q, R = gapopenextend, gapextend
    nblocks = L // KSEG
    prof = matrix.astype(jnp.int32)                       # [32, 32]
    # the pad penalty must be strictly negative so H decays through
    # padding/overhang rows; for int8 matrices this is -128 (build_matrix8)
    pad_pen = jnp.minimum(jnp.min(prof), -1)
    dbb = db.astype(jnp.int32).reshape(nblocks, KSEG, nseqs)
    startb = (start != 0).reshape(nblocks, nseqs)
    iota_q = jnp.arange(qlen_pad, dtype=jnp.int32)[:, None]

    def one_query(qc, ql, h0, e0, s0):
        qprof = prof[qc]                                  # [QLEN, 32]
        qmask = iota_q < ql                               # [QLEN, 1]

        def block(carry, xs):
            h, e, s = carry
            cols, reset = xs
            h = jnp.where(reset[None, :], 0, h)
            e = jnp.where(reset[None, :], NEG_INF, e)
            s = jnp.where(reset, 0, s)

            def column(st, dj):
                h, e, s = st
                p = jnp.where(qmask, qprof[:, dj], pad_pen)
                e = jnp.maximum(e - R, h - Q)
                hd = jnp.concatenate(
                    [jnp.zeros((1, nseqs), jnp.int32), h[:-1, :]], axis=0)
                hnof = jnp.maximum(jnp.maximum(hd + p, e), 0)
                if clamp is not None:
                    hnof = jnp.minimum(hnof, clamp)
                t = jax.lax.cummax(hnof + iota_q * R, axis=0)
                f = jnp.concatenate(
                    [jnp.full((1, nseqs), NEG_INF, jnp.int32), t[:-1, :]],
                    axis=0) - (Q + jnp.maximum(iota_q - 1, 0) * R)
                h = jnp.maximum(hnof, f)
                if clamp is not None:
                    h = jnp.minimum(h, clamp)
                s = jnp.maximum(s, jnp.max(h, axis=0))
                return (h, e, s), None

            (h, e, s), _ = jax.lax.scan(column, (h, e, s), cols)
            return (h, e, s), s

        (h, e, s), dumps = jax.lax.scan(block, (h0, e0, s0), (dbb, startb))
        return dumps, h, e, s                             # [nblocks, NSEQS]

    return jax.vmap(one_query)(qcodes, qlens, h0, e0, s0)


@functools.partial(
    jax.jit,
    static_argnames=("gapopenextend", "gapextend", "clamp"),
)
def sw_scores_stream_lax(qcodes: jax.Array, qlens: jax.Array,
                         matrix: jax.Array, db: jax.Array,
                         start: jax.Array, *,
                         gapopenextend: int, gapextend: int,
                         clamp: int | None = None) -> jax.Array:
    """lax.scan twin of the stream kernel (same contract as
    sw_scores_stream): the CPU route and the CUDA kernel's oracle."""
    nq, qlen_pad = qcodes.shape
    _, nseqs = db.shape
    zvar = db[0, 0].astype(jnp.int32) * 0 + matrix[0, 0].astype(jnp.int32) * 0
    h0 = jnp.zeros((nq, qlen_pad, nseqs), jnp.int32) + zvar
    e0 = jnp.full((nq, qlen_pad, nseqs), NEG_INF, jnp.int32) + zvar
    s0 = jnp.zeros((nq, nseqs), jnp.int32) + zvar
    dumps, _, _, _ = _stream_lax_core(
        qcodes, qlens, matrix, db, start, h0, e0, s0,
        gapopenextend=gapopenextend, gapextend=gapextend, clamp=clamp)
    return dumps


@functools.partial(
    jax.jit,
    static_argnames=("gapopenextend", "gapextend", "clamp"),
)
def sw_scores_stream_lax_carry(qcodes: jax.Array, qlens: jax.Array,
                               matrix: jax.Array, db: jax.Array,
                               start: jax.Array, h: jax.Array,
                               e: jax.Array, s: jax.Array, *,
                               gapopenextend: int, gapextend: int,
                               clamp: int | None = None):
    """lax.scan twin of one carry-series chunk (same contract as
    sw_scores_stream_carry).  Accepts any integer score matrix."""
    dumps, h2, e2, s2 = _stream_lax_core(
        qcodes, qlens, matrix, db, start, h, e, s,
        gapopenextend=gapopenextend, gapextend=gapextend, clamp=clamp)
    return dumps, h2, e2, s2
