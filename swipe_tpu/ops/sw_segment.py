"""Segment-packed Smith-Waterman scoring (lax.scan): the ``lax`` backend.

The reference scores inter-sequence SIMD lanes (/root/reference/search7.cc,
search16.cc, search63.cc).  Here a *segment* of ``NSEQS`` length-sorted
database sequences occupies the lane axis and the whole query occupies the
row axis, so one vector step updates ``QLEN x NSEQS`` DP cells; segments are
concatenated along the db axis and a block->segment map drives the
per-segment reset and score dump.  The per-column gap chain along the query
axis (SWIPE's F) is resolved exactly with a weighted prefix max:
      F[q] = max_{k<q}(Hnof[k] - Q - (q-1-k) R)
           = prefixmax(Hnof[k] + k R)[q-1] - Q - (q-1) R,
exact because opening a gap from inside a gap never beats extending (the
same domination SWIPE's ONESTEP relies on).

Arithmetic is exact int32 in one pass; ``clamp`` reproduces the saturating
7/16-bit tiers, and tier accounting lives in pipeline._count_tiers.  The
production route is the lane stream (ops.sw_stream); this path serves the
explicit ``backend="lax"`` of the CPU tests and golden parity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["sw_scores_lax", "build_qpt", "PAD_SYMBOL", "NEG_INF", "SEG_BLK"]

PAD_SYMBOL = 31       # db/query padding symbol; profile row/col forced -128
NEG_INF = -(1 << 30)  # -inf stand-in that survives adds without overflow
SEG_BLK = 32          # db columns per grid block; segment length granularity


def build_qpt(queries: list[np.ndarray], matrix: np.ndarray,
              qlen_pad: int, dtype=np.int8) -> np.ndarray:
    """Transposed query profiles [NQ, qlen_pad, 32].

    QPT[n, q, s] = matrix[query_n[q], s]; rows beyond a query's length and
    the PAD_SYMBOL column are strongly negative so padded cells decay
    instead of scoring.  Pass np.int32 for matrices outside int8 range.
    """
    m = np.asarray(matrix, dtype=np.int64)
    info = np.iinfo(dtype)
    if m.min() < info.min or m.max() > info.max:
        raise ValueError(
            f"score matrix must fit {np.dtype(dtype).name} for this kernel")
    pad = max(int(info.min), -(1 << 20))
    nq = len(queries)
    qpt = np.full((nq, qlen_pad, 32), pad, dtype=dtype)
    for n, q in enumerate(queries):
        L = len(q)
        if L > qlen_pad:
            raise ValueError(f"query {n} longer than qlen_pad ({L} > {qlen_pad})")
        qpt[n, :L, :] = m[np.asarray(q, dtype=np.int64), :].astype(dtype)
        qpt[n, :, PAD_SYMBOL] = pad
    return qpt


@functools.partial(
    jax.jit,
    static_argnames=("nsegs", "gapopenextend", "gapextend", "clamp"),
)
def sw_scores_lax(qpt: jax.Array, db: jax.Array, seg_ids: jax.Array, *,
                  nsegs: int, gapopenextend: int, gapextend: int,
                  clamp: int | None = None) -> jax.Array:
    """Score queries against a segment-packed db chunk (lax.scan).

    qpt:     [NQ, QLEN, 32] transposed query profiles (build_qpt)
    db:      [L, NSEQS] int8 packed chunk; L multiple of SEG_BLK; column
             ranges belong to segments per seg_ids; PAD_SYMBOL padding
    seg_ids: [L // SEG_BLK + 1] int32 nondecreasing block->segment map
             (last entry duplicates the final segment)
    Returns [NQ, nsegs, NSEQS] int32 local alignment scores (exact when
    clamp is None, saturating at ``clamp`` otherwise).
    """
    nq, qlen, _ = qpt.shape
    L, nseqs = db.shape
    if L % SEG_BLK:
        raise ValueError(f"db length {L} not a multiple of {SEG_BLK}")
    Q, R = gapopenextend, gapextend
    nblocks = L // SEG_BLK
    iota_q = jnp.arange(qlen, dtype=jnp.int32)[:, None]
    qr_vec = iota_q * R
    f_off = Q + jnp.maximum(iota_q - 1, 0) * R
    # per-column segment id and segment-start flag
    col_seg = jnp.repeat(seg_ids[:nblocks], SEG_BLK)
    col_start = jnp.concatenate(
        [jnp.ones(1, jnp.bool_), col_seg[1:] != col_seg[:-1]])

    def one_query(qp):
        qp32 = qp.astype(jnp.int32)  # [QLEN, 32]

        def column(state, xs):
            h, e, s, out = state
            dj, seg, start = xs

            def reset(args):
                h, e, s = args
                return (jnp.zeros_like(h), jnp.full_like(e, NEG_INF),
                        jnp.zeros_like(s))

            h, e, s = jax.lax.cond(start, reset, lambda a: a, (h, e, s))
            p = qp32[:, dj]  # [QLEN, NSEQS]
            e = jnp.maximum(e - R, h - Q)
            hd = jnp.concatenate(
                [jnp.zeros((1, nseqs), jnp.int32), h[:-1, :]], axis=0)
            hnof = jnp.maximum(jnp.maximum(hd + p, e), 0)
            if clamp is not None:
                hnof = jnp.minimum(hnof, clamp)
            t = jax.lax.cummax(hnof + qr_vec, axis=0)
            f = jnp.concatenate(
                [jnp.full((1, nseqs), NEG_INF, jnp.int32), t[:-1, :]],
                axis=0) - f_off
            h = jnp.maximum(hnof, f)
            if clamp is not None:
                h = jnp.minimum(h, clamp)
            s = jnp.maximum(s, h)
            out = out.at[seg].max(jnp.max(s, axis=0))
            return (h, e, s, out), None

        # derive the init carry from db and the query profile so its
        # varying-axes metadata matches the scan body under shard_map
        # (zero-valued, free after fusion)
        zvar = (db[0, 0].astype(jnp.int32) * 0
                + qp32[0, 0] * 0)
        init = (jnp.zeros((qlen, nseqs), jnp.int32) + zvar,
                jnp.full((qlen, nseqs), NEG_INF, jnp.int32) + zvar,
                jnp.zeros((qlen, nseqs), jnp.int32) + zvar,
                jnp.zeros((nsegs, nseqs), jnp.int32) + zvar)
        (_, _, _, out), _ = jax.lax.scan(
            column, init, (db.astype(jnp.int32), col_seg, col_start))
        return out

    return jax.vmap(one_query)(qpt)
