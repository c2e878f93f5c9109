"""Alignment-endpoint hint pass (the reference's search16s equivalent).

Parity target: /root/reference/search16s.cc:297-548.  For each hit that will
be displayed, the reference runs a CDEPTH=1 16-bit kernel that, whenever the
running maximum S strictly increases after a column, records

* ``bestpos`` — the 0-based db offset of that column (i.e. the FIRST column
  at which the final maximum is attained), and
* ``bestq``  — the SMALLEST query row whose H equals S in that column
  (the i loop scans qlen-1..0 and lets smaller i overwrite).

hits_align then skips the forward region pass and starts the reverse pass
from (bestq, bestpos) — but only when ``bestq > 0`` and ``bestpos != 0``
(hits.cc:587-595), and only when the score is below SCORELIMIT_16.  These
tie-breaking semantics differ from the forward region scan (which picks the
smallest query row overall), so reproducing them is required for alignment
parity when several optimal endpoints exist.

Host-side NumPy implementation (exact: the int16 kernel cannot saturate for
scores below SCORELIMIT_16); runs once per displayed hit.
"""

from __future__ import annotations

import numpy as np

__all__ = ["hint_endpoint", "hint_endpoints_many", "hint_endpoints_grid"]

NEG = -(1 << 40)


def hint_endpoint(qseq: np.ndarray, dseq: np.ndarray, matrix: np.ndarray,
                  gapopen: int, gapextend: int
                  ) -> tuple[int, int, int]:
    """Return (score, bestq, bestpos) with search16s tie semantics."""
    if len(dseq) > GIANT_HINT_MIN:
        return hint_endpoints_many(qseq, [np.asarray(dseq)], matrix,
                                   gapopen, gapextend)[0]
    mat = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    return _hint_scalar(qseq, dseq, mat, gapopen + gapextend, gapextend)


def _hint_scalar(qseq, dseq, mat, Q, R) -> tuple[int, int, int]:
    """The O(qlen)-state column-streamed hint pass (one subject)."""
    q = np.asarray(qseq, dtype=np.int64)
    d = np.asarray(dseq, dtype=np.int64)
    m = len(q)
    QP = mat[q, :].T  # (32, m)

    H = np.zeros(m, dtype=np.int64)
    E = np.full(m, NEG, dtype=np.int64)
    idxR = np.arange(m, dtype=np.int64) * R
    S = 0
    bestpos = 0
    bestq = -1
    for j, dj in enumerate(d):
        P = QP[dj]
        E = np.maximum(E - R, H - Q)
        diag = np.concatenate(([0], H[:-1]))
        hnof = np.maximum(np.maximum(diag + P, E), 0)
        A = np.maximum.accumulate(hnof + idxR)
        F = np.concatenate(([NEG], A[:-1])) - Q - idxR + R
        H = np.maximum(hnof, F)
        colmax = int(H.max())
        if colmax > S:
            S = colmax
            bestpos = j
            bestq = int(np.argmax(H == S))  # smallest row attaining S
    return S, bestq, bestpos


# int32 is provably sufficient for the batched passes: scores are
# bounded by qlen * max(matrix) << 2^31 and the sentinel only ever
# decays by R per column (bounded db lengths keep it far from overflow)
NEG32 = -(1 << 28)

# batched workloads above this many DP cells run the lax twin on the
# device when JAX runs on an accelerator (a NumPy hint pass would
# dominate wall clock for -b 100 against long db sequences; the
# reference runs search16s at SIMD speed for the same reason)
DEVICE_CELLS = 50_000_000

# subjects longer than this segment into overlapped pieces for the hint
# pass (the transpose of the search phase's segmented-giant scoring): a
# lone chromosome otherwise runs one lane through maxlen sequential
# columns, which is latency-bound on every backend
GIANT_HINT_MIN = 1 << 18


def _span_bound(m: int, maxS: int, R: int) -> int | None:
    """Max db-span of a positive-score local alignment (same argument
    as pipeline.SearchEngine._overlap_bound): pairs contribute at most
    m * maxS and each unpaired db residue costs at least R.  With free
    gap extension (R == 0) the span is unbounded — no segmentation."""
    if maxS <= 0 or R <= 0:
        return None
    return m + -(-m * maxS // R)


def hint_endpoints_many(qseq: np.ndarray, dseqs: list[np.ndarray],
                        matrix: np.ndarray, gapopen: int, gapextend: int
                        ) -> list[tuple[int, int, int]]:
    """hint_endpoint for MANY db sequences at once (same query).

    One vectorized pass over [nhits, qlen] state — the reference runs
    its hint kernel on the whole displayed-hit bin per thread
    (align_chunk, swipe.cc:339-414).  Tie semantics are identical to
    hint_endpoint (first column attaining the final max; smallest row
    within it).  Large batches run on the attached accelerator via the
    lax twin; small ones stay in NumPy (no dispatch/compile latency).

    Chromosome-scale subjects segment into overlapped pieces that run
    as parallel lanes (EXACT: a positive-score alignment spans at most
    _span_bound db columns, so every colmax over a piece's OWNED
    columns — those at least that far from the piece start — is the
    true colmax; ownership partitions the columns, so merging by
    (max S, then smallest global column) reproduces the unsegmented
    first-improving-column/smallest-row tie semantics bit-for-bit).
    """
    if not dseqs:
        return []
    q = np.asarray(qseq, dtype=np.int64)
    m = len(q)
    mat = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    Q = gapopen + gapextend
    R = gapextend

    V = _span_bound(m, int(mat.max()), R)
    giants, solos = [], []
    for i, d in enumerate(dseqs):
        if len(d) <= GIANT_HINT_MIN:
            continue
        if V is not None and len(d) > 4 * V:
            giants.append(i)
        elif V is None:
            # unsegmentable chromosome-scale subject (free gap extension
            # or an all-negative matrix): batching it would pad every
            # lane of the bin to its length — run it alone through the
            # bounded column-streamed pass instead
            solos.append(i)
    if not giants and not solos:
        return _hint_batch(q, [np.asarray(d) for d in dseqs], mat, Q, R,
                           None)

    results: list[tuple[int, int, int] | None] = [None] * len(dseqs)
    skip = set(giants) | set(solos)
    normals = [i for i in range(len(dseqs)) if i not in skip]
    if normals:
        for i, res in zip(normals, _hint_batch(
                q, [np.asarray(dseqs[i]) for i in normals], mat, Q, R,
                None)):
            results[i] = res
    for i in solos:
        results[i] = _hint_solo(q, np.asarray(dseqs[i]), mat, Q, R)
    if not giants:
        return results

    pieces, starts, owner, gpos = [], [], [], []
    for i in giants:
        d = np.asarray(dseqs[i])
        N = len(d)
        stride = max(2 * V, -(-N // 1024), 2048)
        stride = -(-stride // 256) * 256
        for pos in range(0, max(N - V, 1), stride):
            pieces.append(d[pos: pos + stride + V])
            starts.append(0 if pos == 0 else V)
            owner.append(i)
            gpos.append(pos)
    res = _hint_batch(q, pieces, mat, Q, R,
                      np.asarray(starts, dtype=np.int64))
    best: dict[int, tuple[int, int, int]] = {}
    for (s, bq, bp), i, pos in zip(res, owner, gpos):
        cur = best.get(i)
        if cur is None or s > cur[0] or (s == cur[0] and 0 <= bq
                                         and pos + bp < cur[2]):
            best[i] = (s, bq, pos + bp) if bq >= 0 else (s, bq, bp)
    for i in giants:
        results[i] = best[i]
    return results


def hint_endpoints_grid(jobs, matrix, gapopen: int, gapextend: int):
    """hint_endpoints_many for MANY (query, subject-list) bins at once.

    ``jobs`` is a list of (qseq, dseqs) — one bin per (query, qstrand,
    qframe) of an align phase (the reference runs search16s per thread
    over its bin, swipe.cc:339-414).  Each bin takes hint_endpoints_many:
    NumPy for small bins, the lax twin on the device above DEVICE_CELLS.
    Returns a list of per-bin result lists, aligned with ``jobs``.
    """
    return [hint_endpoints_many(np.asarray(q), dseqs, matrix, gapopen,
                                gapextend) for q, dseqs in jobs]


def _hint_batch(q, dseqs, mat, Q, R, starts):
    """Batched hint pass with optional per-lane first-tracked column
    (``starts``: columns before a lane's start never update S/bq/bp —
    the owned-column mask of the segmented-giant route)."""
    lens = np.array([len(d) for d in dseqs], dtype=np.int64)
    n = len(dseqs)
    m = len(q)
    maxlen = int(lens.max())
    if starts is None:
        starts = np.zeros(n, dtype=np.int64)

    if n * maxlen * m > DEVICE_CELLS and _on_device():
        return _hint_endpoints_lax(q, dseqs, lens, mat, Q, R, starts)

    QP = mat[q, :].T.astype(np.int32)                 # (32, m)
    dense = np.zeros((n, maxlen), dtype=np.int8)
    for i, d in enumerate(dseqs):
        dense[i, : len(d)] = np.asarray(d, dtype=np.int8)

    H = np.zeros((n, m), dtype=np.int32)
    E = np.full((n, m), NEG32, dtype=np.int32)
    idxR = (np.arange(m, dtype=np.int64) * R).astype(np.int32)
    S = np.zeros(n, dtype=np.int32)
    bestpos = np.zeros(n, dtype=np.int64)
    bestq = np.full(n, -1, dtype=np.int64)
    for j in range(maxlen):
        active = j < lens
        if not active.any():
            break
        P = QP[dense[:, j], :]                        # (n, m)
        E = np.maximum(E - R, H - Q)
        diag = np.concatenate(
            [np.zeros((n, 1), dtype=np.int32), H[:, :-1]], axis=1)
        hnof = np.maximum(np.maximum(diag + P, E), 0)
        A = np.maximum.accumulate(hnof + idxR, axis=1)
        F = np.concatenate(
            [np.full((n, 1), NEG32, dtype=np.int32), A[:, :-1]],
            axis=1) - Q - idxR + R
        H = np.maximum(hnof, F)
        colmax = H.max(axis=1)
        improve = active & (colmax > S) & (j >= starts)
        if improve.any():
            rows = np.argmax(H == colmax[:, None], axis=1)
            S = np.where(improve, colmax, S)
            bestpos = np.where(improve, j, bestpos)
            bestq = np.where(improve, rows, bestq)
        H = np.where(active[:, None], H, 0)
        E = np.where(active[:, None], E, NEG32)
    return [(int(S[i]), int(bestq[i]), int(bestpos[i])) for i in range(n)]


_HINT_UNROLL = 8


def _hint_lax_impl(QP, dense_t, lens, starts, rowvalid, state, col0, Q, R):
    """lax twin of the batched hint pass: scan over db columns,
    _HINT_UNROLL columns per scan step (a bare per-column scan is
    step-overhead-bound on tiny [n, m] state).

    QP: [32, m] int32 (m bucketed — pad rows carry a zero profile and
    rowvalid masks them out of the column max; zeroing their H is exact
    because the DP only flows DOWN rows, so pad rows feed nothing back);
    dense_t: [W, n] int8; lens: [n] int32 GLOBAL lengths; starts: [n]
    int32 per-lane first-tracked column (the segmented giant route's
    owned-column mask; zeros for whole sequences); state: the
    (H, E, S, bq, bp) carry (fresh from _hint_lax_init, or the previous
    window's output when a chromosome-scale subject streams through
    fixed windows); col0: this window's global column offset.
    Tie semantics identical to the NumPy pass (argmax = smallest row /
    first improving column).  Returns the full state.
    """
    import jax
    import jax.numpy as jnp

    m = QP.shape[1]
    n = dense_t.shape[1]
    idxR = jnp.arange(m, dtype=jnp.int32) * R
    T = _HINT_UNROLL

    def column(state, sym, j):
        H, E, S, bq, bp = state
        P = QP[sym]                                   # [n, m]
        E = jnp.maximum(E - R, H - Q)
        diag = jnp.concatenate(
            [jnp.zeros((n, 1), jnp.int32), H[:, :-1]], axis=1)
        hnof = jnp.maximum(jnp.maximum(diag + P, E), 0)
        A = jax.lax.cummax(hnof + idxR, axis=1)
        F = jnp.concatenate(
            [jnp.full((n, 1), NEG32, jnp.int32), A[:, :-1]],
            axis=1) - Q - idxR + R
        H = jnp.maximum(hnof, F)
        H = jnp.where(rowvalid, H, 0)     # bucketed query rows, see above
        colmax = H.max(axis=1)
        active = j < lens
        improve = active & (colmax > S) & (j >= starts)
        rows = jnp.argmax(H == colmax[:, None], axis=1).astype(jnp.int32)
        S = jnp.where(improve, colmax, S)
        bp = jnp.where(improve, j, bp)
        bq = jnp.where(improve, rows, bq)
        H = jnp.where(active[:, None], H, 0)
        E = jnp.where(active[:, None], E, NEG32)
        return H, E, S, bq, bp

    def step(state, xs):
        syms, j0 = xs                                 # [T, n], scalar
        for t in range(T):
            state = column(state, syms[t], j0 + t)
        return state, None

    maxlen = dense_t.shape[0]
    state, _ = jax.lax.scan(
        step, state,
        (dense_t.reshape(maxlen // T, T, n),
         col0 + jnp.arange(0, maxlen, T, dtype=jnp.int32)))
    return state


def _hint_lax_init(n, m):
    import jax.numpy as jnp
    return (jnp.zeros((n, m), jnp.int32),
            jnp.full((n, m), NEG32, jnp.int32),
            jnp.zeros((n,), jnp.int32),
            jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,), jnp.int32))


_hint_lax_jit = None


def _on_device() -> bool:
    """True when JAX runs on an accelerator (the batched hint passes then
    run there; on the CPU they stay in NumPy)."""
    import jax
    return jax.default_backend() != "cpu"


def _hint_lax_args(q, mat, n, starts):
    """Bucketed QP/rowvalid/starts for the lax hint (query rows to 64,
    lanes to 8 — repeated align phases reuse one compiled program)."""
    import jax.numpy as jnp
    m = len(q)
    m_pad = max(64, -(-m // 64) * 64)
    QP = np.zeros((32, m_pad), dtype=np.int32)
    QP[:, :m] = mat[q, :].T
    rowvalid = np.zeros(m_pad, dtype=bool)
    rowvalid[:m] = True
    n_pad = -(-n // 8) * 8
    st_pad = np.zeros(n_pad, dtype=np.int32)
    if starts is not None:
        st_pad[:n] = starts
    return (jnp.asarray(QP), jnp.asarray(rowvalid), jnp.asarray(st_pad),
            m_pad, n_pad)


def _hint_endpoints_lax(q, dseqs, lens, mat, Q, R, starts=None):
    import jax.numpy as jnp

    global _hint_lax_jit
    if _hint_lax_jit is None:
        import jax
        _hint_lax_jit = jax.jit(_hint_lax_impl,
                                static_argnames=("Q", "R"))
    n = len(dseqs)
    QP, rowvalid, st_pad, m_pad, n_pad = _hint_lax_args(q, mat, n, starts)
    maxlen = int(lens.max())
    len_pad = -(-maxlen // 2048) * 2048
    dense_t = np.zeros((len_pad, n_pad), dtype=np.int8)
    for i, d in enumerate(dseqs):
        dense_t[: len(d), i] = np.asarray(d, dtype=np.int8)
    lens_pad = np.zeros(n_pad, dtype=np.int32)
    lens_pad[:n] = lens
    _, _, S, bq, bp = _hint_lax_jit(
        QP, jnp.asarray(dense_t), jnp.asarray(lens_pad), st_pad, rowvalid,
        _hint_lax_init(n_pad, m_pad), jnp.int32(0), Q=int(Q), R=int(R))
    S, bq, bp = np.asarray(S), np.asarray(bq), np.asarray(bp)
    return [(int(S[i]), int(bq[i]), int(bp[i])) for i in range(n)]


# columns per window of the solo (unsegmentable-giant) stream:
# 1 M columns x 8 lanes x 1 B upload + [8, m] carried state per window
_SOLO_WINDOW = 1 << 20


def _hint_solo(q, d, mat, Q, R):
    """Bounded-memory hint pass for ONE unsegmentable chromosome-scale
    subject (free gap extension or an all-negative matrix, where the
    positive-span bound does not exist): stream its columns through
    fixed windows with the (H, E, S, bq, bp) state carried between them
    — the reference's O(qlen)-state single-channel streaming
    (search16s.cc), never an n x maxlen dense allocation."""
    if not _on_device():
        return _hint_scalar(q, d, mat, Q, R)

    import jax
    import jax.numpy as jnp

    global _hint_lax_jit
    if _hint_lax_jit is None:
        _hint_lax_jit = jax.jit(_hint_lax_impl,
                                static_argnames=("Q", "R"))
    QP, rowvalid, st_pad, m_pad, n_pad = _hint_lax_args(q, mat, 1, None)
    N = len(d)
    lens_pad = np.zeros(n_pad, dtype=np.int32)
    lens_pad[0] = N
    lens_dev = jnp.asarray(lens_pad)
    state = _hint_lax_init(n_pad, m_pad)
    for col0 in range(0, N, _SOLO_WINDOW):
        dense_t = np.zeros((_SOLO_WINDOW, n_pad), dtype=np.int8)
        win = np.asarray(d[col0: col0 + _SOLO_WINDOW], dtype=np.int8)
        dense_t[: len(win), 0] = win
        state = _hint_lax_jit(QP, jnp.asarray(dense_t), lens_dev, st_pad,
                              rowvalid, state, jnp.int32(col0),
                              Q=int(Q), R=int(R))
    _, _, S, bq, bp = state
    return (int(np.asarray(S)[0]), int(np.asarray(bq)[0]),
            int(np.asarray(bp)[0]))
