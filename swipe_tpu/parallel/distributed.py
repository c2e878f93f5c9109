"""SPMD execution over a device mesh: the MPI master/slave replacement.

The reference distributes dynamically over MPI point-to-point messages
(master/slave, /root/reference/swipe.cc:1793-2434): slaves score db chunks,
keep a local top-K, and the master merges the per-slave top-Ks exactly
(slaves keep at least K entries, swipe.cc:2182).  The equivalent here is
static SPMD: the packed db chunk is sharded across the mesh's "db" axis
(each device scores a disjoint lane range), every device reduces its scores
to a fixed-size per-device top-K with jax.lax.top_k, and the per-device
results are all-gathered and merged — exact for the same reason the MPI
merge is exact.  Work counters ride a psum, mirroring the tag_stats merge
(swipe.cc:1978-1992).

Queries can additionally be sharded over a second mesh axis ("q"), giving
the dp x q grid used for query-batch workloads.  Communication is a single
all-gather of (K x record) arrays per chunk, exactly mirroring the 8-long
tuple encoding the reference slaves ship to the master (swipe.cc:2304-2320).

Multi-process execution lives in :mod:`.multihost`
(``MultiHostEngine``): every host initializes ``jax.distributed``, packs
only its volume-aligned shard with global unit ids, scores on the global
mesh with the same per-device top-K + all-gather merge used here, and
the align phase routes each hit to its owning host — see that module's
docstring and tests/test_multihost.py for the N-process parity proof.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.sw_segment import sw_scores_lax

__all__ = ["make_mesh", "sharded_topk_scores", "merge_topk"]


def make_mesh(n_db: int | None = None, n_q: int = 1,
              devices=None) -> Mesh:
    """Create a (db, q) mesh over the available devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_db is None:
        n_db = len(devices) // n_q
    return Mesh(devices[: n_db * n_q].reshape(n_db, n_q), ("db", "q"))


def _topk_records(scores: jax.Array, base_unit: jax.Array, k: int
                  ) -> tuple[jax.Array, jax.Array]:
    """Per-device top-k of a [NQ, nsegs, NSEQS] score block.

    base_unit: [nsegs, NSEQS] int32 global unit ids (-1 for empty lanes).
    Returns (scores [NQ, k], units [NQ, k]).
    """
    nq = scores.shape[0]
    flat = scores.reshape(nq, -1)
    units = base_unit.reshape(-1)
    # empty lanes must lose: force their scores to a minimum
    flat = jnp.where(units[None, :] >= 0, flat, -1)
    k = min(k, flat.shape[1])
    top, idx = jax.lax.top_k(flat, k)
    # couple units to top so both share the same varying axes under
    # shard_map (unit ids are per-query anyway; zero-valued coupling)
    return top, units[idx] + top * 0


@functools.lru_cache(maxsize=64)
def _sharded_topk_fn(mesh: Mesh, nsegs: int, gapopenextend: int,
                     gapextend: int, k: int):
    """Jitted shard_map step for sharded_topk_scores, cached per config
    (a per-call jit would re-trace and re-compile every invocation)."""

    def per_device(qpt, db, seg_ids, unit_ids):
        scores = sw_scores_lax(qpt, db, seg_ids, nsegs=nsegs,
                          gapopenextend=gapopenextend, gapextend=gapextend)
        top, units = _topk_records(scores, unit_ids, k)
        # exact global merge: gather every device's local top-k
        top_all = jax.lax.all_gather(top, "db", axis=1, tiled=True)
        units_all = jax.lax.all_gather(units, "db", axis=1, tiled=True)
        # qpt.shape[0] is the LOCAL query count, so the global
        # query x unit product needs the psum over BOTH mesh axes
        # (tag_stats merge semantics, swipe.cc:1978-1992)
        cells = jnp.sum(jnp.where(unit_ids >= 0, 1, 0)) * qpt.shape[0]
        cells = jax.lax.psum(cells, ("db", "q"))
        return top_all, units_all, cells

    # check_vma=False: all_gather over "db" makes the outputs equal on
    # every db device, but this jax version's varying-axes inference does
    # not register that replication
    return jax.jit(jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P("q", None, None), P(None, "db"), P(None),
                  P(None, "db")),
        out_specs=(P("q", None), P("q", None), P()),
        check_vma=False,
    ))


def sharded_topk_scores(mesh: Mesh, qpt, db, seg_ids, unit_ids, *, nsegs: int,
                        gapopenextend: int, gapextend: int, k: int):
    """Score a segment-packed chunk (the lax route) sharded over the mesh
    and return merged top-k.

    qpt:      [NQ, QLEN, 32] int8 — replicated over "db", sharded over "q"
    db:       [L, NSEQS] int8 — lanes sharded over "db"
    seg_ids:  [nblocks+1] int32 — replicated
    unit_ids: [nsegs, NSEQS] int32 global unit numbers — sharded like db
    Returns (scores [NQ, n_db*k], units [NQ, n_db*k]) gathered on all
    devices, plus the psum'ed cell counter.
    """
    f = _sharded_topk_fn(mesh, nsegs, gapopenextend, gapextend, k)
    return f(qpt, db, seg_ids, unit_ids)


def merge_topk(scores: np.ndarray, units: np.ndarray, k: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side final merge of gathered per-device top-k lists.

    Sentinel padding entries (unit -1, masked to score -1 on device —
    below any legal SW score) sort last.  Returns
    ``(scores [NQ, kk], units [NQ, kk], counts [NQ])`` where ``counts[i]``
    is the number of REAL entries in row i: row i's results are exactly
    ``scores[i, :counts[i]]`` / ``units[i, :counts[i]]`` and the explicit
    count replaces the old "skip trailing unit<0 entries" convention.
    Entries at or beyond ``counts[i]`` are pinned to score -1 / unit -1.
    """
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    s = np.take_along_axis(scores, order, axis=1)
    u = np.take_along_axis(units, order, axis=1)
    real = u >= 0
    counts = real.sum(axis=1).astype(np.int64)
    kk = min(k, int(counts.max())) if u.size else 0
    s, u, real = s[:, :kk], u[:, :kk], real[:, :kk]
    # uniform sentinels past each row's count (device masking already
    # guarantees score -1 there, but pin it so the contract is typed,
    # not conventional)
    s = np.where(real, s, -1)
    u = np.where(real, u, -1)
    return s, u, np.minimum(counts, kk)


def shard_stream_chunk(chunk, n_db: int):
    """Split a StreamChunk's per-sequence coordinates per device.

    Lanes are assigned contiguously: device d owns lanes
    [d*nl, (d+1)*nl).  Returns (end_block, lane_local, unit) arrays of
    shape [n_db, M] (padded with unit -1), ready to shard over "db".
    """
    nseqs = chunk.nseqs
    if nseqs % n_db:
        raise ValueError(f"nseqs {nseqs} not divisible by n_db {n_db}")
    nl = nseqs // n_db
    dev = chunk.lane // nl
    groups = [np.nonzero(dev == d)[0] for d in range(n_db)]
    # width >= 1 so an empty chunk still yields well-formed [n_db, 1]
    # sentinel arrays (unit -1) instead of zero-width top_k inputs
    m = max(max(len(g) for g in groups), 1)
    eb = np.zeros((n_db, m), dtype=np.int32)
    ln = np.zeros((n_db, m), dtype=np.int32)
    un = np.full((n_db, m), -1, dtype=np.int32)
    for d, g in enumerate(groups):
        eb[d, : len(g)] = chunk.end_block[g]
        ln[d, : len(g)] = chunk.lane[g] - d * nl
        un[d, : len(g)] = chunk.seqnos[g]
    return eb, ln, un


@functools.lru_cache(maxsize=64)
def _sharded_stream_fn(mesh: Mesh, gapopenextend: int, gapextend: int,
                       k: int, kernel: str):
    """Jitted shard_map step for sharded_stream_topk, cached per config
    (an un-jitted shard_map dispatches op by op)."""
    from ..ops.sw_stream import sw_scores_stream

    def per_device(qc, ql, m8, db, st, eb, ln, un):
        out = sw_scores_stream(qc, ql, m8, db, st,   # [NQ, nblocks, NL_local]
                               gapopenextend=gapopenextend,
                               gapextend=gapextend, kernel=kernel)
        un = un[0]
        sc = out[:, eb[0], ln[0]]                # [NQ, M]
        top, units_top = _topk_records(sc[:, None, :], un[None, :], k)
        top_all = jax.lax.all_gather(top, "db", axis=1, tiled=True)
        units_all = jax.lax.all_gather(units_top, "db", axis=1, tiled=True)
        cells = jax.lax.psum(jnp.sum(jnp.where(un >= 0, 1, 0))
                             * qc.shape[0], ("db", "q"))
        return top_all, units_all, cells

    return jax.jit(jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P("q", None), P("q"), P(None, None), P(None, "db"),
                  P(None, "db"), P("db", None), P("db", None),
                  P("db", None)),
        out_specs=(P("q", None), P("q", None), P()),
        check_vma=False,
    ))


def sharded_stream_topk(mesh: Mesh, qcodes, qlens, matrix8, db, start,
                        eb, ln, units, *, gapopenextend: int,
                        gapextend: int, k: int):
    """Stream-route multi-device search step: shard lanes over "db",
    queries over "q"; per-device score + gather + top-k, then an exact
    all-gather merge (the MPI master/slave replacement for the production
    stream path; see module docstring).

    db/start: lane-packed chunk (batching.pack_stream), lanes sharded;
    eb/ln/units: [n_db, M] per-device coordinates (shard_stream_chunk).
    Scores with the platform's stream kernel (ops.sw_stream.stream_kernel).
    Returns (scores [NQ, n_db*k], units [NQ, n_db*k], psum'ed cell count).
    """
    from ..ops.sw_stream import stream_kernel
    f = _sharded_stream_fn(mesh, gapopenextend, gapextend, k,
                           stream_kernel())
    return f(qcodes, qlens, matrix8, db, start, eb, ln, units)
