"""Multi-device SPMD search on the virtual 8-device CPU mesh."""

import jax.numpy as jnp
import numpy as np
import pytest

from swipe_tpu.batching import pack_stream
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops.sw_ref import sw_numpy_many
from swipe_tpu.ops.sw_stream import build_matrix8, build_qcodes
from swipe_tpu.parallel.distributed import (make_mesh, merge_topk,
                                            shard_stream_chunk,
                                            sharded_stream_topk,
                                            sharded_topk_scores)


def test_sharded_topk_cells_global(devices8):
    # the cell counter must psum over BOTH mesh axes (each q-shard sees
    # only its local query count) — it used to undercount by n_q
    from swipe_tpu.batching import pack_database
    from swipe_tpu.ops.sw_segment import build_qpt
    rng = np.random.default_rng(3)
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    queries = [rng.integers(1, 26, size=40, dtype=np.int8)
               for _ in range(4)]
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in rng.integers(20, 100, size=512)]
    ch = pack_database(seqs, nseqs=128 * 4, max_cols=512)[0]
    mesh = make_mesh(n_db=4, n_q=2)
    qpt = jnp.asarray(build_qpt(queries, m.matrix, 64))
    unit_ids = np.asarray(ch.seqnos, dtype=np.int32)
    _, _, cells = sharded_topk_scores(
        mesh, qpt, jnp.asarray(ch.data), jnp.asarray(ch.seg_ids),
        jnp.asarray(unit_ids), nsegs=ch.seqnos.shape[0],
        gapopenextend=12, gapextend=1, k=16)
    want = int((unit_ids >= 0).sum()) * len(queries)
    assert int(np.asarray(cells)) == want


def test_sharded_stream_topk_exact(devices8):
    rng = np.random.default_rng(0)
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    queries = [rng.integers(1, 26, size=int(L), dtype=np.int8)
               for L in (40, 55)]
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in rng.integers(5, 120, size=3000)]
    # 8 devices x 128 local lanes
    ch = pack_stream(seqs, nseqs=1024)[0]
    eb, ln, un = shard_stream_chunk(ch, n_db=4)
    mesh = make_mesh(n_db=4, n_q=2)
    qc, ql = build_qcodes(queries, 64)
    k = 32
    scores, units, cells = sharded_stream_topk(
        mesh, jnp.asarray(qc), jnp.asarray(ql),
        jnp.asarray(build_matrix8(m.matrix)), jnp.asarray(ch.data),
        jnp.asarray(ch.start), jnp.asarray(eb), jnp.asarray(ln),
        jnp.asarray(un), gapopenextend=12, gapextend=1, k=k)
    top_s, top_u, cnt = merge_topk(np.asarray(scores), np.asarray(units), k)
    assert int(np.asarray(cells)) == len(seqs) * len(queries)
    assert (cnt == top_s.shape[1]).all()

    want = np.stack([sw_numpy_many(q, seqs, m.matrix, 11, 1)
                     for q in queries])
    for qi in range(len(queries)):
        ws = np.sort(want[qi])[::-1][:k]
        assert np.array_equal(top_s[qi], ws)
        # every reported (unit, score) pair is genuine
        for u, s in zip(top_u[qi], top_s[qi]):
            assert want[qi, u] == s


def test_sharded_stream_topk_sentinel_trim(devices8):
    # fewer real sequences than k per shard: sentinel (unit -1, score -1)
    # padding must never surface through merge_topk
    rng = np.random.default_rng(7)
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    queries = [rng.integers(1, 26, size=30, dtype=np.int8)]
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in rng.integers(5, 60, size=12)]
    ch = pack_stream(seqs, nseqs=512)[0]
    eb, ln, un = shard_stream_chunk(ch, n_db=4)
    mesh = make_mesh(n_db=4, n_q=1)
    qc, ql = build_qcodes(queries, 32)
    k = 16  # > 12 real sequences in total
    scores, units, cells = sharded_stream_topk(
        mesh, jnp.asarray(qc), jnp.asarray(ql),
        jnp.asarray(build_matrix8(m.matrix)), jnp.asarray(ch.data),
        jnp.asarray(ch.start), jnp.asarray(eb), jnp.asarray(ln),
        jnp.asarray(un), gapopenextend=12, gapextend=1, k=k)
    top_s, top_u, cnt = merge_topk(np.asarray(scores), np.asarray(units), k)
    assert top_u.shape[1] == len(seqs)
    # the explicit per-row count replaces the skip-unit<0 convention
    assert (cnt == len(seqs)).all()
    assert (top_u >= 0).all()
    want = sw_numpy_many(queries[0], seqs, m.matrix, 11, 1)
    assert np.array_equal(top_s[0], np.sort(want)[::-1])


@pytest.mark.parametrize("n_db,n_q", [(8, 1), (2, 4), (1, 8)])
def test_sharded_stream_mesh_shapes(devices8, n_db, n_q):
    rng = np.random.default_rng(n_db * 100 + n_q)
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    queries = [rng.integers(1, 26, size=int(L), dtype=np.int8)
               for L in rng.integers(20, 50, size=n_q)]
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in rng.integers(5, 100, size=600)]
    ch = pack_stream(seqs, nseqs=128 * n_db)[0]
    eb, ln, un = shard_stream_chunk(ch, n_db=n_db)
    mesh = make_mesh(n_db=n_db, n_q=n_q)
    qc, ql = build_qcodes(queries, 64)
    k = 16
    scores, units, cells = sharded_stream_topk(
        mesh, jnp.asarray(qc), jnp.asarray(ql),
        jnp.asarray(build_matrix8(m.matrix)), jnp.asarray(ch.data),
        jnp.asarray(ch.start), jnp.asarray(eb), jnp.asarray(ln),
        jnp.asarray(un), gapopenextend=12, gapextend=1, k=k)
    top_s, top_u, cnt = merge_topk(np.asarray(scores), np.asarray(units), k)
    assert (cnt == top_s.shape[1]).all()
    want = np.stack([sw_numpy_many(q, seqs, m.matrix, 11, 1)
                     for q in queries])
    for qi in range(n_q):
        assert np.array_equal(top_s[qi], np.sort(want[qi])[::-1][:k])
