"""The stream route (lane refill) + LPT packer vs the NumPy oracle.

On the CPU the platform route (sw_scores_stream / sw_scores_stream_carry)
scores with the lax twins; on a GPU the same calls reach the CUDA kernel
(tests/test_sw_cuda.py and chip_smoke.py compare the two exactly)."""

import numpy as np
import pytest

from swipe_tpu.batching import pack_stream
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops.sw_ref import sw_numpy_many
from swipe_tpu.ops.sw_stream import (KSEG, build_matrix8, build_qcodes,
                                     gather_scores, make_stream_state,
                                     permute_stream_state, sw_scores_stream,
                                     sw_scores_stream_carry,
                                     sw_scores_stream_lax,
                                     sw_scores_stream_lax_carry)


@pytest.fixture(scope="module")
def m62():
    return ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)


def _rand_seqs(rng, n, lo, hi):
    return [rng.integers(1, 26, size=int(rng.integers(lo, hi)),
                         dtype=np.int8) for _ in range(n)]


def _run(queries, seqs, m, qlen_pad=128, nseqs=1024, max_cols=65536):
    chunks = pack_stream(seqs, nseqs=nseqs, max_cols=max_cols)
    qc, ql = build_qcodes(queries, qlen_pad)
    m8 = build_matrix8(m.matrix)
    got = np.zeros((len(queries), len(seqs)), dtype=np.int64)
    for ch in chunks:
        out = sw_scores_stream(qc, ql, m8, ch.data, ch.start,
                               gapopenextend=12, gapextend=1)
        sc = np.asarray(gather_scores(out, ch.end_block, ch.lane))
        got[:, ch.seqnos] = sc
    return got, chunks


def test_stream_matches_oracle(m62):
    rng = np.random.default_rng(0)
    queries = _rand_seqs(rng, 2, 10, 50)
    seqs = _rand_seqs(rng, 2200, 1, 150)
    got, chunks = _run(queries, seqs, m62)
    want = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                     for q in queries])
    assert np.array_equal(got, want)


def test_stream_multi_chunk_and_long_seqs(m62):
    # sequences spanning many blocks force cross-block H/E state carry;
    # a small max_cols forces several kernel launches
    rng = np.random.default_rng(1)
    queries = _rand_seqs(rng, 1, 30, 40)
    seqs = _rand_seqs(rng, 4000, 5, 6 * KSEG)
    got, chunks = _run(queries, seqs, m62, max_cols=KSEG * 8)
    assert len(chunks) > 1
    want = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                     for q in queries])
    assert np.array_equal(got, want)


def test_stream_clamped_tier_saturates(m62):
    # identical long sequences score far beyond 127; clamp must stick
    rng = np.random.default_rng(2)
    s = rng.integers(1, 26, size=200, dtype=np.int8)
    seqs = [s] + _rand_seqs(rng, 1023, 10, 30)
    chunks = pack_stream(seqs, nseqs=1024)
    qc, ql = build_qcodes([s], 256)
    m8 = build_matrix8(m62.matrix)
    ch = chunks[0]
    out = sw_scores_stream_lax(qc, ql, m8, ch.data, ch.start,
                               gapopenextend=12, gapextend=1, clamp=127)
    sc = np.asarray(gather_scores(out, ch.end_block, ch.lane))
    got = {int(sn): int(v) for sn, v in zip(ch.seqnos, sc[0])}
    assert got[0] == 127  # saturated, flags escalation


def test_pack_stream_occupancy():
    rng = np.random.default_rng(3)
    lens = np.clip(rng.lognormal(5.8, 0.5, 20_000).astype(int), 20, 3000)
    seqs = [np.zeros(int(L), dtype=np.int8) for L in lens]
    chunks = pack_stream(seqs, nseqs=1024, max_cols=65536)
    occ = sum(c.residues for c in chunks) / sum(c.data.size for c in chunks)
    assert occ > 0.9
    # every sequence is placed exactly once
    all_ids = np.concatenate([c.seqnos for c in chunks])
    assert sorted(all_ids.tolist()) == list(range(len(seqs)))


def test_stream_lax_matches_oracle(m62):
    import jax.numpy as jnp

    from swipe_tpu.ops.sw_stream import sw_scores_stream_lax
    rng = np.random.default_rng(6)
    queries = _rand_seqs(rng, 2, 10, 50)
    seqs = _rand_seqs(rng, 300, 1, 150)
    chunks = pack_stream(seqs, nseqs=128)
    qc, ql = build_qcodes(queries, 64)
    m8 = build_matrix8(m62.matrix)
    got = np.zeros((2, len(seqs)), dtype=np.int64)
    for ch in chunks:
        out = sw_scores_stream_lax(
            jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(m8),
            jnp.asarray(ch.data), jnp.asarray(ch.start),
            gapopenextend=12, gapextend=1)
        sc = np.asarray(gather_scores(out, ch.end_block, ch.lane))
        got[:, ch.seqnos] = sc
    want = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                     for q in queries])
    assert np.array_equal(got, want)


def test_stream_long_query_matches_oracle(m62):
    # queries of several lengths padded to one 256-row bucket: rows past a
    # query's length see the pad penalty and never raise a score
    rng = np.random.default_rng(9)
    queries = [rng.integers(1, 26, size=int(L), dtype=np.int8)
               for L in (250, 40, 130)]
    seqs = _rand_seqs(rng, 1100, 1, 200)
    got, _ = _run(queries, seqs, m62, qlen_pad=256)
    want = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                     for q in queries])
    assert np.array_equal(got, want)


def test_all_kernels_agree_randomized(m62):
    """Property test: the stream route, the stream lax twin, the segment
    lax route and the NumPy oracle agree on random shapes/penalties
    across several seeds."""
    import jax.numpy as jnp

    from swipe_tpu.batching import pack_database
    from swipe_tpu.ops.sw_segment import build_qpt, sw_scores_lax

    for seed in range(3):
        rng = np.random.default_rng(1000 + seed)
        go = int(rng.integers(5, 15))
        ge = int(rng.integers(1, 4))
        nq = int(rng.integers(1, 3))
        queries = _rand_seqs(rng, nq, 5, 80)
        seqs = _rand_seqs(rng, int(rng.integers(100, 400)), 1, 120)
        want = np.stack([sw_numpy_many(q, seqs, m62.matrix, go, ge)
                         for q in queries])
        qlen_pad = 128
        qc, ql = build_qcodes(queries, qlen_pad)
        m8 = build_matrix8(m62.matrix)

        # the platform route + the stream lax twin on the lane packing
        for ch in pack_stream(seqs, nseqs=1024):
            a = sw_scores_stream(qc, ql, m8, ch.data, ch.start,
                                 gapopenextend=go + ge, gapextend=ge)
            b = sw_scores_stream_lax(
                jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(m8),
                jnp.asarray(ch.data), jnp.asarray(ch.start),
                gapopenextend=go + ge, gapextend=ge)
            sa = np.asarray(gather_scores(a, ch.end_block, ch.lane))
            sb = np.asarray(gather_scores(b, ch.end_block, ch.lane))
            assert np.array_equal(sa, want[:, ch.seqnos]), (seed, "stream")
            assert np.array_equal(sb, want[:, ch.seqnos]), (seed, "slax")

        # segmented lax on the segment packing
        for ch in pack_database(seqs, nseqs=16):
            qpt = build_qpt(queries, m62.matrix, qlen_pad)
            out = np.asarray(sw_scores_lax(
                qpt, ch.data, ch.seg_ids, nsegs=ch.seqnos.shape[0],
                gapopenextend=go + ge, gapextend=ge))
            for k in range(ch.seqnos.shape[0]):
                for lane in range(ch.nseqs):
                    sn = ch.seqnos[k, lane]
                    if sn >= 0:
                        assert (out[:, k, lane] == want[:, sn]).all(), seed


@pytest.mark.parametrize("nq", [2, 3, 5, 7])
def test_stream_query_batch_matches_oracle(m62, nq):
    # a batch of queries rides the kernel's query axis; scores must be
    # identical for any batch size, including odd ones
    rng = np.random.default_rng(40 + nq)
    queries = _rand_seqs(rng, nq, 10, 60)
    seqs = _rand_seqs(rng, 1500, 1, 120)
    got, _ = _run(queries, seqs, m62, qlen_pad=64)
    want = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                     for q in queries])
    assert np.array_equal(got, want)


def test_pack_stream_carry_bounds_and_coverage():
    # every chunk footprint <= nseqs x max_cols regardless of member
    # length; every sequence ends exactly once; cuts at block multiples
    from swipe_tpu.batching import pack_stream_carry
    rng = np.random.default_rng(21)
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in [40000, 9000] + list(rng.integers(1, 300, size=500))]
    chunks = pack_stream_carry(seqs, nseqs=64, max_cols=1024)
    assert all(c.data_t.shape[1] <= 1024 for c in chunks[:-1])
    assert all(c.data_t.shape[0] == 64 for c in chunks)
    ends = np.concatenate([c.seqnos for c in chunks if len(c.seqnos)])
    assert sorted(ends.tolist()) == list(range(len(seqs)))
    # total start marks == number of sequences (each starts exactly once)
    assert sum(int(c.start.sum()) for c in chunks) == len(seqs)
    # residues conserved across pieces
    assert sum(c.residues for c in chunks) == sum(len(s) for s in seqs)


def test_stream_carry_matches_oracle(m62):
    # sequences cut across many carry chunks must score exactly like the
    # uncut oracle, through the platform route and the lax twin
    from swipe_tpu.batching import pack_stream_carry
    rng = np.random.default_rng(22)
    queries = _rand_seqs(rng, 2, 20, 60)
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in [1500, 700] + list(rng.integers(1, 120, size=600))]
    chunks = pack_stream_carry(seqs, nseqs=1024, max_cols=256)
    assert len(chunks) >= 4   # giants must span several chunks
    want = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                     for q in queries])
    qc, ql = build_qcodes(queries, 64)
    m8 = build_matrix8(m62.matrix)

    for step in (sw_scores_stream_carry, sw_scores_stream_lax_carry):
        # chunks are compact: the state has the chunks' own lane count
        h, e, s = make_stream_state(2, 64, chunks[0].nseqs)
        got = np.zeros((2, len(seqs)), dtype=np.int64)
        for ch in chunks:
            out, h, e, s = step(qc, ql, m8, ch.data, ch.start, h, e, s,
                                gapopenextend=12, gapextend=1)
            if len(ch.seqnos):
                got[:, ch.seqnos] = np.asarray(
                    gather_scores(out, ch.end_block, ch.lane))
        assert np.array_equal(got, want), step.__name__


def test_stream_carry_long_matches_oracle(m62):
    # tall queries x sequences cut across carry chunks: every combination
    # of (query length, chunk cut, lane refill) must score exactly like
    # the uncut oracle; the fresh first chunk takes carry_in=False
    from swipe_tpu.batching import pack_stream_carry
    rng = np.random.default_rng(29)
    queries = [rng.integers(1, 26, size=150, dtype=np.int8),
               rng.integers(1, 26, size=40, dtype=np.int8)]
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in [1400, 620] + list(rng.integers(1, 120, size=500))]
    chunks = pack_stream_carry(seqs, nseqs=1024, max_cols=256)
    assert len(chunks) >= 4
    want = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                     for q in queries])
    qc, ql = build_qcodes(queries, 192)
    m8 = build_matrix8(m62.matrix)

    h, e, s = make_stream_state(2, 192, chunks[0].nseqs)
    got = np.zeros((2, len(seqs)), dtype=np.int64)
    for i, ch in enumerate(chunks):
        out, h, e, s = sw_scores_stream_carry(
            qc, ql, m8, ch.data, ch.start, h, e, s,
            gapopenextend=12, gapextend=1, carry_in=i > 0)
        if len(ch.seqnos):
            got[:, ch.seqnos] = np.asarray(
                gather_scores(out, ch.end_block, ch.lane))
    assert np.array_equal(got, want)


def test_stream_carry_wide_matrix_lax():
    # non-int8 matrices route through build_matrix_wide + the lax twin
    import jax.numpy as jnp

    from swipe_tpu.batching import pack_stream_carry
    from swipe_tpu.ops.sw_stream import build_matrix_wide
    m = ScoreMatrix.nucleotide(200, -300, 400, 200)
    rng = np.random.default_rng(23)
    # nt16 codes 1..15
    queries = [rng.integers(1, 15, size=30, dtype=np.int8)]
    seqs = [rng.integers(1, 15, size=int(L), dtype=np.int8)
            for L in (900, 50, 70)]
    chunks = pack_stream_carry(seqs, nseqs=8, max_cols=256)
    want = np.stack([sw_numpy_many(q, seqs, m.matrix, 400, 200)
                     for q in queries])
    qc, ql = build_qcodes(queries, 32)
    mw = build_matrix_wide(m.matrix)
    h, e, s = make_stream_state(1, 32, chunks[0].nseqs)
    got = np.zeros((1, len(seqs)), dtype=np.int64)
    for ch in chunks:
        # the int32 matrix routes the platform call to the lax twin
        dumps, h, e, s = sw_scores_stream_carry(
            jnp.asarray(qc), jnp.asarray(ql), jnp.asarray(mw),
            jnp.asarray(ch.data), jnp.asarray(ch.start), h, e, s,
            gapopenextend=600, gapextend=200)
        if len(ch.seqnos):
            got[:, ch.seqnos] = np.asarray(
                gather_scores(dumps, ch.end_block, ch.lane))
    assert np.array_equal(got, want)


def test_pack_stream_oversized_sequence(m62):
    # one sequence longer than max_cols becomes its own oversized chunk
    # and still scores exactly
    rng = np.random.default_rng(13)
    big = rng.integers(1, 26, size=3000, dtype=np.int8)
    seqs = [big] + _rand_seqs(rng, 200, 5, 60)
    chunks = pack_stream(seqs, nseqs=1024, max_cols=512)
    assert any(c.n_cols > 512 for c in chunks)
    qc, ql = build_qcodes([seqs[5]], 64)
    m8 = build_matrix8(m62.matrix)
    got = np.zeros(len(seqs), dtype=np.int64)
    for ch in chunks:
        out = sw_scores_stream(qc, ql, m8, ch.data, ch.start,
                               gapopenextend=12, gapextend=1)
        got[ch.seqnos] = np.asarray(
            gather_scores(out, ch.end_block, ch.lane))[0]
    want = sw_numpy_many(seqs[5], seqs, m62.matrix, 11, 1)
    assert np.array_equal(got, want)


def test_stream_flow_matches_oracle(m62):
    """Flow series (pack_stream_flow): sequences cut at chunk capacity,
    continued next chunk on permuted lanes (permute_stream_state), with
    narrow drain chunks — scores must equal the NumPy oracle exactly."""
    _check_flow(m62, 42, (37, 64), 64, (900, 1400, 2000, 2600))


def test_stream_flow_tall_query_matches_oracle(m62):
    """The same flow walk with a 128-row query bucket."""
    _check_flow(m62, 21, (100, 57), 128, (800, 1300))


def _check_flow(m62, seed, qlens, qlen_pad, tail):
    import jax.numpy as jnp

    from swipe_tpu.batching import pack_stream_flow
    rng = np.random.default_rng(seed)
    # heavy tail: forces multi-chunk cut chains and narrow drains
    lens = np.concatenate([rng.integers(5, 200, 600), tail])
    rng.shuffle(lens)
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8) for L in lens]
    queries = [rng.integers(1, 26, size=int(L), dtype=np.int8)
               for L in qlens]
    chunks = pack_stream_flow(seqs, nseqs=1024, max_cols=256,
                              drain_cols=128)
    assert len(chunks) > 2          # the tail must actually chain
    qc, ql = build_qcodes(queries, qlen_pad)
    qc, ql = jnp.asarray(qc), jnp.asarray(ql)
    m8 = jnp.asarray(build_matrix8(m62.matrix))
    got = np.zeros((2, len(seqs)), dtype=np.int64)
    h = e = s = None
    for i, ch in enumerate(chunks):
        if i == 0:
            h, e, s = make_stream_state(2, qlen_pad, ch.nseqs)
        else:
            h, e, s = permute_stream_state(h, e, s,
                                           jnp.asarray(ch.carry_src))
        out, h, e, s = sw_scores_stream_carry(
            qc, ql, m8, jnp.asarray(ch.data), jnp.asarray(ch.start),
            h, e, s, gapopenextend=12, gapextend=1, carry_in=i > 0)
        if len(ch.seqnos):
            got[:, ch.seqnos] = np.asarray(
                gather_scores(out, jnp.asarray(ch.end_block),
                              jnp.asarray(ch.lane)))
    want = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                     for q in queries])
    assert np.array_equal(got, want)


def test_stream_flow_matches_oracle_lax():
    """Same flow-series walk through the any-backend lax twin (3-D state
    layout through permute_stream_state)."""
    import jax.numpy as jnp

    from swipe_tpu.batching import pack_stream_flow
    m62 = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    rng = np.random.default_rng(43)
    lens = np.concatenate([rng.integers(5, 120, 150), [700, 1100]])
    rng.shuffle(lens)
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8) for L in lens]
    q = rng.integers(1, 26, size=48, dtype=np.int8)
    chunks = pack_stream_flow(seqs, nseqs=1024, max_cols=128,
                              drain_cols=128)
    qc, ql = build_qcodes([q], 48)
    qc, ql = jnp.asarray(qc), jnp.asarray(ql)
    m8 = jnp.asarray(build_matrix8(m62.matrix))
    got = np.zeros(len(seqs), dtype=np.int64)
    h = e = s = None
    for i, ch in enumerate(chunks):
        if i == 0:
            h, e, s = make_stream_state(1, 48, ch.nseqs)
        else:
            h, e, s = permute_stream_state(h, e, s,
                                           jnp.asarray(ch.carry_src))
        out, h, e, s = sw_scores_stream_lax_carry(
            qc, ql, m8, jnp.asarray(ch.data), jnp.asarray(ch.start),
            h, e, s, gapopenextend=12, gapextend=1)
        if len(ch.seqnos):
            got[ch.seqnos] = np.asarray(
                gather_scores(out, jnp.asarray(ch.end_block),
                              jnp.asarray(ch.lane)))[0]
    want = sw_numpy_many(q, seqs, m62.matrix, 11, 1)
    assert np.array_equal(got, want)


def test_stream_flow_query_batch_matches_oracle(m62):
    """Queries of different lengths in one batch over a flow series with
    lane permutes between chunks: a shorter query's overhang rows ride
    the pad penalty, and the carried state of every query threads
    through the cuts exactly."""
    import jax.numpy as jnp

    from swipe_tpu.batching import pack_stream_flow
    rng = np.random.default_rng(33)
    queries = [rng.integers(1, 26, size=int(L), dtype=np.int8)
               for L in (60, 23, 41, 64)]
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8)
            for L in [900, 500] + list(rng.integers(1, 150, size=700))]
    chunks = pack_stream_flow(seqs, nseqs=1024, max_cols=128,
                              drain_cols=64)
    assert len(chunks) >= 3
    want = np.stack([sw_numpy_many(q, seqs, m62.matrix, 11, 1)
                     for q in queries])
    qc, ql = build_qcodes(queries, 64)
    m8 = build_matrix8(m62.matrix)
    got = np.zeros((4, len(seqs)), dtype=np.int64)
    h = e = s = None
    for i, ch in enumerate(chunks):
        if i == 0:
            h, e, s = make_stream_state(4, 64, ch.nseqs)
        else:
            h, e, s = permute_stream_state(h, e, s,
                                           jnp.asarray(ch.carry_src))
        out, h, e, s = sw_scores_stream_carry(
            qc, ql, m8, ch.data, ch.start, h, e, s,
            gapopenextend=12, gapextend=1)
        if len(ch.seqnos):
            got[:, ch.seqnos] = np.asarray(
                gather_scores(out, ch.end_block, ch.lane))
    assert np.array_equal(got, want)
