"""Segment route (sw_scores_lax on segment packing) vs the NumPy oracle."""

import numpy as np
import pytest

from swipe_tpu.batching import pack_database
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops.sw_segment import (PAD_SYMBOL, SEG_BLK, build_qpt,
                                      sw_scores_lax)
from swipe_tpu.ops.sw_ref import sw_numpy_many


@pytest.fixture(scope="module")
def m62():
    return ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)


def _rand_seqs(rng, n, lo, hi):
    return [rng.integers(1, 26, size=int(rng.integers(lo, hi)),
                         dtype=np.int8) for _ in range(n)]


def _check_chunk(got, chunk, queries, seqs, matrix, go, ge):
    """got: [NQ, nsegs, NSEQS]; compare every real lane with the oracle."""
    want = np.stack([sw_numpy_many(q, seqs, matrix, go, ge) for q in queries])
    checked = 0
    for k in range(chunk.nsegs):
        for lane in range(chunk.nseqs):
            sn = chunk.seqnos[k, lane]
            if sn < 0:
                continue
            for qi in range(len(queries)):
                assert got[qi, k, lane] == want[qi, sn], (qi, k, lane, sn)
                checked += 1
    assert checked == len(seqs) * len(queries)


def test_lax_matches_oracle_multiseg(m62):
    rng = np.random.default_rng(0)
    queries = _rand_seqs(rng, 3, 10, 40)
    # spread lengths so packing creates several segments
    seqs = _rand_seqs(rng, 40, 5, 300)
    chunks = pack_database(seqs, nseqs=8)
    assert len(chunks) == 1
    ch = chunks[0]
    assert ch.nsegs >= 4
    qpt = build_qpt(queries, m62.matrix, qlen_pad=64)
    got = np.asarray(sw_scores_lax(qpt, ch.data, ch.seg_ids,
                                   nsegs=ch.nsegs, gapopenextend=12,
                                   gapextend=1))
    _check_chunk(got, ch, queries, seqs, m62.matrix, 11, 1)


def test_lax_matches_oracle_two_queries(m62):
    rng = np.random.default_rng(1)
    queries = _rand_seqs(rng, 2, 10, 50)
    seqs = _rand_seqs(rng, 30, 5, 200)
    ch = pack_database(seqs, nseqs=8)[0]
    qpt = build_qpt(queries, m62.matrix, qlen_pad=64)
    got = np.asarray(sw_scores_lax(
        qpt, ch.data, ch.seg_ids, nsegs=ch.nsegs, gapopenextend=12,
        gapextend=1))
    _check_chunk(got, ch, queries, seqs, m62.matrix, 11, 1)


def test_pallas_padded_segments_are_zero(m62):
    # nsegs beyond the blocks seg_ids names (pack_database pads the
    # segment count): those out rows are never written and must read
    # back as zeros
    rng = np.random.default_rng(9)
    queries = _rand_seqs(rng, 2, 10, 40)
    seqs = _rand_seqs(rng, 10, 5, 100)
    ch = pack_database(seqs, nseqs=8)[0]
    nsegs_pad = ch.nsegs + 3
    got = np.asarray(sw_scores_lax(
        build_qpt(queries, m62.matrix, qlen_pad=64), ch.data,
        ch.seg_ids, nsegs=nsegs_pad, gapopenextend=12, gapextend=1))
    assert got.shape[1] == nsegs_pad
    assert (got[:, ch.nsegs:, :] == 0).all()


def test_lax_state_carry_across_blocks(m62):
    # sequences longer than SEG_BLK: H/E state must carry across blocks
    rng = np.random.default_rng(2)
    queries = _rand_seqs(rng, 1, 30, 40)
    seqs = _rand_seqs(rng, 8, 3 * SEG_BLK, 5 * SEG_BLK)
    ch = pack_database(seqs, nseqs=8)[0]
    qpt = build_qpt(queries, m62.matrix, qlen_pad=64)
    got = np.asarray(sw_scores_lax(
        qpt, ch.data, ch.seg_ids, nsegs=ch.nsegs, gapopenextend=12,
        gapextend=1))
    _check_chunk(got, ch, queries, seqs, m62.matrix, 11, 1)


def test_clamped_tier_saturates(m62):
    # identical sequences score far beyond 127; the clamped tier must stick
    # at the clamp like SWIPE's 7-bit kernel saturates at its limit
    rng = np.random.default_rng(3)
    q = rng.integers(1, 26, size=60, dtype=np.int8)
    ch = pack_database([q.copy()], nseqs=8)[0]
    qpt = build_qpt([q], m62.matrix, qlen_pad=64)
    exact = np.asarray(sw_scores_lax(qpt, ch.data, ch.seg_ids,
                                     nsegs=ch.nsegs, gapopenextend=12,
                                     gapextend=1))
    clamped = np.asarray(sw_scores_lax(qpt, ch.data, ch.seg_ids,
                                       nsegs=ch.nsegs, gapopenextend=12,
                                       gapextend=1, clamp=127))
    assert exact[0, 0, 0] > 127
    assert clamped[0, 0, 0] == 127


def test_empty_lanes_score_zero(m62):
    rng = np.random.default_rng(4)
    queries = _rand_seqs(rng, 1, 10, 20)
    seqs = _rand_seqs(rng, 3, 10, 30)
    ch = pack_database(seqs, nseqs=8)[0]
    qpt = build_qpt(queries, m62.matrix, qlen_pad=32)
    got = np.asarray(sw_scores_lax(qpt, ch.data, ch.seg_ids, nsegs=ch.nsegs,
                                   gapopenextend=12, gapextend=1))
    for lane in range(8):
        if ch.seqnos[0, lane] < 0:
            assert got[0, 0, lane] == 0


def test_packing_occupancy_and_coverage():
    rng = np.random.default_rng(5)
    # Swiss-Prot-ish length distribution (lognormal around ~360)
    lens = np.clip(rng.lognormal(5.8, 0.5, size=65536).astype(int), 20, 3000)
    seqs = [np.ones(L, dtype=np.int8) for L in lens]
    chunks = pack_database(seqs, nseqs=512)
    total_cells = sum(c.data.size for c in chunks)
    occ = int(lens.sum()) / total_cells
    assert occ > 0.90, occ
    seen = sorted(int(sn) for c in chunks
                  for sn in c.seqnos.ravel() if sn >= 0)
    assert seen == list(range(65536))
    for c in chunks:
        assert c.n_cols % SEG_BLK == 0
        assert len(c.seg_ids) == c.n_cols // SEG_BLK + 1


def test_chunk_splitting_max_cols():
    rng = np.random.default_rng(6)
    seqs = _rand_seqs(rng, 64, 100, 400)
    chunks = pack_database(seqs, nseqs=4, max_cols=1024)
    assert len(chunks) > 1
    for c in chunks:
        # all chunks are bucketed shapes
        assert c.n_cols % 512 == 0


def test_build_qpt_padding(m62):
    q = np.array([1, 2, 3], dtype=np.int8)
    qpt = build_qpt([q], m62.matrix, qlen_pad=8)
    assert qpt.shape == (1, 8, 32)
    assert (qpt[0, 3:, :] == -128).all()
    assert (qpt[0, :, PAD_SYMBOL] == -128).all()
    assert qpt[0, 0, 1] == m62.matrix[1, 1]
