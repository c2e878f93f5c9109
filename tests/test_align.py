"""Tests for the gapped aligner (region + Myers-Miller traceback)."""

import numpy as np
import pytest

from swipe_tpu.align import align_py, region
from swipe_tpu.alphabet import MAP_NCBI_AA, encode
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops.sw_ref import sw_scalar


@pytest.fixture(scope="module")
def m62():
    return ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)


def walk_ops(ops, a, b, ab, bb, matrix, q, r):
    """Re-score an op string (like the display layer does) and return the
    score and end coordinates."""
    import re
    score = 0
    i, j = ab, bb
    for op, num in re.findall(r"([MDI])(\d+)", ops):
        n = int(num)
        if op == "M":
            for _ in range(n):
                score += matrix[a[i], b[j]]
                i += 1
                j += 1
        elif op == "D":
            score -= q + r * n
            i += n
        else:
            score -= q + r * n
            j += n
    return score, i - 1, j - 1


def _rand_seq(rng, n):
    return rng.integers(1, 26, size=n, dtype=np.int8)


def test_region_score_matches_oracle(m62):
    rng = np.random.default_rng(1)
    for _ in range(10):
        a = _rand_seq(rng, int(rng.integers(5, 50)))
        b = _rand_seq(rng, int(rng.integers(5, 70)))
        s, ab, bb, ae, be = region(a, b, m62.matrix, 11, 1)
        assert s == sw_scalar(a, b, m62.matrix, 11, 1)
        if s > 0:
            assert 0 <= ab <= ae < len(a)
            assert 0 <= bb <= be < len(b)


def test_alignment_opstring_rescores_exactly(m62):
    rng = np.random.default_rng(2)
    checked = 0
    for _ in range(20):
        a = _rand_seq(rng, int(rng.integers(10, 60)))
        b = _rand_seq(rng, int(rng.integers(10, 80)))
        s = sw_scalar(a, b, m62.matrix, 11, 1)
        if s == 0:
            continue
        score, ab, bb, ae, be, ops = align_py(a, b, m62.matrix, 11, 1)
        assert score == s
        ws, wi, wj = walk_ops(ops, a, b, ab, bb, m62.matrix, 11, 1)
        assert ws == s, f"op walk {ws} != score {s} (ops={ops})"
        assert (wi, wj) == (ae, be)
        checked += 1
    assert checked >= 5


def test_alignment_with_hint_matches_full(m62):
    rng = np.random.default_rng(3)
    a = _rand_seq(rng, 40)
    b = np.concatenate([_rand_seq(rng, 20), a[5:30], _rand_seq(rng, 15)])
    full = align_py(a, b, m62.matrix, 11, 1)
    hinted = align_py(a, b, m62.matrix, 11, 1,
                      hint=(full[0], full[3], full[4]))
    assert hinted == full


def test_perfect_match_alignment(m62):
    a = encode("AAWWAAWW", MAP_NCBI_AA)
    score, ab, bb, ae, be, ops = align_py(a, a, m62.matrix, 11, 1)
    assert ops == "M8"
    assert (ab, bb, ae, be) == (0, 0, 7, 7)


def test_gap_in_db(m62):
    # db has 3 extra residues in the middle -> I3 op
    a = encode("AAWWAAWW", MAP_NCBI_AA)
    b = encode("AAWWCCCAAWW", MAP_NCBI_AA)
    score, ab, bb, ae, be, ops = align_py(a, b, m62.matrix, 11, 1)
    assert score == 46
    assert ops == "M4I3M4"


def test_gap_in_query(m62):
    a = encode("AAWWCCCAAWW", MAP_NCBI_AA)
    b = encode("AAWWAAWW", MAP_NCBI_AA)
    score, ab, bb, ae, be, ops = align_py(a, b, m62.matrix, 11, 1)
    assert score == 46
    assert ops == "M4D3M4"


def test_local_trimming(m62):
    # poor prefix/suffix should be trimmed by the local alignment
    a = encode("WWWW", MAP_NCBI_AA)
    b = encode("AAAWWWWAAA", MAP_NCBI_AA)
    score, ab, bb, ae, be, ops = align_py(a, b, m62.matrix, 11, 1)
    assert score == 44
    assert (ab, ae) == (0, 3)
    assert (bb, be) == (3, 6)
    assert ops == "M4"


@pytest.mark.parametrize("go,ge", [(11, 1), (5, 2), (1, 1)])
def test_random_alignments_many_penalties(m62, go, ge):
    rng = np.random.default_rng(go * 100 + ge)
    for _ in range(8):
        a = _rand_seq(rng, int(rng.integers(8, 40)))
        b = _rand_seq(rng, int(rng.integers(8, 50)))
        s = sw_scalar(a, b, m62.matrix, go, ge)
        if s == 0:
            continue
        score, ab, bb, ae, be, ops = align_py(a, b, m62.matrix, go, ge)
        assert score == s
        ws, wi, wj = walk_ops(ops, a, b, ab, bb, m62.matrix, go, ge)
        assert ws == s


# ---- hint-pass tie semantics (search16s parity, VERDICT W5) ----------------

def _full_h_matrix(a, b, matrix, go, ge):
    """Textbook full H matrix (for brute-forcing the hint tie rules)."""
    mat = np.asarray(matrix, dtype=np.int64).reshape(32, 32)
    Q, R = go + ge, ge
    m, n = len(a), len(b)
    NEG = -(1 << 40)
    H = np.zeros((m + 1, n + 1), dtype=np.int64)
    E = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    F = np.full((m + 1, n + 1), NEG, dtype=np.int64)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            E[i, j] = max(E[i, j - 1] - R, H[i, j - 1] - Q)
            F[i, j] = max(F[i - 1, j] - R, H[i - 1, j] - Q)
            H[i, j] = max(0, H[i - 1, j - 1] + mat[a[i - 1], b[j - 1]],
                          E[i, j], F[i, j])
    return H[1:, 1:]


def _brute_hint(a, b, matrix, go, ge):
    """(score, bestq, bestpos) from the full matrix: bestpos = FIRST
    column attaining the final max, bestq = SMALLEST row attaining it in
    that column (search16s.cc:397-404,523-530)."""
    H = _full_h_matrix(a, b, matrix, go, ge)
    S = int(H.max())
    if S == 0:
        return 0, -1, 0
    colmax = H.max(axis=0)
    bestpos = int(np.argmax(colmax == S))
    bestq = int(np.argmax(H[:, bestpos] == S))
    return S, bestq, bestpos


def test_hint_first_improving_column(m62):
    from swipe_tpu.ops.align_hint import hint_endpoint
    # equal-score endpoints at columns 1 and 4: the FIRST one wins
    a = encode("AR", MAP_NCBI_AA)
    b = encode("ARWAR", MAP_NCBI_AA)
    s, bq, bp = hint_endpoint(a, b, m62.matrix, 11, 1)
    assert (s, bq, bp) == _brute_hint(a, b, m62.matrix, 11, 1)
    assert bp == 1 and bq == 1


def test_hint_smallest_row_in_column(m62):
    from swipe_tpu.ops.align_hint import hint_endpoint
    # two rows reach the max in the same column: smallest row wins
    a = encode("AA", MAP_NCBI_AA)
    b = encode("A", MAP_NCBI_AA)
    s, bq, bp = hint_endpoint(a, b, m62.matrix, 11, 1)
    assert (s, bq, bp) == _brute_hint(a, b, m62.matrix, 11, 1)
    assert bq == 0 and bp == 0


def test_hint_no_strict_improvement_keeps_first(m62):
    from swipe_tpu.ops.align_hint import hint_endpoint
    # a later column TIES the max but does not strictly improve it:
    # bestpos must stay at the first attainment
    a = encode("AA", MAP_NCBI_AA)
    b = encode("AWA", MAP_NCBI_AA)
    s, bq, bp = hint_endpoint(a, b, m62.matrix, 11, 1)
    assert (s, bq, bp) == _brute_hint(a, b, m62.matrix, 11, 1)
    assert bp == 0


def test_hint_endpoints_many_matches_scalar(m62):
    # the vectorized (per-bin) hint pass must be indistinguishable from
    # the per-hit scalar pass, ties included
    from swipe_tpu.ops.align_hint import hint_endpoint, hint_endpoints_many
    rng = np.random.default_rng(51)
    for go, ge, hi in ((11, 1, 26), (4, 2, 4)):
        q = rng.integers(1, hi, size=40, dtype=np.int8)
        dseqs = [rng.integers(1, hi, size=int(rng.integers(3, 120)),
                              dtype=np.int8) for _ in range(60)]
        got = hint_endpoints_many(q, dseqs, m62.matrix, go, ge)
        want = [hint_endpoint(q, d, m62.matrix, go, ge) for d in dseqs]
        assert got == want


def test_hint_device_twin_matches_numpy(m62):
    # the lax (device) hint pass must match the NumPy pass exactly,
    # including bucket padding and tie rules
    import numpy as _np

    from swipe_tpu.ops import align_hint as AH
    rng = np.random.default_rng(53)
    q = rng.integers(1, 5, size=37, dtype=np.int8)
    dseqs = [rng.integers(1, 5, size=int(rng.integers(5, 200)),
                          dtype=np.int8) for _ in range(21)]
    lens = _np.array([len(d) for d in dseqs], dtype=_np.int64)
    mat = _np.asarray(m62.matrix, dtype=_np.int64).reshape(32, 32)
    got = AH._hint_endpoints_lax(q.astype(_np.int64), dseqs, lens,
                                 mat, 12, 1)
    want = [AH.hint_endpoint(q, d, m62.matrix, 11, 1) for d in dseqs]
    assert got == want


def test_hint_lax_twin_matches_numpy_cases(m62):
    # the lax hint pass (search16s analog) must reproduce the NumPy pass
    # exactly — scores, smallest-row / first-column tie rules, and the
    # (-1, 0) no-score sentinel — across lane and row bucket padding
    from swipe_tpu.ops import align_hint as AH
    rng = np.random.default_rng(54)
    for go, ge, qlen in ((11, 1, 37), (4, 2, 130)):
        q = rng.integers(1, 4, size=qlen, dtype=np.int8)
        dseqs = [rng.integers(1, 4, size=int(rng.integers(3, 220)),
                              dtype=np.int8) for _ in range(19)]
        dseqs.append(np.array([25, 25, 25], dtype=np.int8))  # score-0 lane
        lens = np.array([len(d) for d in dseqs], dtype=np.int64)
        mat = np.asarray(m62.matrix, dtype=np.int64).reshape(32, 32)
        got = AH._hint_endpoints_lax(q.astype(np.int64), dseqs, lens,
                                     mat, go + ge, ge)
        want = [AH.hint_endpoint(q, d, m62.matrix, go, ge) for d in dseqs]
        assert got == want


def test_hint_lax_window_carry_matches_single_pass(m62):
    # the solo (unsegmentable-giant) route streams columns through fixed
    # windows with carried state: windowed == single-pass == the NumPy
    # scalar oracle, with a bucketed (padded) query-row dimension
    import jax
    import jax.numpy as jnp

    from swipe_tpu.ops import align_hint as AH
    rng = np.random.default_rng(60)
    q = rng.integers(1, 21, size=33, dtype=np.int8)
    d = rng.integers(1, 21, size=6000, dtype=np.int8)
    d[4100:4133] = q
    mat = np.asarray(m62.matrix, dtype=np.int64).reshape(32, 32)
    jit = jax.jit(AH._hint_lax_impl, static_argnames=("Q", "R"))
    QP, rowvalid, st, m_pad, n_pad = AH._hint_lax_args(q, mat, 1, None)
    assert m_pad == 64          # bucketed rows: one compile per bucket
    lens = np.zeros(n_pad, np.int32)
    lens[0] = len(d)

    def run(windows):
        state = AH._hint_lax_init(n_pad, m_pad)
        for c0, c1 in windows:
            dt = np.zeros((c1 - c0, n_pad), np.int8)
            seg = d[c0: min(c1, len(d))]
            dt[: len(seg), 0] = seg
            state = jit(QP, jnp.asarray(dt), jnp.asarray(lens), st,
                        rowvalid, state, jnp.int32(c0), Q=12, R=1)
        _, _, S, bq, bp = state
        return (int(np.asarray(S)[0]), int(np.asarray(bq)[0]),
                int(np.asarray(bp)[0]))

    want = AH._hint_scalar(q, d, mat, 12, 1)
    assert run([(0, 6144)]) == want
    assert run([(0, 2048), (2048, 6144)]) == want


def test_hint_unsegmentable_giant_routes_solo(m62, monkeypatch):
    # free gap extension kills the positive-span bound, so a
    # chromosome-scale subject must stream alone in bounded memory
    # instead of padding every batched lane to its length
    from swipe_tpu.ops import align_hint as AH
    monkeypatch.setattr(AH, "GIANT_HINT_MIN", 2048)
    rng = np.random.default_rng(61)
    q = rng.integers(1, 21, size=30, dtype=np.int8)
    mat = np.asarray(m62.matrix, dtype=np.int64).reshape(32, 32)
    dseqs = [rng.integers(1, 21, size=300, dtype=np.int8),
             rng.integers(1, 21, size=6000, dtype=np.int8)]
    dseqs[1][5000:5030] = q
    got = AH.hint_endpoints_many(q, dseqs, m62.matrix, 11, 0)
    want = [AH._hint_scalar(q, d, mat, 11, 0) for d in dseqs]
    assert got == want


def test_hint_lax_overhang_rows_high_gap(m62):
    # gapopenextend > 128 exceeds the PAD row score (-128), so a query
    # row past qlen (the row-bucket overhang) could beat the real rows'
    # column max at a segmented lane's first owned column; the lax pass
    # masks overhang rows out of the column max.  One lane plants a
    # full-query match just before its owned region so an overhang diag
    # step would win there if it were not masked.
    from swipe_tpu.ops import align_hint as AH
    rng = np.random.default_rng(58)
    q = rng.integers(1, 21, size=37, dtype=np.int8)      # 37 % 4 != 0
    dseqs = [rng.integers(1, 21, size=int(rng.integers(40, 200)),
                          dtype=np.int8) for _ in range(23)]
    planted = np.concatenate(
        [q, rng.integers(1, 21, size=80).astype(np.int8)])
    dseqs.append(planted)
    lens = np.array([len(d) for d in dseqs], dtype=np.int64)
    st = np.array([int(rng.integers(0, 30)) for _ in range(23)] + [37],
                  dtype=np.int64)
    mat = np.asarray(m62.matrix, dtype=np.int64).reshape(32, 32)
    got = AH._hint_endpoints_lax(q.astype(np.int64), dseqs, lens, mat,
                                 140, 1, starts=st)
    want = AH._hint_batch(q.astype(np.int64), dseqs, mat, 140, 1, st)
    assert got == want
    assert all(bq < 37 for _, bq, _ in got)  # no overhang row reported


def test_hinted_align_window_matches_full(m62):
    # with a hint, align() cuts the subject to the span-bound window
    # ending at b_end; result must be identical to the unwindowed
    # aligner on the full subject (coordinates in full-subject space)
    from swipe_tpu.align import align
    rng = np.random.default_rng(57)
    a = _rand_seq(rng, 45)
    for at in (900, 2600):   # window both clear of and clamped at 0-edge
        b = _rand_seq(rng, 3000)
        b[at:at + 30] = a[8:38]
        full = align_py(a, b, m62.matrix, 11, 1)
        score, ab, bb, ae, be, ops = full
        hint = (score, ae, be)
        want = align_py(a, b, m62.matrix, 11, 1, hint=hint)
        assert want == full
        got = align(a, b, m62.matrix, 11, 1, hint=hint)
        assert got == full
        # the windowed call must actually have triggered for the far case
        V = 45 + 45 * int(np.asarray(m62.matrix).max())
        if be + 1 > V:
            sub = b[be + 1 - V: be + 1]
            assert align_py(a, sub, m62.matrix, 11, 1,
                            hint=(score, ae, V - 1))[2] + be + 1 - V == bb


def test_hint_giant_segmented_matches_unsegmented(m62, monkeypatch):
    # chromosome-scale subjects segment into overlapped pieces (the
    # transpose of the search phase's segmented-giant scoring); the
    # merged (S, bestq, bestpos) must be bit-identical to the
    # unsegmented pass, including the first-global-column tie when the
    # same maximal match is planted twice
    from swipe_tpu.ops import align_hint as AH
    rng = np.random.default_rng(55)
    q = rng.integers(1, 21, size=40, dtype=np.int8)
    d = rng.integers(1, 21, size=6000, dtype=np.int8)
    d[2480:2540] = rng.integers(1, 21, size=60, dtype=np.int8)
    d[2500:2530] = q[5:35]
    d[4680:4740] = d[2480:2540]           # identical copy + flanks: tie
    mat = np.asarray(m62.matrix, dtype=np.int64).reshape(32, 32)
    q64 = np.asarray(q, dtype=np.int64)
    want_giant = AH._hint_batch(q64, [np.asarray(d)], mat, 12, 1, None)[0]
    short = d[:100]
    want_short = AH._hint_batch(q64, [np.asarray(short)], mat, 12, 1,
                                None)[0]
    monkeypatch.setattr(AH, "GIANT_HINT_MIN", 1024)
    got = AH.hint_endpoints_many(q, [d, short, d], m62.matrix, 11, 1)
    assert got == [want_giant, want_short, want_giant]
    # the planted tie must resolve to the FIRST copy's global column
    assert got[0][2] < 2600


def test_hint_device_routes_honor_starts(m62):
    # the device twin (lax scan) must apply the per-lane
    # first-tracked-column mask exactly like the NumPy pass
    from swipe_tpu.ops import align_hint as AH
    rng = np.random.default_rng(56)
    q = rng.integers(1, 5, size=33, dtype=np.int8)
    dseqs = [rng.integers(1, 5, size=int(rng.integers(40, 220)),
                          dtype=np.int8) for _ in range(13)]
    lens = np.array([len(d) for d in dseqs], dtype=np.int64)
    starts = np.array([int(rng.integers(0, max(2, L // 2)))
                       for L in lens], dtype=np.int64)
    mat = np.asarray(m62.matrix, dtype=np.int64).reshape(32, 32)
    q64 = q.astype(np.int64)
    want = AH._hint_batch(q64, [np.asarray(d) for d in dseqs], mat,
                          12, 1, starts)
    got_lax = AH._hint_endpoints_lax(q64, dseqs, lens, mat, 12, 1, starts)
    assert got_lax == want


def test_align_all_threads_identical():
    # -a N fans the gapped tracebacks over a worker pool; output must be
    # byte-identical to the serial align phase
    import io

    from swipe_tpu.io.db import FastaDatabase
    from swipe_tpu.io.fasta import preprocess_query
    from swipe_tpu.pipeline import SearchEngine, SearchParams
    rng = np.random.default_rng(52)
    AAl = list("ARNDCQEGHILKMFPSTWYV")
    q = "".join(rng.choice(AAl, 60))
    fasta = ""
    for i in range(80):
        s = "".join(rng.choice(AAl, int(rng.integers(40, 200))))
        if i % 7 == 0:
            s = s[:10] + q[5:50] + s[10:]
        fasta += f">s{i} t{i}\n{s}\n"
    db = FastaDatabase(io.StringIO(fasta), "aa", title="thr")
    query = preprocess_query("q", q, 1, 3)

    def run(threads):
        params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                              descriptions=80, alignments=40, expect=1e9,
                              threads=threads)
        return SearchEngine(db, params, nseqs=8, backend="lax").search(query)

    a, b = run(1), run(4)
    assert [(h.seqno, h.score_align, h.alignment, h.align_q_start,
             h.align_d_start) for h in a.hits] == \
           [(h.seqno, h.score_align, h.alignment, h.align_q_start,
             h.align_d_start) for h in b.hits]


@pytest.mark.parametrize("go,ge", [(11, 1), (4, 2)])
def test_hint_ties_match_bruteforce_random(m62, go, ge):
    from swipe_tpu.ops.align_hint import hint_endpoint
    rng = np.random.default_rng(go * 10 + ge)
    # tiny alphabet maximizes multi-optimal-endpoint collisions
    for _ in range(30):
        a = rng.integers(1, 4, size=int(rng.integers(3, 16)), dtype=np.int8)
        b = rng.integers(1, 4, size=int(rng.integers(3, 25)), dtype=np.int8)
        got = hint_endpoint(a, b, m62.matrix, go, ge)
        want = _brute_hint(a, b, m62.matrix, go, ge)
        if want[0] == 0:
            assert got[0] == 0
            continue
        assert got == want, (a.tolist(), b.tolist(), got, want)


def test_hint_many_zero_gapextend(m62):
    # free gap extension (-E 0) makes the positive-score span unbounded:
    # _span_bound must disable giant segmentation (it used to divide by
    # zero) and the batched pass must still match the scalar one
    from swipe_tpu.ops import align_hint as AH
    assert AH._span_bound(40, int(m62.matrix.max()), 0) is None
    rng = np.random.default_rng(77)
    q = rng.integers(1, 26, size=30, dtype=np.int8)
    dseqs = [rng.integers(1, 26, size=int(rng.integers(10, 120)),
                          dtype=np.int8) for _ in range(12)]
    got = AH.hint_endpoints_many(q, dseqs, m62.matrix, 12, 0)
    want = [AH.hint_endpoint(q, d, m62.matrix, 12, 0) for d in dseqs]
    assert got == want


def test_align_empty_subject_fatal(m62):
    # empty query/subject pairs score 0 and must trip the internal-error
    # fatal (the reference binary SEGFAULTS fetching + aligning an empty
    # db sequence under -c 0; our fatal is the non-UB equivalent of its
    # score-0 behavior) — the NumPy region() used to die on H.max() of a
    # zero-size array instead
    import pytest as _pytest
    a = np.arange(1, 21, dtype=np.int8)
    empty = np.zeros(0, dtype=np.int8)
    for x, y in ((a, empty), (empty, a), (empty, empty)):
        with _pytest.raises(RuntimeError, match="Internal error"):
            align_py(x, y, m62.matrix, 11, 1)


def test_hint_endpoints_grid_matches_per_bin(m62):
    # the batched pass over many (query, bin) jobs must equal the per-bin
    # results exactly, across different query lengths, subject scales,
    # score-0 lanes and a segmented giant
    from swipe_tpu.ops import align_hint as AH
    rng = np.random.default_rng(77)
    jobs = []
    for qlen, n, dmax in ((37, 7, 150), (130, 19, 400), (64, 3, 60)):
        q = rng.integers(1, 26, size=qlen, dtype=np.int8)
        ds = [rng.integers(1, 26, size=int(rng.integers(3, dmax)),
                           dtype=np.int8) for _ in range(n)]
        ds.append(np.array([25, 25, 25], dtype=np.int8))   # score-0 lane
        jobs.append((q, ds))
    # one subject above the giant threshold takes the segmented path
    qg = rng.integers(1, 26, size=40, dtype=np.int8)
    giant = rng.integers(1, 26, size=AH.GIANT_HINT_MIN + 7,
                         dtype=np.int8)
    jobs.append((qg, [giant]))
    got = AH.hint_endpoints_grid(jobs, m62.matrix, 11, 1)
    for (q, ds), res in zip(jobs, got):
        want = AH.hint_endpoints_many(q, ds, m62.matrix, 11, 1)
        assert res == want
