"""The Hopper stream kernel (native/sw_stream.cu) without a card.

A CUDA kernel has no interpret mode, so these tests keep what surrounds it
in reach of the CPU:

* ``_emulate`` replays the kernel's own schedule in NumPy: G threads per
  (query, lane) pair, RPT rows per thread, the one-step skew between
  threads, the values passed down by ``__shfl_up_sync``, the strip loop
  with its boundary scratch, resets at block starts and the unadvanced E
  of the last column.  It is checked against the lax twin, which is the
  kernel's oracle, for every thread layout ``kernel_config`` picks.
* the wrapper (``sw_scores_stream_cuda``) runs with the emulator in place
  of the FFI call: lane-major layout, column pieces of tall queries and
  the carried state must give the lax twin's answers.
* the choice of kernel by platform, and the error (no fallback) when the
  library cannot be built.

On the card the compiled kernel is compared with the same oracle by
``chip_smoke.py`` and by the ``chip`` tests below.
"""

import numpy as np
import pytest

from swipe_tpu.batching import pack_stream, pack_stream_carry
from swipe_tpu.matrices import ScoreMatrix
from swipe_tpu.ops import sw_cuda, sw_stream
from swipe_tpu.ops.sw_stream import (build_matrix8, build_qcodes,
                                     make_stream_state,
                                     sw_scores_stream_lax,
                                     sw_scores_stream_lax_carry)

NEG_INF = -(1 << 30)


def _emulate(qcodes, qlens, matrix8, pad_pen, db_t, start_t, h_in, e_in,
             s_in, *, gapopenextend, gapextend, group, rows, nstrips,
             carry_in, carry_out):
    """NumPy replay of sw_stream_kernel<group, rows> (same argument list
    as sw_cuda._ffi_call)."""
    qcodes, qlens = np.asarray(qcodes), np.asarray(qlens)
    mat = np.asarray(matrix8).astype(np.int64)
    pad = int(np.asarray(pad_pen)[0])
    db_t, start_t = np.asarray(db_t), np.asarray(start_t)
    nq, qlen_pad = qcodes.shape
    nseqs, L = db_t.shape
    G, RPT, SH = group, rows, group * rows
    Q, R = gapopenextend, gapextend
    P = nq * nseqs
    qi = np.repeat(np.arange(nq), nseqs)           # pair -> query
    li = np.tile(np.arange(nseqs), nq)             # pair -> lane
    tt = np.arange(G)
    dumps = np.zeros((nq, L // 16, nseqs), np.int64)
    h_out = np.zeros((nq, qlen_pad, nseqs), np.int64)
    e_out = np.zeros((nq, qlen_pad, nseqs), np.int64)
    s_out = np.zeros((nq, nseqs), np.int64)
    bnd = np.zeros((P, L, 3), np.int64)
    if carry_in:
        h_in, e_in, s_in = (np.asarray(x).astype(np.int64)
                            for x in (h_in, e_in, s_in))
    for strip in range(nstrips):
        top, bottom = strip == 0, strip == nstrips - 1
        rowi = strip * SH + tt[:, None] * RPT + np.arange(RPT)  # [G, RPT]
        # profile [P, 32, G, RPT]
        prof = np.full((P, 32, G, RPT), pad, np.int64)
        for p in range(P):
            q = qi[p]
            real = rowi < qlens[q]
            codes = qcodes[q][np.minimum(rowi, qlen_pad - 1)] & 31
            prof[p] = np.where(real[None], mat[codes].transpose(2, 0, 1),
                               pad)
        inq = rowi < qlen_pad
        if carry_in:
            rr = np.minimum(rowi, qlen_pad - 1)
            hi = h_in[qi[:, None, None], rr[None], li[:, None, None]]
            ei = e_in[qi[:, None, None], rr[None], li[:, None, None]]
            H = np.where(inq, hi, 0)
            E = np.where(inq, np.maximum(ei - R, hi - Q), -Q)
            above = tt * RPT + strip * SH - 1
            da = h_in[qi[:, None], np.clip(above, 0, qlen_pad - 1)[None],
                      li[:, None]]
            diag0 = np.where((above >= 0) & (above < qlen_pad), da, 0)
        else:
            H = np.zeros((P, G, RPT), np.int64)
            E = np.full((P, G, RPT), -Q, np.int64)
            diag0 = np.zeros((P, G), np.int64)
        smax = np.zeros((P, G), np.int64)
        if top and carry_in:
            smax[:, 0] = s_in[qi, li]
        in_h = np.zeros((P, G), np.int64)
        in_f = np.full((P, G), -Q, np.int64)
        in_s = np.zeros((P, G), np.int64)
        for m in range(L + G - 1):
            c = m - tt
            active = (c >= 0) & (c < L)
            cc = np.clip(c, 0, L - 1)
            last = c == L - 1
            if not top:
                b = bnd[:, cc[0]]
                in_h[:, 0], in_f[:, 0], in_s[:, 0] = b[:, 0], b[:, 1], \
                    b[:, 2]
            sym = db_t[li[:, None], cc[None]] & 31                 # [P, G]
            rst = ((cc % 16) == 0)[None] & \
                (start_t[li[:, None], (cc // 16)[None]] != 0)
            rst &= active[None]
            H = np.where(rst[..., None], 0, H)
            E = np.where(rst[..., None], -Q, E)
            smax = np.where(rst, 0, smax)
            diag0 = np.where(rst, 0, diag0)
            pr = np.take_along_axis(
                prof, sym[:, None, :, None], axis=1)[:, 0]        # [P,G,RPT]
            diag = diag0.copy()
            f = in_f.copy()
            act = np.broadcast_to(active[None], (P, G))
            for r in range(RPT):
                hn = np.maximum(np.maximum(diag + pr[..., r], E[..., r]), 0)
                h = np.maximum(hn, f)
                fn = np.maximum(f - R, hn - Q)
                en = np.maximum(E[..., r] - R, h - Q)
                diag = H[..., r].copy()
                H[..., r] = np.where(act, h, H[..., r])
                E[..., r] = np.where(act & ~last[None], en, E[..., r])
                smax = np.where(act, np.maximum(smax, h), smax)
                f = fn
            diag0 = np.where(act, in_h, diag0)
            hb = H[..., RPT - 1]
            sc = np.maximum(in_s, smax)
            if active[G - 1]:
                col = c[G - 1]
                if not bottom:
                    bnd[:, col] = np.stack([hb[:, G - 1], f[:, G - 1],
                                            sc[:, G - 1]], axis=1)
                elif col % 16 == 15:
                    dumps[qi, col // 16, li] = sc[:, G - 1]
                    if col == L - 1 and carry_out:
                        s_out[qi, li] = sc[:, G - 1]
            in_h[:, 1:], in_f[:, 1:], in_s[:, 1:] = \
                hb[:, :-1], f[:, :-1], sc[:, :-1]
        if carry_out:
            for g in range(G):
                for r in range(RPT):
                    row = strip * SH + g * RPT + r
                    if row < qlen_pad:
                        h_out[qi, row, li] = H[:, g, r]
                        e_out[qi, row, li] = E[:, g, r]
    one = np.zeros((1,), np.int32)
    state = (h_out, e_out, s_out) if carry_out else (one, one, one)
    return tuple(np.asarray(x, np.int32) for x in (dumps,) + state)


@pytest.fixture(scope="module")
def m62():
    return ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)


def _chunk(seed, nseqs, lens=(5, 90), max_cols=4096, nq=2, qlen=40,
           qlen_pad=64):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, 24, size=int(n), dtype=np.int8)
            for n in rng.integers(*lens, size=3 * nseqs)]
    ch = pack_stream(seqs, nseqs=nseqs, max_cols=max_cols)[0]
    queries = [rng.integers(0, 24, size=qlen - 7 * i, dtype=np.int8)
               for i in range(nq)]
    qc, ql = build_qcodes(queries, qlen_pad)
    return qc, ql, ch.data_t.T.copy(), ch.start


def _inputs(qc, ql, m62, db, start):
    m8 = build_matrix8(m62.matrix)
    return (qc, ql, m8, np.array([min(int(m8.min()), -1)], np.int32),
            np.ascontiguousarray(db.T),
            np.ascontiguousarray((start != 0).astype(np.int8).T))


# one case per thread layout kernel_config picks: sub-warp groups, a
# full warp at 8/16/32 rows per thread, and the multi-strip path
@pytest.mark.parametrize("qlen,qlen_pad", [(40, 64), (100, 128),
                                           (200, 256), (390, 512),
                                           (700, 768), (1100, 1152)])
def test_emulated_kernel_matches_lax_twin(m62, qlen, qlen_pad):
    qc, ql, db, start = _chunk(qlen, nseqs=4, lens=(20, 160), nq=2,
                               qlen=qlen, qlen_pad=qlen_pad)
    G, RPT, ns = sw_cuda.kernel_config(qlen_pad)
    assert G * RPT * ns >= qlen_pad
    args = _inputs(qc, ql, m62, db, start)
    got = _emulate(*args, None, None, None, gapopenextend=12, gapextend=1,
                   group=G, rows=RPT, nstrips=ns, carry_in=False,
                   carry_out=False)[0]
    want = np.asarray(sw_scores_stream_lax(
        qc, ql, args[2], db, start, gapopenextend=12, gapextend=1))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qlen_pad,layout", [(64, None), (128, None),
                                             (64, (8, 8, 2)),
                                             (1152, None)])
def test_emulated_kernel_carry_chain_matches_lax_twin(m62, qlen_pad,
                                                      layout):
    """A pack_stream_carry series: state threads chunk to chunk, and the
    emulated kernel's (dumps, h, e, s) equal the lax twin's at every
    chunk (exact int32, all state rows including padding rows)."""
    rng = np.random.default_rng(qlen_pad)
    seqs = [rng.integers(0, 24, size=int(n), dtype=np.int8)
            for n in (700, 300, 45, 520, 96, 33)]
    chunks = pack_stream_carry(seqs, nseqs=4, max_cols=128)
    assert len(chunks) > 2
    qlen = min(qlen_pad - 5, 1100)
    qc, ql = build_qcodes([rng.integers(0, 24, size=qlen, dtype=np.int8),
                           rng.integers(0, 24, size=qlen // 3,
                                        dtype=np.int8)], qlen_pad)
    m8 = build_matrix8(m62.matrix)
    G, RPT, ns = layout or sw_cuda.kernel_config(qlen_pad)
    st_k = st_l = make_stream_state(2, qlen_pad, 4)
    first = True
    for ch in chunks:
        db, start = ch.data_t.T.copy(), ch.start
        args = _inputs(qc, ql, m62, db, start)
        got = _emulate(*args, *st_k, gapopenextend=12, gapextend=1,
                       group=G, rows=RPT, nstrips=ns, carry_in=not first,
                       carry_out=True)
        want = sw_scores_stream_lax_carry(qc, ql, m8, db, start, *st_l,
                                          gapopenextend=12, gapextend=1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        st_k = got[1:]
        st_l = want[1:]
        first = False


def _fake_ffi(monkeypatch):
    """Stand the emulator in for the FFI call (traceable, like the op)."""
    import jax
    calls = []

    def fake(*args, **kw):
        calls.append((args[4].shape, kw["carry_in"], kw["carry_out"]))
        nq, qlen_pad = args[0].shape
        nseqs, L = args[4].shape
        state = ((nq, qlen_pad, nseqs), (nq, qlen_pad, nseqs),
                 (nq, nseqs)) if kw["carry_out"] else ((1,),) * 3
        shapes = tuple(jax.ShapeDtypeStruct(sh, np.int32)
                       for sh in ((nq, L // 16, nseqs),) + state)
        return jax.pure_callback(lambda *a: _emulate(*a, **kw), shapes,
                                 *args)

    monkeypatch.setattr(sw_cuda, "_ffi_call", fake)
    return calls


@pytest.mark.parametrize("qlen_pad", [64, 256])
def test_wrapper_layout_matches_lax_twin(m62, monkeypatch, qlen_pad):
    """The wrapper hands the chunk over lane-major with a 0/1 start mask
    and the matrix's pad penalty, and returns the dumps as they are."""
    calls = _fake_ffi(monkeypatch)
    qc, ql, db, start = _chunk(7, nseqs=6, nq=3, qlen_pad=qlen_pad)
    m8 = build_matrix8(m62.matrix)
    got = sw_cuda.sw_scores_stream_cuda(qc, ql, m8, db, start * 3,
                                        gapopenextend=12, gapextend=1)
    want = sw_scores_stream_lax(qc, ql, m8, db, start, gapopenextend=12,
                                gapextend=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert calls == [((6, db.shape[0]), False, False)]


def test_wrapper_column_pieces_match_lax_twin(m62, monkeypatch):
    """A tall query whose boundary scratch would exceed BND_BYTES is
    scored in column pieces with the state carried between them."""
    calls = _fake_ffi(monkeypatch)
    monkeypatch.setattr(sw_cuda, "BND_BYTES", 16 * 2 * 3 * 32)
    qc, ql, db, start = _chunk(11, nseqs=3, lens=(30, 60), nq=2,
                               qlen=1030, qlen_pad=1152)
    assert db.shape[0] > 32
    m8 = build_matrix8(m62.matrix)
    st = make_stream_state(2, 1152, 3)
    got = sw_cuda.sw_scores_stream_cuda(qc, ql, m8, db, start, st,
                                        gapopenextend=12, gapextend=1,
                                        carry_out=True)
    want = sw_scores_stream_lax_carry(qc, ql, m8, db, start, *st,
                                      gapopenextend=12, gapextend=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert len(calls) == db.shape[0] // 32
    assert all(shape[1] == 32 for shape, _, _ in calls)
    assert all(ci and co for _, ci, co in calls)


@pytest.mark.parametrize("nq,nseqs,qlen_pad,L,want", [
    (16, 4096, 256, 8192, 8192),        # one strip: never split
    (16, 4096, 1024, 8192, 8192),
    (16, 4096, 1408, 8192, 1024),       # 1 GiB / 16 B / 65536 pairs
    (2, 2048, 1408, 512, 512),          # the scratch fits
    (6, 4096, 2048, 8192, 2720),        # six frames of a long query
    (1 << 10, 1 << 20, 4096, 8192, 16),  # never below one block
])
def test_piece_columns(nq, nseqs, qlen_pad, L, want):
    assert sw_cuda.piece_columns(nq, nseqs, qlen_pad, L) == want


def test_wrapper_rejects_wide_matrix_and_ragged_chunk(m62):
    qc, ql, db, start = _chunk(3, nseqs=2)
    with pytest.raises(ValueError, match="int8"):
        sw_cuda.sw_scores_stream_cuda(
            qc, ql, m62.matrix.astype(np.int32), db, start,
            gapopenextend=12, gapextend=1)
    with pytest.raises(ValueError, match="multiple of 16"):
        sw_cuda.sw_scores_stream_cuda(
            qc, ql, build_matrix8(m62.matrix), db[:-1], start,
            gapopenextend=12, gapextend=1)


@pytest.mark.parametrize("platform,kernel", [("gpu", "cuda"), ("cuda", "cuda"),
                                             ("cpu", "lax")])
def test_kernel_choice_by_platform(platform, kernel):
    assert sw_stream.stream_kernel(platform) == kernel


def test_forced_kernel_scope():
    """forced_kernel overrides the platform's choice inside its block
    only (nested blocks restore the outer one), and the engine's lane
    count follows the kernel it is built with."""
    from swipe_tpu.pipeline import SearchEngine
    assert sw_stream.stream_kernel() == "lax"            # the CPU here
    with sw_stream.forced_kernel("cuda"):
        assert sw_stream.stream_kernel() == "cuda"
        assert SearchEngine.stream_lanes() == 4096
        with sw_stream.forced_kernel("lax"):
            assert sw_stream.stream_kernel() == "lax"
        assert sw_stream.stream_kernel() == "cuda"
        # an explicit platform is answered as asked
        assert sw_stream.stream_kernel("cpu") == "lax"
    assert sw_stream.stream_kernel() == "lax"
    assert SearchEngine.stream_lanes() == 1024
    with pytest.raises(ValueError, match="unknown stream kernel"):
        with sw_stream.forced_kernel("pallas"):
            pass


def test_platform_route_on_cpu_is_the_lax_twin(m62, monkeypatch):
    calls = _fake_ffi(monkeypatch)
    qc, ql, db, start = _chunk(5, nseqs=4)
    m8 = build_matrix8(m62.matrix)
    got = sw_stream.sw_scores_stream(qc, ql, m8, db, start,
                                     gapopenextend=12, gapextend=1)
    want = sw_scores_stream_lax(qc, ql, m8, db, start, gapopenextend=12,
                                gapextend=1)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert calls == []
    # an explicit kernel choice reaches the wrapper
    got = sw_stream.sw_scores_stream(qc, ql, m8, db, start,
                                     gapopenextend=12, gapextend=1,
                                     kernel="cuda")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert len(calls) == 1


def test_missing_compiler_raises_without_fallback(m62, monkeypatch,
                                                  tmp_path):
    """No nvcc: the CUDA route fails with the build's message instead of
    quietly scoring on the lax twin."""
    monkeypatch.setattr(sw_cuda, "LIBRARY", str(tmp_path / "lib.so"))
    monkeypatch.setattr(sw_cuda, "_nvcc",
                        lambda: str(tmp_path / "no-such-nvcc"))
    monkeypatch.setattr(sw_cuda, "_registered", False)
    # a shape no other test traced, so the jit cache cannot answer
    qc, ql, db, start = _chunk(5, nseqs=5)
    with pytest.raises(RuntimeError, match="cannot build the CUDA"):
        sw_stream.sw_scores_stream(qc, ql, build_matrix8(m62.matrix), db,
                                   start, gapopenextend=12, gapextend=1,
                                   kernel="cuda")
    assert not (tmp_path / "lib.so").exists()


def test_build_reports_compiler_errors(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'sw_stream.cu(1): error: boom' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(sw_cuda, "LIBRARY", str(tmp_path / "lib.so"))
    with pytest.raises(RuntimeError, match="boom"):
        sw_cuda.build(nvcc=str(fake))
    assert "sm_90a" in " ".join(sw_cuda.build_command("nvcc", "x.so"))


@pytest.mark.chip
def test_cuda_kernel_matches_lax_twin_on_card(m62, gpu):
    """On the card: compiled kernel == lax twin, exact (integer scores;
    no float matmul is on this path, so TF32 precision does not apply)."""
    import jax.numpy as jnp
    for qlen_pad in (64, 256, 1152):
        qc, ql, db, start = _chunk(qlen_pad, nseqs=2048, nq=4,
                                   qlen=min(qlen_pad - 3, 1100),
                                   qlen_pad=qlen_pad)
        m8 = jnp.asarray(build_matrix8(m62.matrix))
        got = sw_cuda.sw_scores_stream_cuda(
            jnp.asarray(qc), jnp.asarray(ql), m8, jnp.asarray(db),
            jnp.asarray(start), gapopenextend=12, gapextend=1)
        want = sw_scores_stream_lax(qc, ql, m8, db, start,
                                    gapopenextend=12, gapextend=1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("flow", [False, True])
def test_engine_search_through_cuda_wrapper_matches_lax(m62, monkeypatch,
                                                        flow):
    """The engine's walks (plain pack and flow series, with the fresh
    first chunk and the state-free last chunk) drive the CUDA wrapper
    exactly as they drive the lax twin: same hits, same counters."""
    import io

    from swipe_tpu.io.db import FastaDatabase
    from swipe_tpu.io.fasta import preprocess_query
    from swipe_tpu.pipeline import SearchEngine, SearchParams
    calls = _fake_ffi(monkeypatch)
    rng = np.random.default_rng(17)
    AA = list("ARNDCQEGHILKMFPSTWYV")
    q = "".join(rng.choice(AA, 50))
    recs = ["".join(rng.choice(AA, int(n)))
            for n in rng.integers(20, 120, size=60)]
    recs[9] = recs[9][:5] + q[3:40] + recs[9][5:]
    recs[31] = "".join(rng.choice(AA, 1500)) + q[10:48]
    fasta = "".join(f">s{i} r{i}\n{s}\n" for i, s in enumerate(recs))
    db = FastaDatabase(io.StringIO(fasta), "aa", title="cudawrap")
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=30, alignments=3, expect=1e9)
    query = preprocess_query("q", q, 1, 3)
    with sw_stream.forced_kernel("cuda"):
        got_eng = SearchEngine(db, params, nseqs=8, max_cols=2048,
                               backend="stream")
    want_eng = SearchEngine(db, params, nseqs=8, max_cols=2048,
                            backend="stream")
    assert (got_eng.kernel, want_eng.kernel) == ("cuda", "lax")
    for eng in (got_eng, want_eng):
        eng.FLOW_MIN_AVG_LANE = 0 if flow else 1 << 30
    assert (got_eng._flow_cols(8) is not None) == flow
    got, want = got_eng.search(query), want_eng.search(query)
    assert calls, "the CUDA wrapper was not called"
    if flow:
        assert any(not ci for _, ci, _ in calls)      # fresh series head
    assert [(h.seqno, h.score, h.alignment) for h in got.hits] == \
           [(h.seqno, h.score, h.alignment) for h in want.hits]
    assert (got.totalhits, got.obvious) == (want.totalhits, want.obvious)
    assert {9, 31} <= {h.seqno for h in got.hits}
