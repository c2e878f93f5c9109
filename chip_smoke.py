"""On-card check: the search engine on one NVIDIA GPU, end to end.

    python chip_smoke.py              # one card: phases 1-4
    python chip_smoke.py --cards 4    # four cards: the mesh phase only

Phases, each fatal on failure:

1. the device: JAX must run on a GPU (anything else exits 1 with no
   result), and the card's name and power limit as nvidia-smi gives them;
2. the CUDA stream kernel (native/sw_stream.cu) built from source, then
   compiled at real widths for every thread layout it has, with the
   compiled scoring step's memory analysis;
3. exactness: the compiled kernel against its lax twin and both against
   the NumPy oracle (ops.sw_ref) on random 2048-lane chunks, fresh and
   with carried state, query lengths 64 to 1300; 16 queries of 1300 aa
   at 4096 lanes x 8192 columns, which the wrapper scores in column
   pieces, against the lax twin on a slice; then every scoring route
   of the engine (plain pack, flow series, tall query, segmented and
   carried giants, blastn, a batch with a power-of-two tail) against the
   oracle.  Scores are integers, so every comparison is exact equality;
4. end to end at BASELINE config 4's scale: a 570k-sequence Swiss-Prot-
   like database (~2e8 residues) written from a fixed seed, searched
   through ``swipe_tpu.cli.main`` (BLOSUM62 11/1, -m 9 and -m 0) and
   through ``SearchEngine.search_batch`` with the CUDA kernel and with
   the lax twin; every reported score is checked against the oracle and
   the two hit lists must be identical.  Wall time, GCUPS and the align
   phase's time are printed with the card.

With ``--cards 4`` only the four-card phase runs: ``MultiHostEngine`` in
this one process over the four local cards, on the same database and
queries, compared with the single-card ``SearchEngine``.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time
from contextlib import redirect_stdout

import numpy as np

AA = list("ARNDCQEGHILKMFPSTWYV")
CFG4_SEQS = 570_000
QUERIES = 4
QLEN = 200


def phase(name):
    print(f"== {name}", flush=True)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


# ---- 2. build and compile -------------------------------------------------

def build_and_compile(lanes=4096, L=1024):
    import jax
    import jax.numpy as jnp

    from swipe_tpu.ops import sw_cuda
    from swipe_tpu.ops.sw_stream import sw_scores_stream

    t0 = time.time()
    sw_cuda.build(force=True)
    print(f"built {sw_cuda.LIBRARY} in {time.time() - t0:.1f}s", flush=True)
    with open(sw_cuda.LIBRARY + ".log") as log:
        for line in log:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    step = jax.jit(sw_scores_stream,
                   static_argnames=("gapopenextend", "gapextend", "kernel"))
    for qlen_pad in (64, 128, 256, 512, 1024, 1408):
        layout = sw_cuda.kernel_config(qlen_pad)
        args = (jax.ShapeDtypeStruct((16, qlen_pad), jnp.int32),
                jax.ShapeDtypeStruct((16,), jnp.int32),
                jax.ShapeDtypeStruct((32, 32), jnp.int8),
                jax.ShapeDtypeStruct((L, lanes), jnp.int8),
                jax.ShapeDtypeStruct((L // 16, lanes), jnp.int8))
        t0 = time.time()
        compiled = step.lower(*args, gapopenextend=12, gapextend=1,
                              kernel="cuda").compile()
        print(f"compiled qlen_pad {qlen_pad} (group, rows, strips) "
              f"{layout} x {lanes} lanes in {time.time() - t0:.1f}s",
              flush=True)
        if qlen_pad == 256:
            print("  memory_analysis:", compiled.memory_analysis())


# ---- 3. exactness -----------------------------------------------------------

def _chunks(rng, nseqs, max_cols, lens, carry=False, extra=()):
    from swipe_tpu.batching import pack_stream, pack_stream_carry
    seqs = [rng.integers(0, 24, size=int(n), dtype=np.int8)
            for n in rng.integers(*lens, size=3 * nseqs)]
    seqs += [rng.integers(0, 24, size=n, dtype=np.int8) for n in extra]
    if carry:
        return seqs, pack_stream_carry(seqs, nseqs=nseqs, max_cols=max_cols)
    return seqs, pack_stream(seqs, nseqs=nseqs, max_cols=max_cols)[:1]


def kernel_exactness(nseqs=2048, max_cols=512, oracle_sample=300, seed=0):
    """CUDA kernel == lax twin (full chunk, dumps and state) and both ==
    the NumPy oracle on a sample of the chunk's sequences."""
    import jax.numpy as jnp

    from swipe_tpu.matrices import ScoreMatrix
    from swipe_tpu.ops.sw_ref import sw_numpy_many
    from swipe_tpu.ops.sw_stream import (build_matrix8, build_qcodes,
                                         gather_scores, make_stream_state,
                                         sw_scores_stream_carry)
    from swipe_tpu.pipeline import SearchEngine

    rng = np.random.default_rng(seed)
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    m8 = jnp.asarray(build_matrix8(m.matrix))
    for qlen, carry in ((64, False), (200, True), (500, False),
                        (1000, True), (1300, True)):
        qlen_pad = SearchEngine.qlen_bucket(qlen)
        queries = [rng.integers(0, 24, size=qlen - 9 * i, dtype=np.int8)
                   for i in range(2)]
        qc, ql = map(jnp.asarray, build_qcodes(queries, qlen_pad))
        seqs, chunks = _chunks(rng, nseqs, max_cols, (5, 260), carry=carry,
                               extra=(3000, 1500) if carry else ())
        states = {k: make_stream_state(2, qlen_pad, chunks[0].nseqs)
                  for k in ("cuda", "lax")}
        scores = {k: np.zeros((2, len(seqs)), np.int64)
                  for k in ("cuda", "lax")}
        for i, ch in enumerate(chunks):
            db, st = jnp.asarray(ch.data_t).T, jnp.asarray(ch.start)
            res = {}
            for k in ("cuda", "lax"):
                res[k] = sw_scores_stream_carry(
                    qc, ql, m8, db, st, *states[k], gapopenextend=12,
                    gapextend=1, kernel=k, carry_in=i > 0)
                states[k] = res[k][1:]
                if len(ch.seqnos):
                    scores[k][:, ch.seqnos] = np.asarray(gather_scores(
                        res[k][0], jnp.asarray(ch.end_block),
                        jnp.asarray(ch.lane)))
            for name, a, b in zip(("dumps", "h", "e", "s"), res["cuda"],
                                  res["lax"]):
                check(np.array_equal(np.asarray(a), np.asarray(b)),
                      f"qlen {qlen} chunk {i}: CUDA {name} != lax twin")
        # a random sample of the chunk's sequences, plus the long ones
        # cut across the carry series
        done = np.concatenate([c.seqnos for c in chunks])
        sample = rng.choice(done, size=min(oracle_sample, len(done)),
                            replace=False)
        if carry:
            sample = np.union1d(sample, [len(seqs) - 2, len(seqs) - 1])
        for qi, q in enumerate(queries):
            want = sw_numpy_many(q, [seqs[j] for j in sample], m.matrix,
                                 11, 1)
            check(np.array_equal(scores["cuda"][qi, sample], want),
                  f"qlen {qlen}: CUDA scores != oracle")
        print(f"kernel qlen {qlen} (pad {qlen_pad}) x {nseqs} lanes, "
              f"{len(chunks)} chunk(s){' carried' if carry else ''}: "
              f"CUDA == lax twin (dumps, h, e, s); "
              f"{len(sample)} sequences == oracle", flush=True)


def piece_exactness(nq=16, qlen=1300, nseqs=4096, max_cols=8192,
                    ref_queries=3, ref_lanes=128, oracle_sample=24, seed=1):
    """A batch of tall queries at full width takes the column-piece path
    (several chained launches per chunk, each with the boundary scratch
    XLA allocates for it): two chunks of a carry series, the second
    starting from the first's state.  Queries and lanes are independent,
    so the lax twin replays a slice of both and must equal the CUDA
    dumps and state on it; the oracle checks sequences that end in the
    two chunks, among them ones cut across the chunk boundary."""
    import jax.numpy as jnp

    from swipe_tpu.batching import pack_stream_carry
    from swipe_tpu.matrices import ScoreMatrix
    from swipe_tpu.ops import sw_cuda
    from swipe_tpu.ops.sw_ref import sw_numpy_many
    from swipe_tpu.ops.sw_stream import (build_matrix8, build_qcodes,
                                         gather_scores, make_stream_state,
                                         sw_scores_stream_carry)
    from swipe_tpu.pipeline import SearchEngine

    rng = np.random.default_rng(seed)
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    m8 = jnp.asarray(build_matrix8(m.matrix))
    qlen_pad = SearchEngine.qlen_bucket(qlen)
    piece = sw_cuda.piece_columns(nq, nseqs, qlen_pad, max_cols)
    check(piece < max_cols, f"{nq} x {qlen_pad} x {nseqs} lanes does not "
          f"take the column-piece path")
    queries = [rng.integers(0, 24, size=qlen - 7 * i, dtype=np.int8)
               for i in range(nq)]
    qc, ql = map(jnp.asarray, build_qcodes(queries, qlen_pad))
    # a little over two full chunks of residues
    hi = min(3000, max_cols)
    lens = rng.integers(5, hi, size=int(2.1 * nseqs * max_cols * 2 / hi))
    seqs = [rng.integers(0, 24, size=int(n), dtype=np.int8) for n in lens]
    chunks = pack_stream_carry(seqs, nseqs=nseqs, max_cols=max_cols)[:2]
    check(all(c.n_cols == max_cols and c.nseqs == nseqs for c in chunks)
          and len(chunks) == 2, "expected two full chunks")
    sl = (slice(0, ref_queries), Ellipsis, slice(0, ref_lanes))
    st_cuda = make_stream_state(nq, qlen_pad, nseqs)
    st_lax = make_stream_state(ref_queries, qlen_pad, ref_lanes)
    scores = np.zeros((nq, len(seqs)), np.int64)
    t_cuda = 0.0
    for i, ch in enumerate(chunks):
        db, st = jnp.asarray(ch.data_t).T, jnp.asarray(ch.start)
        t0 = time.time()
        got = sw_scores_stream_carry(
            qc, ql, m8, db, st, *st_cuda, gapopenextend=12, gapextend=1,
            kernel="cuda", carry_in=i > 0)
        np.asarray(got[0])
        t_cuda += time.time() - t0
        want = sw_scores_stream_carry(
            qc[:ref_queries], ql[:ref_queries], m8, db[:, :ref_lanes],
            st[:, :ref_lanes], *st_lax, gapopenextend=12, gapextend=1,
            kernel="lax", carry_in=i > 0)
        for name, a, b in zip(("dumps", "h", "e", "s"), got, want):
            check(np.array_equal(np.asarray(a[sl]), np.asarray(b)),
                  f"column pieces, chunk {i}: CUDA {name} != lax twin")
        st_cuda, st_lax = got[1:], want[1:]
        if len(ch.seqnos):
            scores[:, ch.seqnos] = np.asarray(gather_scores(
                got[0], jnp.asarray(ch.end_block), jnp.asarray(ch.lane)))
    # sequences of chunk 1 that began in chunk 0, and a random sample
    last = chunks[1]
    cut = last.seqnos[lens[last.seqnos] > 16 * (last.end_block + 1)]
    check(len(cut) > 0, "no sequence cut across the chunk boundary")
    done = np.concatenate([c.seqnos for c in chunks])
    sample = np.union1d(cut[:oracle_sample // 2],
                        rng.choice(done, size=oracle_sample // 2,
                                   replace=False))
    for qi in (0, nq - 1):
        want = sw_numpy_many(queries[qi], [seqs[j] for j in sample],
                             m.matrix, 11, 1)
        check(np.array_equal(scores[qi, sample], want),
              "column pieces: CUDA scores != oracle")
    print(f"column pieces: {nq} queries x {qlen} aa (pad {qlen_pad}) x "
          f"{nseqs} lanes x 2 chunks of {max_cols} columns, "
          f"{-(-max_cols // piece)} launches of {piece} columns per chunk, "
          f"{t_cuda:.2f}s with compilation: CUDA == lax twin on {ref_queries} queries x "
          f"{ref_lanes} lanes (dumps, h, e, s); {len(sample)} sequences "
          f"({len(cut[:oracle_sample // 2])} cut) == oracle", flush=True)


#        name          nseq   lenrange    qlen  options
ROUTE_CASES = [
    ("plain_q200",     2000, (30, 500),   200, {}),
    ("flow_q120",       800, (50, 2900),  120, {"flow": True}),
    ("tall_q300",      1200, (30, 500),   300, {}),
    ("long_q1300",      600, (30, 400),  1300, {}),
    ("giant_segmented",  40, (50, 200),    90, {"giant": 70_000}),
    ("giant_carry",      40, (50, 200),    90, {"giant": 70_000,
                                                "carry": True}),
    ("blastn_q500",    1500, (40, 900),   500, {"nt": True}),
    ("batch18_q150",   1000, (30, 500),   150, {"batch": 18}),
]


def route_exactness(cases=ROUTE_CASES, seed=0):
    """Every scoring route of SearchEngine against the oracle: each
    reported score, and the kept set == the oracle's top-N multiset."""
    from swipe_tpu.alphabet import MAP_NCBI_AA, MAP_NCBI_NT16, encode
    from swipe_tpu.io.db import FastaDatabase
    from swipe_tpu.io.fasta import preprocess_query
    from swipe_tpu.ops.sw_ref import sw_numpy_many
    from swipe_tpu.pipeline import SearchEngine, SearchParams

    rng = np.random.default_rng(seed)
    for name, nseq, (lo, hi), qlen, opt in cases:
        nt = bool(opt.get("nt"))
        alpha = list("ACGT") if nt else AA
        strs = ["".join(rng.choice(alpha, int(n)))
                for n in rng.integers(lo, hi, size=nseq)]
        if opt.get("giant"):
            strs.append("".join(rng.choice(alpha, opt["giant"])))
        fasta = "".join(f">s{i} c{i}\n{s}\n" for i, s in enumerate(strs))
        db = FastaDatabase(io.StringIO(fasta), "nt" if nt else "aa",
                           title=name)
        if nt:
            params = SearchParams(symtype=0, matchscore=1, mismatchscore=-3,
                                  gapopen=5, gapextend=2, querystrands=1,
                                  descriptions=len(strs), alignments=0,
                                  expect=1e12)
        else:
            params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                                  descriptions=len(strs), alignments=0,
                                  expect=1e12)
        eng = SearchEngine(db, params, backend="stream")
        if opt.get("flow"):
            eng.FLOW_MIN_AVG_LANE = 0
        if opt.get("carry"):
            eng.SEGMENT_GIANTS = False
        if opt.get("giant"):
            check(eng._giant_ids.size == 1, f"{name}: no giant unit")
        nq = int(opt.get("batch", 1))
        qs = [preprocess_query(f"q{k}", "".join(rng.choice(alpha, qlen)),
                               params.symtype, params.querystrands)
              for k in range(nq)]
        t0 = time.time()
        hitlists = eng.search_batch(qs)
        wall = time.time() - t0
        codes = [encode(s, MAP_NCBI_NT16 if nt else MAP_NCBI_AA)
                 for s in strs]
        nhits = 0
        for q, hits in zip(qs, hitlists):
            want = sw_numpy_many(q.nt[0] if nt else q.aa[0], codes,
                                 eng.matrix.matrix, params.gapopen,
                                 params.gapextend)
            bad = [(h.seqno, h.score, int(want[h.seqno]))
                   for h in hits.hits if h.score != want[h.seqno]]
            check(not bad, f"{name}: scores != oracle {bad[:3]}")
            got = sorted((h.score for h in hits.hits), reverse=True)
            top = sorted(want.tolist(), reverse=True)[:len(got)]
            check(got == top, f"{name}: kept set != oracle top-N")
            nhits += hits.count
        check(nhits > 0, f"{name}: no hits")
        print(f"route {name}: exact, {nhits} hits, {wall:.2f}s", flush=True)


# ---- 4. end to end ----------------------------------------------------------

def write_cfg4(tmp, nseqs=CFG4_SEQS, nq=QUERIES, qlen=QLEN, seed=4):
    """The database, and queries that are 200-aa windows of database
    sequences with a fifth of their residues replaced, so every query has
    true homologs to align besides the random hits."""
    from bench_corpus import swissprot_letters, write_swissprot_fasta
    rng = np.random.default_rng(seed)
    db_path = os.path.join(tmp, "cfg4.fa")
    t0 = time.time()
    residues = write_swissprot_fasta(db_path, nseqs, rng)
    picks = set(rng.choice(nseqs, size=8 * nq, replace=False).tolist())
    sources = []
    with open(db_path) as f:
        for i, line in enumerate(f):
            if i % 2 and i // 2 in picks and len(line) > qlen:
                sources.append(line.strip())
    q_path = os.path.join(tmp, "queries.fa")
    with open(q_path, "w") as f:
        for k, src in enumerate(sources[:nq]):
            at = int(rng.integers(0, len(src) - qlen + 1))
            q = np.array(list(src[at:at + qlen]))
            swap = rng.random(qlen) < 0.2
            q[swap] = list(swissprot_letters(int(swap.sum()), rng))
            f.write(f">q{k} smoke query {k}\n{''.join(q)}\n")
    print(f"database: {nseqs} sequences, {residues} residues "
          f"({os.path.getsize(db_path) / 1e9:.2f} GB FASTA) written in "
          f"{time.time() - t0:.1f}s", flush=True)
    return db_path, q_path


def run_cli(argv):
    from swipe_tpu.cli import main
    buf = io.StringIO()
    t0 = time.time()
    with redirect_stdout(buf):
        rc = main(argv)
    check(rc == 0, f"cli.main {argv} returned {rc}")
    return buf.getvalue(), time.time() - t0


def m9_hits(text):
    """query id -> subject ids in report order, from -m 9 output."""
    out: dict[str, list[str]] = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            f = line.split("\t")
            out.setdefault(f[0], []).append(f[1])
    return out


def m0_scores(text):
    """(query description, subject id, raw score) of every alignment
    section of -m 0 output."""
    out, query, subject = [], None, None
    for line in text.splitlines():
        if line.startswith("Query description:"):
            query = line.split(":", 1)[1].strip()
        elif line.startswith(">"):
            subject = line[1:].split()[0]
        elif line.startswith(" Score =") and "bits (" in line:
            raw = int(line.split("bits (", 1)[1].split(")", 1)[0])
            out.append((query, subject, raw))
    return out


def end_to_end(db_path, q_path, card):
    from swipe_tpu.io.db import FastaDatabase
    from swipe_tpu.io.fasta import read_queries
    from swipe_tpu.ops.sw_ref import sw_numpy_many
    from swipe_tpu.ops.sw_stream import forced_kernel
    from swipe_tpu.pipeline import SearchEngine, SearchParams, SearchTimings

    base = ["-d", db_path, "-i", q_path, "-M", "BLOSUM62", "-G", "11",
            "-E", "1"]
    out9, wall9 = run_cli(base + ["-m", "9"])
    out0, wall0 = run_cli(base + ["-m", "0"])
    cli_hits = m9_hits(out9)
    check(len(cli_hits) > 0, "cli -m 9 reported no hits")
    check("Sequences producing significant alignments" in out0
          or "Score =" in out0, "cli -m 0 rendered no alignments")
    print(f"cli.main -m 9: {wall9:.1f}s, -m 0: {wall0:.1f}s (each: ingest, "
          f"pack, upload, compile, search, align, render) [{card}]",
          flush=True)

    db = FastaDatabase(db_path, "aa")
    queries = list(read_queries(q_path, 1, 3))
    params = SearchParams(symtype=1, gapopen=11, gapextend=1)
    kernels = ("cuda", "lax")
    results = {}
    for kernel in kernels:
        with forced_kernel(kernel):
            eng = SearchEngine(db, params, backend="stream")
        eng.search_batch(queries)                 # compile + warm
        t = SearchTimings()
        t0 = time.time()
        hitlists = eng.search_batch(queries, t)
        wall = time.time() - t0
        results[kernel] = hitlists
        print(f"search_batch {len(queries)} x {QLEN} aa vs "
              f"{db.seqcount()} sequences, kernel {kernel}: wall "
              f"{wall:.3f}s, search {t.elapsed:.3f}s "
              f"({t.speed / 1e9:.1f} GCUPS), align phase "
              f"{wall - t.elapsed:.3f}s [{card}]", flush=True)
    ref = results[kernels[0]]
    for k in kernels[1:]:
        for a, b in zip(ref, results[k]):
            check([(h.seqno, h.score, h.alignment) for h in a.hits]
                  == [(h.seqno, h.score, h.alignment) for h in b.hits],
                  f"hit lists differ between kernels {kernels[0]} and {k}")
    nchecked = 0
    for q, hits in zip(queries, ref):
        seqs = [np.asarray(db.get_sequence(h.seqno, 1)[0])
                for h in hits.hits]
        want = sw_numpy_many(q.aa[0], seqs, eng.matrix.matrix, 11, 1)
        check([h.score for h in hits.hits] == [int(w) for w in want],
              "a reported score != oracle")
        nchecked += len(seqs)
    print(f"{nchecked} reported hits == oracle; hit lists identical for "
          f"kernels {', '.join(kernels)}", flush=True)
    # the CLI's own report: every -m 0 alignment's raw score == oracle
    by_desc = {q.description: q for q in queries}
    sections = m0_scores(out0)
    check(sections, "cli -m 0 has no alignment sections")
    for desc, subject, raw in sections:
        q = by_desc[desc]
        seq = np.asarray(db.get_sequence(int(subject[1:]), 1)[0])
        want = int(sw_numpy_many(q.aa[0], [seq], eng.matrix.matrix, 11,
                                 1)[0])
        check(raw == want, f"cli -m 0 {desc} vs {subject}: {raw} != {want}")
    print(f"cli -m 0: {len(sections)} alignment scores == oracle",
          flush=True)
    order = {q.description.split()[0]: [f"s{h.seqno}" for h in hl.hits]
             for q, hl in zip(queries, ref)}
    for qname, subj in cli_hits.items():
        want = order[qname]
        check(subj[:len(want)] == want[:len(subj)],
              f"cli -m 9 hit order != engine for {qname}")
    print("cli -m 9 hit order == engine hit order", flush=True)


# ---- 5. four cards ----------------------------------------------------------

def four_cards(db_path, q_path, card):
    import jax

    from swipe_tpu.io.db import FastaDatabase
    from swipe_tpu.io.fasta import read_queries
    from swipe_tpu.parallel.multihost import MultiHostEngine
    from swipe_tpu.pipeline import SearchEngine, SearchParams, SearchTimings

    db = FastaDatabase(db_path, "aa")
    queries = list(read_queries(q_path, 1, 3))
    params = SearchParams(symtype=1, gapopen=11, gapextend=1)
    res = {}
    for name, cls in (("single card", SearchEngine),
                      (f"{len(jax.local_devices())} cards", MultiHostEngine)):
        eng = cls(db, params, backend="stream")
        eng.search_batch(queries)
        t = SearchTimings()
        t0 = time.time()
        res[name] = eng.search_batch(queries, t)
        print(f"{name}: wall {time.time() - t0:.3f}s, search "
              f"{t.elapsed:.3f}s ({t.speed / 1e9:.1f} GCUPS) [{card}]",
              flush=True)
    a, b = res.values()
    for x, y in zip(a, b):
        check([(h.seqno, h.score, h.alignment) for h in x.hits]
              == [(h.seqno, h.score, h.alignment) for h in y.hits],
              "multi-card hit list != single-card hit list")
        check(x.totalhits == y.totalhits, "totalhits differ")
    print("multi-card hit lists == single-card hit lists", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    from swipe_tpu import native
    from swipe_tpu.cli import _enable_compile_cache
    from swipe_tpu.devices import card_info, require_gpu

    phase("1. device")
    dev = require_gpu("chip_smoke")
    card = card_info().splitlines()[0]
    _enable_compile_cache()
    native.tune_malloc()
    t_start = time.time()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.cards == 4:
            check(dev["count"] >= 4, f"--cards 4 needs 4 GPUs, found "
                  f"{dev['count']}")
            phase("5. four cards")
            four_cards(*write_cfg4(tmp), card)
        else:
            phase("2. build and compile")
            build_and_compile()
            phase("3. exactness")
            kernel_exactness()
            piece_exactness()
            route_exactness()
            phase("4. end to end")
            end_to_end(*write_cfg4(tmp), card)
    print(f"chip_smoke: all phases passed in {time.time() - t_start:.0f}s "
          f"[{card}]", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"],
        "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
