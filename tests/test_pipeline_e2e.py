"""End-to-end pipeline tests (CPU lax backend) across search modes."""

import io
import math

import numpy as np
import pytest

from swipe_tpu.io.db import FastaDatabase
from swipe_tpu.io.fasta import preprocess_query
from swipe_tpu.pipeline import SearchEngine, SearchParams
from swipe_tpu.report import Reporter
from swipe_tpu.ops.sw_ref import sw_numpy_many

AA = "ARNDCQEGHILKMFPSTWYV"
NT = "ACGT"


def _mkfasta(rng, n, lo, hi, alphabet, plant=None):
    recs = []
    for i in range(n):
        s = "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi))))
        if plant and i in plant:
            s = plant[i]
        recs.append((f"seq{i} description {i}", s))
    return "".join(f">{d}\n{s}\n" for d, s in recs), recs


@pytest.fixture(scope="module")
def protein_setup():
    rng = np.random.default_rng(11)
    q = "".join(rng.choice(list(AA), 80))
    fasta, recs = _mkfasta(rng, 40, 40, 150, AA,
                           plant={3: q[5:70], 9: q[:40] + "W" * 5 + q[40:]})
    db = FastaDatabase(io.StringIO(fasta), "aa", title="testdb")
    query = preprocess_query("q1 test", q, 1, 3)
    return db, query, recs, q


def test_blastp_scores_match_oracle(protein_setup):
    db, query, recs, q = protein_setup
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=40, alignments=40)
    eng = SearchEngine(db, params, nseqs=8, backend="lax")
    hits = eng.search(query)
    assert hits.count > 0
    from swipe_tpu.alphabet import MAP_NCBI_AA, encode
    seqs = [encode(s, MAP_NCBI_AA) for _, s in recs]
    want = sw_numpy_many(query.aa[0], seqs, eng.matrix.matrix, 11, 1)
    for h in hits.hits:
        assert h.score == want[h.seqno]
    # ordering: score desc, seqno desc on ties
    keys = [(-h.score, -h.seqno) for h in hits.hits]
    assert keys == sorted(keys)
    # alignment re-walk equals score
    for i in range(hits.showalignments):
        h = hits.hits[i]
        assert h.score_align == h.score


def test_blastp_evalue_consistency(protein_setup):
    db, query, recs, q = protein_setup
    params = SearchParams(symtype=1)
    eng = SearchEngine(db, params, nseqs=8, backend="lax")
    hits = eng.search(query)
    ev = hits.evmodel
    assert ev.available
    for h in hits.hits:
        assert ev.evalue(h.score) <= 10.0 + 1e-9


def test_report_formats_render(protein_setup):
    db, query, recs, q = protein_setup
    params = SearchParams(symtype=1)
    eng = SearchEngine(db, params, nseqs=8, backend="lax")
    hits = eng.search(query)
    for view in (0, 7, 8, 9):
        buf = io.StringIO()
        rep = Reporter(buf, view, 1, eng.matrix.matrix, query=query)
        rep.show(hits, "testdb")
        text = buf.getvalue()
        assert "seq3" in text
        if view == 0:
            assert "Identities" in text
            assert "Query:" in text
        if view == 7:
            assert "<result>" in text and "</result>" in text
        if view in (8, 9):
            line = [l for l in text.splitlines()
                    if l and not l.startswith("#")][0]
            assert len(line.split("\t")) == 12


def test_blastn_both_strands():
    rng = np.random.default_rng(5)
    q = "".join(rng.choice(list(NT), 60))
    import swipe_tpu.alphabet as al
    rc = al.decode(al.revcompl(al.encode(q, al.MAP_NCBI_NT16)),
                   al.SYM_NCBI_NT16).upper()
    fasta, recs = _mkfasta(rng, 20, 40, 120, NT,
                           plant={2: q, 6: rc})
    db = FastaDatabase(io.StringIO(fasta), "nt")
    query = preprocess_query("qn", q, 0, 3)
    params = SearchParams(symtype=0, matchscore=1, mismatchscore=-3,
                          gapopen=5, gapextend=2)
    eng = SearchEngine(db, params, nseqs=8, backend="lax")
    hits = eng.search(query)
    top2 = {(h.seqno, h.dstrand) for h in hits.hits[:2]}
    assert (2, 0) in top2      # forward plant: plus/plus
    assert (6, 1) in top2      # revcompl plant: plus/minus
    assert hits.hits[0].score == 60
    # alignment of the minus hit must rescore correctly
    for h in hits.hits[:2]:
        assert h.score_align == h.score


def test_tblastn_translated_db():
    rng = np.random.default_rng(7)
    prot = "".join(rng.choice(list(AA), 50))
    # reverse-translate via standard code (pick a codon per aa)
    from swipe_tpu.alphabet import GENETIC_CODES
    code = GENETIC_CODES[1]
    codon_of = {}
    bases = "TCAG"
    for i, aa in enumerate(code):
        codon = bases[i // 16] + bases[(i // 4) % 4] + bases[i % 4]
        codon_of.setdefault(aa, codon)
    dna = "".join(codon_of[c] for c in prot)
    fasta, recs = _mkfasta(rng, 15, 60, 200, NT, plant={4: dna})
    db = FastaDatabase(io.StringIO(fasta), "nt")
    query = preprocess_query("qp", prot, 3, 1)
    params = SearchParams(symtype=3, querystrands=1, gapopen=11, gapextend=1)
    eng = SearchEngine(db, params, nseqs=8, backend="lax")
    hits = eng.search(query)
    assert hits.hits[0].seqno == 4
    assert hits.hits[0].dstrand == 0 and hits.hits[0].dframe == 0
    # perfect translated match: score = sum of diagonal
    from swipe_tpu.alphabet import MAP_NCBI_AA, encode
    pq = encode(prot, MAP_NCBI_AA)
    assert hits.hits[0].score == int(eng.matrix.matrix[pq, pq].sum())
    assert hits.hits[0].score_align == hits.hits[0].score


def test_blastx_translated_query():
    rng = np.random.default_rng(9)
    fasta, recs = _mkfasta(rng, 12, 40, 120, AA)
    # query: dna that translates (frame 1, minus strand too) into seq5
    target = recs[5][1]
    from swipe_tpu.alphabet import GENETIC_CODES
    code = GENETIC_CODES[1]
    bases = "TCAG"
    codon_of = {}
    for i, aa in enumerate(code):
        codon = bases[i // 16] + bases[(i // 4) % 4] + bases[i % 4]
        codon_of.setdefault(aa, codon)
    dna = "G" + "".join(codon_of[c] for c in target[:30])  # frame 1
    db = FastaDatabase(io.StringIO(fasta), "aa")
    query = preprocess_query("qx", dna, 2, 3)
    params = SearchParams(symtype=2, gapopen=11, gapextend=1)
    eng = SearchEngine(db, params, nseqs=8, backend="lax")
    hits = eng.search(query)
    assert hits.hits[0].seqno == 5
    assert hits.hits[0].qstrand == 0 and hits.hits[0].qframe == 1


def test_counters_and_thresholds(protein_setup):
    db, query, recs, q = protein_setup
    params = SearchParams(symtype=1, minscore=25)
    eng = SearchEngine(db, params, nseqs=8, backend="lax")
    hits = eng.search(query)
    assert all(h.score >= hits.init_threshold for h in hits.hits)
    assert hits.totalhits >= hits.count


def test_report_paralign_renders(protein_setup):
    import re

    from swipe_tpu.report import ParalignInfo, show_begin, show_end
    db, query, recs, q = protein_setup
    params = SearchParams(symtype=1)
    eng = SearchEngine(db, params, nseqs=8, backend="lax")
    hits = eng.search(query)
    buf = io.StringIO()
    show_begin(buf, 99)
    rep = Reporter(buf, 99, 1, eng.matrix.matrix, query=query)
    rep.show(hits, "testdb", paralign=ParalignInfo(
        queryname="q.fa", databasename="testdb", matrixname="BLOSUM62",
        starttime="t0", endtime="t1", elapsed=0.5, speed=1e9, sw_count=40))
    show_end(buf, 99)
    text = buf.getvalue()
    assert text.startswith('<?xml version="1.0"?>\n<ParalignXML')
    assert text.rstrip().endswith("</ParalignXML>")
    assert "<paralignOutput>" in text and "</paralignOutput>" in text
    assert "<shortVersionHit>" in text and "<longVersionHit>" in text
    assert "<searchSpeed>1.000 GCUPS</searchSpeed>" in text
    # alignment blocks carry consistent percentages
    m = re.search(r"<identicalPercentage>([\d.]+)</identicalPercentage>",
                  text)
    assert m and 0.0 <= float(m.group(1)) <= 100.0


def test_stream_backend_matches_lax(protein_setup):
    db, query, recs, q = protein_setup
    params = SearchParams(symtype=1, descriptions=40, alignments=0)
    ref = SearchEngine(db, params, nseqs=8, backend="lax").search(query)
    got = SearchEngine(db, params,
                       backend="stream").search(query)
    assert [(h.seqno, h.score) for h in got.hits] == \
           [(h.seqno, h.score) for h in ref.hits]


def test_search_batch_matches_single(protein_setup):
    db, query, recs, q = protein_setup
    rng = np.random.default_rng(4)
    q2 = preprocess_query("q2 other", "".join(rng.choice(list(AA), 55)),
                          1, 3)
    params = SearchParams(symtype=1, descriptions=40, alignments=5)
    eng = SearchEngine(db, params, nseqs=8, backend="lax")
    single = [eng.search(query), eng.search(q2)]
    batch = eng.search_batch([query, q2])
    for s, b in zip(single, batch):
        assert [(h.seqno, h.score) for h in s.hits] == \
               [(h.seqno, h.score) for h in b.hits]


def test_stream_device_topk_matches_full():
    # enough sequences that the device-side top-K reduction kicks in
    # (keephits + 64 < n); results must equal the full-transfer path
    rng = np.random.default_rng(8)
    fasta, recs = _mkfasta(rng, 800, 30, 90, AA)
    db = FastaDatabase(io.StringIO(fasta), "aa", title="big")
    q = preprocess_query("q big", "".join(rng.choice(list(AA), 64)), 1, 3)
    params = SearchParams(symtype=1, descriptions=20, alignments=0,
                          expect=1e9)
    got = SearchEngine(db, params, backend="stream").search(q)
    ref = SearchEngine(db, params, nseqs=8, backend="lax").search(q)
    assert got.keephits + 64 < 800
    assert [(h.seqno, h.score) for h in got.hits] == \
           [(h.seqno, h.score) for h in ref.hits]
    assert got.totalhits == ref.totalhits
    assert got.obvious == ref.obvious


def test_stream_device_topk_upper_cutoff():
    # -u / -k upper cutoffs: the device reduction now masks scores above
    # the cutoff instead of falling back to full transfers; list, order
    # and both counters must match the host path exactly
    rng = np.random.default_rng(18)
    q = "".join(rng.choice(list(AA), 64))
    fasta, recs = _mkfasta(rng, 800, 30, 90, AA,
                           plant={5: q[2:60], 77: q[:50], 401: q[10:62]})
    db = FastaDatabase(io.StringIO(fasta), "aa", title="upper")
    query = preprocess_query("q up", q, 1, 3)
    # maxscore cuts out the planted near-perfect hits
    params = SearchParams(symtype=1, descriptions=20, alignments=0,
                          expect=1e9, maxscore=120)
    got = SearchEngine(db, params, backend="stream").search(query)
    ref = SearchEngine(db, params, nseqs=8, backend="lax").search(query)
    assert got.keephits + 64 < 800
    assert ref.obvious > 0          # the cutoff actually bites
    assert [(h.seqno, h.score) for h in got.hits] == \
           [(h.seqno, h.score) for h in ref.hits]
    assert got.totalhits == ref.totalhits
    assert got.obvious == ref.obvious


def test_stream_long_query_pipeline(protein_setup):
    # a query of 1400+ rows takes the same stream route (the CUDA kernel
    # runs it in strips of rows; the lax twin takes any length) and must
    # match the lax path
    db, _, recs, q = protein_setup
    rng = np.random.default_rng(12)
    longq = preprocess_query(
        "qlong", "".join(rng.choice(list(AA), 1400)) + q, 1, 3)
    params = SearchParams(symtype=1, descriptions=40, alignments=0)
    ref = SearchEngine(db, params, nseqs=8, backend="lax").search(longq)
    got = SearchEngine(db, params,
                       backend="stream").search(longq)
    assert [(h.seqno, h.score) for h in got.hits] == \
           [(h.seqno, h.score) for h in ref.hits]


def test_cli_batch_output_identical(tmp_path):
    # --batch N must render byte-identical reports to sequential runs
    import re
    from contextlib import redirect_stdout

    from swipe_tpu.cli import main as cli_main
    rng = np.random.default_rng(21)
    fasta, recs = _mkfasta(rng, 60, 40, 120, AA)
    (tmp_path / "db.fa").write_text(fasta)
    qs = "".join(">q%d query %d\n%s\n" %
                 (i, i, "".join(rng.choice(list(AA), 50)))
                 for i in range(5))
    (tmp_path / "q.fa").write_text(qs)
    volatile = re.compile(r"^(Search started|Search completed|Elapsed|Speed)")

    def run(extra):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli_main(["-i", str(tmp_path / "q.fa"),
                           "-d", str(tmp_path / "db.fa"), "-m", "0",
                           "--backend", "lax"] + extra)
        assert rc == 0
        return "\n".join(l for l in buf.getvalue().splitlines()
                         if not volatile.match(l))

    assert run([]) == run(["--batch", "5"])


def test_cli_batch_m99_identical(tmp_path):
    # -m 99 carries per-query counters (SWAbsolute, totalCount); --batch
    # must render them identically to sequential runs
    import re
    from contextlib import redirect_stdout

    from swipe_tpu.cli import main as cli_main
    rng = np.random.default_rng(22)
    fasta, recs = _mkfasta(rng, 40, 40, 100, AA)
    (tmp_path / "db.fa").write_text(fasta)
    qs = "".join(">mq%d q %d\n%s\n" %
                 (i, i, "".join(rng.choice(list(AA), 45)))
                 for i in range(4))
    (tmp_path / "q.fa").write_text(qs)
    volatile = re.compile(
        r"\s*<search(Started|Completed|ElapsedTime|Speed)>")

    def run(extra):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli_main(["-i", str(tmp_path / "q.fa"),
                           "-d", str(tmp_path / "db.fa"), "-m", "99",
                           "--backend", "lax"] + extra)
        assert rc == 0
        return "\n".join(l for l in buf.getvalue().splitlines()
                          if not volatile.match(l))

    assert run([]) == run(["--batch", "4"])


def test_batch_mixed_lengths_grouped(protein_setup):
    # short + very long queries in one batch: each routes to its own
    # stream configuration; results must match per-query lax searches
    db, query, recs, q = protein_setup
    rng = np.random.default_rng(31)
    longq = preprocess_query(
        "qlong2", "".join(rng.choice(list(AA), 1300)) + q[:40], 1, 3)
    shortq = preprocess_query("qs", q[:50], 1, 3)
    params = SearchParams(symtype=1, descriptions=40, alignments=0)
    lax = SearchEngine(db, params, nseqs=8, backend="lax")
    want = [lax.search(qq) for qq in (shortq, longq)]
    got = SearchEngine(db, params, backend="stream"
                       ).search_batch([shortq, longq])
    for w, g in zip(want, got):
        assert [(h.seqno, h.score) for h in w.hits] == \
               [(h.seqno, h.score) for h in g.hits]


def test_sound_mode_e2e():
    # symtype 5 ("sound", swipe.cc symtype 5): plain scores, no E-values
    rng = np.random.default_rng(41)
    fasta, recs = _mkfasta(rng, 20, 30, 80, AA)
    db = FastaDatabase(io.StringIO(fasta), "sound", title="sounddb")
    q = preprocess_query("qs sound", recs[3][1][:40], 5, 3)
    params = SearchParams(symtype=5, gapopen=11, gapextend=1)
    eng = SearchEngine(db, params, nseqs=8, backend="lax")
    hits = eng.search(q)
    assert hits.count > 0
    assert not hits.evmodel.available
    buf = io.StringIO()
    rep = Reporter(buf, 0, 5, eng.matrix.matrix, query=q)
    rep.show(hits, "sounddb")
    assert "Score" in buf.getvalue()


def test_stream_uncached_device_path(protein_setup, monkeypatch):
    # databases over the device-cache budget stream per search; results
    # must be identical to the cached path
    from swipe_tpu.pipeline import SearchEngine as SE
    db, query, recs, q = protein_setup
    params = SearchParams(symtype=1, descriptions=40, alignments=0)
    cached = SE(db, params, backend="stream").search(query)
    monkeypatch.setattr(SE, "DEVICE_CACHE_BYTES", 1)
    streamed = SE(db, params, backend="stream").search(query)
    assert [(h.seqno, h.score) for h in cached.hits] == \
           [(h.seqno, h.score) for h in streamed.hits]


def test_cli_error_paths(tmp_path, capsys):
    # fatal() paths behave like the reference: message + exit(1)
    import pytest as _pytest

    from swipe_tpu.cli import main as cli_main
    (tmp_path / "q.fa").write_text(">q\nMKV\n")
    with _pytest.raises(SystemExit):
        cli_main(["-i", str(tmp_path / "q.fa"),
                  "-d", str(tmp_path / "nope"), "--backend", "lax"])
    assert "Cannot open database" in capsys.readouterr().err
    with _pytest.raises(SystemExit):
        cli_main(["-i", str(tmp_path / "q.fa"), "-d", str(tmp_path / "q.fa"),
                  "-m", "3", "--backend", "lax"])
    assert "Illegal view type" in capsys.readouterr().err
    with _pytest.raises(SystemExit):
        cli_main(["-i", str(tmp_path / "q.fa"), "-d", str(tmp_path / "q.fa"),
                  "-C", "T", "--backend", "lax"])
    assert "Composition-based" in capsys.readouterr().err


def test_cli_prime_mode(tmp_path, capsys):
    """--prime compiles one shape class per distinct FRAME qlen bucket
    (translated modes bucket the ~L/3 aa frames, round-5 fix), writes
    nothing to the report stream, and must NOT truncate an existing -o
    results file."""
    from swipe_tpu.cli import main as cli_main
    rng = np.random.default_rng(9)
    fasta = "".join(">s%d x\n%s\n" % (i, "".join(rng.choice(list(AA), 60)))
                    for i in range(6))
    (tmp_path / "db.fa").write_text(fasta)
    (tmp_path / "q.fa").write_text(
        ">q\n" + "".join(rng.choice(list(AA), 40)) + "\n")
    (tmp_path / "out.txt").write_text("precious results")
    rc = cli_main(["-i", str(tmp_path / "q.fa"),
                   "-d", str(tmp_path / "db.fa"), "--backend", "lax",
                   "-o", str(tmp_path / "out.txt"), "--prime"])
    err = capsys.readouterr().err
    assert rc == 0 and "shape class" in err
    assert (tmp_path / "out.txt").read_text() == "precious results"
    # translated mode: the frame buckets drive the sweep (6 frames)
    ntdb = "".join(">n%d x\n%s\n" % (i, "".join(rng.choice(list(NT), 90)))
                   for i in range(6))
    (tmp_path / "ndb.fa").write_text(ntdb)
    (tmp_path / "nq.fa").write_text(
        ">nq\n" + "".join(rng.choice(list(NT), 120)) + "\n")
    rc = cli_main(["-p", "tblastx", "-i", str(tmp_path / "nq.fa"),
                   "-d", str(tmp_path / "ndb.fa"), "--backend", "lax",
                   "--prime"])
    err = capsys.readouterr().err
    assert rc == 0 and "(6 frames)" in err


def test_cli_subprocess_search(tmp_path):
    """The CLI runs as its own process on the CPU backend: rc 0 and the
    reference's banner (JAX_PLATFORMS=cpu is JAX's own switch; the
    program sets no platform itself)."""
    import os
    import subprocess
    import sys

    rng = np.random.default_rng(3)
    fasta = "".join(">s%d x\n%s\n" % (i, "".join(rng.choice(list(AA), 50)))
                    for i in range(5))
    (tmp_path / "db.fa").write_text(fasta)
    (tmp_path / "q.fa").write_text(
        ">q\n" + "".join(rng.choice(list(AA), 40)) + "\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "swipe_tpu.cli",
         "-i", str(tmp_path / "q.fa"), "-d", str(tmp_path / "db.fa"),
         "--backend", "lax"],
        capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0 and "SWIPE 2.1.1" in r.stdout


def test_non_int8_matrix_searches(tmp_path):
    # blastn reward/penalty outside int8: the stream route scores with
    # the int32 matrix on the lax twin (the CUDA kernel's profile is
    # int8) instead of crashing (matrix.fits_int8 False)
    rng = np.random.default_rng(51)
    fasta = "".join(">n%d x\n%s\n" % (i, "".join(rng.choice(list(NT), 60)))
                    for i in range(20))
    db = FastaDatabase(io.StringIO(fasta), "nt", title="widematrix")
    # plant a self-hit
    q = preprocess_query("qw", "".join(rng.choice(list(NT), 40)), 0, 3)
    params = SearchParams(symtype=0, matchscore=200, mismatchscore=-300,
                          gapopen=400, gapextend=200, alignments=0)
    eng = SearchEngine(db, params, backend="stream")
    assert not eng.matrix.fits_int8
    hits = eng.search(q)  # must not raise
    # cross-check against the oracle with the wide matrix
    seqs = [np.asarray(db.get_sequence(i, 0)[0]) for i in range(20)]
    want_p = sw_numpy_many(q.nt[0], seqs, eng.matrix.matrix, 400, 200)
    want_m = sw_numpy_many(q.nt[1], seqs, eng.matrix.matrix, 400, 200)
    for h in hits.hits:
        want = want_m if h.dstrand else want_p
        assert h.score == want[h.seqno]


def test_cli_combined_short_flags(tmp_path, capsys):
    from contextlib import redirect_stdout

    from swipe_tpu.cli import parse_args
    a = parse_args(["-IH", "-d", "x"])
    assert a.show_gis == 1 and a.show_taxid == 1
    a = parse_args(["-I", "-d", "x"])
    assert a.show_gis == 1 and a.show_taxid == 0


def test_cli_atol_prefix_semantics():
    # C atol parses a leading numeric prefix: '-p 1x' runs blastp in the
    # reference rather than dying with 'Illegal symbol type.'
    from swipe_tpu.cli import _atol, parse_args
    assert _atol("1x") == 1
    assert _atol("  -3yz") == -3
    assert _atol("+2 ") == 2
    assert _atol("x1") == 0
    assert _atol(None) == 0
    a = parse_args(["-p", "1x", "-d", "x"])
    assert a.symtype == 1
    a = parse_args(["-S", "2extra", "-p", "0", "-d", "x"])
    assert a.querystrands == 2


def test_hitlist_keephits_zero_counts_only():
    # -v 0 -b 0 is accepted by the reference: counters tick, list stays
    # empty, and the compaction path must not crash past 4096 candidates
    from swipe_tpu.hits import HitList
    from swipe_tpu.stats import EvalueModel

    class _DB:
        def seqcount_masked(self):
            return 10000

        def symcount_masked(self):
            return 10000 * 50

    ev = EvalueModel(1, 50, 10000, 500000, matrixname="NOSUCH",
                     gapopen=3, gapextend=3)
    hl = HitList(0, 0, 1, 2**62, 0.0, 10.0, ev, _DB(), 1, 3)
    assert hl.keephits == 0
    rng = np.random.default_rng(9)
    scores = rng.integers(1, 500, size=10000)
    for i in range(0, 10000, 500):
        sl = slice(i, i + 500)
        hl.enter_batch(np.arange(i, i + 500), scores[sl], 0, 0,
                       np.zeros(500, np.int64), np.zeros(500, np.int64))
    hl.finalize()
    assert hl.hits == [] and hl.totalhits == 10000


def test_empty_query_description_no_line(tmp_path):
    from contextlib import redirect_stdout

    from swipe_tpu.cli import main as cli_main
    rng = np.random.default_rng(52)
    fasta, recs = _mkfasta(rng, 10, 30, 60, AA)
    (tmp_path / "db.fa").write_text(fasta)
    (tmp_path / "q.fa").write_text(">\n" + recs[0][1] + "\n")
    buf = io.StringIO()
    with redirect_stdout(buf):
        cli_main(["-i", str(tmp_path / "q.fa"), "-d", str(tmp_path / "db.fa"),
                  "-m", "0", "--backend", "lax"])
    assert "Query description:" not in buf.getvalue()


def test_cli_outfile(tmp_path):
    from swipe_tpu.cli import main as cli_main
    rng = np.random.default_rng(61)
    fasta, recs = _mkfasta(rng, 15, 30, 60, AA)
    (tmp_path / "db.fa").write_text(fasta)
    (tmp_path / "q.fa").write_text(">q t\n" + recs[2][1] + "\n")
    outf = tmp_path / "res.tsv"
    rc = cli_main(["-i", str(tmp_path / "q.fa"), "-d", str(tmp_path / "db.fa"),
                   "-m", "9", "-o", str(outf), "--backend", "lax"])
    assert rc == 0
    text = outf.read_text()
    assert "seq2" in text and text.startswith("# SWIPE")


def test_device_topk_tie_membership_translated():
    # massive equal-score ties across frames at the top-K boundary:
    # device-side selection must keep exactly the entries the host path
    # keeps (score desc, seqno desc, then frames ascending)
    rng = np.random.default_rng(71)
    s = "".join(rng.choice(list(NT), 90))
    fasta = "".join(f">t{i} same {i}\n{s}\n" for i in range(300))
    db = FastaDatabase(io.StringIO(fasta), "nt", title="ties")
    q = preprocess_query("qt", "".join(rng.choice(list(AA), 30)), 3, 3)
    params = SearchParams(symtype=3, gapopen=11, gapextend=1,
                          descriptions=10, alignments=0, expect=1e9)
    got = SearchEngine(db, params, backend="stream").search(q)
    ref = SearchEngine(db, params, nseqs=8, backend="lax").search(q)
    assert [(h.seqno, h.score, h.dstrand, h.dframe) for h in got.hits] == \
           [(h.seqno, h.score, h.dstrand, h.dframe) for h in ref.hits]


@pytest.mark.parametrize("backend", ["stream", "lax", "stream_carry"])
def test_engine_giant_sequences(backend):
    # db sequences longer than one chunk stream through the bounded carry
    # series (chromosome-scale capability); scores and the align phase
    # must match the oracle exactly
    rng = np.random.default_rng(31)
    parts = []
    for i in range(30):
        parts.append((f"s{i} normal {i}",
                      "".join(rng.choice(list(AA),
                                         int(rng.integers(30, 120))))))
    q = "".join(rng.choice(list(AA), 45))
    parts.append(("s30 giant plain",
                  "".join(rng.choice(list(AA), 5000))))
    parts.append(("s31 giant with planted hit",
                  "".join(rng.choice(list(AA), 6500)) + q
                  + "".join(rng.choice(list(AA), 90))))
    fasta = "".join(f">{d}\n{s}\n" for d, s in parts)
    db = FastaDatabase(io.StringIO(fasta), "aa", title="giantdb")
    query = preprocess_query("q", q, 1, 3)
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=40, alignments=3, expect=1e9)
    # plain stream takes the overlapped-segmentation route; the _carry
    # variant pins the carry series
    base = backend.removesuffix("_carry")
    eng = SearchEngine(db, params, max_cols=2048, backend=base)
    if backend.endswith("_carry"):
        eng.SEGMENT_GIANTS = False
    assert eng._giant_ids.size == 2
    hits = eng.search(query)
    seqs = [np.asarray(db.get_sequence(i, 1)[0]) for i in range(len(parts))]
    want = sw_numpy_many(query.aa[0], seqs, eng.matrix.matrix, 11, 1)
    for h in hits.hits:
        assert h.score == want[h.seqno]
    assert hits.hits[0].seqno == 31          # the planted giant wins
    assert hits.hits[0].alignment            # align phase ran on the giant


def test_engine_segmented_giant_cut_positions():
    # overlapped segmentation must be exact for hits planted AT the
    # piece-cut positions (the overlap bound argument): with
    # max_cols=2048 and this query the stride is ~1024, so plant hits
    # straddling every multiple of 1024 near the front
    rng = np.random.default_rng(35)
    q = "".join(rng.choice(list(AA), 40))
    body = list("".join(rng.choice(list(AA), 9000)))
    for cut in (1024, 2048, 3072, 4096):
        frag = q[5:35]
        body[cut - 15: cut - 15 + len(frag)] = list(frag)
    giant = "".join(body)
    fasta = f">g0 giant\n{giant}\n" + "".join(
        f">s{i} small {i}\n" + "".join(rng.choice(list(AA), 50)) + "\n"
        for i in range(1, 6))
    db = FastaDatabase(io.StringIO(fasta), "aa", title="segcut")
    query = preprocess_query("q", q, 1, 3)
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=6, alignments=0, expect=1e9)
    eng = SearchEngine(db, params, backend="stream",
                       max_cols=2048)
    assert eng._giant_ids.size == 1
    hits = eng.search(query)
    seqs = [np.asarray(db.get_sequence(i, 1)[0]) for i in range(6)]
    want = sw_numpy_many(query.aa[0], seqs, eng.matrix.matrix, 11, 1)
    got = {h.seqno: h.score for h in hits.hits}
    assert got[0] == want[0]


def test_engine_long_query_giant_sequence():
    # an 1100-residue query vs a chromosome-scale unit: the giant route
    # must match the oracle exactly
    rng = np.random.default_rng(34)
    q = "".join(rng.choice(list(AA), 1100))
    parts = [(f"s{i} normal {i}",
              "".join(rng.choice(list(AA), int(rng.integers(30, 100)))))
             for i in range(12)]
    parts.append(("s12 giant with planted hit",
                  "".join(rng.choice(list(AA), 1500)) + q[300:420]
                  + "".join(rng.choice(list(AA), 1400))))
    fasta = "".join(f">{d}\n{s}\n" for d, s in parts)
    db = FastaDatabase(io.StringIO(fasta), "aa", title="longgiant")
    query = preprocess_query("q", q, 1, 3)
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=13, alignments=0, expect=1e9)
    eng = SearchEngine(db, params, backend="stream",
                       max_cols=2048)
    assert eng._giant_ids.size == 1
    hits = eng.search(query)
    seqs = [np.asarray(db.get_sequence(i, 1)[0]) for i in range(len(parts))]
    want = sw_numpy_many(query.aa[0], seqs, eng.matrix.matrix, 11, 1)
    for h in hits.hits:
        assert h.score == want[h.seqno]
    assert hits.hits[0].seqno == 12


def test_engine_giant_hint_segmentation_identical(monkeypatch):
    # the align phase's segmented hint route (subjects past
    # GIANT_HINT_MIN split into overlapped owned-column pieces) must
    # leave every displayed alignment byte-identical to the unsegmented
    # hint pass, wired through the full engine
    from swipe_tpu.ops import align_hint as AH
    rng = np.random.default_rng(36)
    q = "".join(rng.choice(list(AA), 45))
    body = list("".join(rng.choice(list(AA), 7000)))
    body[3000:3030] = list(q[8:38])
    body[6200:6230] = list(q[8:38])      # second copy: endpoint tie
    parts = [("g0 giant twin-planted", "".join(body))] + [
        (f"s{i} small {i}", "".join(rng.choice(list(AA), 80)))
        for i in range(1, 8)]
    fasta = "".join(f">{d}\n{s}\n" for d, s in parts)
    query = preprocess_query("q", q, 1, 3)
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=8, alignments=8, expect=1e9)

    def run():
        db = FastaDatabase(io.StringIO(fasta), "aa", title="hintseg")
        eng = SearchEngine(db, params, backend="stream",
                           max_cols=2048)
        hits = eng.search(query)
        return [(h.seqno, h.score, h.align_q_start, h.align_d_start,
                 h.align_q_end, h.align_d_end, h.alignment)
                for h in hits.hits]

    want = run()
    monkeypatch.setattr(AH, "GIANT_HINT_MIN", 1024)
    assert run() == want


def test_engine_all_units_giant():
    # a db of ONLY chromosome-scale sequences: the normal pack is empty
    # and everything flows through the carry series
    rng = np.random.default_rng(32)
    q = "".join(rng.choice(list(AA), 40))
    parts = [(f"g{i} giant {i}",
              "".join(rng.choice(list(AA), 3000 + 500 * i)))
             for i in range(3)]
    fasta = "".join(f">{d}\n{s}\n" for d, s in parts)
    db = FastaDatabase(io.StringIO(fasta), "aa", title="allgiant")
    query = preprocess_query("q", q, 1, 3)
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=5, alignments=0, expect=1e9)
    eng = SearchEngine(db, params, backend="stream",
                       max_cols=2048)
    assert eng._giant_ids.size == 3 and eng._normal_ids.size == 0
    hits = eng.search(query)
    seqs = [np.asarray(db.get_sequence(i, 1)[0]) for i in range(3)]
    want = sw_numpy_many(query.aa[0], seqs, eng.matrix.matrix, 11, 1)
    assert {h.seqno: h.score for h in hits.hits} == \
           {i: int(want[i]) for i in range(3) if want[i] >= 1}


def test_engine_giant_blastn_both_strands():
    # blastn: both strand units of a giant nucleotide sequence go carry
    rng = np.random.default_rng(33)
    q = "".join(rng.choice(list(NT), 60))
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    qrc = "".join(comp[c] for c in reversed(q))
    giant = ("".join(rng.choice(list(NT), 4000)) + qrc
             + "".join(rng.choice(list(NT), 200)))
    parts = [(f"n{i} nt {i}",
              "".join(rng.choice(list(NT), int(rng.integers(40, 150)))))
             for i in range(12)] + [("n12 giant rc-planted", giant)]
    fasta = "".join(f">{d}\n{s}\n" for d, s in parts)
    db = FastaDatabase(io.StringIO(fasta), "nt", title="giantnt")
    query = preprocess_query("q", q, 0, 3)
    params = SearchParams(symtype=0, matchscore=1, mismatchscore=-3,
                          gapopen=5, gapextend=2, descriptions=13,
                          alignments=2, expect=1e9)
    eng = SearchEngine(db, params, backend="stream",
                       max_cols=1024)
    # blastn strand variants live on the QUERY axis (swipe.cc:1468);
    # the db contributes one unit per sequence
    assert eng._giant_ids.size == 1
    hits = eng.search(query)
    top = hits.hits[0]
    assert top.seqno == 12 and top.dstrand == 1
    assert top.score == 60            # perfect reverse-complement match


def test_hitlist_candidate_compaction():
    # stats-unavailable mode admits nearly every sequence; the candidate
    # buffer must stay bounded and still produce the exact final list
    from swipe_tpu.hits import HitList
    from swipe_tpu.stats import EvalueModel

    class _DB:
        def seqcount_masked(self):
            return 6000

        def symcount_masked(self):
            return 6000 * 50

    ev = EvalueModel(1, 50, 6000, 300000, matrixname="NOSUCH",
                     gapopen=3, gapextend=3)
    assert not ev.available
    hl = HitList(20, 5, 1, 2**62, 0.0, 10.0, ev, _DB(), 1, 3)
    rng = np.random.default_rng(5)
    scores = rng.integers(1, 500, size=6000)
    want = sorted(((-int(s), -i) for i, s in enumerate(scores)))[:hl.keephits]
    for i in range(0, 6000, 100):
        sl = slice(i, i + 100)
        hl.enter_batch(np.arange(i, i + 100), scores[sl], 0, 0,
                       np.zeros(100, np.int64), np.zeros(100, np.int64))
        assert hl._ncand <= max(4 * hl.keephits, 4096) + 100
    hl.finalize()
    assert [(-h.score, -h.seqno) for h in hl.hits] == want
    assert hl.totalhits == 6000


def test_engine_giant_zero_gapextend():
    # -E 0 (free gap extension, legal input) makes the segmentation span
    # bound infinite: _overlap_bound must route giants to the carry
    # series instead of dividing by zero, and scores stay exact
    rng = np.random.default_rng(41)
    q = "".join(rng.choice(list(AA), 40))
    parts = [(f"s{i} n", "".join(rng.choice(list(AA),
                                            int(rng.integers(30, 100)))))
             for i in range(10)]
    parts.append(("s10 giant", "".join(rng.choice(list(AA), 4000)) + q))
    fasta = "".join(f">{d}\n{s}\n" for d, s in parts)
    db = FastaDatabase(io.StringIO(fasta), "aa", title="ge0")
    params = SearchParams(symtype=1, gapopen=12, gapextend=0,
                          descriptions=20, alignments=2, expect=1e9)
    eng = SearchEngine(db, params, max_cols=2048, backend="stream")
    assert eng._giant_ids.size == 1
    assert eng._overlap_bound(64) > eng._max_cols // 2   # no segmentation
    query = preprocess_query("q", q, 1, 3)
    hits = eng.search(query)
    seqs = [np.asarray(db.get_sequence(i, 1)[0]) for i in range(len(parts))]
    want = sw_numpy_many(query.aa[0], seqs, eng.matrix.matrix, 12, 0)
    for h in hits.hits:
        assert h.score == want[h.seqno]
    assert hits.hits[0].seqno == 10


def test_engine_giant_batch_slot_groups_lax():
    # a batch beyond SLOT_BATCH slots must flow through the carry series
    # in bounded slot groups (the lax fallback used to pass every slot at
    # once); batch results == per-query results
    rng = np.random.default_rng(43)
    parts = [(f"s{i} n", "".join(rng.choice(list(AA),
                                            int(rng.integers(30, 90)))))
             for i in range(8)]
    parts.append(("s8 giant", "".join(rng.choice(list(AA), 9000))))
    fasta = "".join(f">{d}\n{s}\n" for d, s in parts)
    db = FastaDatabase(io.StringIO(fasta), "aa", title="slotdb")
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=10, alignments=0, expect=1e9)
    queries = [preprocess_query(f"q{i}",
                                "".join(rng.choice(list(AA), 30)), 1, 3)
               for i in range(20)]
    eng = SearchEngine(db, params, max_cols=2048, backend="lax")
    assert len(queries) > eng.SLOT_BATCH
    batch = eng.search_batch(queries)
    for q, hl in zip(queries, batch):
        solo = SearchEngine(db, params, max_cols=2048,
                            backend="lax").search(q)
        assert [(h.seqno, h.score) for h in hl.hits] == \
               [(h.seqno, h.score) for h in solo.hits]


def test_stream_batch_pow2_tail_group(protein_setup):
    # a multi-group stream batch pads its TAIL group to its own power of
    # two ({1,2,4,8} shapes), not the full SLOT_BATCH (a dead slot still
    # costs its share of the kernel); results must stay identical to
    # per-query searches across the 16+2 group split
    db, _, recs, q = protein_setup
    rng = np.random.default_rng(47)
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=20, alignments=0, expect=1e9)
    queries = [preprocess_query(
        f"q{i}", "".join(rng.choice(list(AA), int(rng.integers(25, 60)))),
        1, 3) for i in range(17)]
    queries.append(preprocess_query("qhit", q, 1, 3))
    eng = SearchEngine(db, params, backend="stream")
    assert len(queries) > eng.SLOT_BATCH
    batch = eng.search_batch(queries)
    for qu, hl in zip(queries, batch):
        solo = eng.search(qu)
        assert [(h.seqno, h.score) for h in hl.hits] == \
               [(h.seqno, h.score) for h in solo.hits]


def test_segmented_giant_pack_cached():
    # the giant piece pack (host slicing + device upload) is built once
    # per (nseqs, V) and reused across searches and slot groups — a
    # genome-scale pack used to be re-sliced and re-uploaded per group
    rng = np.random.default_rng(47)
    q = "".join(rng.choice(list(AA), 40))
    parts = [("s0 giant", "".join(rng.choice(list(AA), 5000)) + q)]
    fasta = "".join(f">{d}\n{s}\n" for d, s in parts)
    db = FastaDatabase(io.StringIO(fasta), "aa", title="segcache")
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=5, alignments=0, expect=1e9)
    eng = SearchEngine(db, params, max_cols=2048, backend="stream")
    query = preprocess_query("q", q, 1, 3)
    h1 = eng.search(query)
    assert len(eng._seg_packs) == 1 and len(eng._dev_seg) == 1
    h2 = eng.search(query)
    assert len(eng._seg_packs) == 1 and len(eng._dev_seg) == 1
    assert [(h.seqno, h.score) for h in h1.hits] == \
           [(h.seqno, h.score) for h in h2.hits]
    seqs = [np.asarray(db.get_sequence(0, 1)[0])]
    want = sw_numpy_many(query.aa[0], seqs, eng.matrix.matrix, 11, 1)
    assert h1.hits[0].score == want[0]


def test_cli_internal_align_error_is_clean_fatal(tmp_path, capsys):
    # an empty db sequence shown under -c 0 trips the align phase's
    # "Internal error in align function." — the CLI must render it as
    # the reference's fatal() (bare message on stderr, exit 1), not a
    # Python traceback.  (The reference binary itself SEGFAULTS on this
    # input; the fatal matches its score-0 behavior, align.cc:156.)
    import pytest as _pytest

    from swipe_tpu.alphabet import MAP_NCBI_AA, encode
    from swipe_tpu.cli import main
    from swipe_tpu.io.blastdb_writer import make_deflines, write_blastdb
    seqs = [encode("ARNDCQEGHILKMFPSTWYV", MAP_NCBI_AA),
            encode("", MAP_NCBI_AA)]
    write_blastdb(str(tmp_path / "edb"), seqs,
                  make_deflines(["s0 first", "s1 empty"]), "aa",
                  title="edb")
    qf = tmp_path / "q.fa"
    qf.write_text(">q test\nARNDCQEGHILKMFPSTWYV\n")
    with _pytest.raises(SystemExit) as exc:
        main(["-d", str(tmp_path / "edb"), "-i", str(qf), "-c", "0",
              "-e", "1e9", "-v", "10", "-b", "10", "--backend", "lax"])
    assert exc.value.code == 1
    assert capsys.readouterr().err == "Internal error in align function.\n"


def test_stream_flow_route_heavy_tail():
    """Heavy length tail over a small db: the engine must take the flow
    route (pack_stream_flow + carry kernel + state permute) and still
    match the oracle exactly, including sequences spanning chunk cuts."""
    rng = np.random.default_rng(91)
    q = "".join(rng.choice(list(AA), 60))
    plant = {5: "".join(rng.choice(list(AA), 1500)) + q[10:55],
             17: q[5:50] + "".join(rng.choice(list(AA), 900))}
    fasta, recs = _mkfasta(rng, 150, 20, 120, AA, plant=plant)
    db = FastaDatabase(io.StringIO(fasta), "aa", title="flowdb")
    query = preprocess_query("qf flow", q, 1, 3)
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=150, alignments=0, expect=1e9)
    eng = SearchEngine(db, params, backend="stream")
    eng.FLOW_MIN_AVG_LANE = 0       # engage flow on this small test db
    assert eng._flow_cols(1024) is not None       # the route must engage
    hits = eng.search(query)
    from swipe_tpu.alphabet import MAP_NCBI_AA, encode
    seqs = [encode(s, MAP_NCBI_AA) for _, s in recs]
    want = sw_numpy_many(query.aa[0], seqs, eng.matrix.matrix, 11, 1)
    got = {h.seqno: h.score for h in hits.hits}
    for sno, sc in got.items():
        assert sc == want[sno]
    assert 5 in got and 17 in got
    # device top-K reduced path too (keephits < ending units per chunk)
    params2 = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=5, alignments=0, expect=1e9)
    eng2 = SearchEngine(db, params2, backend="stream")
    eng2.FLOW_MIN_AVG_LANE = 0
    hits2 = eng2.search(query)
    top = sorted(want, key=lambda *_: 0)
    order = np.lexsort((-np.arange(len(want)), -want))
    assert [h.seqno for h in hits2.hits] == list(order[:5])


def test_batch_align_matches_single_query_align():
    """A multi-query batch's align phase (one hint pass over every
    (query, bin)) produces the same alignments as the queries searched
    one at a time."""
    rng = np.random.default_rng(93)
    base = "".join(rng.choice(list(AA), 90))
    fasta, recs = _mkfasta(rng, 60, 40, 160, AA,
                           plant={k: base[k:60 + k] for k in range(6)})
    db = FastaDatabase(io.StringIO(fasta), "aa", title="griddb")
    queries = [preprocess_query(f"g{k}", base[k:80 + k], 1, 3)
               for k in range(6)]
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=20, alignments=20)
    eng = SearchEngine(db, params, backend="lax")
    got = eng.search_batch(queries)
    for qu, hg in zip(queries, got):
        hr = eng.search(qu)
        assert [(h.seqno, h.score, h.alignment, h.align_q_start,
                 h.align_d_start) for h in hg.hits] == \
               [(h.seqno, h.score, h.alignment, h.align_q_start,
                 h.align_d_start) for h in hr.hits]


def test_engine_backend_names():
    """Backends are "stream", "lax" and "auto" (lax on the CPU); the
    names of removed kernels are refused, not silently remapped."""
    rng = np.random.default_rng(5)
    fasta, _ = _mkfasta(rng, 10, 20, 40, AA)
    db = FastaDatabase(io.StringIO(fasta), "aa", title="names")
    params = SearchParams(symtype=1)
    assert SearchEngine(db, params).backend == "lax"
    assert SearchEngine(db, params, backend="stream").backend == "stream"
    for gone in ("pallas", "pallas_v1", "pallas_interpret",
                 "stream_interpret"):
        with pytest.raises(ValueError, match="unknown backend"):
            SearchEngine(db, params, backend=gone)


def test_stream_multichunk_fused_walk_matches_lax():
    """Device-cached multi-chunk databases score through ONE jitted walk
    (single packed result); hits, counters, and tie order must match the
    per-chunk lax route exactly."""
    rng = np.random.default_rng(97)
    q = "".join(rng.choice(list(AA), 70))
    fasta, recs = _mkfasta(rng, 2000, 40, 140, AA,
                           plant={7: q[5:65], 123: q[:40] + q[20:60],
                                  1999: q[10:66]})
    db = FastaDatabase(io.StringIO(fasta), "aa", title="walkdb")
    query = preprocess_query("qw walk", q, 1, 3)
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=50, alignments=5, expect=1e9)
    eng = SearchEngine(db, params, nseqs=1024, max_cols=128,
                       backend="stream")
    assert len(eng._stream_chunks(1024)) > 1
    got = eng.search(query)
    want = SearchEngine(db, params, backend="lax").search(query)
    assert [(h.seqno, h.score) for h in got.hits] == \
           [(h.seqno, h.score) for h in want.hits]
    assert got.totalhits == want.totalhits


def test_stream_flow_route_query_stream_minter():
    """A query BATCH through the flow route (pipeline._flow_walk): drain
    chunks, lane permutes and the series head (no carried state in) and
    tail (no state out); scores must match the oracle exactly for every
    query."""
    rng = np.random.default_rng(95)
    qs = ["".join(rng.choice(list(AA), 55 + 7 * k)) for k in range(4)]
    plant = {3: "".join(rng.choice(list(AA), 1200)) + qs[0][5:50],
             29: qs[2][2:40] + "".join(rng.choice(list(AA), 700))}
    fasta, recs = _mkfasta(rng, 160, 20, 120, AA, plant=plant)
    db = FastaDatabase(io.StringIO(fasta), "aa", title="flowdb4")
    queries = [preprocess_query(f"q{k}", q, 1, 3) for k, q in enumerate(qs)]
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=160, alignments=0, expect=1e9)
    eng = SearchEngine(db, params, backend="stream")
    eng.FLOW_MIN_AVG_LANE = 0
    assert eng._flow_cols(1024) is not None
    hitlists = eng.search_batch(queries)
    from swipe_tpu.alphabet import MAP_NCBI_AA, encode
    seqs = [encode(s, MAP_NCBI_AA) for _, s in recs]
    for query, hits in zip(queries, hitlists):
        want = sw_numpy_many(query.aa[0], seqs, eng.matrix.matrix, 11, 1)
        for h in hits.hits:
            assert h.score == want[h.seqno], (h.seqno, h.score)


def test_stream_tall_query_plain_pack_matches_oracle():
    """A 300-residue query (384-row bucket) on the plain lane pack: scores
    must match the oracle exactly, planted hits included."""
    rng = np.random.default_rng(97)
    q = "".join(rng.choice(list(AA), 300))
    fasta, recs = _mkfasta(rng, 300, 30, 150, AA,
                           plant={7: q[5:120], 42: q[100:260]})
    db = FastaDatabase(io.StringIO(fasta), "aa", title="tall")
    query = preprocess_query("qtall", q, 1, 3)
    params = SearchParams(symtype=1, gapopen=11, gapextend=1,
                          descriptions=300, alignments=0, expect=1e9)
    eng = SearchEngine(db, params, backend="stream")
    assert eng._flow_cols(eng._nseqs) is None   # plain-pack route
    hits = eng.search(query)
    from swipe_tpu.alphabet import MAP_NCBI_AA, encode
    seqs = [encode(s, MAP_NCBI_AA) for _, s in recs]
    want = sw_numpy_many(query.aa[0], seqs, eng.matrix.matrix, 11, 1)
    for h in hits.hits:
        assert h.score == want[h.seqno]
    assert {7, 42} <= {h.seqno for h in hits.hits}
