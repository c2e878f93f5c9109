"""BASELINE.md measurement configs 2-4 (one JSON line each).

bench.py covers config 1; this script exercises the fuller
configurations end-to-end through SearchEngine — E-values, gapped
alignments of the top hits, query batches, nucleotide mode — on one
NVIDIA GPU (without one it exits 1 and prints no result).  Every line
names the device and card.  Scales are trimmed to finish in minutes;
pass --full for the full BASELINE sizes.
"""

import io
import json
import sys
import time

import numpy as np

from bench_corpus import swissprot_fasta, swissprot_letters

AA = "ARNDCQEGHILKMFPSTWYV"
NT = "ACGT"


def _fasta(rng, n, lo, hi, alphabet):
    out = []
    for i in range(n):
        s = "".join(rng.choice(list(alphabet), int(rng.integers(lo, hi))))
        out.append(f">s{i} seq {i}\n{s}\n")
    return "".join(out)


def config2():
    """~200aa query, BLOSUM62, 10k-seq db, alignments + E-values."""
    from swipe_tpu.io.db import FastaDatabase
    from swipe_tpu.io.fasta import preprocess_query
    from swipe_tpu.pipeline import SearchEngine, SearchParams, SearchTimings

    rng = np.random.default_rng(0)
    # Swiss-Prot composition + length model (bench_corpus)
    db = FastaDatabase(io.StringIO(swissprot_fasta(10_000, rng)), "aa",
                       title="cfg2")
    q = preprocess_query("q cfg2", swissprot_letters(200, rng), 1, 3)
    eng = SearchEngine(db, SearchParams(symtype=1, gapopen=11, gapextend=1,
                                        alignments=100))
    eng.search(q)                       # warm-up/compile
    t = SearchTimings()
    hits = eng.search(q, t)
    assert hits.evmodel.available and hits.count > 0
    return {"metric": "cfg2_blastp_aligned_evalues",
            "value": round(t.speed / 1e9, 3), "unit": "GCUPS",
            "hits": hits.count}


def config2_batch():
    """Config-2 workload at batch scale, measured as WALL (search +
    E-values + batched hint pass + gapped tracebacks + hit fill), not
    the search-phase meter: the number a user's clock sees."""
    import time

    from swipe_tpu.io.db import FastaDatabase
    from swipe_tpu.io.fasta import preprocess_query
    from swipe_tpu.pipeline import SearchEngine, SearchParams

    rng = np.random.default_rng(0)
    db = FastaDatabase(io.StringIO(swissprot_fasta(10_000, rng)), "aa",
                       title="cfg2b")
    qs = [preprocess_query(f"q{i}", swissprot_letters(200, rng), 1, 3)
          for i in range(32)]
    eng = SearchEngine(db, SearchParams(symtype=1, gapopen=11, gapextend=1,
                                        alignments=100))
    from swipe_tpu.pipeline import SearchTimings

    eng.search_batch(qs[:16])           # warm both phases' shapes
    t = SearchTimings()
    t0 = time.time()
    hl = eng.search_batch(qs[16:32], t)
    wall = time.time() - t0
    cells = 16 * 200 * db.symcount()
    assert all(h.count > 0 for h in hl)
    # itemization: SearchTimings spans the SEARCH phase (the
    # reference's clock, swipe.cc clock_start/stop); the remainder of
    # the wall is the align phase (hint pass + gapped tracebacks +
    # render prep) + E-value/hit fill
    search_s = t.elapsed
    return {"metric": "cfg2_batch16_wall_aligned",
            "value": round(cells / wall / 1e9, 3), "unit": "GCUPS",
            "wall_s": round(wall, 3),
            "search_s": round(search_s, 3),
            "align_s": round(max(wall - search_s, 0.0), 3)}


def config3(full: bool):
    """Nucleotide +1/-3, query batch vs DNA db (BASELINE: 1k x 100k)."""
    from swipe_tpu.io.db import FastaDatabase
    from swipe_tpu.io.fasta import preprocess_query
    from swipe_tpu.pipeline import SearchEngine, SearchParams, SearchTimings

    nq, ndb = (1000, 100_000) if full else (256, 100_000)
    rng = np.random.default_rng(1)
    db = FastaDatabase(io.StringIO(_fasta(rng, ndb, 200, 800, NT)), "nt",
                       title="cfg3")
    queries = [preprocess_query(f"q{i}", "".join(rng.choice(list(NT), 500)),
                                0, 3) for i in range(nq)]
    eng = SearchEngine(db, SearchParams(symtype=0, matchscore=1,
                                        mismatchscore=-3, gapopen=5,
                                        gapextend=2, alignments=0,
                                        descriptions=100))
    eng.search_batch(queries[:8])       # warm-up/compile
    t = SearchTimings()
    hls = eng.search_batch(queries, t)
    assert all(h.count >= 0 for h in hls)
    return {"metric": f"cfg3_blastn_batch{nq}_db{ndb}",
            "value": round(t.speed / 1e9, 3), "unit": "GCUPS"}


def config4(full: bool):
    """Swiss-Prot-scale protein db, query batch (BASELINE: 570k x 100q)."""
    from swipe_tpu.io.db import FastaDatabase
    from swipe_tpu.io.fasta import preprocess_query
    from swipe_tpu.pipeline import SearchEngine, SearchParams, SearchTimings

    nq, ndb = (100, 570_000) if full else (16, 120_000)
    rng = np.random.default_rng(2)
    # Swiss-Prot composition + length model (bench_corpus)
    db = FastaDatabase(io.StringIO(swissprot_fasta(ndb, rng)), "aa",
                       title="cfg4")
    queries = [preprocess_query(f"q{i}", swissprot_letters(200, rng), 1, 3)
               for i in range(nq)]
    eng = SearchEngine(db, SearchParams(symtype=1, gapopen=11, gapextend=1,
                                        alignments=0, descriptions=100))
    eng.search_batch(queries[:16])      # warm-up/compile (same slot-group size)
    if nq % 16:
        eng.search_batch(queries[:nq % 16])   # tail-group pow2 shape
    t = SearchTimings()
    eng.search_batch(queries, t)
    d = {"metric": f"cfg4_blastp_batch{nq}_db{ndb}",
         "value": round(t.speed / 1e9, 3), "unit": "GCUPS"}
    # LPT area occupancy of the lane pack actually dispatched
    # (config-4-scale mean lane load >> longest member, so plain LPT
    # packs dense)
    packs = max(eng._stream_packs.values(), default=[],
                key=lambda lst: sum(int(c.data_t.size) for c in lst))
    if packs:
        area = sum(int(c.data_t.size) for c in packs)
        d["cfg4_occupancy"] = round(float(eng._norm_lens.sum()) / area, 4)
    # compiled walk shape classes this whole batch needed (cold-start
    # cost scales with this count; the pow2 tail adds exactly one)
    d["walk_shape_classes"] = len(getattr(eng, "_flow_walk_cache", {}))
    return d


def main():
    from swipe_tpu.cli import _enable_compile_cache
    from swipe_tpu.devices import card_info, require_gpu
    dev = require_gpu("bench_configs")
    card = card_info().splitlines()[0]
    _enable_compile_cache()
    full = "--full" in sys.argv
    only = [a for a in sys.argv[1:] if a.startswith("--cfg=")]
    want = only[0].split("=")[1].split(",") if only else ["2", "3", "4"]
    runs = []
    if "2" in want:
        runs += [config2, config2_batch]
    if "3" in want:
        runs.append(lambda: config3(full))
    if "4" in want:
        runs.append(lambda: config4(full))
    for run in runs:
        print(json.dumps({**run(), "device": dev, "card": card}),
              flush=True)


if __name__ == "__main__":
    main()
