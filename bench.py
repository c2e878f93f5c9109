"""Benchmark: one-card Smith-Waterman database-search throughput (GCUPS).

Measurement config 1 of BASELINE.md through the engine's own route
(SearchEngine: the lane-stream route with the CUDA kernel on an NVIDIA
GPU): ~200-aa protein queries, BLOSUM62 gap 11/1, against a 10k-sequence
protein database with Swiss-Prot-fitted lengths and composition
(bench_corpus), exact int32 scores, top-100 alignments per query.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", "card", ...}.  ``value`` is the search phase's GCUPS (the
reference's own meter, swipe.cc:1744-1782) for one query, the median of
TRIALS searches after a warm-up; ``batch16_wall_s`` is the wall of a
16-query ``search_batch`` including the align phase.  vs_baseline
compares with the reference's published aggregate throughput (~106
GCUPS on a dual 6-core Xeon X5650; Rognes 2011).  Needs an NVIDIA GPU:
without one it exits 1 and prints no result.
"""

import io
import json
import time

import numpy as np

BASELINE_GCUPS = 106.0  # reference machine aggregate (Rognes 2011)
TRIALS = 5


def main():
    from bench_corpus import swissprot_fasta, swissprot_letters
    from swipe_tpu import native
    from swipe_tpu.cli import _enable_compile_cache
    from swipe_tpu.devices import card_info, require_gpu
    from swipe_tpu.io.db import FastaDatabase
    from swipe_tpu.io.fasta import preprocess_query
    from swipe_tpu.pipeline import SearchEngine, SearchParams, SearchTimings

    dev = require_gpu("bench")
    card = card_info().splitlines()[0]
    _enable_compile_cache()
    native.tune_malloc()

    rng = np.random.default_rng(0)
    t0 = time.time()
    db = FastaDatabase(io.StringIO(swissprot_fasta(10_000, rng)), "aa",
                       title="cfg1")
    queries = [preprocess_query(f"q{i}", swissprot_letters(200, rng), 1, 3)
               for i in range(TRIALS + 1 + 32)]
    eng = SearchEngine(db, SearchParams(symtype=1, gapopen=11, gapextend=1,
                                        alignments=100))
    eng.search(queries[0])                      # compile + warm
    setup_s = time.time() - t0
    speeds = []
    for q in queries[1:TRIALS + 1]:
        t = SearchTimings()
        hits = eng.search(q, t)
        assert hits.count > 0
        speeds.append(t.speed / 1e9)
    gcups = float(np.median(speeds))
    batch = queries[TRIALS + 1:]
    eng.search_batch(batch[:16])                # warm the batch shapes
    t0 = time.time()
    eng.search_batch(batch[16:])
    wall16 = time.time() - t0
    print(json.dumps({
        "metric": "GCUPS_1card_blastp_10kseq",
        "value": round(gcups, 3),
        "unit": "GCUPS",
        "vs_baseline": round(gcups / BASELINE_GCUPS, 3),
        "device": dev,
        "card": card,
        "backend": eng.backend,
        "batch16_wall_s": round(wall16, 4),
        "setup_s": round(setup_s, 2),
    }), flush=True)


if __name__ == "__main__":
    main()
