"""The CUDA stream kernel against the lax twin, on the card.

    python tools/stream_kernel_ab.py [--only chunks|engine]
                                     [--out chiprun_out/stream_kernel_ab.json]

``chunks``: the scoring call alone on single lane-packed chunks, no
engine around it — 4 queries x 250 aa x 2048 lanes x 1024 columns with
both kernels, then one and sixteen 200-aa queries x 2048 and 4096 lanes x
4096 columns with the CUDA kernel (the lane count per chunk the engine
takes on a GPU, SearchEngine.stream_lanes).

``engine``: two shapes of BASELINE.md: config 1 (10k Swiss-Prot-like sequences, one
200-aa query; the engine takes the flow series) and config 4 (570k
Swiss-Prot-like sequences, a batch of 16 200-aa queries).  For each, one
SearchEngine per kernel ("cuda", "lax"), both warmed, then

* end to end: ``search_batch`` wall and its search phase (SearchTimings),
  in turns cuda, lax, lax, cuda so drift cancels;
* on the device: one search per kernel under ``jax.profiler``, reduced to
  the device's busy time (union of the GPU stream events) and the time
  of the CUDA kernel's own events (``sw_stream_kernel``).

Prints one line per measurement with the card, and writes the numbers as
JSON.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import glob
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _union_ns(spans) -> float:
    busy, end = 0.0, -1.0
    for s, e in sorted(spans):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def reduce_trace(trace_dir: str) -> dict:
    """Device busy time (union of the stream events of all GPUs, and of
    each GPU) and CUDA-kernel time (seconds) from an xplane."""
    from jax.profiler import ProfileData
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    spans, per_device, kernel_ns, nevents = [], {}, 0, 0
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        mine = per_device.setdefault(plane.name, [])
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                nevents += 1
                mine.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                if "sw_stream_kernel" in ev.name:
                    kernel_ns += ev.duration_ns
        spans += mine
    return {"device_busy_s": _union_ns(spans) / 1e9,
            "busy_per_device_s": [_union_ns(per_device[k]) / 1e9
                                  for k in sorted(per_device)],
            "cuda_kernel_s": kernel_ns / 1e9, "device_events": nevents}


def measure(name, db, queries, card, reps, out):
    import jax

    from swipe_tpu.pipeline import SearchEngine, SearchParams, SearchTimings

    from swipe_tpu.ops.sw_stream import forced_kernel

    params = SearchParams(symtype=1, gapopen=11, gapextend=1)
    engines = {}
    for k in ("cuda", "lax"):
        with forced_kernel(k):
            engines[k] = SearchEngine(db, params, backend="stream")
    for eng in engines.values():
        eng.search_batch(queries)                    # compile + warm
    rows = {k: [] for k in engines}
    for _ in range(reps):
        for k in ("cuda", "lax", "lax", "cuda"):
            t = SearchTimings()
            t0 = time.perf_counter()
            engines[k].search_batch(queries, t)
            rows[k].append((time.perf_counter() - t0, t.elapsed, t.speed))
    res = {}
    for k, r in rows.items():
        wall = float(np.median([x[0] for x in r]))
        search = float(np.median([x[1] for x in r]))
        gcups = float(np.median([x[2] for x in r])) / 1e9
        with tempfile.TemporaryDirectory() as tdir:
            with jax.profiler.trace(tdir):
                engines[k].search_batch(queries)
            tr = reduce_trace(tdir)
        res[k] = {"wall_s": wall, "search_s": search, "gcups": gcups,
                  "runs": len(r), **tr}
        print(f"{name} kernel {k}: end to end wall {wall:.4f}s, search "
              f"{search:.4f}s ({gcups:.1f} GCUPS); traced device busy "
              f"{tr['device_busy_s']:.4f}s, CUDA kernel "
              f"{tr['cuda_kernel_s']:.4f}s, {tr['device_events']} device "
              f"events [{card}]", flush=True)
    res["speedup_search"] = res["lax"]["search_s"] / res["cuda"]["search_s"]
    res["speedup_device"] = (res["lax"]["device_busy_s"]
                             / res["cuda"]["device_busy_s"])
    out[name] = res


def isolated_chunks(card, out, reps=5):
    """Median time of the scoring call on one chunk, and GCUPS counted
    over the queries' real rows."""
    import jax
    import jax.numpy as jnp

    from swipe_tpu.batching import pack_stream
    from swipe_tpu.matrices import ScoreMatrix
    from swipe_tpu.ops.sw_stream import (build_matrix8, build_qcodes,
                                         sw_scores_stream)

    rng = np.random.default_rng(0)
    m8 = jnp.asarray(build_matrix8(ScoreMatrix.builtin(
        "BLOSUM62", gapopen=11, gapextend=1).matrix))

    def chunk(nseqs, ncols):
        seqs = [rng.integers(0, 24, size=int(n), dtype=np.int8)
                for n in rng.integers(20, 400, size=nseqs * ncols // 200)]
        ch = pack_stream(seqs, nseqs=nseqs, max_cols=ncols)[0]
        return jnp.asarray(ch.data_t.T.copy()), jnp.asarray(ch.start)

    def run(nq, qlen, qlen_pad, nseqs, ncols, kernel):
        db, st = chunk(nseqs, ncols)
        qc, ql = map(jnp.asarray, build_qcodes(
            [rng.integers(0, 24, size=qlen, dtype=np.int8)] * nq, qlen_pad))

        def f():
            return sw_scores_stream(qc, ql, m8, db, st, gapopenextend=12,
                                    gapextend=1, kernel=kernel)
        jax.block_until_ready(f())
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(f())
            times.append(time.perf_counter() - t0)
        t = float(np.median(times))
        gcups = nq * qlen * db.shape[0] * nseqs / t / 1e9
        key = f"chunk_{nq}x{qlen}_{nseqs}lanes_{db.shape[0]}cols_{kernel}"
        out[key] = {"s": t, "gcups": gcups, "runs": reps}
        print(f"{key}: {t * 1e3:.3f} ms, {gcups:.1f} GCUPS [{card}]",
              flush=True)

    for kernel in ("cuda", "lax"):
        run(4, 250, 256, 2048, 1024, kernel)
    for nseqs in (2048, 4096):
        for nq in (1, 16):
            run(nq, 200, 256, nseqs, 4096, "cuda")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("chunks", "engine"))
    ap.add_argument("--out", default="chiprun_out/stream_kernel_ab.json")
    args = ap.parse_args()

    from swipe_tpu.cli import _enable_compile_cache
    from swipe_tpu.devices import card_info, require_gpu

    dev = require_gpu("stream_kernel_ab")
    card = card_info().splitlines()[0]
    _enable_compile_cache()
    out = {"device": dev, "card": card}
    if args.only != "engine":
        isolated_chunks(card, out)
    if args.only != "chunks":
        engine_ab(card, out)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: {kk: vv for kk, vv in v.items()
                          if kk.startswith("speedup")}
                      for k, v in out.items() if k.startswith("cfg")}))


def engine_ab(card, out):
    from bench_corpus import (swissprot_fasta, swissprot_letters,
                              write_swissprot_fasta)
    from swipe_tpu.io.db import FastaDatabase
    from swipe_tpu.io.fasta import preprocess_query

    rng = np.random.default_rng(1)
    db1 = FastaDatabase(io.StringIO(swissprot_fasta(10_000, rng)), "aa",
                        title="cfg1")
    q1 = [preprocess_query("q1", swissprot_letters(200, rng), 1, 3)]
    measure("cfg1_10k_1x200", db1, q1, card, 3, out)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cfg4.fa")
        write_swissprot_fasta(path, 570_000, np.random.default_rng(4))
        db4 = FastaDatabase(path, "aa")
        q4 = [preprocess_query(f"q{i}", swissprot_letters(200, rng), 1, 3)
              for i in range(16)]
        measure("cfg4_570k_16x200", db4, q4, card, 1, out)


if __name__ == "__main__":
    main()
