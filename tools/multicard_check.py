"""Several NVIDIA cards of one host, on the cards.

    python tools/multicard_check.py [--mh-procs N] [--trace]
                                    [--out chiprun_out/multicard.json]

``--mh-procs N``: the CLI as N processes on this host
(``--mh-procs N --mh-rank r --mh-coord localhost:PORT``), each bound to
its own card by ``init_multihost``; rank 0's ``-m 9`` report must equal
the report of one process (20k Swiss-Prot-like sequences, two queries).
It runs first, before this process opens JAX, since each child takes a
card.

``--trace``: this one process over all local cards (MultiHostEngine) at
BASELINE config 4's scale (570k sequences, 4 x 200 aa), with its default
chunk height and with the single card's (8192 columns), beside the
single-card SearchEngine.  Each is searched once warm for its wall and
search phase, and once more under ``jax.profiler`` for each card's busy
time.  Needs NVIDIA GPUs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

# report lines that carry times or the date
VOLATILE = re.compile(r"^(# SWIPE|Search started|Search completed|Elapsed|"
                      r"Speed|\[Gloo\])")


def _normalize(text: str) -> list[str]:
    return [line for line in text.splitlines() if not VOLATILE.match(line)]


def mh_procs(n: int, out: dict, timeout: float = 120) -> None:
    from bench_corpus import swissprot_fasta, swissprot_letters
    rng = np.random.default_rng(3)
    env = dict(os.environ, PYTHONPATH=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        db, q = os.path.join(tmp, "db.fa"), os.path.join(tmp, "q.fa")
        with open(db, "w") as f:
            f.write(swissprot_fasta(20_000, rng))
        with open(q, "w") as f:
            f.write(f">q1 a\n{swissprot_letters(200, rng)}\n"
                    f">q2 b\n{swissprot_letters(150, rng)}\n")
        args = [sys.executable, "-m", "swipe_tpu", "-d", db, "-i", q,
                "-m", "9"]
        t0 = time.time()
        single = subprocess.run(args, capture_output=True, text=True,
                                timeout=timeout, env=env)
        if single.returncode:
            raise SystemExit(f"single process failed:\n{single.stderr}")
        t_single = time.time() - t0
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.time()
        procs = [subprocess.Popen(
            args + ["--mh-procs", str(n), "--mh-rank", str(r),
                    "--mh-coord", f"localhost:{port}"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env) for r in range(n)]
        try:
            outs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                p.kill()
        t_multi = time.time() - t0
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise SystemExit(f"rank {r} failed:\n{err[-3000:]}")
    same = _normalize(outs[0][0]) == _normalize(single.stdout)
    print(f"--mh-procs {n}: rank-0 report {'==' if same else '!='} "
          f"single-process report ({len(single.stdout.splitlines())} "
          f"lines); one process {t_single:.1f}s, {n} processes "
          f"{t_multi:.1f}s (each: start, ingest, compile, search, align)",
          flush=True)
    out["mh_procs"] = {"n": n, "equal": same, "single_s": t_single,
                       "multi_s": t_multi}
    if not same:
        raise SystemExit("--mh-procs report differs")


def traced(card: str, out: dict) -> None:
    import jax

    from chip_smoke import write_cfg4
    from stream_kernel_ab import reduce_trace
    from swipe_tpu.io.db import FastaDatabase
    from swipe_tpu.io.fasta import read_queries
    from swipe_tpu.parallel.multihost import MultiHostEngine
    from swipe_tpu.pipeline import SearchEngine, SearchParams, SearchTimings

    params = SearchParams(symtype=1, gapopen=11, gapextend=1)
    n = len(jax.local_devices())
    with tempfile.TemporaryDirectory() as tmp:
        db_path, q_path = write_cfg4(tmp)
        db = FastaDatabase(db_path, "aa")
        queries = list(read_queries(q_path, 1, 3))
        runs = (("1 card", SearchEngine, {}),
                (f"{n} cards", MultiHostEngine, {}),
                (f"{n} cards, 8192 columns", MultiHostEngine,
                 {"max_cols": 8192}))
        for name, cls, kw in runs:
            t0 = time.time()
            eng = cls(db, params, backend="stream", **kw)
            t_init = time.time() - t0
            eng.search_batch(queries)                  # compile + warm
            t = SearchTimings()
            t0 = time.time()
            eng.search_batch(queries, t)
            wall = time.time() - t0
            with tempfile.TemporaryDirectory() as tdir:
                with jax.profiler.trace(tdir):
                    eng.search_batch(queries)
                tr = reduce_trace(tdir)
            busy = ", ".join(f"{b:.4f}" for b in tr["busy_per_device_s"])
            print(f"{name}: init {t_init:.2f}s, wall {wall:.4f}s, search "
                  f"{t.elapsed:.4f}s ({t.speed / 1e9:.1f} GCUPS); traced "
                  f"busy per card [{busy}] s, CUDA kernel "
                  f"{tr['cuda_kernel_s']:.4f}s [{card}]", flush=True)
            out[name] = {"init_s": t_init, "wall_s": wall,
                         "search_s": t.elapsed, "gcups": t.speed / 1e9, **tr}
            del eng


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mh-procs", type=int, default=0)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--out", default="chiprun_out/multicard.json")
    args = ap.parse_args()
    out = {}
    if args.mh_procs:
        mh_procs(args.mh_procs, out)
    if args.trace:
        from swipe_tpu.cli import _enable_compile_cache
        from swipe_tpu.devices import card_info, require_gpu
        out["device"] = require_gpu("multicard_check")
        card = card_info().splitlines()[0]
        _enable_compile_cache()
        traced(card, out)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
