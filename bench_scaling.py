"""Multi-card scaling benchmark: GCUPS per card at mesh sizes 1..N.

BASELINE.md target: >=0.8 scaling efficiency from 1 card to many.  The
db's packed lanes shard over the mesh's "db" axis
(parallel.distributed.sharded_stream_topk, which scores with the engine's
platform route: the CUDA kernel on a GPU) and the per-device top-K lists
merge with one all-gather — the communication volume is K records per
device per chunk, so efficiency is expected to be ~1.0 until the chunk is
too small to fill a device.

Needs NVIDIA GPUs (without one it exits 1 and prints no result); on a
host with four cards it measures 1, 2 and 4.  Prints one JSON line per
mesh size, naming the device and card.
"""

import json
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp

    from swipe_tpu.batching import pack_stream
    from swipe_tpu.cli import _enable_compile_cache
    from swipe_tpu.devices import card_info, require_gpu
    from swipe_tpu.matrices import ScoreMatrix
    from swipe_tpu.ops.sw_stream import build_matrix8, build_qcodes
    from swipe_tpu.parallel.distributed import (make_mesh,
                                                shard_stream_chunk,
                                                sharded_stream_topk)
    from swipe_tpu.pipeline import SearchEngine

    dev = require_gpu("bench_scaling")
    card = card_info().splitlines()[0]
    _enable_compile_cache()
    devices = jax.devices()
    nl_local = SearchEngine.stream_lanes()

    rng = np.random.default_rng(0)
    m = ScoreMatrix.builtin("BLOSUM62", gapopen=11, gapextend=1)
    # length-clipped corpus: dense LPT pack isolates SCALING efficiency
    # from the occupancy question (bench.py owns the realistic-corpus
    # number)
    lens = np.clip(rng.lognormal(5.8, 0.5, 20_000).astype(int), 20, 3000)
    seqs = [rng.integers(1, 26, size=int(L), dtype=np.int8) for L in lens]
    m8 = jnp.asarray(build_matrix8(m.matrix))
    qlen, r_small, r_big, trials = 200, 3, 12, 3
    nq = trials * (r_small + r_big) + r_big
    qcs = [tuple(map(jnp.asarray, build_qcodes(
        [rng.integers(1, 26, size=qlen, dtype=np.int8)], 256)))
        for _ in range(nq)]
    cells = qlen * int(lens.sum())

    sizes = []
    n = 1
    while n <= len(devices):
        sizes.append(n)
        n *= 2

    base = None
    for n_db in sizes:
        mesh = make_mesh(n_db=n_db, n_q=1, devices=devices[:n_db])
        ch = pack_stream(seqs, nseqs=nl_local * n_db, max_cols=262144)[0]
        eb, ln, un = shard_stream_chunk(ch, n_db=n_db)
        d = jnp.asarray(ch.data_t).T
        st = jnp.asarray(ch.start)
        eb, ln, un = map(jnp.asarray, (eb, ln, un))

        def run(qc):
            s, u, c = sharded_stream_topk(
                mesh, qc[0], qc[1], m8, d, st, eb, ln, un,
                gapopenextend=12, gapextend=1, k=100)
            return s

        def one_pass(sets):
            return np.asarray(
                jnp.concatenate([run(qc) for qc in sets]).max())

        # slope timing: two chain lengths, one sync each; the fixed
        # dispatch+sync cost cancels in the difference
        one_pass(qcs[-r_big:])
        walls = {r_small: [], r_big: []}
        pos = 0
        for _ in range(trials):
            for r in (r_small, r_big):
                sel = qcs[pos:pos + r]
                pos += r
                t0 = time.time()
                one_pass(sel)
                walls[r].append(time.time() - t0)
        dt = max((min(walls[r_big]) - min(walls[r_small]))
                 / (r_big - r_small), 1e-9)
        gcups = cells / dt / 1e9
        if base is None:
            base = gcups
        print(json.dumps({
            "metric": f"GCUPS_{n_db}card_sharded",
            "value": round(gcups, 3),
            "unit": "GCUPS",
            "per_card": round(gcups / n_db, 3),
            "scaling_efficiency": round(gcups / (base * n_db), 3),
            "device": dev,
            "card": card,
        }))


if __name__ == "__main__":
    main()
