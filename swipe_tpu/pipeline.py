"""Per-query search pipeline: pack -> score on the device -> enter hits ->
align.

Re-design of the reference's search runtime (parity targets: work()
/root/reference/swipe.cc:2436-2505, prepare_search/search_chunk
swipe.cc:1365-1699).  Differences by design:

* the pthread work queue over db chunks becomes a list of pre-packed
  lane-stream chunks scored by the stream route (ops.sw_stream: the CUDA
  kernel on a GPU, the lax twin elsewhere); segment packing with the lax
  scan (ops.sw_segment) remains as the explicit ``backend="lax"``;
  sharding of the same chunk list over devices lives in swipe_tpu.parallel;
* all (qstrand, qframe) variants of a query are scored in ONE kernel
  call per chunk (the query axis of the kernel), instead of the
  reference's per-frame passes;
* the 7->16->63-bit escalation is replaced by one exact int32 pass;
  cascade-compatibility tier counters are derived from the exact scores
  (_count_tiers) and match the reference's compute7/16/63 exactly.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

import numpy as np

from .batching import pack_database, pack_stream
from .hits import HitList
from .io.db import Database
from .io.fasta import Query
from .matrices import ScoreMatrix
from .ops.sw_segment import build_qpt, sw_scores_lax
from .stats import EvalueModel

__all__ = ["SearchEngine", "SearchParams", "SearchTimings"]


def reverse_tie_order(meta: np.ndarray) -> np.ndarray:
    """Column order for the device-side top-K: units must ascend in the
    REVERSE of the hit list's tie preference (score desc, seqno desc,
    dstrand asc, dframe asc — hits.finalize), because the reversed
    lax.top_k in the reductions prefers the highest column on ties.
    ``meta`` is [n, 3] rows of (seqno, dstrand, dframe)."""
    return np.lexsort((-meta[:, 2], -meta[:, 1], meta[:, 0]))


def _chunk_reduce_impl(sc, init_thr, upper, k, sl7, sl16):
    """Device-side per-chunk hit reduction: top-K candidates + counters.

    Replaces transferring every score to the host (the reference instead
    relies on a mutexed hits_enter per sequence, hits.cc:163-222).  Scores
    are selected by (score desc, unit id desc) — the reference's insertion
    tie order (hits.cc:188-191) — by running top_k on the unit-reversed
    array, since lax.top_k prefers the lowest index on ties.  Scores above
    the per-slot upper cutoff are masked to -1 (callers drop them), so the
    reduction stays exact under -u/-k.  Dispatched only as part of
    _fused_stream_step's single jitted computation.
    """
    import jax
    import jax.numpy as jnp

    totalh = (sc >= init_thr[:, None]).sum(axis=1)
    obvious = (sc > upper[:, None]).sum(axis=1)
    n16 = (sc >= sl7).sum()
    n63 = (sc >= sl16).sum()
    # entries above the upper cutoff (-u / -k) are counted in `obvious`
    # but excluded from the hit list (hits.cc:168-180): mask them below
    # any real SW score so they cannot occupy top-K slots
    sc = jnp.where(sc > upper[:, None], -1, sc)
    rev = sc[:, ::-1]
    vals, ridx = jax.lax.top_k(rev, k)
    idx = sc.shape[1] - 1 - ridx
    return vals, idx, totalh, obvious, n16, n63


@functools.lru_cache(maxsize=128)
def _fused_stream_step(gapopenextend, gapextend, nslots, topk, k, sl7, sl16,
                       kernel):
    """One jitted computation per configuration: stream kernel -> score
    gather -> (optionally) device top-K reduction.

    Folding the three device steps into a single dispatch removes two
    host round trips per chunk and lets XLA free the per-block dump —
    up to 32 MB per slot on a full chunk — right after the gather."""
    import jax

    from .ops.sw_stream import gather_scores, sw_scores_stream

    def impl(qc, ql, m8, data, start, end_block, lane, init_thr, upper):
        out = sw_scores_stream(qc, ql, m8, data, start,
                               gapopenextend=gapopenextend,
                               gapextend=gapextend, kernel=kernel)
        sc = gather_scores(out, end_block, lane)[:nslots]
        if topk:
            return _chunk_reduce_impl(sc, init_thr, upper, k, sl7, sl16)
        return sc

    return jax.jit(impl)


@functools.lru_cache(maxsize=256)
def _fused_flow_step(first, has_ends, gapopenextend, gapextend, nslots,
                     topk, k, sl7, sl16, kernel):
    """One jitted computation per flow-chunk configuration: state permute
    -> carry kernel -> score gather -> (optionally) device top-K.

    The flow series (batching.pack_stream_flow) threads per-lane DP state
    chunk to chunk, so unlike _fused_stream_step the carried (h, e, s)
    rides through the step; ``first`` skips the permute on chunk 0 and
    ``has_ends`` elides the gather for chunks where no sequence ends."""
    import jax

    from .ops.sw_stream import (gather_scores, permute_stream_state,
                                sw_scores_stream_carry)

    def impl(qc, ql, m8, data, start, src, h, e, s, eb, ln,
             init_thr, upper):
        if not first:
            h, e, s = permute_stream_state(h, e, s, src)
        out, h, e, s = sw_scores_stream_carry(
            qc, ql, m8, data, start, h, e, s,
            gapopenextend=gapopenextend, gapextend=gapextend,
            kernel=kernel, carry_in=not first)
        if not has_ends:
            return h, e, s
        sc = gather_scores(out, eb, ln)[:nslots]
        if topk:
            return (h, e, s) + _chunk_reduce_impl(sc, init_thr, upper, k,
                                                  sl7, sl16)
        return h, e, s, sc

    return jax.jit(impl)


@dataclass
class SearchParams:
    symtype: int = 1
    querystrands: int = 3
    matrixname: str = "BLOSUM62"
    matchscore: int = 1
    mismatchscore: int = -3
    gapopen: int = 11
    gapextend: int = 1
    descriptions: int = 250   # -v
    alignments: int = 100     # -b
    minscore: int = 1         # -c
    maxscore: int = 2**63 - 1  # -u
    expect: float = 10.0      # -e
    minexpect: float = 0.0    # -k
    effdbsize: int = 0        # -z
    query_gencode: int = 1
    db_gencode: int = 1
    threads: int = 1          # -a: align-phase worker pool width

    @property
    def gapopenextend(self) -> int:
        return self.gapopen + self.gapextend


@dataclass
class SearchTimings:
    """GCUPS meter (parity: clock_start/clock_stop swipe.cc:1716-1790)."""

    start: float = 0.0
    elapsed: float = 0.0
    speed: float = 0.0
    starttime: str = ""
    endtime: str = ""
    # precision-cascade counters (compute*/rounds*, swipe.cc:111-119)
    compute: dict = field(default_factory=lambda: {7: 0, 16: 0, 32: 0, 63: 0})
    rounds: dict = field(default_factory=lambda: {7: 0, 16: 0, 32: 0, 63: 0})

    def begin(self):
        self.start = time.time()
        self.starttime = time.strftime(
            "%a, %e %b %Y %H:%M:%S UTC", time.gmtime(self.start))

    @staticmethod
    def _work_multiplier(query, symtype: int, querystrands: int) -> float:
        """Per-query cell multiplier of the GCUPS formula
        (clock_stop, swipe.cc:1744-1775)."""
        if symtype == 0:
            w = len(query.nt[0])
            return 2 * w if querystrands == 3 else w
        if symtype in (1, 5):
            return len(query.aa[0])
        if symtype == 2:
            w = len(query.nt[0])
            return 2 * w if querystrands == 3 else w
        if symtype == 3:
            return 2 * len(query.aa[0])
        if symtype == 4:
            w = 2 * len(query.nt[0])
            return 2 * w if querystrands == 3 else w
        return 0

    def end(self, db_symcount: int, query, symtype: int, querystrands: int):
        self.end_batch(db_symcount, [query], symtype, querystrands)

    def end_batch(self, db_symcount: int, queries, symtype: int,
                  querystrands: int):
        now = time.time()
        self.endtime = time.strftime(
            "%a, %e %b %Y %H:%M:%S UTC", time.gmtime(now))
        self.elapsed = now - self.start
        speed = float(db_symcount) * sum(
            self._work_multiplier(q, symtype, querystrands)
            for q in queries)
        self.speed = speed / self.elapsed if self.elapsed > 0 else 0.0


class SearchEngine:
    """Holds the packed database and runs queries against it."""

    def __init__(self, db: Database, params: SearchParams, *,
                 nseqs: int | None = None, max_cols: int | None = None,
                 backend: str = "auto"):
        """``backend``: "stream" (the lane-stream route), "lax" (segment
        packing with the lax scan, for CPU tests and golden parity) or
        "auto" — the stream route on a GPU, "lax" on the CPU.  The stream
        route's scoring kernel comes from the platform
        (ops.sw_stream.stream_kernel), fixed when the engine is built."""
        from .ops.sw_stream import stream_kernel
        self.db = db
        self.params = params
        self.backend = self._resolve_backend(backend)
        self.kernel = stream_kernel()
        self.matrix = self._build_matrix()
        stream = self.backend == "stream"
        if nseqs is None:
            nseqs = self.stream_lanes() if stream else 512
        if max_cols is None:
            # stream chunks: the per-block dump of a full slot group is
            # 16 x (8192 / 16) x lanes int32 (134 MB at 4096 lanes).  The
            # GIANT threshold stays at 65536: an 8k-64k db sequence (common
            # nucleotide scale) keeps the lane pack and its one
            # oversized chunk instead of the serial carry route
            max_cols = 8192 if stream else 16384
            self._giant_cols = 65536 if stream else max_cols
        else:
            # explicit caps keep the old contract (tests force the giant
            # route by shrinking max_cols)
            self._giant_cols = max_cols
        self._pack(nseqs, max_cols)

    @staticmethod
    def stream_lanes() -> int:
        """Default lane count of the stream route.  The CUDA kernel runs
        one (query, lane) pair per warp or sub-warp, so one 200-aa query
        fills only as many warps as there are lanes: on an H100 at 400 W
        it scores 805 GCUPS at 4096 lanes and 662 at 2048, against 968
        for a batch of 16 (tools/stream_kernel_ab.py --only chunks).  The
        lax twin on the CPU pays for every padded lane, so it keeps
        1024."""
        from .ops.sw_stream import stream_kernel
        return 4096 if stream_kernel() == "cuda" else 1024

    @staticmethod
    def _resolve_backend(backend: str) -> str:
        if backend == "auto":
            import jax
            return "stream" if jax.default_backend() == "gpu" else "lax"
        if backend not in ("stream", "lax"):
            raise ValueError(f"unknown backend {backend!r} "
                             "(auto, stream or lax)")
        return backend

    def _build_matrix(self) -> ScoreMatrix:
        p = self.params
        if p.symtype == 0:
            return ScoreMatrix.nucleotide(p.matchscore, p.mismatchscore,
                                          p.gapopen, p.gapextend)
        return ScoreMatrix.from_name_or_file(
            p.matrixname, p.gapopen, p.gapextend, symtype=p.symtype)

    def _pack(self, nseqs: int, max_cols: int) -> None:
        units = list(self.db.search_units(self.params.symtype))
        self._unit_seqs = [u.codes for u in units]
        self.unit_meta = np.array(
            [(u.seqno, u.dstrand, u.dframe) for u in units], dtype=np.int64
        ).reshape(len(units), 3)
        self._max_cols = max_cols
        self._nseqs = nseqs
        # units longer than the giant threshold would stretch the whole
        # pack to nseqs x their length; they go to the carry series
        # instead (pack_stream_carry), which bounds every chunk at
        # nseqs x max_cols
        gc = getattr(self, "_giant_cols", max_cols)
        lens = np.array([len(s) for s in self._unit_seqs], dtype=np.int64)
        self._giant_ids = np.nonzero(lens > gc)[0].astype(np.int64)
        self._normal_ids = np.nonzero(lens <= gc)[0].astype(np.int64)
        self._giant_seqs = [self._unit_seqs[i] for i in self._giant_ids]
        self._norm_lens = lens[self._normal_ids]
        self._carry_packs: dict[int, list] = {}
        self._stream_packs: dict[int, list] = {}
        self._dev_stream: dict[int, list] = {}
        self._seg_packs: dict[tuple, tuple] = {}
        self._dev_seg: dict[tuple, list] = {}
        self._flow_packs: dict[int, list] = {}
        self._dev_flow: dict[int, list] = {}
        if self.backend == "stream":
            # flow-routed databases never touch the plain lane pack;
            # build it only when the flow heuristic passes on it
            self.chunks = None if self._flow_cols(nseqs) is not None \
                else self._stream_chunks(nseqs)
        else:
            self.chunks = pack_database(
                [self._unit_seqs[i] for i in self._normal_ids],
                nseqs=nseqs, max_cols=max_cols, seqnos=self._normal_ids)

    @property
    def unit_count(self) -> int:
        """Number of (seqno, strand, frame) scoring units in the database."""
        return len(self.unit_meta)

    def _stream_chunks(self, nseqs: int, max_cols: int | None = None):
        """Lane-packed chunks for the stream kernel at a lane count
        (giant units excluded — they score via the carry series)."""
        key = (nseqs, max_cols or self._max_cols)
        if key not in self._stream_packs:
            self._stream_packs[key] = pack_stream(
                [self._unit_seqs[i] for i in self._normal_ids],
                nseqs=key[0], max_cols=key[1], seqnos=self._normal_ids)
        return self._stream_packs[key]

    # flow packing engages when single-chunk lane packing would pad every
    # lane to the tallest member: occupancy ceiling = mean_lane/longest,
    # which collapses on heavy length tails over SMALL databases (large
    # ones have mean lane >> longest and LPT stays ~0.95+).  Below
    # FLOW_MIN_AVG_LANE columns of mean lane load the absolute waste is
    # negligible and the plain single-dispatch pack stays (the flow
    # series costs one launch + state DMA per chunk).
    FLOW_TAIL_RATIO = 1.25
    FLOW_MIN_AVG_LANE = 512

    def _flow_cols(self, nseqs: int) -> int | None:
        """Full-chunk height for the flow route, or None to keep the
        plain lane pack (pack_stream)."""
        if self._norm_lens.size == 0:
            return None
        total = int(self._norm_lens.sum())
        longest = int(self._norm_lens.max())
        avg_lane = total / nseqs
        if avg_lane < self.FLOW_MIN_AVG_LANE \
                or longest <= self.FLOW_TAIL_RATIO * avg_lane:
            return None
        mc = (int(avg_lane) // 2 + 64) // 128 * 128
        return min(max(mc, 256), self._max_cols)

    def _flow_chunks(self, nseqs: int):
        """Flow-series chunks (built lazily; see pack_stream_flow)."""
        from .batching import pack_stream_flow
        if nseqs not in self._flow_packs:
            self._flow_packs[nseqs] = pack_stream_flow(
                [self._unit_seqs[i] for i in self._normal_ids],
                nseqs=nseqs, max_cols=self._flow_cols(nseqs),
                drain_cols=128, seqnos=self._normal_ids)
        return self._flow_packs[nseqs]

    def _dev_flow_chunks(self, nseqs: int):
        """Device arrays per flow chunk (score-gather coordinates in
        reverse tie order, like _dev_stream_chunks)."""
        import jax.numpy as jnp

        def prep(c):
            order = reverse_tie_order(self.unit_meta[c.seqnos])
            return (jnp.asarray(c.data_t).T, jnp.asarray(c.start),
                    jnp.asarray(c.carry_src),
                    jnp.asarray(c.end_block[order]),
                    jnp.asarray(c.lane[order]),
                    c.seqnos[order], c.nseqs,
                    jnp.asarray(c.seqnos[order].astype(np.int32)))

        chunks = self._flow_chunks(nseqs)
        total = sum(c.data_t.size for c in chunks)
        if total <= self.DEVICE_CACHE_BYTES:
            if nseqs not in self._dev_flow:
                self._dev_flow[nseqs] = [prep(c) for c in chunks]
            yield from self._dev_flow[nseqs]
        else:
            for c in chunks:
                yield prep(c)

    def _carry_chunks(self, nseqs: int):
        """Carry-series chunks for chromosome-scale units (built lazily).

        The series streams each giant unit through bounded fixed-height
        chunks with H/E/S carried between them — the equivalent of
        the reference's O(qlen)-state unbounded db streaming
        (search7.cc:787, database.cc:1082-1131)."""
        from .batching import pack_stream_carry
        if nseqs not in self._carry_packs:
            self._carry_packs[nseqs] = pack_stream_carry(
                self._giant_seqs, nseqs=nseqs, max_cols=self._max_cols,
                seqnos=self._giant_ids)
        return self._carry_packs[nseqs]

    # ---- scoring ------------------------------------------------------------

    def query_frames(self, query: Query) -> list[tuple[int, int, np.ndarray]]:
        return query.frames()

    def search(self, query: Query, timings: SearchTimings | None = None
               ) -> HitList:
        """Run the full search+align pipeline for one query."""
        return self.search_batch([query], timings)[0]

    def search_batch(self, queries: list[Query],
                     timings: SearchTimings | None = None) -> list[HitList]:
        """Search a batch of queries in one kernel pass per db chunk.

        All (query, strand, frame) variants share the kernel's query
        axis, so batching amortizes dispatch and db-streaming costs
        (BASELINE configs 3-4).  Returns one finalized+aligned HitList per
        query, in order.
        """
        p = self.params
        hitlists = []
        for query in queries:
            evmodel = EvalueModel(
                p.symtype, query.length, self.db.seqcount_masked(),
                self.db.symcount_masked(),
                matrixname=p.matrixname if p.symtype != 0 else None,
                matchscore=p.matchscore, mismatchscore=p.mismatchscore,
                gapopen=p.gapopen, gapextend=p.gapextend,
                effdbsize=p.effdbsize)
            hitlists.append(
                HitList(p.descriptions, p.alignments, p.minscore,
                        p.maxscore, p.minexpect, p.expect, evmodel, self.db,
                        p.symtype, p.querystrands))

        # flat (hitlist, qstrand, qframe, codes) slots across the batch
        slots = []
        for query, hits in zip(queries, hitlists):
            for qstrand, qframe, codes in self.query_frames(query):
                slots.append((hits, qstrand, qframe, codes))

        if slots:
            if timings is not None:
                timings.begin()
            if self.backend == "stream":
                # group slots by length bucket so one long query doesn't
                # pad the whole batch to its rows; hit entry is per-slot
                # so scoring order doesn't matter
                groups: dict[int, list] = {}
                for s in sorted(slots, key=lambda s: len(s[3])):
                    groups.setdefault(self.qlen_bucket(len(s[3])),
                                      []).append(s)
                for qlen_pad, group in groups.items():
                    self._search_stream(group, qlen_pad, timings)
            else:
                self._search_segments(slots, max(len(s[3]) for s in slots),
                                      timings)
            if timings is not None:
                timings.end_batch(self.db.symcount_masked(), queries,
                                  p.symtype, p.querystrands)

        # align phase: the hint pass covers every (query, qstrand, qframe)
        # bin of the batch (ops.align_hint.hint_endpoints_grid), the
        # reference's per-thread search16s over its bin
        # (swipe.cc:339-414)
        from .ops.align_hint import hint_endpoints_grid
        prepared = []
        jobs = []
        for query, hits in zip(queries, hitlists):
            hits.finalize()
            shown, bins = hits.align_prepare(
                query, self.matrix.scorelimit_16)
            prepared.append((query, hits, shown, bins))
            for qseq, items in bins:
                jobs.append((qseq, [h.dseq for _, h in items]))
        res = hint_endpoints_grid(jobs, self.matrix.matrix, p.gapopen,
                                  p.gapextend)
        k = 0
        for query, hits, shown, bins in prepared:
            hints: dict[int, tuple[int, int, int]] = {}
            for qseq, items in bins:
                for (i, h), (score, bestq, bestpos) in zip(items, res[k]):
                    if bestq > 0 and bestpos:
                        hints[i] = (score, bestq, bestpos)
                k += 1
            hits.align_finish(query, self.matrix.matrix, p.gapopen,
                              p.gapextend, shown, hints,
                              threads=p.threads)
        return hitlists

    @staticmethod
    def qlen_bucket(L: int) -> int:
        """Compiled query-row bucket for a query of length L: short
        queries bucket to 32 rows, longer ones to 128 (bounded
        compile-cache shapes).  Shared with the CLI's --prime sweep,
        which compiles one shape class per distinct bucket."""
        if L <= 128:
            return max(32, -(-L // 32) * 32)
        return -(-L // 128) * 128

    def _count_tiers(self, timings: SearchTimings | None, scores, nq: int
                     ) -> None:
        """Cascade-compatibility counters (compute*/rounds*, swipe.cc:111-119).

        Arithmetic here is exact int32 in one pass, but the tier a sequence
        *would* terminate at in the reference's 7->16->63-bit escalation is
        fully determined by its exact score vs SCORELIMIT_7/_16
        (matrices.cc:575-578, swipe.cc:1464,1518), so the counters are
        reproduced without running the narrow tiers.
        """
        if timings is None:
            return
        sl7 = self.matrix.scorelimit_7
        sl16 = self.matrix.scorelimit_16
        n16 = int((scores >= sl7).sum())
        n63 = int((scores >= sl16).sum())
        timings.compute[7] += int(scores.size)
        timings.compute[16] += n16
        timings.compute[63] += n63
        timings.rounds[7] += nq
        if n16:
            timings.rounds[16] += nq
        if n63:
            timings.rounds[63] += nq

    # packed chunks are kept resident on the device up to this budget;
    # larger databases (e.g. NR-scale) stream per search instead — the
    # reference equivalently re-reads its mmap per query (database.cc)
    DEVICE_CACHE_BYTES = 8 << 30

    def _dev_stream_chunks(self, nseqs: int):
        """Device arrays per stream chunk, with the score-gather coordinates
        sorted by unit id so score columns ascend in unit order (the exact
        tie-break the device-side top-K relies on).  Yields lazily; chunks
        are cached on device only while the total stays under
        DEVICE_CACHE_BYTES."""
        import jax.numpy as jnp

        def prep(c):
            order = reverse_tie_order(self.unit_meta[c.seqnos])
            # upload lane-major and transpose on device (the host-side
            # transpose of a multi-hundred-MB chunk is the slow part);
            # the trailing device copy of the unit ids feeds the fused
            # walk as an ARGUMENT (see _stream_walk)
            return (jnp.asarray(c.data_t).T, jnp.asarray(c.start),
                    jnp.asarray(c.end_block[order]),
                    jnp.asarray(c.lane[order]),
                    c.seqnos[order],
                    jnp.asarray(c.seqnos[order].astype(np.int32)))

        chunks = self._stream_chunks(nseqs)
        key = (nseqs, self._max_cols)
        total = sum(c.data_t.size for c in chunks)
        if total <= self.DEVICE_CACHE_BYTES:
            if key not in self._dev_stream:
                self._dev_stream[key] = [prep(c) for c in chunks]
            yield from self._dev_stream[key]
        else:
            for c in chunks:
                yield prep(c)

    # slots scored per kernel pass: bounds the [nslots, nblocks, nseqs]
    # per-block dump (1k-query batches would otherwise exhaust memory)
    SLOT_BATCH = 16
    # chunks in flight before syncing the oldest (async dispatch with no
    # backpressure would keep every upload + dump buffer live at once)
    CHUNK_WINDOW = 4

    def _search_stream(self, slots, qlen_pad, timings):
        """Score all (hitlist, strand, frame) slots of one query-length
        bucket on the stream route (ops.sw_stream); the slot index is the
        kernel's query axis, processed SLOT_BATCH at a time."""
        for i in range(0, len(slots), self.SLOT_BATCH):
            # the tail group pads to its own power of two, NOT the full
            # step: a dead slot still costs its share of the kernel; the
            # price is one extra compiled walk shape per distinct tail
            # size, which the persistent compile cache amortizes
            self._search_stream_group(slots[i:i + self.SLOT_BATCH],
                                      qlen_pad, timings)

    def _search_stream_group(self, slots, qlen_pad, timings):
        import jax.numpy as jnp

        from .ops.sw_stream import build_qcodes, stream_matrix
        p = self.params
        nseqs = self._nseqs
        qc, ql = build_qcodes([s[3] for s in slots], qlen_pad)
        # bucket the slot count to a power of two: bounded compiled
        # shapes ({1,2,4,...,SLOT_BATCH}); a dead slot has qlen 0
        nslots = len(slots)
        nslots_pad = 1
        while nslots_pad < nslots:
            nslots_pad *= 2
        if nslots_pad != nslots:
            from .ops.sw_segment import PAD_SYMBOL
            qc = np.concatenate(
                [qc, np.full((nslots_pad - nslots, qlen_pad), PAD_SYMBOL,
                             qc.dtype)], axis=0)
            ql = np.concatenate(
                [ql, np.zeros(nslots_pad - nslots, ql.dtype)], axis=0)
        qc, ql = jnp.asarray(qc), jnp.asarray(ql)
        m8 = jnp.asarray(stream_matrix(self.matrix.matrix))
        # dead padding slots get INT32_MAX thresholds: they count no
        # hits, mask nothing, and their all-zero scores never reach the
        # tier limits — the host ignores their payload rows anyway
        pad_hi = [2**31 - 1] * (nslots_pad - nslots)
        init_thr = jnp.asarray(
            [max(min(s[0].init_threshold, 2**31 - 1), -2**31)
             for s in slots] + pad_hi, jnp.int32)
        # upper cutoff (-u/-k): _chunk_reduce_impl masks scores above it on
        # device, so the top-K stays exact (hits.cc:168-180 semantics)
        upper_thr = jnp.asarray(
            [max(min(s[0].upperscorethreshold, 2**31 - 1), -2**31)
             for s in slots] + pad_hi, jnp.int32)
        kbase = max(s[0].keephits for s in slots) + 64

        def drain(item):
            units, payload, reduced = item
            self._enter_chunk(slots, units, payload, reduced, timings)

        # heavy length tails over small databases route through the flow
        # series (state-carrying chunks at ~full occupancy) instead of
        # the single-chunk lane pack; giants still go to the carry /
        # segmented routes below
        if self._flow_cols(nseqs) is not None:
            self._search_flow_group(slots, qc, ql, m8, init_thr, upper_thr,
                                    kbase, nseqs, qlen_pad, timings, drain)
            self._score_carry_series(slots, qlen_pad, timings,
                                     kernel=self.kernel)
            return

        # device-cached multi-chunk databases run as ONE jitted walk with
        # a single packed result (one host round trip per slot group).
        # Streaming-mode databases keep the windowed per-chunk loop:
        # dispatch is async so device work overlaps the host-side hit
        # entry, but unbounded issue would keep every upload + dump
        # buffer live at once.
        chunks_dev = list(self._dev_stream_chunks(nseqs))
        if (nseqs, self._max_cols) in self._dev_stream \
                and len(chunks_dev) > 1:
            self._search_stream_fused(slots, qc, ql, m8, init_thr,
                                      upper_thr, kbase, timings, nseqs,
                                      chunks_dev)
        else:
            pending = []
            for data, start, end_block, lane, units, _ud in chunks_dev:
                use_topk = kbase < units.shape[0]
                step = _fused_stream_step(
                    p.gapopenextend, p.gapextend, nslots_pad, use_topk,
                    kbase, self.matrix.scorelimit_7,
                    self.matrix.scorelimit_16, self.kernel)
                payload = step(qc, ql, m8, data, start, end_block, lane,
                               init_thr, upper_thr)
                pending.append((units, payload, use_topk))
                if len(pending) >= self.CHUNK_WINDOW:
                    drain(pending.pop(0))
            for item in pending:
                drain(item)
        # chromosome-scale units stream through the bounded carry series
        self._score_carry_series(slots, qlen_pad, timings,
                                 kernel=self.kernel)

    def _reduce_walk_chunk(self, sc, ud, init_thr, upper, kbase, acc):
        """One chunk's share of a fused walk: counters, upper-cutoff
        mask, per-chunk top-K in the hit list's tie order."""
        import jax
        import jax.numpy as jnp
        totalh, obvious, n16, n63, vals_parts, unit_parts = acc
        totalh = totalh + (sc >= init_thr[:, None]).sum(
            axis=1).astype(jnp.int32)
        obvious = obvious + (sc > upper[:, None]).sum(
            axis=1).astype(jnp.int32)
        n16 = n16 + (sc >= self.matrix.scorelimit_7).sum().astype(jnp.int32)
        n63 = n63 + (sc >= self.matrix.scorelimit_16).sum().astype(
            jnp.int32)
        sc = jnp.where(sc > upper[:, None], -1, sc)
        if kbase < sc.shape[1]:
            rev = sc[:, ::-1]
            v, ridx = jax.lax.top_k(rev, kbase)
            idx = sc.shape[1] - 1 - ridx
            u = ud[idx] + v * 0
        else:
            v = sc
            u = jnp.broadcast_to(ud[None, :], sc.shape) + v * 0
        return (totalh, obvious, n16, n63, vals_parts + [v],
                unit_parts + [u])

    @staticmethod
    def _pack_walk_result(nq, acc):
        """[nq, 2*K + 4] = [scores | unit ids | totalh | obvious | n16 |
        n63]: exactly one buffer crosses to the host per slot group."""
        import jax.numpy as jnp
        totalh, obvious, n16, n63, vals_parts, unit_parts = acc
        return jnp.concatenate(
            [jnp.concatenate(vals_parts, axis=1),
             jnp.concatenate(unit_parts, axis=1),
             totalh[:, None], obvious[:, None],
             jnp.full((nq, 1), 1, jnp.int32) * n16,
             jnp.full((nq, 1), 1, jnp.int32) * n63], axis=1)

    @staticmethod
    def _walk_init(nq):
        import jax.numpy as jnp
        return (jnp.zeros((nq,), jnp.int32), jnp.zeros((nq,), jnp.int32),
                jnp.int32(0), jnp.int32(0), [], [])

    def _stream_walk(self, nseqs, nq, kbase):
        """One-dispatch walk over a device-cached plain-pack chunk list
        (the independent-chunk twin of _flow_walk): every chunk scores,
        gathers, and reduces on device into one packed result.

        The chunk buffers ride as a PYTREE ARGUMENT, never a closure: a
        closed-over jax.Array embeds in the lowered module as a constant
        (slow to lower, and it would pin one database into the compiled
        walk); as arguments the walk lowers in milliseconds and one
        jitted walk re-binds to any same-shaped database."""
        key = ("stream", nseqs, nq, kbase, self.kernel)
        cache = getattr(self, "_flow_walk_cache", None)
        if cache is None:
            cache = self._flow_walk_cache = {}
        if key in cache:
            return cache[key]
        import jax

        from .ops.sw_stream import gather_scores, sw_scores_stream
        p = self.params

        @jax.jit
        def walk(qc, ql, m8, init_thr, upper, chunks):
            acc = self._walk_init(nq)
            for data, start, eb, ln, ud in chunks:
                out = sw_scores_stream(
                    qc, ql, m8, data, start, gapopenextend=p.gapopenextend,
                    gapextend=p.gapextend, kernel=self.kernel)
                acc = self._reduce_walk_chunk(gather_scores(out, eb, ln),
                                              ud, init_thr, upper, kbase,
                                              acc)
            return self._pack_walk_result(nq, acc)

        cache[key] = walk
        return walk

    def _search_stream_fused(self, slots, qc, ql, m8, init_thr, upper_thr,
                             kbase, timings, nseqs, chunks_dev):
        """One dispatch + one fetch for a device-cached plain-pack chunk
        list (see _stream_walk)."""
        walk = self._stream_walk(nseqs, int(qc.shape[0]), kbase)
        chunks = tuple((d, st, eb, ln, ud)
                       for d, st, eb, ln, _u, ud in chunks_dev)
        packed = np.asarray(walk(qc, ql, m8, init_thr, upper_thr, chunks))
        self._enter_packed(slots, packed,
                           sum(u.shape[0] for *_, u, _ud in chunks_dev),
                           timings)

    def _enter_packed(self, slots, packed, n_units, timings):
        """Unpack one [nq, 2K+4] walk result and enter all hits."""
        K = (packed.shape[1] - 4) // 2
        V, U = packed[:, :K], packed[:, K:2 * K]
        totalh = packed[:, 2 * K]
        obvious = packed[:, 2 * K + 1]
        n16, n63 = int(packed[0, 2 * K + 2]), int(packed[0, 2 * K + 3])
        for fi, (hits, qstrand, qframe, _) in enumerate(slots):
            sel = V[fi] >= 0
            meta = self.unit_meta[U[fi][sel]]
            hits.enter_batch(meta[:, 0], V[fi][sel], qstrand, qframe,
                             meta[:, 1], meta[:, 2],
                             counts=(int(totalh[fi]), int(obvious[fi])))
        if timings is not None:
            timings.compute[7] += n_units * len(slots)
            timings.compute[16] += n16
            timings.compute[63] += n63
            timings.rounds[7] += len(slots)
            if n16:
                timings.rounds[16] += len(slots)
            if n63:
                timings.rounds[63] += len(slots)

    def _search_flow_group(self, slots, qc, ql, m8, init_thr, upper_thr,
                           kbase, nseqs, qlen_pad, timings, drain):
        """Score one slot group through the flow series.

        When the whole series is device-cached (the common case), ALL
        chunks run as ONE jitted walk whose single packed result crosses
        to the host once (_flow_walk).  Streaming-mode databases (beyond
        the device cache) keep the per-chunk step loop with a
        CHUNK_WINDOW of pending payloads."""
        from .ops.sw_stream import make_stream_state
        p = self.params
        chunks_dev = list(self._dev_flow_chunks(nseqs))
        if nseqs in self._dev_flow:
            walk = self._flow_walk(nseqs, int(qc.shape[0]), qlen_pad, kbase)
            chunks = tuple((d, st, src, eb, ln, ud)
                           for d, st, src, eb, ln, _u, _w, ud in chunks_dev)
            packed = np.asarray(walk(qc, ql, m8, init_thr, upper_thr,
                                     chunks))
            self._enter_packed(
                slots, packed,
                sum(u.shape[0] for *_, u, _w, _ud in chunks_dev), timings)
            return
        state = None
        pending = []
        for data, start, src, eb, ln, units, w, _ud in chunks_dev:
            first = state is None
            if first:
                state = make_stream_state(qc.shape[0], qlen_pad, w)
            has_ends = units.shape[0] > 0
            use_topk = has_ends and kbase < units.shape[0]
            step = _fused_flow_step(
                first, has_ends, p.gapopenextend, p.gapextend,
                int(qc.shape[0]), use_topk, kbase,
                self.matrix.scorelimit_7, self.matrix.scorelimit_16,
                self.kernel)
            out = step(qc, ql, m8, data, start, src, *state, eb, ln,
                       init_thr, upper_thr)
            state = out[:3]
            if has_ends:
                payload = out[3] if not use_topk else out[3:]
                pending.append((units, payload, use_topk))
                if len(pending) >= self.CHUNK_WINDOW:
                    drain(pending.pop(0))
        for item in pending:
            drain(item)

    def _flow_walk(self, nseqs, nq, qlen_pad, kbase):
        """Build (and cache) the one-dispatch walk over a device-cached
        flow series: state threads through every chunk in one jit; each
        chunk's ending units reduce to (score, GLOBAL unit id) rows on
        device; everything packs into ONE int32 array (see
        _pack_walk_result).  The chunk buffers ride as a pytree
        argument, never a closure (see _stream_walk)."""
        key = (nseqs, nq, qlen_pad, kbase, self.kernel)
        cache = getattr(self, "_flow_walk_cache", None)
        if cache is None:
            cache = self._flow_walk_cache = {}
        if key in cache:
            return cache[key]
        import jax

        from .ops.sw_stream import (gather_scores, make_stream_state,
                                    permute_stream_state,
                                    sw_scores_stream_carry)
        p = self.params

        @jax.jit
        def walk(qc, ql, m8, init_thr, upper, chunks):
            h = e = s = None
            acc = self._walk_init(nq)
            for i, (data, start, src, eb, ln, ud) in enumerate(chunks):
                if i == 0:
                    h, e, s = make_stream_state(nq, qlen_pad, data.shape[1])
                else:
                    h, e, s = permute_stream_state(h, e, s, src)
                out, h, e, s = sw_scores_stream_carry(
                    qc, ql, m8, data, start, h, e, s,
                    gapopenextend=p.gapopenextend, gapextend=p.gapextend,
                    kernel=self.kernel, carry_in=i > 0,
                    carry_out=i < len(chunks) - 1)
                if ud.shape[0]:
                    acc = self._reduce_walk_chunk(
                        gather_scores(out, eb, ln), ud, init_thr, upper,
                        kbase, acc)
            return self._pack_walk_result(nq, acc)

        cache[key] = walk
        return walk

    def _score_carry_series(self, slots, qlen_pad, timings, *, kernel):
        """Score the giant units against all slots via the carry series.

        Each chunk of the series is one kernel call; the per-lane DP
        state (H/E rows + running S) flows chunk to chunk on device, so a
        100 Mbp sequence runs in nseqs x max_cols memory, matching the
        reference's unbounded-db-length semantics (search7.cc:787).

        Slots are processed SLOT_BATCH at a time for the same reason the
        stream path batches them: the carried H/E state and the per-chunk
        dump scale with the slot count, and some callers (the segment
        route) pass the whole batch at once."""
        for i in range(0, len(slots), self.SLOT_BATCH):
            group = slots[i:i + self.SLOT_BATCH]
            pending = []
            for units, sc in self._iter_carry_scores(group, qlen_pad,
                                                     kernel):
                pending.append((units, sc))
                if len(pending) >= self.CHUNK_WINDOW:
                    u, s = pending.pop(0)
                    self._enter_chunk(group, u, s, False, timings)
            for u, s in pending:
                self._enter_chunk(group, u, s, False, timings)

    def _iter_carry_scores(self, slots, qlen_pad, kernel):
        """Walk the giant units, yielding (unit_ids, device scores
        [nslots, n]) per chunk as each chunk's sequences end.

        ``kernel`` is the stream kernel to score with ("lax" from the
        segment route).  Consumers delay the host sync (np.asarray) by a
        chunk window so kernel dispatches overlap with hit entry."""
        if self._giant_ids.size == 0:
            return
        import jax.numpy as jnp

        from .ops.sw_stream import (build_qcodes, gather_scores,
                                    make_stream_state, stream_matrix,
                                    sw_scores_stream_carry)
        p = self.params
        # chromosome-scale units normally score via exact overlapped
        # segmentation at full lane occupancy (a positive-score local
        # alignment has bounded db-span, so a piece overlap of that bound
        # makes max-over-pieces exact); scoring parameters that blow the
        # bound up (huge maxS/R) lane-pack the giants into the carry
        # series instead
        if self.backend == "stream" and self.SEGMENT_GIANTS:
            V = self._overlap_bound(qlen_pad)
            if V <= self._max_cols // 2:
                yield from self._iter_segmented_giants(slots, qlen_pad, V)
                return
        # chunks come back compact: only the lanes that hold data
        chunks = self._carry_chunks(1024)
        if not chunks:
            return
        qc, ql = build_qcodes([s[3] for s in slots], qlen_pad)
        qc, ql = jnp.asarray(qc), jnp.asarray(ql)
        mat = jnp.asarray(stream_matrix(self.matrix.matrix))
        h, e, s = make_stream_state(len(slots), qlen_pad, chunks[0].nseqs)
        for i, ch in enumerate(chunks):
            out, h, e, s = sw_scores_stream_carry(
                qc, ql, mat, jnp.asarray(ch.data_t).T,
                jnp.asarray(ch.start), h, e, s,
                gapopenextend=p.gapopenextend, gapextend=p.gapextend,
                kernel=kernel, carry_in=i > 0)
            if len(ch.seqnos):
                sc = gather_scores(out, jnp.asarray(ch.end_block),
                                   jnp.asarray(ch.lane))
                yield ch.seqnos, sc

    SEGMENT_GIANTS = True      # tests pin the carry route off this

    def _overlap_bound(self, qlen_pad: int) -> int:
        """Upper bound on the db-span of any positive-score local
        alignment (ops.align_hint._span_bound — shared with the
        segmented hint pass and the hinted align window).  Pieces of a
        giant sequence cut with this much overlap contain every scoring
        alignment whole, so max-over-pieces is EXACT.  All-negative
        matrices admit no positive alignment at all (any overlap is
        exact); free gap extension makes the span unbounded — return a
        bound the `V <= max_cols // 2` gate always rejects, routing
        giants to the carry series instead."""
        from .ops.align_hint import _span_bound
        maxS = int(self.matrix.matrix.max())
        if maxS <= 0:
            return qlen_pad
        V = _span_bound(qlen_pad, maxS, self.params.gapextend)
        return (1 << 62) if V is None else V

    def _iter_segmented_giants(self, slots, qlen_pad, V):
        """Score giant units via overlapped segmentation on the stream
        route: pieces of stride S and length S + V lane-pack at full
        occupancy (the reference's channel machine has no equivalent —
        its chromosome throughput is one SSE lane); a unit's score is
        the max over its pieces, exact by the _overlap_bound argument."""
        import jax.numpy as jnp

        from .ops.sw_stream import (build_qcodes, gather_scores,
                                    stream_matrix, sw_scores_stream)
        p = self.params
        owner, dev_chunks = self._seg_giant_chunks(self._nseqs, V)
        qc, ql = build_qcodes([s[3] for s in slots], qlen_pad)
        qc, ql = jnp.asarray(qc), jnp.asarray(ql)
        m8 = jnp.asarray(stream_matrix(self.matrix.matrix))
        best = np.zeros((len(slots), len(self._giant_ids)), dtype=np.int64)
        pending = []

        def fold(item):
            snos, sc = item
            sc = np.asarray(sc)
            np.maximum.at(best, (slice(None), owner[snos]), sc)

        for data, start, end_block, lane, snos in dev_chunks:
            out = sw_scores_stream(qc, ql, m8, data, start,
                                   gapopenextend=p.gapopenextend,
                                   gapextend=p.gapextend, kernel=self.kernel)
            sc = gather_scores(out, end_block, lane)
            pending.append((snos, sc))
            if len(pending) >= self.CHUNK_WINDOW:
                fold(pending.pop(0))
        for item in pending:
            fold(item)
        yield self._giant_ids, best

    def _seg_giant_chunks(self, nseqs: int, V: int):
        """Owner map + device arrays of the giant-piece pack, cached per
        (nseqs, V): slot groups and repeated queries re-walk the same
        pieces, and re-slicing + re-uploading a genome-scale pack per
        group would dominate wall clock (cf. _dev_stream_chunks)."""
        import jax.numpy as jnp

        key = (nseqs, V)
        if key not in self._seg_packs:
            # stride adapts to the giant payload so mid-size genomes
            # still fill the lanes (a few long pieces would idle most of
            # them); piece length S+V always fits one chunk
            total = sum(len(s) for s in self._giant_seqs)
            S = max(total // (4 * nseqs), V, 1024)
            S = min(S, self._max_cols - V)
            pieces, owner = [], []
            for gi, seq in enumerate(self._giant_seqs):
                for pos in range(0, max(len(seq) - V, 1), S):
                    pieces.append(seq[pos: pos + S + V])
                    owner.append(gi)
            self._seg_packs[key] = (
                np.asarray(owner, dtype=np.int64),
                pack_stream(pieces, nseqs=nseqs, max_cols=self._max_cols,
                            seqnos=np.arange(len(pieces), dtype=np.int64)))
        owner, chunks = self._seg_packs[key]

        def prep(ch):
            # lane-major upload + device transpose (host transposes of
            # multi-hundred-MB chunks are the slow part; cf.
            # _dev_stream_chunks)
            return (jnp.asarray(ch.data_t).T, jnp.asarray(ch.start),
                    jnp.asarray(ch.end_block), jnp.asarray(ch.lane),
                    ch.seqnos)

        # share the device-cache budget with _dev_stream_chunks AND the
        # giant-piece packs already cached under other (nseqs, V) keys
        # (all hold HBM-resident int8 packs for the engine's lifetime)
        cached = sum(sum(c.data_t.size for c in self._stream_packs[k])
                     for k in self._dev_stream if k in self._stream_packs)
        cached += sum(sum(c.data_t.size for c in self._seg_packs[k][1])
                      for k in self._dev_seg if k in self._seg_packs)
        total = sum(c.data_t.size for c in chunks)
        if key in self._dev_seg or \
                cached + total <= self.DEVICE_CACHE_BYTES:
            if key not in self._dev_seg:
                self._dev_seg[key] = [prep(c) for c in chunks]
            return owner, self._dev_seg[key]
        return owner, (prep(c) for c in chunks)

    def _enter_chunk(self, slots, units, payload, reduced, timings):
        if reduced:
            vals, idx, totalh, obvious, n16, n63 = map(np.asarray, payload)
            for fi, (hits, qstrand, qframe, _) in enumerate(slots):
                # drop upper-cutoff-masked slots (-1, below any SW score)
                sel = vals[fi] >= 0
                meta = self.unit_meta[units[idx[fi][sel]]]
                hits.enter_batch(meta[:, 0], vals[fi][sel], qstrand, qframe,
                                 meta[:, 1], meta[:, 2],
                                 counts=(int(totalh[fi]), int(obvious[fi])))
            if timings is not None:
                timings.compute[7] += units.shape[0] * len(slots)
                timings.compute[16] += int(n16)
                timings.compute[63] += int(n63)
                timings.rounds[7] += len(slots)
                if int(n16):
                    timings.rounds[16] += len(slots)
                if int(n63):
                    timings.rounds[63] += len(slots)
        else:
            # [NSLOTS_PAD, n_chunk_units]: drop dead padding rows (their
            # zero scores would inflate the exact compute7 counter)
            sc = np.asarray(payload)[:len(slots)]
            meta = self.unit_meta[units]
            for fi, (hits, qstrand, qframe, _) in enumerate(slots):
                hits.enter_batch(meta[:, 0], sc[fi], qstrand, qframe,
                                 meta[:, 1], meta[:, 2])
            self._count_tiers(timings, sc, len(slots))

    def _search_segments(self, slots, max_qlen, timings):
        """Score all (hitlist, strand, frame) slots on the segment route
        (ops.sw_segment.sw_scores_lax)."""
        import jax.numpy as jnp

        p = self.params
        qlen_pad = max(64, -(-max_qlen // 64) * 64)
        dtype = np.int8 if self.matrix.fits_int8 else np.int32
        qpt = jnp.asarray(build_qpt([s[3] for s in slots],
                                    self.matrix.matrix, qlen_pad,
                                    dtype=dtype))
        for chunk in self.chunks:
            out = np.asarray(sw_scores_lax(
                qpt, jnp.asarray(chunk.data), jnp.asarray(chunk.seg_ids),
                nsegs=chunk.seqnos.shape[0],
                gapopenextend=p.gapopenextend, gapextend=p.gapextend))
            # map (segment, lane) back to units
            unit_idx = chunk.seqnos.ravel()
            valid = unit_idx >= 0
            uids = unit_idx[valid]
            meta = self.unit_meta[uids]
            flats = []
            for fi, (hits, qstrand, qframe, _) in enumerate(slots):
                flat = out[fi].reshape(-1)[valid]
                flats.append(flat)
                hits.enter_batch(meta[:, 0], flat, qstrand, qframe,
                                 meta[:, 1], meta[:, 2])
            self._count_tiers(timings, np.stack(flats), len(slots))
        self._score_carry_series(slots, qlen_pad, timings, kernel="lax")
