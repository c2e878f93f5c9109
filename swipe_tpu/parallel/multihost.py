"""Multi-process execution: the mpiswipe replacement, as running code.

The reference's ``mpiswipe`` is a master/slave MPI program
(/root/reference/swipe.cc:1793-2434): phase 1 hands out seqno chunks,
slaves search locally and bulk-report their top-K as 8-long tuples plus
counters (:2273-2334, merged :1951-1993); phase 2 routes each displayed
hit to a slave that recomputes the alignment and streams dseq / coords /
op-string / header back (:2336-2411).  Every rank opens the database
itself over a shared filesystem.

The equivalent here keeps the collectives on the devices and the host
skew OFF the critical path:

* every host process calls :func:`init_multihost`
  (``jax.distributed.initialize``) and opens the database itself;
* the database is split into per-host contiguous seqno shards, snapped
  to volume boundaries when the BLAST db has several volumes
  (:func:`split_seqnos`) — unit numbering stays GLOBAL
  (``Database.unit_metas``), so merged results are host-independent;
* each host lane-packs and scores its shard LOCALLY: one jitted
  shard_map step per chunk over the host's OWN device mesh — the
  scoring ``all_gather``/``psum`` stay between the host's own cards
  (NVLink), never between hosts — reducing each
  chunk to a per-slot top-K (score desc, unit desc — the hit list's tie
  order) plus totalhits / obvious / tier counters;
* hosts run at their own pace (no per-chunk cross-host barrier — the
  round-lockstep design this replaces made every host pay the slowest
  host's kernel time every round); the reduced per-chunk payloads are
  exchanged ONCE per search with a byte-allgather between processes and
  entered
  by every host in (rank, chunk) order — replacing
  tag_search_report + tag_stats;
* host-speed skew (a contended host in a shared cluster) is absorbed by
  DYNAMIC work assignment (:func:`assign_ranges`): each host scores a
  first wave (~1/4 of its static shard) while timing itself, the
  measured residues/second ride one tiny allgather, and every host
  deterministically recomputes the remaining assignment proportional to
  measured speed — the static-SPMD replacement for the reference
  master's on-demand chunk handout (swipe.cc:1335-1362, 1883-1994);
* the align phase routes each kept hit to the host owning its sequence
  (``HitList.fill_hit``), and the filled hits are exchanged with one
  byte-allgather — replacing the per-hit tag_align message quartet.

Every host ends with identical, fully-aligned HitLists; rank 0 renders
the report (the CLI wires this through ``--mh-procs/--mh-rank/
--mh-coord``, and the N-process CPU test asserts byte-identical output
vs the single-process run — modulo the volatile timing/speed lines, on
the lax backend).  One process over all of a host's cards needs no
:func:`init_multihost` at all: the engine meshes ``jax.local_devices()``.
Output bytes are independent of the wave assignment: the scored union
is always the whole database and the merge is exact, so the measured
speeds only move WHERE work runs, never what is reported.

Chromosome-scale sequences compose with multi-host: units longer than
``max_cols`` are excluded from the owning host's lane pack and stream
through that host's local carry series (``pipeline._iter_carry_scores``,
bounded nseqs x max_cols chunks); the resulting (unit, score) tuples are
tiny and are exchanged with one byte-allgather so every host enters the
same union — giant-unit counters then fall out of ``enter_batch``'s own
counting, identically on every host.
"""

from __future__ import annotations

import functools
import os
import pickle

import numpy as np

from ..pipeline import SearchEngine, reverse_tie_order

__all__ = ["init_multihost", "split_seqnos", "assign_ranges",
           "MultiHostEngine"]


def init_multihost(coordinator: str, num_processes: int, process_id: int,
                   local_devices: int | None = None) -> None:
    """Join the multi-process job (call before any other JAX use).

    On CPU test rigs, set ``local_devices`` to fan one process into N
    virtual devices (XLA_FLAGS --xla_force_host_platform_device_count
    must agree when set externally).  Several processes on one GPU host
    each take one card (:func:`own_card`).
    """
    if local_devices is not None and "XLA_FLAGS" not in os.environ:
        os.environ["XLA_FLAGS"] = (
            f"--xla_force_host_platform_device_count={local_devices}")
    import jax
    kw = {}
    card = own_card(process_id, num_processes)
    if card is not None:
        kw["local_device_ids"] = [card]
    jax.distributed.initialize(coordinator, num_processes=num_processes,
                               process_id=process_id, **kw)


def visible_cards() -> int:
    """NVIDIA cards this process may open, counted without opening them
    (JAX must not start before jax.distributed.initialize): the entries
    of CUDA_VISIBLE_DEVICES when it is set, else the host's device
    nodes."""
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([d for d in vis.split(",") if d.strip()])
    import glob
    return len(glob.glob("/dev/nvidia[0-9]*"))


def own_card(process_id: int, num_processes: int) -> int | None:
    """Index, among the visible cards, of the one card this process
    takes when several processes share a GPU host: ``process_id`` modulo
    the visible count.  None for a single process or fewer than two
    visible cards (the process then takes what JAX finds)."""
    n = visible_cards()
    if num_processes < 2 or n < 2:
        return None
    return process_id % n


def _db_cumlens(db) -> np.ndarray:
    """[seqcount + 1] cumulative residue counts, from the offset tables
    when the backing store answers cheaply (BlastDatabase.get_length
    never decodes)."""
    n = db.seqcount()
    lens = np.empty(n, dtype=np.int64)
    for s in range(n):
        lens[s] = db.get_length(s, 0 if getattr(db, "dbtype", "aa") == "nt"
                                else 1)[1]
    return np.concatenate([[0], np.cumsum(lens)])


def split_seqnos(db, n_hosts: int, *,
                 balance_tol: float = 0.20) -> list[tuple[int, int]]:
    """Contiguous per-host seqno ranges balanced by RESIDUE mass.

    The reference's master hands chunks out dynamically so a skewed
    database never idles a rank (search_getwork /root/reference/
    swipe.cc:1335-1362, master loop :1883-1994).  The static-SPMD
    equivalent is a size-proportional split: host cuts are placed on the
    cumulative residue curve (lengths read from the volume offset tables
    — no sequence decode), not on the sequence count, so one giant
    volume among tiny ones still yields near-equal per-host work.  Cuts
    are then snapped to volume starts (mmap locality; the reference's
    calc_chunks never crosses volumes either, database.cc:1102-1103) but
    ONLY when the snap keeps every host's residue load within
    ``balance_tol`` of the even share — load balance outranks volume
    alignment.  Residual imbalance is bounded by the longest single
    sequence (chromosome-scale units additionally stream through the
    owning host's bounded carry series, see MultiHostEngine).
    """
    total = db.seqcount()
    cum = _db_cumlens(db)
    even = cum[-1] / n_hosts if n_hosts else 0
    # residue-proportional cut points
    cuts = [0]
    for h in range(1, n_hosts):
        cuts.append(int(np.searchsorted(cum, h * even, side="left")))
    cuts.append(total)
    vol_start = getattr(db, "_vol_start", None)
    if vol_start is not None and len(vol_start) > 2 and even > 0:
        vs = np.asarray(vol_start, dtype=np.int64)
        for h in range(1, n_hosts):
            snapped = int(vs[np.argmin(np.abs(cum[vs] - cum[cuts[h]]))])
            trial = list(cuts)
            trial[h] = snapped
            trial = np.maximum.accumulate(trial)
            loads = cum[trial[1:]] - cum[trial[:-1]]
            if loads.max() <= (1 + balance_tol) * even:
                cuts[h] = snapped
    cuts = list(np.maximum.accumulate(cuts))
    cuts[n_hosts] = total
    return list(zip(cuts[:-1], cuts[1:]))


def assign_ranges(segments: list[tuple[int, int]], weights: np.ndarray,
                  cum: np.ndarray) -> list[list[tuple[int, int]]]:
    """Cut a list of seqno segments into per-host pieces by weight.

    ``segments`` are disjoint ascending [lo, hi) seqno ranges (the
    hosts' unscored remainders), ``cum`` a cumulative residue curve
    (the engine passes its giant-excluded WORK curve: units the waves
    never lane-pack contribute zero mass), ``weights`` one positive
    speed per host
    (residues/second measured on the first wave).  Returns, per host, a
    list of [lo, hi) pieces whose residue mass is proportional to its
    weight — every host derives the identical assignment from the same
    allgathered weights, so no further coordination is needed (the
    static-SPMD form of the reference master's dynamic chunk handout,
    /root/reference/swipe.cc:1335-1362).
    """
    n = len(weights)
    w = np.asarray(weights, dtype=np.float64)
    w = np.where(w > 0, w, w[w > 0].mean() if (w > 0).any() else 1.0)
    seg_res = np.array([cum[hi] - cum[lo] for lo, hi in segments],
                       dtype=np.float64)
    total = seg_res.sum()
    if total <= 0:
        return [[] for _ in range(n)]
    targets = np.cumsum(w / w.sum()) * total     # host h ends at targets[h]
    out: list[list[tuple[int, int]]] = [[] for _ in range(n)]
    h = 0
    done = 0.0
    for (lo, hi) in segments:
        while lo < hi:
            # advance past hosts whose quota is already filled
            while h < n - 1 and done >= targets[h] - 0.5:
                h += 1
            if h == n - 1:
                out[h].append((lo, hi))
                done += cum[hi] - cum[lo]
                break
            # largest prefix of [lo, hi) fitting host h's quota
            room = targets[h] - done
            cut = int(np.searchsorted(cum, cum[lo] + room,
                                      side="right")) - 1
            cut = max(lo + 1, min(cut, hi))
            out[h].append((lo, cut))
            done += cum[cut] - cum[lo]
            lo = cut
    return out


def stabilize_speeds(prev: np.ndarray | None, speeds: np.ndarray,
                     drift: float) -> np.ndarray:
    """Hysteresis over allgathered per-host speeds.

    A rank whose shard had zero wave-1 work (all-giant or empty)
    measures speed 0 every batch; substitute the mean of the positive
    speeds (the normalization ``assign_ranges`` itself applies) so one
    workless rank cannot disable the hysteresis — and the wave-2 pack
    cache — fleet-wide.  Then, when the fresh speeds keep the same
    relative shape as the ones that produced the cached assignment
    (every ratio within ``drift`` of the mean drift), return ``prev``
    unchanged so the assignment — and therefore the wave-2 pack cache —
    is stable under measurement noise.  All inputs are derived from
    allgathered arrays, so every host computes the identical result.
    """
    if (speeds <= 0).any() and (speeds > 0).any():
        speeds = speeds.copy()
        speeds[speeds <= 0] = speeds[speeds > 0].mean()
    if prev is not None and (prev > 0).all() and (speeds > 0).all():
        r = speeds / prev
        if r.max() <= drift * r.min():
            return prev
    return speeds


@functools.lru_cache(maxsize=32)
def _mh_step(mesh, gapopenextend: int, gapextend: int, k: int,
             sl7: int, sl16: int, kernel: str | None):
    """Jitted global-mesh search step (cached per configuration).

    Per device: score the lane shard, gather per-unit scores, count
    totalhits/obvious/tier sequences (psum over "db"), mask scores above
    the upper cutoff, take the per-device top-k by (score desc, unit
    desc), and all-gather the per-device lists — the exact-merge
    argument of the MPI master (each shard keeps >= K entries).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..ops.sw_stream import sw_scores_stream

    def per_device(qc, ql, m8, db, st, eb, ln, un, thr, upper):
        out = sw_scores_stream(qc, ql, m8, db, st,
                               gapopenextend=gapopenextend,
                               gapextend=gapextend, kernel=kernel)
        un0, eb0, ln0 = un[0], eb[0], ln[0]
        sc = out[:, eb0, ln0]                      # [NQ, M]
        valid = un0 >= 0
        sc = jnp.where(valid[None, :], sc, -1)
        totalh = jax.lax.psum((sc >= thr[:, None]).sum(axis=1), "db")
        obvious = jax.lax.psum((sc > upper[:, None]).sum(axis=1), "db")
        n16 = jax.lax.psum((sc >= sl7).sum(), "db")
        n63 = jax.lax.psum((sc >= sl16).sum(), "db")
        cells = jax.lax.psum(valid.sum() * qc.shape[0], "db")
        # entries above the upper cutoff are excluded from the list
        # (hits.cc:168-180) but counted above — mask them out of top-k
        sc = jnp.where(sc > upper[:, None], -1, sc)
        # per-device selection in the hit list's tie order (score desc,
        # unit desc): columns ascend by unit, so run top_k reversed
        # (lax.top_k prefers the lowest index on ties)
        kk = min(k, sc.shape[1])
        rev = sc[:, ::-1]
        vals, ridx = jax.lax.top_k(rev, kk)
        idx = sc.shape[1] - 1 - ridx
        units_top = un0[idx] + vals * 0
        top_all = jax.lax.all_gather(vals, "db", axis=1, tiled=True)
        units_all = jax.lax.all_gather(units_top, "db", axis=1, tiled=True)
        return top_all, units_all, totalh, obvious, n16, n63, cells

    return jax.jit(jax.shard_map(
        per_device, mesh=mesh,
        in_specs=(P(None, None), P(None), P(None, None), P(None, "db"),
                  P(None, "db"), P("db", None), P("db", None),
                  P("db", None), P(None), P(None)),
        out_specs=(P(None, None), P(None, None), P(None), P(None),
                   P(), P(), P()),
        check_vma=False,
    ))


class MultiHostEngine(SearchEngine):
    """SearchEngine over a multi-host device mesh.

    Construct after :func:`init_multihost`; every process builds one and
    runs the same queries.  All processes end with identical HitLists
    (scores, counters, headers, alignments); rank 0 typically renders.
    """

    # first-wave share of each host's static shard: measured while timed,
    # the remainder is reassigned by measured speed (assign_ranges)
    WAVE1_FRAC = 0.25
    # speed skew below this keeps the static residue-proportional split
    # (avoids repacking noise when hosts are in fact symmetric)
    REBALANCE_TOL = 1.15
    # fresh speeds whose relative shape stays within this factor of the
    # speeds that produced the cached assignment reuse that assignment
    # (keeps the wave-2 pack cache hot under measurement noise).
    # Env-tunable: on heavily oversubscribed hosts (CI, the 1-vCPU dev
    # box) wall-clock speed measurements jitter far more than on a quiet
    # production host, so tests widen it rather than flake.  A malformed
    # value falls back to the default instead of breaking import
    try:
        SPEED_DRIFT = float(os.environ.get("SWIPE_TPU_SPEED_DRIFT", 1.10))
    except ValueError:
        SPEED_DRIFT = 1.10

    def __init__(self, db, params, *, nseqs: int | None = None,
                 max_cols: int | None = None, backend: str = "auto"):
        import jax

        from ..ops.sw_stream import stream_kernel
        self._pid = jax.process_index()
        self._nproc = jax.process_count()
        self._n_local = len(jax.local_devices())
        self._n_dev = len(jax.devices())
        from jax.sharding import Mesh
        # scoring mesh = THIS process's devices (all local cards): the
        # per-chunk all_gather / psum ride NVLink; cross-process traffic
        # is one byte-allgather of reduced payloads per search phase
        self._mesh = Mesh(np.asarray(jax.local_devices()).reshape(-1),
                          ("db",))
        # its own init: lanes scale with the local device count, and the
        # chunks are lane-packed for every backend
        self.db = db
        self.params = params
        self.backend = self._resolve_backend(backend)
        stream = self.backend == "stream"
        self.kernel = stream_kernel() if stream else "lax"
        self.matrix = self._build_matrix()
        if nseqs is None:
            nseqs = self.stream_lanes() * self._n_local if stream else 512
        if max_cols is None:
            max_cols = 65536 if stream else 16384
        self._pack(nseqs, max_cols)

    # ---- packing ------------------------------------------------------------

    def _pack(self, nseqs: int, max_cols: int) -> None:
        symtype = self.params.symtype
        # lanes per host must split evenly over the host's devices
        if nseqs % self._n_local:
            nseqs += self._n_local - nseqs % self._n_local
        self._nseqs_local = nseqs
        self._max_cols = max_cols
        self.unit_meta = self.db.unit_metas(symtype)      # GLOBAL numbering
        self._cum = _db_cumlens(self.db)
        # WORK curve: giant units (len > max_cols) never enter the lane
        # packs the waves score — they stream through the static owner's
        # carry series outside the timed waves — so speed measurement and
        # proportional reassignment must not count their residue mass
        # (a chromosome among the wave-1 units would otherwise inflate
        # the owner's measured speed and let giant mass satisfy wave-2
        # quotas with workless residues)
        lens = np.diff(self._cum)
        self._cum_work = np.concatenate(
            [[0], np.cumsum(np.where(lens > max_cols, 0, lens))])
        self._ranges = split_seqnos(self.db, self._nproc)
        lo, hi = self._ranges[self._pid]
        # GIANT units (len > max_cols) stay with the STATIC owner (they
        # stream through its bounded local carry series); every host
        # excludes them from lane packs by the same length test, so
        # dynamic reassignment can never double-score one.  The decode
        # also yields the shard's NORMAL units, kept as this host's
        # range-addressable cache (_units_for_range) so wave packs never
        # re-decode the shard (the dominant host cost at scale).
        self._own_range = (lo, hi)
        self._own_ids, self._own_seqs = self._load_units(
            lo, hi, keep_giants=True)
        self._own_seqnos = self.unit_meta[self._own_ids, 0] \
            if len(self._own_ids) else np.zeros(0, dtype=np.int64)
        # wave split: deterministic from the work curve, so every
        # host knows every other host's unscored remainder without
        # communication
        self._wave_splits = []
        for (rlo, rhi) in self._ranges:
            target = self._cum_work[rlo] + self.WAVE1_FRAC * (
                self._cum_work[rhi] - self._cum_work[rlo])
            w = int(np.searchsorted(self._cum_work, target, side="left"))
            self._wave_splits.append(min(max(w, rlo), rhi))
        # caches the giant-unit routes reach through the base class
        # (_iter_carry_scores -> _iter_segmented_giants/_seg_giant_chunks)
        self._carry_packs = {}
        self._stream_packs = {}
        self._dev_stream = {}
        self._seg_packs = {}
        self._dev_seg = {}
        self._wave1_chunks = None
        # wave-2 pack cache: two entries, keyed by the assigned ranges —
        # steady-state query streams (speeds within SPEED_DRIFT of the
        # ones that produced the cached assignment) reuse the packed
        # chunks instead of re-decoding + re-packing ~3/4 of the shard
        # per search phase
        self._wave2_cache: dict[tuple, list] = {}
        self._assign_speeds: np.ndarray | None = None

    def _load_units(self, lo: int, hi: int, *, keep_giants: bool):
        """Decode [lo, hi)'s units; NORMAL units go to (ids, seqs);
        giants are kept as this host's carry-series work only when it is
        the static owner."""
        symtype = self.params.symtype
        um = self.unit_meta
        ids = np.nonzero(
            (um[:, 0] >= lo) & (um[:, 0] < hi))[0].astype(np.int64)
        seqs = [u.codes for u in self.db.search_units(symtype, (lo, hi))]
        assert len(seqs) == len(ids)
        lens = np.array([len(s) for s in seqs], dtype=np.int64)
        giant = np.nonzero(lens > self._max_cols)[0]
        normal = np.nonzero(lens <= self._max_cols)[0]
        if keep_giants:
            self._giant_ids = ids[giant]
            self._giant_seqs = [seqs[i] for i in giant]
        return ids[normal], [seqs[i] for i in normal]

    def _units_for_range(self, lo: int, hi: int):
        """NORMAL units of [lo, hi): served from the shard decode done at
        init when the range lies inside this host's static shard (the
        common case — wave 1 and the static wave 2), decoded on demand
        only for ranges stolen from OTHER hosts' shards."""
        olo, ohi = self._own_range
        if lo >= olo and hi <= ohi:
            i0 = int(np.searchsorted(self._own_seqnos, lo, side="left"))
            i1 = int(np.searchsorted(self._own_seqnos, hi, side="left"))
            return self._own_ids[i0:i1], self._own_seqs[i0:i1]
        return self._load_units(lo, hi, keep_giants=False)

    def _pack_ranges(self, pieces: list[tuple[int, int]]):
        """Lane-pack the NORMAL units of a list of seqno ranges."""
        from ..batching import pack_stream
        all_ids, all_seqs = [], []
        for (lo, hi) in pieces:
            ids, seqs = self._units_for_range(lo, hi)
            all_ids.append(ids)
            all_seqs.extend(seqs)
        ids = np.concatenate(all_ids) if all_ids else \
            np.zeros(0, dtype=np.int64)
        return pack_stream(all_seqs, nseqs=self._nseqs_local,
                           max_cols=self._max_cols, seqnos=ids)

    def _local_wave1(self):
        if self._wave1_chunks is None:
            lo, _ = self._ranges[self._pid]
            self._wave1_chunks = self._pack_ranges(
                [(lo, self._wave_splits[self._pid])])
        return self._wave1_chunks

    # ---- search -------------------------------------------------------------

    def search_batch(self, queries, timings=None):
        from ..hits import HitList
        from ..stats import EvalueModel
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
        slots = []
        for query, hits in zip(queries, hitlists):
            for qstrand, qframe, codes in self.query_frames(query):
                slots.append((hits, qstrand, qframe, codes))
        if slots:
            if timings is not None:
                timings.begin()
            self._mh_search(slots, timings)
            if timings is not None:
                timings.end_batch(self.db.symcount_masked(), queries,
                                  p.symtype, p.querystrands)
        for hits in hitlists:
            hits.finalize()
        self._mh_align(queries, hitlists)
        return hitlists

    def _mh_search(self, slots, timings):
        import sys
        import time as _time

        import jax
        import jax.experimental.multihost_utils as mhu
        import jax.numpy as jnp  # noqa: F401 (kept for parity with base)
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..ops.sw_segment import PAD_SYMBOL
        from ..ops.sw_stream import build_qcodes, stream_matrix
        p = self.params
        lpd = self._nseqs_local // self._n_local   # lanes per device
        qlen_pad = max(128, -(-max(len(s[3]) for s in slots) // 128) * 128)

        qc, ql = build_qcodes([s[3] for s in slots], qlen_pad)
        m8 = stream_matrix(self.matrix.matrix)
        thr = np.asarray(
            [max(min(s[0].init_threshold, 2**31 - 1), -2**31)
             for s in slots], np.int32)
        upper = np.asarray(
            [max(min(s[0].upperscorethreshold, 2**31 - 1), -2**31)
             for s in slots], np.int32)
        kbase = max(s[0].keephits for s in slots) + 64

        mesh = self._mesh                      # LOCAL devices only
        rep = NamedSharding(mesh, P())
        sh_lanes = NamedSharding(mesh, P(None, "db"))
        sh_dev = NamedSharding(mesh, P("db", None))
        mk = jax.make_array_from_process_local_data
        args_rep = (mk(rep, qc), mk(rep, ql), mk(rep, m8),
                    mk(rep, thr), mk(rep, upper))
        step = _mh_step(mesh, p.gapopenextend, p.gapextend, kbase,
                        self.matrix.scorelimit_7, self.matrix.scorelimit_16,
                        self.kernel)
        # test-only fault injection: deliberately slowed rank(s) for the
        # dynamic-balance tests (subprocess CLI runs cannot monkeypatch).
        # SWIPE_TPU_TEST_SLOW_RANK takes a comma list of ranks;
        # SWIPE_TPU_TEST_CHUNK_SLEEP one sleep per listed rank (the last
        # entry repeats when shorter).
        import os
        slow_ids = [s for s in os.environ.get(
            "SWIPE_TPU_TEST_SLOW_RANK", "").split(",") if s != ""]
        chunk_sleep = 0.0
        if str(self._pid) in slow_ids:
            sleeps = os.environ.get(
                "SWIPE_TPU_TEST_CHUNK_SLEEP", "0").split(",")
            idx = min(slow_ids.index(str(self._pid)), len(sleeps) - 1)
            chunk_sleep = float(sleeps[idx])

        def score_chunk(ch):
            """One local chunk -> (top, units, totalh, obvious, n16,
            n63, cells) jax arrays (device top-K over the local mesh)."""
            if chunk_sleep:
                _time.sleep(chunk_sleep)
            L = ch.n_cols
            M = max(int(np.bincount(ch.lane // lpd,
                                    minlength=self._n_local).max())
                    if len(ch.lane) else 0, 1)
            # bucket the per-device unit count to a power of two (>=64):
            # M otherwise varies freely per chunk and every distinct M is
            # a fresh jit signature for the step — compile-cache churn.
            # Padding grows only the tiny gather tables (un=-1 sentinels
            # are dropped at entry), never the scored columns.
            M = max(64, 1 << (M - 1).bit_length())
            data = np.full((L, self._nseqs_local), PAD_SYMBOL, np.int8)
            start = np.zeros((L // 16, self._nseqs_local), np.int8)
            eb = np.zeros((self._n_local, M), np.int32)
            ln = np.zeros((self._n_local, M), np.int32)
            un = np.full((self._n_local, M), -1, np.int64)
            data[: ch.n_cols] = ch.data
            start[: ch.n_cols // 16] = ch.start
            dev = ch.lane // lpd
            for d in range(self._n_local):
                g = np.nonzero(dev == d)[0]
                # reverse tie preference per device — required by the
                # reversed-top_k selection in the step (same invariant
                # as pipeline._dev_stream_chunks)
                g = g[reverse_tie_order(self.unit_meta[ch.seqnos[g]])]
                eb[d, : len(g)] = ch.end_block[g]
                ln[d, : len(g)] = ch.lane[g] - d * lpd
                un[d, : len(g)] = ch.seqnos[g]
            return step(*args_rep[:3],
                        mk(sh_lanes, data),
                        mk(sh_lanes, start.astype(np.int32)),
                        mk(sh_dev, eb), mk(sh_dev, ln), mk(sh_dev, un),
                        *args_rep[3:])

        # ---- wave 1: static quarter-shard, timed --------------------------------
        wave1 = self._local_wave1()
        payloads = []
        t0 = _time.time()
        for ch in wave1:
            payloads.append(score_chunk(ch))
        if payloads:
            jax.block_until_ready(payloads[-1])
        t1 = max(_time.time() - t0, 1e-6)
        lo, hi = self._ranges[self._pid]
        w = self._wave_splits[self._pid]
        res1 = float(self._cum_work[w] - self._cum_work[lo])
        # host sleep injection models contention: fold it into the speed.
        # Caveat, documented: the FIRST batch's wave-1 wall includes one
        # jit compile per rank (chunk shapes are bucketed above, so it is
        # one compile each — roughly symmetric); speeds are re-measured
        # every batch, so a compile-skewed first assignment self-corrects
        # on the next batch (the drift test below forces a recompute).
        speed = res1 / t1 if res1 > 0 else 0.0

        # ---- rebalance: measured speeds -> deterministic reassignment ----------
        speeds = np.asarray(mhu.process_allgather(
            np.array([speed], np.float64))).reshape(self._nproc)
        speeds = stabilize_speeds(self._assign_speeds, speeds,
                                  self.SPEED_DRIFT)
        self._assign_speeds = speeds
        segments = [(int(self._wave_splits[h]), int(self._ranges[h][1]))
                    for h in range(self._nproc)]
        segments = [(a, b) for a, b in segments if b > a]
        pos = speeds[speeds > 0]
        skewed = pos.size > 1 and pos.max() > self.REBALANCE_TOL * pos.min()
        if skewed:
            mine = assign_ranges(segments, speeds, self._cum_work)[self._pid]
        else:
            mine = [(w, hi)] if hi > w else []
        got = sum(self._cum_work[b] - self._cum_work[a] for a, b in mine)
        print(f"swipe_tpu multihost: rank {self._pid} wave2 residues "
              f"{int(got)} (speed {speed:.0f}/s, "
              f"{'dynamic' if skewed else 'static'})", file=sys.stderr)

        # ---- wave 2: reassigned remainder ---------------------------------------
        for ch in self._wave2_for(mine):
            payloads.append(score_chunk(ch))

        # ---- one cross-process exchange of the reduced payloads -----------------
        local = [tuple(np.asarray(x) for x in pl) for pl in payloads]
        for blob in _allgather_bytes(pickle.dumps(local)):
            for top, units, totalh, obvious, n16, n63, cells in \
                    pickle.loads(blob):
                self._mh_enter(slots, top, units, totalh, obvious,
                               int(n16), int(n63), int(cells), timings)
        self._mh_score_giants(slots, qlen_pad, timings)

    def _wave2_for(self, mine):
        """Packed chunks for this host's wave-2 ranges, LRU-cached.

        Holds TWO entries so skew oscillating around REBALANCE_TOL
        (static assignment <-> one dynamic assignment) stays cached
        instead of re-packing ~3/4 of the shard per flip; a cache hit
        refreshes LRU position so the alternation partner survives."""
        key = tuple(mine)
        wave2 = self._wave2_cache.get(key)
        if wave2 is None:
            wave2 = self._pack_ranges(mine)
            self._wave2_cache[key] = wave2
            while len(self._wave2_cache) > 2:
                self._wave2_cache.pop(next(iter(self._wave2_cache)))
        else:
            self._wave2_cache[key] = self._wave2_cache.pop(key)
        return wave2

    def _mh_score_giants(self, slots, qlen_pad, timings):
        """Chromosome-scale units under multi-host: local carry series,
        global exchange.

        Each host walks the bounded carry series for ITS giant units on
        its local devices (the single-host chromosome path), then the
        per-unit score rows — a handful of (unit, nslots-scores) tuples —
        ride one byte-allgather so every host enters the identical union
        in pid order.  Counters come from ``enter_batch``'s own counting
        over the union, so totalhits/obvious/tier counts are global and
        host-independent.  Collective: every process calls this every
        batch (with an empty payload when it owns no giants)."""
        local = [(units, np.asarray(sc)) for units, sc in
                 self._iter_carry_scores(slots, qlen_pad, self.kernel)]
        for blob in _allgather_bytes(pickle.dumps(local)):
            for units, sc in pickle.loads(blob):
                self._enter_chunk(slots, units, sc, False, timings)

    def _mh_enter(self, slots, top, units, totalh, obvious, n16, n63,
                  cells, timings):
        for fi, (hits, qstrand, qframe, _) in enumerate(slots):
            u = units[fi]
            # drop device padding sentinels AND upper-cutoff-masked
            # entries (both carry score -1, below any real SW score)
            keep = (u >= 0) & (top[fi] >= 0)
            uu = u[keep]
            meta = self.unit_meta[uu]
            hits.enter_batch(meta[:, 0], top[fi][keep], qstrand, qframe,
                             meta[:, 1], meta[:, 2],
                             counts=(int(totalh[fi]), int(obvious[fi])))
        if timings is not None:
            # cells = psum of (scored units x nslots) this round — the
            # global compute7 increment; tier counts are exact globals
            timings.compute[7] += cells
            timings.compute[16] += n16
            timings.compute[63] += n63
            timings.rounds[7] += len(slots)
            if n16:
                timings.rounds[16] += len(slots)
            if n63:
                timings.rounds[63] += len(slots)

    # ---- align --------------------------------------------------------------

    def _mh_align(self, queries, hitlists):
        p = self.params
        lo, hi = self._ranges[self._pid]
        payload = []
        for qi, (query, hits) in enumerate(zip(queries, hitlists)):
            for i, h in enumerate(hits.hits):
                if lo <= h.seqno < hi:
                    hits.fill_hit(i, h, query, self.matrix.matrix,
                                  p.gapopen, p.gapextend,
                                  scorelimit_16=self.matrix.scorelimit_16)
                    payload.append((qi, i, h))
        blobs = _allgather_bytes(pickle.dumps(payload))
        for pid, blob in enumerate(blobs):
            if pid == self._pid:
                continue
            for qi, i, h in pickle.loads(blob):
                hitlists[qi].hits[i] = h


def _allgather_bytes(data: bytes) -> list[bytes]:
    """Exchange one byte blob per process (fixed-size allgather pair)."""
    import jax
    import jax.experimental.multihost_utils as mhu
    n = jax.process_count()
    if n == 1:
        return [data]
    sizes = mhu.process_allgather(np.array([len(data)], np.int64))
    sizes = np.asarray(sizes).reshape(n)
    buf = np.zeros(int(sizes.max()), np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    gathered = np.asarray(mhu.process_allgather(buf)).reshape(n, -1)
    return [gathered[i, : int(sizes[i])].tobytes() for i in range(n)]
