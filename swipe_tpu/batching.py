"""Host-side database batching: length-sorted segment packing.

Replacement for SWIPE's dynamic work structures (parity targets:
calc_chunks /root/reference/swipe.cc:441-525 and the in-kernel channel
refill machine /root/reference/search7.cc:830-957): because XLA wants
static shapes, sequences are length-sorted and packed ahead of time.

Packing model (matches swipe_tpu.ops.sw_segment.sw_scores_lax):

* a *segment* holds ``nseqs`` consecutive length-sorted sequences, one per
  lane, padded with PAD_SYMBOL to the segment length = the longest member
  rounded up to SEG_BLK columns;
* many segments are concatenated along the db axis into a *chunk* — one
  kernel launch — described by a block->segment map;
* chunks are capped at ``max_cols`` columns so very large databases become
  several launches (and shard naturally across devices).

Length sorting keeps co-resident lanes nearly equal in length: measured
occupancy on a Swiss-Prot-like length distribution is ~0.96.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

from .ops.sw_segment import PAD_SYMBOL, SEG_BLK

__all__ = ["PackedChunk", "pack_database", "StreamChunk", "pack_stream",
           "pack_stream_carry", "FlowChunk", "pack_stream_flow", "round_up"]


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclass
class PackedChunk:
    """One packed multi-segment batch ready for the segmented SW kernel.

    data:    [L, nseqs] int8, PAD_SYMBOL-padded, L multiple of SEG_BLK
    seg_ids: [L // SEG_BLK + 1] int32 nondecreasing block->segment map
    seqnos:  [nsegs, nseqs] int64 original sequence numbers (-1 = empty lane)
    lengths: [nsegs, nseqs] int64 true lengths
    """

    data: np.ndarray
    seg_ids: np.ndarray
    seqnos: np.ndarray
    lengths: np.ndarray

    @property
    def nsegs(self) -> int:
        return self.seqnos.shape[0]

    @property
    def nseqs(self) -> int:
        return self.data.shape[1]

    @property
    def n_cols(self) -> int:
        return self.data.shape[0]

    @property
    def residues(self) -> int:
        return int(self.lengths.sum())

    @property
    def occupancy(self) -> float:
        return self.residues / (self.data.size or 1)


def pack_database(seqs: list[np.ndarray], nseqs: int = 512,
                  max_cols: int = 16384,
                  seqnos: np.ndarray | None = None) -> list[PackedChunk]:
    """Length-sort and pack sequences into segment chunks.

    ``max_cols`` caps a chunk's column count (controls
    launch granularity and device sharding units).  A single segment longer
    than max_cols still becomes its own (oversized) chunk.
    """
    if seqnos is None:
        seqnos = np.arange(len(seqs), dtype=np.int64)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    order = np.argsort(-lens, kind="stable")  # longest first

    # split into segments of nseqs lanes
    segments = [order[i:i + nseqs] for i in range(0, len(order), nseqs)]

    chunks: list[PackedChunk] = []
    group: list[np.ndarray] = []
    group_cols = 0

    def flush():
        nonlocal group, group_cols
        if not group:
            return
        # bucket the chunk length to multiples of 512 (bounded compile-cache
        # shapes; full chunks are exactly max_cols); the padding columns
        # extend the last segment with PAD symbols
        L = round_up(group_cols, 512)
        # lane-major build then one contiguous transpose (column-strided
        # writes into [L, nseqs] are ~10x slower; cf. pack_stream)
        data_t = np.full((nseqs, L), PAD_SYMBOL, dtype=np.int8)
        nsegs = len(group)
        # pad the segment-count axis to a power of two (few output shapes)
        nsegs_pad = 1
        while nsegs_pad < nsegs:
            nsegs_pad *= 2
        snos = np.full((nsegs_pad, nseqs), -1, dtype=np.int64)
        lengths = np.zeros((nsegs_pad, nseqs), dtype=np.int64)
        seg_ids = np.zeros(L // SEG_BLK + 1, dtype=np.int32)
        col = 0
        for k, idx in enumerate(group):
            seg_len = round_up(max(int(lens[idx].max()), 1), SEG_BLK)
            for lane, si in enumerate(idx):
                s = seqs[si]
                data_t[lane, col: col + len(s)] = s
                snos[k, lane] = seqnos[si]
                lengths[k, lane] = len(s)
            seg_ids[col // SEG_BLK: (col + seg_len) // SEG_BLK] = k
            col += seg_len
        seg_ids[col // SEG_BLK:] = nsegs - 1
        chunks.append(PackedChunk(np.ascontiguousarray(data_t.T), seg_ids,
                                  snos, lengths))
        group = []
        group_cols = 0

    for idx in segments:
        seg_len = round_up(max(int(lens[idx].max()), 1), SEG_BLK)
        if group and group_cols + seg_len > max_cols:
            flush()
        group.append(idx)
        group_cols += seg_len
        if group_cols >= max_cols:
            flush()
    flush()
    return chunks


def _pack_stream_native(seqs, lens, order, seqnos, nseqs: int,
                        max_cols: int, block: int) -> list["StreamChunk"]:
    """pack_stream through the native planner/filler (swipe_tpu.native):
    same LPT plan, chunk splits, member order, and byte layout as the
    Python loop — the fuzz test asserts full equality."""
    from . import native
    max_blocks = max(max_cols // block, 1)
    nchunks, chunk_id, lane, startblk, chunk_nblocks = native.pack_plan(
        lens, order, nseqs, max_blocks, block)
    blob = np.concatenate([np.asarray(s, dtype=np.int8).ravel()
                           for s in seqs]) if len(seqs) else \
        np.zeros(0, dtype=np.int8)
    offs = np.concatenate([[0], np.cumsum(lens, dtype=np.int64)])
    nb_arr = np.maximum(-(-lens // block), 1)
    # flush order within a chunk: lane-major, then placement order
    ord2 = np.lexsort((startblk, lane, chunk_id))
    bounds = np.searchsorted(chunk_id[ord2], np.arange(nchunks + 1))
    chunks: list[StreamChunk] = []
    for c in range(nchunks):
        sel = np.ascontiguousarray(ord2[bounds[c]: bounds[c + 1]])
        ncols = int(chunk_nblocks[c]) * block
        data_t = np.empty((nseqs, ncols), dtype=np.int8)
        start = np.zeros((int(chunk_nblocks[c]), nseqs), dtype=np.int8)
        lane_c = np.ascontiguousarray(lane[sel])
        blk_c = np.ascontiguousarray(startblk[sel])
        native.pack_fill(sel, blob, offs, lane_c, blk_c, block,
                         PAD_SYMBOL, data_t, start)
        chunks.append(StreamChunk(
            data_t, start, np.ascontiguousarray(seqnos[sel]),
            lane_c, (blk_c + nb_arr[sel] - 1).astype(np.int32),
            int(lens[sel].sum())))
    return chunks


@dataclass
class StreamChunk:
    """One lane-packed batch for the stream kernel (ops.sw_stream).

    Packing model = SWIPE's channel machine at block granularity
    (/root/reference/search7.cc:830-957): each of ``nseqs`` lanes holds a
    concatenation of sequences, each padded up to KSEG-column blocks; the
    ``start`` mask marks blocks where a lane begins a new sequence (the
    kernel resets that lane's state there).  Sequence k's score is the
    kernel's per-block dump at (end_block[k], lane[k]).

    data_t:    [nseqs, L] int8, PAD_SYMBOL padded, L multiple of KSEG —
               lane-major so each sequence is one contiguous memcpy at
               pack time; consumers needing the kernel's [L, nseqs] view
               transpose on device (cheap) or use ``.data`` (host copy)
    start:     [L // KSEG, nseqs] int8
    seqnos:    [n] int64 original sequence ids
    lane:      [n] int32
    end_block: [n] int32
    residues:  true residue count (for occupancy accounting)
    """

    data_t: np.ndarray
    start: np.ndarray
    seqnos: np.ndarray
    lane: np.ndarray
    end_block: np.ndarray
    residues: int

    @property
    def data(self) -> np.ndarray:
        """[L, nseqs] host copy (tests / lax paths)."""
        return np.ascontiguousarray(self.data_t.T)

    @property
    def nseqs(self) -> int:
        return self.data_t.shape[0]

    @property
    def n_cols(self) -> int:
        return self.data_t.shape[1]

    @property
    def occupancy(self) -> float:
        return self.residues / (self.data_t.size or 1)


def pack_stream(seqs: list[np.ndarray], nseqs: int = 2048,
                max_cols: int = 65536, block: int = 16,
                seqnos: np.ndarray | None = None) -> list[StreamChunk]:
    """LPT-pack sequences onto ``nseqs`` lanes with block-granular refill.

    Sequences are sorted longest-first and each is appended to the
    currently shortest lane (longest-processing-time scheduling), rounded
    up to ``block`` columns — the static-shape equivalent of SWIPE's
    dynamic lane refill.  Occupancy on real length distributions is
    ~0.95+.  ``max_cols`` caps a chunk's column count; a single sequence
    longer than that still becomes its own (oversized) chunk.
    """
    if seqnos is None:
        seqnos = np.arange(len(seqs), dtype=np.int64)
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    order = np.argsort(-lens, kind="stable")

    from . import native
    if native.pack_available() and len(seqs) >= 4096:
        # the C plan+fill (native/packer.cc) — byte-identical output,
        # ~5x faster at Swiss-Prot scale (test_native_packer.py)
        return _pack_stream_native(seqs, lens, order, seqnos, nseqs,
                                   max_cols, block)

    chunks: list[StreamChunk] = []
    # per-chunk state
    heap = [(0, ln) for ln in range(nseqs)]  # (blocks used, lane)
    members: list[list[int]] = [[] for _ in range(nseqs)]

    def flush():
        nonlocal heap, members
        if not any(members):
            heap = [(0, ln) for ln in range(nseqs)]
            return
        loads = np.zeros(nseqs, dtype=np.int64)
        for used, ln in heap:
            loads[ln] = used
        # bucket the block count (bounded compile-cache shapes), capped
        # at max_blocks so the bucket cannot push a full chunk past the
        # documented max_cols when max_blocks % 8 != 0; oversized-member
        # chunks (loads.max() > max_blocks, see docstring) keep their
        # true height
        nblocks = round_up(int(loads.max()), 8)
        if int(loads.max()) <= max_blocks:
            nblocks = min(nblocks, max_blocks)
        # lane-major build: each sequence lands with ONE contiguous copy
        # ([L, nseqs] column writes are 2KB-strided and ~10x slower)
        data_t = np.full((nseqs, nblocks * block), PAD_SYMBOL,
                         dtype=np.int8)
        start = np.zeros((nblocks, nseqs), dtype=np.int8)
        snos, lanev, endv = [], [], []
        residues = 0
        for ln in range(nseqs):
            row = data_t[ln]
            b = 0
            for si in members[ln]:
                s = seqs[si]
                nb = max(-(-len(s) // block), 1)
                row[b * block: b * block + len(s)] = s
                start[b, ln] = 1
                snos.append(seqnos[si])
                lanev.append(ln)
                endv.append(b + nb - 1)
                residues += len(s)
                b += nb
        chunks.append(StreamChunk(
            data_t, start,
            np.array(snos, dtype=np.int64),
            np.array(lanev, dtype=np.int32),
            np.array(endv, dtype=np.int32),
            residues))
        heap = [(0, ln) for ln in range(nseqs)]
        members = [[] for _ in range(nseqs)]

    max_blocks = max(max_cols // block, 1)
    # a sequence longer than max_cols stretches the whole chunk: raise the
    # cap so OTHER lanes keep filling to the same height (otherwise every
    # other lane would be padding).  The chunk's footprint is still
    # nseqs x longest-member — chromosome-scale sequences belong in
    # pack_stream_carry, which bounds every chunk at nseqs x max_cols.
    chunk_cap = max_blocks
    for si in order:
        nb = max(-(-int(lens[si]) // block), 1)
        used, ln = heap[0]
        if used and used + nb > chunk_cap:
            flush()
            chunk_cap = max_blocks
            used, ln = heap[0]
        chunk_cap = max(chunk_cap, nb)
        heapq.heappushpop(heap, (used + nb, ln))
        members[ln].append(int(si))
    flush()
    return chunks


@dataclass
class FlowChunk(StreamChunk):
    """A chunk of a FLOW series (pack_stream_flow): like a StreamChunk,
    plus ``carry_src[lane]`` = the lane of the PREVIOUS chunk whose
    carried H/E/S state this lane continues (-1 = the lane starts fresh;
    all -1 for chunk 0).  Consumers gather the previous chunk's carry
    state by ``carry_src`` before the launch
    (ops.sw_stream.permute_stream_state)."""

    carry_src: np.ndarray = None


def pack_stream_flow(seqs: list[np.ndarray], nseqs: int = 2048,
                     max_cols: int = 2048, block: int = 16,
                     drain_cols: int | None = None,
                     seqnos: np.ndarray | None = None,
                     oneshot_drain: bool = True) -> list[FlowChunk]:
    """Full-occupancy flow packing: cut ANY sequence at chunk capacity.

    pack_stream cannot beat occupancy = mean_lane_load / longest_member
    inside one chunk (every lane pads to the tallest), which collapses on
    heavy-tailed length distributions over small databases (measured 0.60
    on a Swiss-Prot-fitted 10k corpus).  Here the database streams
    through FIXED (nseqs x max_cols) chunks instead: each lane fills
    completely, the sequence covering a lane's last column is cut there,
    and its remainder continues at block 0 of the NEXT chunk — on
    whichever lane it lands — with the DP state (H/E/S) gathered across
    lanes between launches.  Every chunk except the last is full modulo
    block rounding, so occupancy is ~cols/(cols+block/2) on ANY length
    distribution.  This generalizes the reference's channel-refill
    machine (/root/reference/search7.cc:830-957) across launches: SWIPE
    refills a lane the moment a sequence ends; the flow series also
    refills mid-sequence at chunk boundaries.

    The returned chunks must be scored IN ORDER with carried state
    permuted by ``carry_src`` between launches
    (ops.sw_stream.sw_scores_stream_carry + permute_stream_state);
    ``seqnos``/``lane``/``end_block`` list the sequences *ending* in each
    chunk, ready for gather_scores.
    """
    if max_cols % block:
        raise ValueError(f"max_cols {max_cols} not a multiple of {block}")
    if drain_cols is None:
        drain_cols = min(max_cols, 128)
    if drain_cols % block:
        raise ValueError(f"drain_cols {drain_cols} not a multiple of {block}")
    if seqnos is None:
        seqnos = np.arange(len(seqs), dtype=np.int64)
    if not len(seqs):
        return []
    H_full = max_cols // block
    H_drain = max(drain_cols // block, 1)
    nblk = [max(-(-len(s) // block), 1) for s in seqs]
    lens_arr = np.array([len(s) for s in seqs], dtype=np.int64)
    # longest first: long sequences are consumed (and their cut chains
    # retired) early, so the end-game — where the queue dries mid-chunk
    # and lanes can no longer fill — involves only short sequences and
    # the final chunks stay compact
    queue = list(np.argsort(-lens_arr, kind="stable"))[::-1]
    # carried remainders: (seq index, blocks already consumed, prev lane)
    remainders: list[tuple[int, int, int]] = []
    chunks: list[FlowChunk] = []
    while queue or remainders:
        # drain phase: once the queue is dry only cut chains remain (few,
        # for heavy tails).  A chain advances at most one chunk height
        # per launch while every lane of the launch pays full time, so
        # drain chunks get SHORT (drain_cols) and NARROW (the smallest
        # 1024-lane multiple that holds the chains; the carried state
        # narrows with the chunk through the carry_src gather).
        draining = not queue
        H = H_drain if draining else H_full
        width = nseqs if not draining else \
            min(nseqs, max(round_up(len(remainders), 1024), 1024))
        if oneshot_drain and draining and len(remainders) <= width <= 1024:
            # one-shot drain: every chain fits one lane of this chunk, and
            # the width is already at its 1024-lane floor, so walking the
            # chains progressively (H_drain cols per launch) costs the
            # SAME footprint but pays a chunk boundary — state in/out, a
            # carry permute, a launch — per step.  Retire
            # everything in ONE chunk of height max-remaining instead
            # (measured on the config-1 corpus: chunks 3..10 collapse to
            # one).  Chromosome-deep chains keep the bounded progressive
            # walk so a drain chunk's bytes stay capped.
            dmax = max(nblk[si] - off for si, off, _ in remainders)
            if dmax <= max(4 * H_full, H_drain):
                # bucket the one-shot height to 8 blocks (every distinct
                # drain depth would otherwise compile a fresh kernel
                # shape — minutes each on a cold cache); no lane reaches
                # the rounded-up height, so no cut can land there
                H = round_up(dmax, 8)
        lanes: list[list[tuple[int, int, int]]] = []   # (si, off, nb) per lane
        carry_src = np.full(width, -1, dtype=np.int32)
        new_rem: list[tuple[int, int, int]] = []
        used_blocks = 0
        for ln in range(width):
            lane: list[tuple[int, int, int]] = []
            free = H
            if remainders:
                si, off, prev_ln = remainders.pop()
                carry_src[ln] = prev_ln
                nb = nblk[si] - off
                if nb > free:
                    lane.append((si, off, free))
                    new_rem.append((si, off + free, ln))
                    free = 0
                else:
                    lane.append((si, off, nb))
                    free -= nb
            while free and queue:
                si = queue.pop()
                nb = nblk[si]
                if nb > free:
                    lane.append((si, 0, free))
                    new_rem.append((si, free, ln))
                    free = 0
                else:
                    lane.append((si, 0, nb))
                    free -= nb
            used_blocks = max(used_blocks, H - free)
            lanes.append(lane)
            if not queue and not remainders:
                lanes += [[] for _ in range(nseqs - ln - 1)]
                break
        remainders = new_rem[::-1]          # pop() keeps lane order
        # every chunk shrinks to its tallest used lane (bucketed to 8
        # blocks for bounded compile-cache shapes): full chunks keep H,
        # the end-game drain chunks stay compact.  Shrinking is safe
        # because used_blocks IS the max any lane filled — cut positions
        # at H only exist on lanes that reached H.
        hc = min(max(round_up(used_blocks, 8), 8), H)
        data_t = np.full((width, hc * block), PAD_SYMBOL, dtype=np.int8)
        start = np.zeros((hc, width), dtype=np.int8)
        snos, lanev, endv = [], [], []
        residues = 0
        for ln, lane in enumerate(lanes):
            b = 0
            for si, off, nb in lane:
                s = seqs[si]
                piece = s[off * block: (off + nb) * block]
                data_t[ln, b * block: b * block + len(piece)] = piece
                residues += len(piece)
                if off == 0:
                    start[b, ln] = 1
                if off + nb == nblk[si]:    # the sequence ends here
                    snos.append(seqnos[si])
                    lanev.append(ln)
                    endv.append(b + nb - 1)
                b += nb
        chunks.append(FlowChunk(
            data_t, start,
            np.array(snos, dtype=np.int64),
            np.array(lanev, dtype=np.int32),
            np.array(endv, dtype=np.int32),
            residues, carry_src=carry_src))
    return chunks


def pack_stream_carry(seqs: list[np.ndarray], nseqs: int = 1024,
                      max_cols: int = 65536, block: int = 16,
                      seqnos: np.ndarray | None = None
                      ) -> list[StreamChunk]:
    """Carry packing: bounded chunks for unbounded sequence lengths.

    The equivalent of the reference's O(qlen)-state unbounded db
    streaming (/root/reference/search7.cc:787 — hearray is the only
    state; windowed mmap database.cc:1082-1131): each lane holds one
    concatenated stream of whole sequences (LPT-assigned by total load),
    and the streams are cut every ``max_cols`` columns into fixed-height
    chunks.  A sequence crossing a cut continues at block 0 of the next
    chunk on the SAME lane with no start mask — the kernel must carry
    H/E/S state across the series (ops.sw_stream.sw_scores_stream_carry),
    which makes the cut invisible to the DP.  Every chunk's footprint is
    <= nseqs x max_cols bytes regardless of member lengths.

    The returned chunks must be scored IN ORDER with state threaded
    between them; each chunk's (seqnos, lane, end_block) lists only the
    sequences that *end* in that chunk.

    Chunks are emitted COMPACT: only the ``min(len(seqs), nseqs)`` lanes
    that can ever hold data are materialized (LPT fills lanes 0..n-1
    first), so neither host memory nor the host->device link pays for
    idle-lane padding.  Consumers needing a wider kernel lane count pad
    on device (sw_scores_stream_carry does this itself).
    """
    if max_cols % block:
        raise ValueError(f"max_cols {max_cols} not a multiple of {block}")
    if seqnos is None:
        seqnos = np.arange(len(seqs), dtype=np.int64)
    if not len(seqs):
        return []
    lens = np.array([len(s) for s in seqs], dtype=np.int64)
    nblk = np.maximum(-(-lens // block), 1)
    order = np.argsort(-lens, kind="stable")

    # global LPT: each sequence goes to the least-loaded lane
    heap = [(0, ln) for ln in range(nseqs)]
    members: list[list[int]] = [[] for _ in range(nseqs)]
    for si in order:
        used, ln = heap[0]
        heapq.heappushpop(heap, (used + int(nblk[si]), ln))
        members[ln].append(int(si))
    nused = min(len(seqs), nseqs)
    members = members[:nused]
    # per-lane member start blocks (within the lane's global stream)
    starts = [np.concatenate([[0], np.cumsum(nblk[m])]).astype(np.int64)
              for m in members]
    total_blocks = int(max(s[-1] for s in starts))

    H = max_cols // block
    nchunks = -(-total_blocks // H)
    chunks: list[StreamChunk] = []
    for c in range(nchunks):
        lo = c * H
        # uniform height except the last chunk (bucketed to 8 blocks for
        # bounded compile-cache shapes; capped at H so the documented
        # nseqs x max_cols footprint bound holds when H % 8 != 0 — the
        # capped shape equals the main chunks' already-compiled one)
        hc = H if c < nchunks - 1 else min(round_up(total_blocks - lo, 8), H)
        hi = lo + hc
        data_t = np.full((nused, hc * block), PAD_SYMBOL, dtype=np.int8)
        start = np.zeros((hc, nused), dtype=np.int8)
        snos, lanev, endv = [], [], []
        residues = 0
        for ln in range(nused):
            st = starts[ln]
            if st[-1] <= lo:
                continue
            # members whose block range [st[k], st[k+1]) overlaps [lo, hi)
            k0 = int(np.searchsorted(st, lo, side="right")) - 1
            k1 = int(np.searchsorted(st, hi, side="left"))
            for k in range(max(k0, 0), min(k1, len(members[ln]))):
                si = members[ln][k]
                sb = int(st[k])
                gcol = sb * block              # member's global start col
                a = max(gcol, lo * block)      # piece range, global cols
                b = min(gcol + int(lens[si]), hi * block)
                if b > a:
                    data_t[ln, a - lo * block: b - lo * block] = \
                        seqs[si][a - gcol: b - gcol]
                    residues += b - a
                if lo <= sb < hi:
                    start[sb - lo, ln] = 1
                eb = sb + int(nblk[si]) - 1
                if lo <= eb < hi:
                    snos.append(seqnos[si])
                    lanev.append(ln)
                    endv.append(eb - lo)
        chunks.append(StreamChunk(
            data_t, start,
            np.array(snos, dtype=np.int64),
            np.array(lanev, dtype=np.int32),
            np.array(endv, dtype=np.int32),
            residues))
    return chunks
