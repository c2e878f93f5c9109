// Native LPT lane packer — the hot half of batching.pack_stream.
//
// The Python packer walks 570k sequences through a heap and then copies
// each into its lane (measured ~5 s at full Swiss-Prot scale on one
// core); this is the same algorithm in one C pass, byte-for-byte equal
// output (tests/test_native_packer.py fuzzes the equivalence).  It is
// the search-phase counterpart of the reference's pthread-parallel db
// preprocessing (/root/reference/swipe.cc:804,1684-1699): in this
// design the device does the scoring, so the host side's job is to keep
// ingestion off the critical path.
//
// Plan: EXACT replica of batching.pack_stream's assignment loop —
// longest-first (caller passes the stable argsort order), each sequence
// onto the least-loaded lane (ties: lowest lane, like heapq's tuple
// order), chunks split when the least-loaded lane would exceed
// max_blocks (a single oversized member instead raises the cap, so
// other lanes keep filling to the same height).

#include <cstdint>
#include <cstring>
#include <queue>
#include <utility>
#include <vector>

extern "C" {

// Assign every sequence to (chunk, lane, start block).
// order[nseq]: processing order (longest first).
// Outputs (caller-allocated): chunk_id[nseq], lane_out[nseq],
// startblk_out[nseq], chunk_nblocks[<=nseq] (bucketed per-chunk column
// blocks).  Returns the number of chunks.
int64_t swtpu_pack_plan(int64_t nseq, const int64_t* lens,
                        const int64_t* order, int64_t nlanes,
                        int64_t max_blocks, int64_t block,
                        int32_t* chunk_id, int32_t* lane_out,
                        int64_t* startblk_out, int64_t* chunk_nblocks) {
  typedef std::pair<int64_t, int64_t> UL;  // (used blocks, lane)
  std::priority_queue<UL, std::vector<UL>, std::greater<UL>> heap;
  for (int64_t ln = 0; ln < nlanes; ++ln) heap.emplace(0, ln);
  int64_t nchunks = 0;
  int64_t chunk_cap = max_blocks;
  int64_t max_used = 0;  // tallest lane of the open chunk
  bool any = false;

  auto flush = [&]() {
    if (!any) return;
    int64_t nblocks = (max_used + 7) / 8 * 8;
    if (max_used <= max_blocks && nblocks > max_blocks) nblocks = max_blocks;
    chunk_nblocks[nchunks++] = nblocks;
    heap = decltype(heap)();
    for (int64_t ln = 0; ln < nlanes; ++ln) heap.emplace(0, ln);
    max_used = 0;
    any = false;
  };

  for (int64_t i = 0; i < nseq; ++i) {
    const int64_t si = order[i];
    int64_t nb = (lens[si] + block - 1) / block;
    if (nb < 1) nb = 1;
    UL top = heap.top();
    if (top.first && top.first + nb > chunk_cap) {
      flush();
      chunk_cap = max_blocks;
      top = heap.top();
    }
    if (nb > chunk_cap) chunk_cap = nb;
    heap.pop();
    heap.emplace(top.first + nb, top.second);
    if (top.first + nb > max_used) max_used = top.first + nb;
    chunk_id[si] = (int32_t)nchunks;
    lane_out[si] = (int32_t)top.second;
    startblk_out[si] = top.first;
    any = true;
  }
  flush();
  return nchunks;
}

// Fill one chunk's lane-major data plane and start mask.
// members are pre-sorted by (lane, start block) — the flush order of the
// Python packer; blob/offs address the concatenated sequence bytes.
void swtpu_pack_fill(int64_t nmember, const int64_t* seqidx,
                     const int8_t* blob, const int64_t* offs,
                     const int32_t* lane, const int64_t* startblk,
                     int64_t block, int64_t ncols, int8_t pad,
                     int8_t* data_t, int8_t* start, int64_t nlanes,
                     int64_t nblocks) {
  std::vector<int64_t> load(nlanes, 0);
  for (int64_t m = 0; m < nmember; ++m) {
    const int64_t si = seqidx[m];
    const int64_t L = offs[si + 1] - offs[si];
    int64_t nb = (L + block - 1) / block;
    if (nb < 1) nb = 1;
    const int64_t ln = lane[m];
    int8_t* dst = data_t + ln * ncols + startblk[m] * block;
    std::memcpy(dst, blob + offs[si], (size_t)L);
    std::memset(dst + L, pad, (size_t)(nb * block - L));
    start[startblk[m] * nlanes + ln] = 1;
    load[ln] = startblk[m] + nb;
  }
  for (int64_t ln = 0; ln < nlanes; ++ln) {
    const int64_t used = load[ln] * block;
    if (used < ncols)
      std::memset(data_t + ln * ncols + used, pad, (size_t)(ncols - used));
  }
  (void)nblocks;
}

}  // extern "C"
