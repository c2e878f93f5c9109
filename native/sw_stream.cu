// Lane-stream Smith-Waterman scoring for NVIDIA Hopper (sm_90a), called
// from JAX through the XLA foreign function interface.
//
// Contract (identical to swipe_tpu.ops.sw_stream.sw_scores_stream_lax_carry,
// which is this kernel's oracle):
//   qcodes  [nq, qlen_pad] int32   query symbols, PAD_SYMBOL padded
//   qlens   [nq]           int32   true query lengths
//   matrix  [32, 32]       int8    score matrix (build_matrix8)
//   pad_pen [1]            int32   profile value of rows >= qlen
//   db_t    [nseqs, L]     int8    lane-packed chunk, LANE-MAJOR
//   start_t [nseqs, L/16]  int8    1 where a lane starts a new sequence
//   h_in, e_in [nq, qlen_pad, nseqs], s_in [nq, nseqs]  carried state
// Results:
//   dumps   [nq, L/16, nseqs] running max score of every lane after each
//           16-column block
//   h_out, e_out, s_out       state after the chunk's last column
//   bnd     boundary scratch of the query-strip loop (see below)
//
// Arithmetic is exact int32.  Per cell, with the gap penalties Q (open +
// extend) and R (extend):
//   E(i,j) = max(E(i,j-1) - R, H(i,j-1) - Q)
//   F(i,j) = max(F(i-1,j) - R, H(i-1,j) - Q)
//   H(i,j) = max(H(i-1,j-1) + P(i,j), E(i,j), F(i,j), 0)
// E and F are kept pre-advanced (computed for the next cell as soon as H
// is known), and F(i+1,j) is taken from the H value before F is folded in
// (exact because Q >= R), so the row-to-row dependence is one DPX
// instruction per cell.
//
// Layout of the work: G threads (a warp or a part of one) own one
// (query, lane) pair.  Thread t holds RPT consecutive query rows of H and
// E in registers and walks the lane's columns one step behind thread t-1:
// at step m it computes column m - t, taking the bottom row of thread t-1
// (H, pre-advanced F and the running-max chain) by __shfl_up_sync.  The
// query profile of the block's query sits in shared memory as int8, 32
// symbols x rows.  Queries taller than one strip of G * RPT rows run the
// strips one after another; the bottom row of a strip is kept per column
// in the bnd scratch, which the next strip reads back.

#include <cuda_runtime.h>

#include <cstdint>
#include <string>
#include <type_traits>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int KSEG = 16;          // columns per dumped block
constexpr int BLOCK_THREADS = 256;

struct Params {
  const int32_t* qcodes;
  const int32_t* qlens;
  const int8_t* matrix;
  const int32_t* pad_pen;
  const int8_t* db;
  const int8_t* start;
  const int32_t* h_in;
  const int32_t* e_in;
  const int32_t* s_in;
  int32_t* dumps;
  int32_t* h_out;
  int32_t* e_out;
  int32_t* s_out;
  int4* bnd;
  int nq, qlen_pad, nseqs, L, nblocks, nstrips;
  int Q, R;
  int carry_in, carry_out;
};

template <int RPT>
__device__ __forceinline__ void load_profile(const int8_t* row, int* p) {
  // RPT consecutive int8 profile values -> sign-extended int32
  if constexpr (RPT % 16 == 0) {
#pragma unroll
    for (int k = 0; k < RPT / 16; ++k) {
      int4 w = reinterpret_cast<const int4*>(row)[k];
      int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        p[16 * k + b] = (int)(int8_t)(ws[b / 4] >> (8 * (b % 4)));
    }
  } else {
    static_assert(RPT % 8 == 0, "RPT must be a multiple of 8");
#pragma unroll
    for (int k = 0; k < RPT / 8; ++k) {
      int2 w = reinterpret_cast<const int2*>(row)[k];
      int ws[2] = {w.x, w.y};
#pragma unroll
      for (int b = 0; b < 8; ++b)
        p[8 * k + b] = (int)(int8_t)(ws[b / 4] >> (8 * (b % 4)));
    }
  }
}

// One wavefront step of one thread: column c of its RPT rows.  PRED steps
// (the wavefront's fill and drain) may be inactive for this thread and
// must leave the state untouched; on the chunk's last column E is not
// advanced, so the carried E is E(i, L-1) as the contract says.
template <int RPT, bool PRED>
__device__ __forceinline__ void cell_step(
    int (&H)[RPT], int (&E)[RPT], int& smax, int& diag0, const int* p,
    int in_h, int& f, bool rst, bool active, bool last, int Q, int R) {
  if (rst && active) {
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      H[r] = 0;
      E[r] = -Q;        // E(i,c) after a reset: max(NEG_INF - R, 0 - Q)
    }
    smax = 0;
    diag0 = 0;
  }
  int diag = diag0;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    int hn = __viaddmax_s32_relu(diag, p[r], E[r]);   // max(d+p, E, 0)
    int h = max(hn, f);
    int fn = __viaddmax_s32(f, -R, hn - Q);           // F(i+1, c)
    int en = __viaddmax_s32(E[r], -R, h - Q);         // E(i, c+1)
    if constexpr (PRED) {
      diag = H[r];
      H[r] = active ? h : H[r];
      E[r] = (active && !last) ? en : E[r];
      smax = active ? max(smax, h) : smax;
      f = fn;
    } else {
      diag = H[r];
      H[r] = h;
      E[r] = en;
      smax = max(smax, h);
      f = fn;
    }
  }
  if (!PRED || active) diag0 = in_h;
}

template <int G, int RPT>
__global__ void __launch_bounds__(BLOCK_THREADS)
sw_stream_kernel(Params p) {
  constexpr int SH = G * RPT;                  // query rows per strip
  constexpr int PPB = BLOCK_THREADS / G;       // lanes per block
  __shared__ __align__(16) int8_t qp[32 * SH];

  const int q = blockIdx.y;
  const int t = threadIdx.x % G;
  const int lane = blockIdx.x * PPB + threadIdx.x / G;
  const bool valid = lane < p.nseqs;
  const unsigned mask =
      G == 32 ? 0xffffffffu
              : (((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1)));
  const int L = p.L;
  const int Q = p.Q, R = p.R;
  const int ql = p.qlens[q];
  const int pad_pen = p.pad_pen[0];
  const size_t pair = (size_t)q * p.nseqs + (valid ? lane : 0);
  const int8_t* dbl = p.db + (size_t)(valid ? lane : 0) * L;
  const int8_t* stl = p.start + (size_t)(valid ? lane : 0) * p.nblocks;
  int4* bnd = p.bnd + pair * L;

  for (int strip = 0; strip < p.nstrips; ++strip) {
    const int row0 = strip * SH;
    const bool top = strip == 0;
    const bool bottom = strip == p.nstrips - 1;
    __syncthreads();                 // previous strip done with qp / bnd
    for (int idx = threadIdx.x; idx < 32 * SH; idx += BLOCK_THREADS) {
      const int d = idx / SH, r = idx % SH, row = row0 + r;
      int v = pad_pen;
      if (row < ql) v = p.matrix[(p.qcodes[(size_t)q * p.qlen_pad + row] & 31) * 32 + d];
      qp[idx] = (int8_t)v;
    }
    __syncthreads();
    if (!valid) continue;

    const int myrow = row0 + t * RPT;
    int H[RPT], E[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = myrow + r;
      if (p.carry_in && row < p.qlen_pad) {
        const size_t at = ((size_t)q * p.qlen_pad + row) * p.nseqs + lane;
        const int h = p.h_in[at];
        H[r] = h;
        E[r] = max(p.e_in[at] - R, h - Q);
      } else {
        H[r] = 0;
        E[r] = -Q;
      }
    }
    int diag0 = 0;                   // H(myrow - 1, c - 1)
    if (p.carry_in && myrow > 0 && myrow - 1 < p.qlen_pad)
      diag0 = p.h_in[((size_t)q * p.qlen_pad + myrow - 1) * p.nseqs + lane];
    int smax = (top && t == 0 && p.carry_in) ? p.s_in[pair] : 0;
    // what the row above passes for the current column: H, pre-advanced F,
    // running-max chain.  The first strip's top row sees H = 0, F < 0.
    int in_h = 0, in_f = -Q, in_s = 0;

    // prefetch column 0 of this thread
    int c = -t;
    int sym = 0, rst = 0;
    int4 b4 = make_int4(0, -Q, 0, 0);
    if (c >= 0) {
      sym = dbl[c] & 31;
      rst = stl[0];
    }
    if (t == 0 && !top) b4 = bnd[0];

    auto step = [&](auto pred_tag, int m) {
      constexpr bool PRED = decltype(pred_tag)::value;
      c = m - t;
      const bool active = !PRED || (c >= 0 && c < L);
      const int cur_sym = sym;
      const bool cur_rst = rst != 0;
      if (t == 0 && !top) {
        in_h = b4.x;
        in_f = b4.y;
        in_s = b4.z;
      }
      // prefetch the next column
      const int cn = c + 1;
      if (!PRED || (cn >= 0 && cn < L)) {
        sym = dbl[cn] & 31;
        rst = (cn & (KSEG - 1)) == 0 ? stl[cn / KSEG] : 0;
        if (t == 0 && !top) b4 = bnd[cn];
      }
      int prof[RPT];
      load_profile<RPT>(qp + cur_sym * SH + t * RPT, prof);
      int f = in_f;
      cell_step<RPT, PRED>(H, E, smax, diag0, prof, in_h, f, cur_rst,
                           active, PRED && c == L - 1, Q, R);
      const int hb = H[RPT - 1];
      const int sc = max(in_s, smax);
      if (t == G - 1 && active) {
        if (!bottom) {
          bnd[c] = make_int4(hb, f, sc, 0);
        } else if ((c & (KSEG - 1)) == KSEG - 1) {
          p.dumps[((size_t)q * p.nblocks + c / KSEG) * p.nseqs + lane] = sc;
          if (c == L - 1 && p.carry_out) p.s_out[pair] = sc;
        }
      }
      const int nh = __shfl_up_sync(mask, hb, 1, G);
      const int nf = __shfl_up_sync(mask, f, 1, G);
      const int ns = __shfl_up_sync(mask, sc, 1, G);
      if (t > 0) {
        in_h = nh;
        in_f = nf;
        in_s = ns;
      }
    };

    const int nsteps = L + G - 1;
    const int mid_lo = G - 1 < L - 1 ? G - 1 : L - 1;
    const int mid_hi = L - 1;        // exclusive: the last column is PRED
    int m = 0;
    for (; m < mid_lo; ++m) step(std::true_type{}, m);
    for (; m < mid_hi; ++m) step(std::false_type{}, m);
    for (; m < nsteps; ++m) step(std::true_type{}, m);

    if (p.carry_out) {
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        const int row = myrow + r;
        if (row < p.qlen_pad) {
          const size_t at = ((size_t)q * p.qlen_pad + row) * p.nseqs + lane;
          p.h_out[at] = H[r];
          p.e_out[at] = E[r];
        }
      }
    }
  }
}

template <int G, int RPT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int PPB = BLOCK_THREADS / G;
  dim3 grid((p.nseqs + PPB - 1) / PPB, p.nq);
  sw_stream_kernel<G, RPT><<<grid, BLOCK_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Threads per (query, lane) pair and query rows per thread; chosen by the
// Python wrapper (swipe_tpu.ops.sw_cuda.kernel_config).
static ffi::Error SwStreamImpl(
    cudaStream_t stream, ffi::Buffer<ffi::S32> qcodes,
    ffi::Buffer<ffi::S32> qlens, ffi::Buffer<ffi::S8> matrix,
    ffi::Buffer<ffi::S32> pad_pen, ffi::Buffer<ffi::S8> db_t,
    ffi::Buffer<ffi::S8> start_t, ffi::Buffer<ffi::S32> h_in,
    ffi::Buffer<ffi::S32> e_in, ffi::Buffer<ffi::S32> s_in,
    ffi::ResultBuffer<ffi::S32> dumps, ffi::ResultBuffer<ffi::S32> h_out,
    ffi::ResultBuffer<ffi::S32> e_out, ffi::ResultBuffer<ffi::S32> s_out,
    ffi::ResultBuffer<ffi::S32> bnd, int32_t gapopenextend,
    int32_t gapextend, int32_t group, int32_t rows, int32_t nstrips,
    int32_t carry_in, int32_t carry_out) {
  auto qd = qcodes.dimensions();
  auto dd = db_t.dimensions();
  if (qd.size() != 2 || dd.size() != 2)
    return ffi::Error::InvalidArgument("sw_stream: qcodes and db_t must be 2-D");
  Params p;
  p.nq = (int)qd[0];
  p.qlen_pad = (int)qd[1];
  p.nseqs = (int)dd[0];
  p.L = (int)dd[1];
  if (p.L <= 0 || p.L % KSEG)
    return ffi::Error::InvalidArgument("sw_stream: L must be a positive multiple of 16");
  p.nblocks = p.L / KSEG;
  p.nstrips = nstrips;
  p.Q = gapopenextend;
  p.R = gapextend;
  p.carry_in = carry_in;
  p.carry_out = carry_out;
  p.qcodes = qcodes.typed_data();
  p.qlens = qlens.typed_data();
  p.matrix = matrix.typed_data();
  p.pad_pen = pad_pen.typed_data();
  p.db = db_t.typed_data();
  p.start = start_t.typed_data();
  p.h_in = h_in.typed_data();
  p.e_in = e_in.typed_data();
  p.s_in = s_in.typed_data();
  p.dumps = dumps->typed_data();
  p.h_out = h_out->typed_data();
  p.e_out = e_out->typed_data();
  p.s_out = s_out->typed_data();
  p.bnd = reinterpret_cast<int4*>(bnd->typed_data());
  if (p.nq == 0 || p.nseqs == 0) return ffi::Error::Success();
  if (nstrips > 1 &&
      bnd->element_count() < (size_t)4 * p.nq * p.nseqs * p.L)
    return ffi::Error::InvalidArgument("sw_stream: boundary scratch too small");

  cudaError_t err;
  if (group == 8 && rows == 8) err = launch<8, 8>(p, stream);
  else if (group == 16 && rows == 8) err = launch<16, 8>(p, stream);
  else if (group == 32 && rows == 8) err = launch<32, 8>(p, stream);
  else if (group == 32 && rows == 16) err = launch<32, 16>(p, stream);
  else if (group == 32 && rows == 32) err = launch<32, 32>(p, stream);
  else
    return ffi::Error::InvalidArgument(
        "sw_stream: no kernel for group " + std::to_string(group) +
        " x rows " + std::to_string(rows));
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("sw_stream launch: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    SwStream, SwStreamImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::S32>>()   // qcodes
        .Arg<ffi::Buffer<ffi::S32>>()   // qlens
        .Arg<ffi::Buffer<ffi::S8>>()    // matrix
        .Arg<ffi::Buffer<ffi::S32>>()   // pad_pen
        .Arg<ffi::Buffer<ffi::S8>>()    // db_t
        .Arg<ffi::Buffer<ffi::S8>>()    // start_t
        .Arg<ffi::Buffer<ffi::S32>>()   // h_in
        .Arg<ffi::Buffer<ffi::S32>>()   // e_in
        .Arg<ffi::Buffer<ffi::S32>>()   // s_in
        .Ret<ffi::Buffer<ffi::S32>>()   // dumps
        .Ret<ffi::Buffer<ffi::S32>>()   // h_out
        .Ret<ffi::Buffer<ffi::S32>>()   // e_out
        .Ret<ffi::Buffer<ffi::S32>>()   // s_out
        .Ret<ffi::Buffer<ffi::S32>>()   // bnd
        .Attr<int32_t>("gapopenextend")
        .Attr<int32_t>("gapextend")
        .Attr<int32_t>("group")
        .Attr<int32_t>("rows")
        .Attr<int32_t>("nstrips")
        .Attr<int32_t>("carry_in")
        .Attr<int32_t>("carry_out"));
