// decode_attention.cu — one new token per (batch, KV head) against a KV
// cache on Hopper (sm_90a): every decode step of the continuous batcher.
//
// Replaces repro/kernels/decode_attention.py::_decode_kernel (the Pallas
// TPU kernel) with its contract:
//   q (B, KV, G, Dh), caches (B, S, KV, Dh) contiguous, fp32 or bf16, any
//   Dh from 1 to 1024 (attn::DH_MAX), any G, a position pos -> o (B, KV, G,
//   Dh) in q's type. pos is a host int, or an int32 in device memory (the TPU
//   kernel's pos_ref), read by every CTA, so that a captured CUDA graph
//   follows a pos that changes between replays. The G query rows of one
//   KV head attend over cache rows 0..pos
//   (rows past pos are the reference's masked -1e30 scores, whose weights
//   exp(-1e30 - m) are exactly 0 next to any real score); scores, max,
//   denominator and accumulator in fp32; o = acc / max(l, 1e-30).
//   Given a non-null lse pointer, each query row's log-sum-exp
//   m + log(max(l, 1e-30)) in natural-log units, (B, KV, G) fp32: what a
//   caller needs to merge this output with another over other cache rows
//   (a decode over a cache whose rows are split across ranks). A null
//   pointer writes none.
//
// What bounds it on an H100: the bytes of rows 0..pos of K and V (the
// Pallas kernel streams the whole cache; this one reads only those rows),
// about 20 us for one batch row of the agent (KV 4, Dh 128, bf16) at
// pos = 32767. Four KV heads are four CTAs: a single pass per (b, kv)
// would stream 67 MB through 4 of 132 SMs. So the rows are split (split-S,
// flash-decoding): the wrapper (kernels/decode_attention.py::split_rows)
// picks chunks of cache rows so that the (b, kv, chunk) CTAs fill the card
// in one wave, and one chunk when the cache is short (the batcher's
// max_len of 128).
//
// Where pos lives in device memory the host cannot plan by it: the grid,
// the chunks and the scratch are planned for all S rows (the reference's
// grid is sized from the cache length too), each CTA reads pos, and a
// chunk that starts past it reads no row and writes an empty partial (m
// = -1e30, l = 0), which decode_combine skips. With a host pos (a null
// pointer) the plan covers rows 0..pos alone, as before.
//
// The G query rows of a KV head go in G-tiles of up to 16 (G_TILE): a CTA
// per (b, kv, chunk, G-tile), the G-tile the fastest grid axis, so that
// the ceil(G / 16) CTAs of one chunk run side by side and all but the first
// read its K/V rows from L2 (a multi-query model's G 48 or 71 is 3 or 5
// G-tiles over one cache). At G <= 16 there is one G-tile and the grid is
// the (b, kv, chunk) grid it always was.
//
// Three designs; the wrapper (kernels/decode_attention.py::pick_design)
// chooses, and each has its own entry point:
//
// decode_tc — bf16 caches on 16-byte boundaries (every decode step of the
//   LM path), Dh a multiple of 8 up to 256: one instance a width of the
//   wrapper's 12 (flash_attention.tc_width, passed in as w), a head without
//   its own on the next, zero-padded in shared memory (as flash_fwd_tc). One CTA of 4 warps per (b, kv, chunk,
//   G-tile). The G-tile's query rows are the M side of mma.sync m16n8k16 (bf16 in, fp32
//   accumulate), padded to 16 with zero rows; cache rows are N of S = Q K^T
//   and K of acc += P V. (Cache rows on M and G on N = 8 would waste less of
//   each product at G <= 8, but then S's accumulator is not P's A fragment,
//   and P would take a trip through shared memory; decode does some 8
//   operations per byte of cache, far below the tensor cores' rate, so the
//   padding costs nothing that shows.) Each warp works through its own
//   16-row tiles of the chunk (tiles w, w + 4, ...) with its own (m, l,
//   acc) in registers, filling its own 3-stage bf16 ring with 16-byte
//   cp.async (up to three tiles, 24 KB, in flight per warp: the next load
//   is issued before the wait for the current tile); its only barriers are
//   __syncwarp. P is rounded to bf16 in
//   registers as in flash_fwd_tc. The warps merge once, through shared
//   memory, at the end: with one chunk the CTA writes o itself (one
//   launch, no scratch); with more it writes its (m, l, acc) per query row
//   and decode_combine merges the chunks. At Dh 256 (gemma3) the 3-stage
//   rings take 211 KB, so one CTA has the SM (ctas_per_sm), and Q's
//   fragments are read from shared memory at each k-step (attention.cuh,
//   wide_head): its 64 registers would come on top of the accumulator's
//   128.
//
// decode_partial — fp32 (its 3e-5 check rules out bf16 products) and bf16
//   caches off a 16-byte boundary. One CTA of 128 threads per (b, kv,
//   chunk) stages 64-row K/V tiles in shared memory as fp32 (16-byte loads
//   when aligned, several in flight per thread; attention.cuh), scores
//   (g, row) pairs with fp32 FMAs, runs the online softmax per query row
//   with one warp per row, and accumulates P.V with a thread per (Dh
//   column, query rows), or per (two Dh columns, every row) at Dh 256
//   (152 KB of shared memory: one CTA per SM). It writes its (m, l, acc)
//   per query row to an fp32 scratch the caller owns, and decode_combine,
//   one CTA per (b, kv, query row), rescales the chunks' partials to their
//   common max and divides (a single chunk passes through with weight
//   exp(0) = 1). One instance a width of {16, 32, 64, 128, 256}.
//
// decode_partial_any — the same for every other width (fp32, caches off a
//   16-byte boundary, bf16 with Dh % 8 != 0, and above 256), Dh a runtime
//   argument: the G-tile's rows, a K and a V tile, P and the fp32
//   accumulator in shared memory (attn::tile_any), the tile of BK rows the
//   largest of 64 down to 8 that fits ctas_per_sm_at(Dh) CTAs an SM (8 at
//   Dh 1024: 197 KB); then decode_combine, as every design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "attention.cuh"

namespace {

constexpr int BK = 64;        // cache rows per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int G_TILE = 16;    // query rows of a KV head per CTA

// (b * kvh + kv, chunk, G-tile) of this CTA, the G-tile varying fastest
struct Cta {
  int bh, split, g0, gq;  // g0: the tile's first query row; gq: its rows
};
__device__ __forceinline__ Cta cta_of(int nsplit, int g) {
  const int ngt = (g + G_TILE - 1) / G_TILE;
  const int rest = static_cast<int>(blockIdx.x) / ngt;
  const int g0 = (static_cast<int>(blockIdx.x) % ngt) * G_TILE;
  return {rest / nsplit, rest % nsplit, g0, min(G_TILE, g - g0)};
}

// The rows a CTA reads: min(pos, S - 1) + 1 from device memory where pos
// lives there (a negative pos reads as 0), else the host's count.
__device__ __forceinline__ int rows_read(const int* pos, int rows,
                                         int s_cache) {
  return pos == nullptr ? rows : min(max(*pos, 0), s_cache - 1) + 1;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (G_TILE * DH + BK * (DH + 1) + BK * DH + G_TILE * BK + 3 * G_TILE);
}

template <typename T, int DH, int VEC>
__global__ void __launch_bounds__(THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ kc,
               const T* __restrict__ vc, float* __restrict__ part,
               const int* __restrict__ pos, int s_cache, int kvh, int g,
               int rows, int chunk, int nsplit, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [G_TILE][DH] query rows
  float* ks = qs + G_TILE * DH;         // [BK][DH + 1] key tile
  float* vs = ks + BK * (DH + 1);       // [BK][DH] value tile
  float* ss = vs + BK * DH;             // [G_TILE][BK] scores, then p
  float* ms = ss + G_TILE * BK;         // [G_TILE] running max
  float* ls = ms + G_TILE;              // [G_TILE] running denominator
  float* as = ls + G_TILE;              // [G_TILE] this tile's rescale
  // P.V: thread (column d, query rows g0 + TPD r) holds Dh columns d + DW c;
  // up to Dh 128 one column and G_TILE / (THREADS / Dh) rows a thread, at
  // Dh 256 two columns and every row
  constexpr int CPT = DH > THREADS ? DH / THREADS : 1;  // columns a thread
  constexpr int DW = DH / CPT;          // threads across a row's columns
  constexpr int TPD = THREADS / DW;     // threads per Dh column
  constexpr int GR = G_TILE / TPD;      // query rows per thread in P.V

  const Cta at = cta_of(nsplit, g);
  const int split = at.split;
  const int bh = at.bh;                 // b * kvh + kv
  const int gq = at.gq;                 // this G-tile's query rows
  const int b = bh / kvh;
  const int kv = bh % kvh;
  const int j0 = split * chunk;
  const int j1 = min(rows_read(pos, rows, s_cache), j0 + chunk);
  const int tid = threadIdx.x;
  const long long row_stride = static_cast<long long>(kvh) * DH;
  const long long head0 =
      static_cast<long long>(b) * s_cache * row_stride +
      static_cast<long long>(kv) * DH;
  const T* kbase = kc + head0;
  const T* vbase = vc + head0;
  const T* qbase = q + (static_cast<long long>(bh) * g + at.g0) * DH;

  for (int i = tid; i < gq * DH; i += THREADS) qs[i] = attn::to_f32(qbase[i]);
  if (tid < gq) {
    ms[tid] = attn::NEG;
    ls[tid] = 0.f;
  }
  const int d = tid % DW;
  const int g0 = tid / DW;
  float acc[GR][CPT];
#pragma unroll
  for (int r = 0; r < GR; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.f;

  for (int t0 = j0; t0 < j1; t0 += BK) {
    __syncthreads();  // the last tile's readers are done (and q is staged)
    attn::stage_rows<T, DH, BK, THREADS, VEC, DH + 1>(kbase, row_stride, t0,
                                                      j1, ks);
    attn::stage_rows<T, DH, BK, THREADS, VEC, DH>(vbase, row_stride, t0, j1,
                                                  vs);
    __syncthreads();

    // scores: thread (row j, query rows g0', g0' + 2, ...)
    {
      const int j = tid % BK;
      for (int gi = tid / BK; gi < gq; gi += THREADS / BK) {
        float s = 0.f;
#pragma unroll 8
        for (int e = 0; e < DH; ++e)
          s = fmaf(qs[gi * DH + e], ks[j * (DH + 1) + e], s);
        ss[gi * BK + j] = t0 + j < j1 ? s * scale : attn::neg_inf();
      }
    }
    __syncthreads();

    // online softmax: one warp per query row
    {
      const int warp = tid / 32;
      const int lane = tid % 32;
      for (int gi = warp; gi < gq; gi += WARPS) {
        const float x0 = ss[gi * BK + lane];
        const float x1 = ss[gi * BK + lane + 32];
        float mx = fmaxf(x0, x1);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(attn::FULL, mx, off));
        const float m_old = ms[gi];
        const float m_new = fmaxf(m_old, mx);
        const float p0 = expf(x0 - m_new);
        const float p1 = expf(x1 - m_new);
        ss[gi * BK + lane] = p0;
        ss[gi * BK + lane + 32] = p1;
        float sum = p0 + p1;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          sum += __shfl_xor_sync(attn::FULL, sum, off);
        __syncwarp();
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          ls[gi] = ls[gi] * alpha + sum;
          ms[gi] = m_new;
          as[gi] = alpha;
        }
      }
    }
    __syncthreads();

    // acc += P . V: thread (Dh columns d + DW c, query rows g0 + TPD r)
#pragma unroll
    for (int r = 0; r < GR; ++r)
      if (g0 + TPD * r < gq)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] *= as[g0 + TPD * r];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vx[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vx[c] = vs[j * DH + d + DW * c];
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        const int gi = g0 + TPD * r;
        if (gi < gq)
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            acc[r][c] = fmaf(ss[gi * BK + j], vx[c], acc[r][c]);
      }
    }
  }

  // partial of this chunk, per query row: [m, l, acc[DH]]
  float* out = part + ((static_cast<long long>(bh) * nsplit + split) * g +
                       at.g0) * (DH + 2);
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    const int gi = g0 + TPD * r;
    if (gi < gq)
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        out[gi * (DH + 2) + 2 + d + DW * c] = acc[r][c];
  }
  if (tid < gq) {
    out[tid * (DH + 2)] = ms[tid];
    out[tid * (DH + 2) + 1] = ls[tid];
  }
}

constexpr int CTHREADS = 256;  // decode_combine's CTA

// x reduced over the CTA (max or sum) with red[0..CTHREADS/32) as scratch;
// every thread gets the result.
template <bool MAX>
__device__ __forceinline__ float cta_reduce(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float y = __shfl_xor_sync(attn::FULL, x, off);
    x = MAX ? fmaxf(x, y) : x + y;
  }
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < CTHREADS / 32; ++w) x = MAX ? fmaxf(x, red[w]) : x + red[w];
  __syncthreads();  // red may be written again
  return x;
}

// Pass 2 of a split: one CTA per (b, kv, query row) rescales the chunks'
// partials to their common max and divides (a single chunk passes through
// with weight exp(0) = 1). Chunks that start past a device pos hold empty
// partials and are skipped. The chunks are spread over the CTA's threads:
// the max and the weights over all of them, then, up to CTHREADS columns,
// each Dh column over CTHREADS / Dh groups of chunks, so that a long cache
// (64 chunks per head at 32k rows) costs a few loads per thread, not one
// CTA per (b, kv) walking every chunk; above CTHREADS columns a thread a
// column (and the columns CTHREADS on) over every chunk. Dh is a runtime
// argument: every design's partials (at the head's own width, a padded
// tensor-core instance's too) merge here.
template <typename T>
__global__ void __launch_bounds__(CTHREADS)
decode_combine(const float* __restrict__ part, T* __restrict__ o,
               float* __restrict__ lse, const int* __restrict__ pos,
               int s_cache, int g, int dh, int rows, int chunk,
               int nsplit_plan) {
  extern __shared__ float csm[];
  float* wt = csm;                // [nsplit] each chunk's weight
  float* red = wt + nsplit_plan;  // [CTHREADS] reduction scratch
  const int row = blockIdx.x;     // (b * kvh + kv) * g + gi
  const long long sstride = static_cast<long long>(g) * (dh + 2);
  const float* p = part +
                   static_cast<long long>(row / g) * nsplit_plan * sstride +
                   static_cast<long long>(row % g) * (dh + 2);
  const int tid = threadIdx.x;
  const int nsplit =
      min(nsplit_plan, (rows_read(pos, rows, s_cache) + chunk - 1) / chunk);
  float mx = attn::NEG;
  for (int s = tid; s < nsplit; s += CTHREADS) mx = fmaxf(mx, p[s * sstride]);
  mx = cta_reduce<true>(mx, red);
  float l = 0.f;
  for (int s = tid; s < nsplit; s += CTHREADS) {
    const float w = expf(p[s * sstride] - mx);
    wt[s] = w;
    l = fmaf(p[s * sstride + 1], w, l);
  }
  l = cta_reduce<false>(l, red);  // its barrier also publishes wt
  const float den = fmaxf(l, 1e-30f);
  if (lse != nullptr && tid == 0) lse[row] = mx + logf(den);
  T* orow = o + static_cast<long long>(row) * dh;
  if (dh <= CTHREADS) {
    const int groups = CTHREADS / dh;
    const int d = tid % dh, grp = tid / dh;
    float a = 0.f;
    if (grp < groups)
      for (int s = grp; s < nsplit; s += groups)
        a = fmaf(p[s * sstride + 2 + d], wt[s], a);
    red[tid] = a;
    __syncthreads();
    if (grp == 0) {
      for (int j = 1; j < groups; ++j) a += red[j * dh + d];
      orow[d] = attn::from_f32<T>(a / den);
    }
  } else {
    for (int d = tid; d < dh; d += CTHREADS) {
      float a = 0.f;
      for (int s = 0; s < nsplit; ++s)
        a = fmaf(p[s * sstride + 2 + d], wt[s], a);
      orow[d] = attn::from_f32<T>(a / den);
    }
  }
}

// decode_combine over b * kvh * g query rows; its shared memory holds one
// weight per chunk.
template <typename T>
cudaError_t launch_combine(const float* part, T* o, float* lse,
                           const int* pos, int b, int s_cache, int kvh, int g,
                           int dh, int rows, int chunk, int nsplit,
                           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (nsplit + CTHREADS);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  decode_combine<T><<<b * kvh * g, CTHREADS, smem, stream>>>(
      part, o, lse, pos, s_cache, g, dh, rows, chunk, nsplit);
  return cudaGetLastError();
}

// the any-width partial pass's tiles of cache rows, largest first: the
// first whose shared memory fits ctas_per_sm_at(dh) CTAs an SM
constexpr int ANY_BK[] = {64, 32, 16, 8};

size_t any_smem_bytes(int bk, int dh) {
  const size_t k = bk, d = dh;
  return sizeof(float) * (G_TILE * d + k * attn::ld_any(dh) + k * d +
                          G_TILE * (k + 1) + G_TILE * d + 3 * G_TILE);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
decode_partial_any(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, float* __restrict__ part,
                   const int* __restrict__ pos, int s_cache, int kvh, int g,
                   int dh, int bk, int rows, int chunk, int nsplit,
                   float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [G_TILE][dh] query rows
  float* ks = qs + G_TILE * dh;            // [bk][ld_any] key tile
  float* vs = ks + bk * attn::ld_any(dh);  // [bk][dh] value tile
  float* ps = vs + bk * dh;                // [G_TILE][bk + 1] scores, then p
  float* acc = ps + G_TILE * (bk + 1);     // [G_TILE][dh] accumulator
  float* ms = acc + G_TILE * dh;           // [G_TILE] running max
  float* ls = ms + G_TILE;                 // [G_TILE] running denominator
  float* as = ls + G_TILE;                 // [G_TILE] this tile's rescale

  const Cta at = cta_of(nsplit, g);
  const int b = at.bh / kvh;
  const int kv = at.bh % kvh;
  const int j0 = at.split * chunk;
  const int j1 = min(rows_read(pos, rows, s_cache), j0 + chunk);
  const int tid = threadIdx.x;
  const long long row_stride = static_cast<long long>(kvh) * dh;
  const long long head0 =
      static_cast<long long>(b) * s_cache * row_stride +
      static_cast<long long>(kv) * dh;
  const T* qbase = q + (static_cast<long long>(at.bh) * g + at.g0) * dh;

  attn::stage_rows_any<T, VEC, THREADS>(qbase, dh, 0, at.gq, at.gq, dh, qs,
                                        dh);
  for (int e = tid; e < at.gq * dh; e += THREADS) acc[e] = 0.f;
  for (int r = tid; r < at.gq; r += THREADS) {
    ms[r] = attn::NEG;
    ls[r] = 0.f;
  }
  for (int t0 = j0; t0 < j1; t0 += bk) {
    __syncthreads();  // the last tile's readers are done (and q is staged)
    attn::stage_rows_any<T, VEC, THREADS>(kc + head0, row_stride, t0, j1, bk,
                                          dh, ks, attn::ld_any(dh));
    attn::stage_rows_any<T, VEC, THREADS>(vc + head0, row_stride, t0, j1, bk,
                                          dh, vs, dh);
    __syncthreads();
    attn::tile_any<THREADS>(qs, ks, vs, ps, acc, ms, ls, as, at.gq, bk, dh,
                            [&](int, int j, float x) {
                              // rows past the chunk: not keys, p = 0
                              return t0 + j < j1 ? x * scale
                                                 : attn::neg_inf();
                            });
  }
  __syncthreads();
  // partial of this chunk, per query row: [m, l, acc[dh]]
  float* out = part + ((static_cast<long long>(at.bh) * nsplit + at.split) *
                           g + at.g0) * (dh + 2);
  for (int e = tid; e < at.gq * dh; e += THREADS) {
    const int r = e / dh, d = e - r * dh;
    out[r * (dh + 2) + 2 + d] = acc[e];
  }
  for (int r = tid; r < at.gq; r += THREADS) {
    out[r * (dh + 2)] = ms[r];
    out[r * (dh + 2) + 1] = ls[r];
  }
}

template <typename T, int VEC>
cudaError_t launch_any(int dh, const void* q, const void* k, const void* v,
                       void* o, float* lse, void* part, const int* pos, int b,
                       int s_cache, int kvh, int g, int rows, int chunk,
                       float scale, cudaStream_t stream) {
  int bk = 0;
  for (const int t : ANY_BK)
    if (any_smem_bytes(t, dh) * attn::ctas_per_sm_at(dh) <= attn::SMEM_MAX) {
      bk = t;
      break;
    }
  if (bk == 0 || part == nullptr) return cudaErrorInvalidValue;
  const size_t smem = any_smem_bytes(bk, dh);
  auto kern = decode_partial_any<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nsplit = (rows + chunk - 1) / chunk;
  const long long blocks = static_cast<long long>(b) * kvh * nsplit *
                           ((g + G_TILE - 1) / G_TILE);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto* pp = static_cast<float*>(part);
  kern<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pp, pos, s_cache, kvh, g, dh, bk, rows, chunk,
      nsplit, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<T>(pp, static_cast<T*>(o), lse, pos, b, s_cache, kvh,
                           g, dh, rows, chunk, nsplit, stream);
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, void* part, const int* pos, int b, int s_cache,
                   int kvh, int g, int rows, int chunk, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static_assert(attn::ctas_per_sm<DH>() * smem <= attn::SMEM_MAX,
                "CTAs per SM (decode_attention.ctas_per_sm)");
  // contiguous caches: every row starts on a 16-byte boundary when the
  // base pointers do (DH * sizeof(T) is a multiple of 16 at every DH here)
  const bool aligned = reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  constexpr int VEC = static_cast<int>(16 / sizeof(T));
  auto kern = aligned ? decode_partial<T, DH, VEC>
                      : decode_partial<T, DH, 1>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nsplit = (rows + chunk - 1) / chunk;
  const long long blocks = static_cast<long long>(b) * kvh * nsplit *
                           ((g + G_TILE - 1) / G_TILE);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto* pp = static_cast<float*>(part);
  kern<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pp, pos, s_cache, kvh, g, rows, chunk,
      nsplit, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_combine<T>(pp, static_cast<T*>(o), lse, pos, b, s_cache, kvh,
                           g, DH, rows, chunk, nsplit, stream);
}

// Contiguous q and caches: every row of every head starts on a 16-byte
// boundary when the base pointers do and dh elements make whole 16-byte
// chunks (a head starts dh elements after the last; Dh 12 in bf16 or 3 in
// fp32 puts the second head off the boundary).
bool rows_aligned(size_t elt, int dh, const void* q, const void* k,
                  const void* v) {
  if ((static_cast<size_t>(dh) * elt) % 16 != 0) return false;
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

// ------------------------------------------------ tensor-core design

namespace tc {

constexpr int TR = 16;       // cache rows per warp tile
constexpr int STAGES = 3;    // each warp's ring depth
constexpr int QROWS = G_TILE;  // a G-tile's query rows, padded to one m16 tile

template <int DH>
__host__ __device__ constexpr int acc_ld() { return DH + 8; }  // fp32 merge rows

template <int DH>
constexpr size_t smem_bytes() {
  constexpr size_t ring = sizeof(attn::bf16) * attn::ld_bf16<DH>() *
                          (QROWS + WARPS * STAGES * 2 * TR);
  constexpr size_t merge =
      sizeof(float) * WARPS * QROWS * (2 + acc_ld<DH>());
  return ring > merge ? ring : merge;
}

// PAD as in flash_fwd_tc: dh_in read at run time; without it dh = DH
template <int DH, bool PAD>
__global__ void __launch_bounds__(THREADS, 2)
decode_tc(const attn::bf16* __restrict__ q, const attn::bf16* __restrict__ kc,
          const attn::bf16* __restrict__ vc, attn::bf16* __restrict__ o,
          float* __restrict__ lse, float* __restrict__ part,
          const int* __restrict__ pos, int s_cache, int kvh, int g, int dh_in,
          int rows, int chunk, int nsplit, float scale_log2) {
  using attn::bf16;
  constexpr int LD = attn::ld_bf16<DH>();
  constexpr int NT = DH / 8;
  constexpr int SLOT = 2 * TR * LD;   // one stage: K rows, then V rows
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [QROWS][LD]
  const Cta at = cta_of(nsplit, g);
  const int split = at.split;
  const int bh = at.bh;                         // b * kvh + kv
  const int gq = at.gq;                         // this G-tile's query rows
  const int b = bh / kvh;
  const int kv = bh % kvh;
  const int j0 = split * chunk;
  const int j1 = min(rows_read(pos, rows, s_cache), j0 + chunk);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int col = 2 * (lane % 4);
  const int dh = PAD ? dh_in : DH;
  const int cpr = dh / 8;  // the head's 16-byte chunks (DH / 8 padded)
  const long long row_stride = static_cast<long long>(kvh) * dh;
  const long long head0 =
      static_cast<long long>(b) * s_cache * row_stride +
      static_cast<long long>(kv) * dh;
  const bf16* kbase = kc + head0;
  const bf16* vbase = vc + head0;
  bf16* ring = qs + QROWS * LD + warp * STAGES * SLOT;  // this warp's ring
  constexpr bool QREG = !attn::wide_head<DH>();  // Q's fragments in registers

  // a chunk past a device pos (j1 <= j0) has no tile: an empty partial
  const int ntiles = j1 > j0 ? (j1 - j0 + TR - 1) / TR : 0;
  const int mine = ntiles > warp ? (ntiles - warp + WARPS - 1) / WARPS : 0;
  auto load_tile = [&](int i) {  // this warp's i-th tile: tile warp + 4 i
    bf16* kd = ring + (i % STAGES) * SLOT;
    const int r0 = j0 + (warp + i * WARPS) * TR;
    attn::cp_rows<DH, TR, 32>(kd, kbase, row_stride, r0, j1, lane, cpr);
    attn::cp_rows<DH, TR, 32>(kd + TR * LD, vbase, row_stride, r0, j1, lane,
                              cpr);
  };
  attn::cp_rows<DH, QROWS, THREADS>(
      qs, q + (static_cast<long long>(bh) * g + at.g0) * dh, dh, 0, gq, tid,
      cpr);
  attn::cp_async_commit();
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < mine) load_tile(i);
    attn::cp_async_commit();
  }
  attn::cp_async_wait<STAGES - 1>();  // q, the oldest group, landed
  __syncthreads();                     // for every thread
  unsigned qf[QREG ? DH / 16 : 1][4];
  if constexpr (QREG) attn::load_q_frags<DH>(qf, qs, lane);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {attn::NEG, attn::NEG}, l[2] = {0.f, 0.f};

  for (int i = 0; i < mine; ++i) {
    // slot (i - 1) % STAGES: the warp read tile i - 1 from it last turn
    __syncwarp();
    if (i + STAGES - 1 < mine) load_tile(i + STAGES - 1);
    attn::cp_async_commit();
    attn::cp_async_wait<STAGES - 1>();  // tile i landed: mine ...
    __syncwarp();                       // ... and the warp's
    const bf16* ks = ring + (i % STAGES) * SLOT;
    const int r0 = j0 + (warp + i * WARPS) * TR;

    float s[TR / 8][4];
#pragma unroll
    for (int j = 0; j < TR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (QREG)
      attn::qk_tile<DH, TR / 16>(s, qf, ks, lane);
    else
      attn::qk_tile_smem<DH, TR / 16>(s, qs, ks, lane);
#pragma unroll
    for (int j = 0; j < TR / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)  // rows past the chunk: not keys, p = 0
        s[j][e] = r0 + j * 8 + col + (e & 1) < j1 ? s[j][e] * scale_log2
                                                  : attn::neg_inf();
    attn::softmax_tile<TR / 8, DH>(s, m, l, acc);
    attn::pv_tile<DH, TR / 16>(acc, s, ks + TR * LD, lane);
  }

  // the warps' (m, l, acc) merge through shared memory, once
  l[0] = attn::quad_sum(l[0]);
  l[1] = attn::quad_sum(l[1]);
  attn::cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring
  float* ms = reinterpret_cast<float*>(smem_tc);  // [WARPS][QROWS]
  float* ls = ms + WARPS * QROWS;                 // [WARPS][QROWS]
  float* as = ls + WARPS * QROWS;                 // [WARPS][QROWS][acc_ld]
  const int r = lane / 4;
  if (lane % 4 == 0) {
    ms[warp * QROWS + r] = m[0];
    ms[warp * QROWS + r + 8] = m[1];
    ls[warp * QROWS + r] = l[0];
    ls[warp * QROWS + r + 8] = l[1];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* a = as + (warp * QROWS + r) * acc_ld<DH>() + n * 8 + col;
    *reinterpret_cast<float2*>(a) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(a + 8 * acc_ld<DH>()) =
        make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  for (int i = tid; i < gq * dh; i += THREADS) {
    const int gi = i / dh, d = i % dh;
    float mx = attn::NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, ms[w * QROWS + gi]);
    float den = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float wt = exp2f(ms[w * QROWS + gi] - mx);
      den = fmaf(ls[w * QROWS + gi], wt, den);
      a = fmaf(as[(w * QROWS + gi) * acc_ld<DH>() + d], wt, a);
    }
    const long long row = static_cast<long long>(bh) * g + at.g0 + gi;
    if (nsplit == 1) {
      o[row * dh + d] = __float2bfloat16(a / fmaxf(den, 1e-30f));
      if (lse != nullptr && d == 0)  // mx is in the log2 domain
        lse[row] = mx * attn::LN2 + logf(fmaxf(den, 1e-30f));
    } else {  // the combine's layout, m back in natural-log units
      float* out = part + ((static_cast<long long>(bh) * nsplit + split) * g +
                           at.g0 + gi) * (dh + 2);
      out[2 + d] = a;
      if (d == 0) {
        out[0] = mx * attn::LN2;
        out[1] = den;
      }
    }
  }
}

// Dh dh on the instance of width DH (dh <= DH)
template <int DH, bool PAD>
cudaError_t launch(int dh, const void* q, const void* k, const void* v,
                   void* o, float* lse, void* part, const int* pos, int b,
                   int s_cache, int kvh, int g, int rows, int chunk,
                   float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static_assert(attn::ctas_per_sm<DH>() * smem <= attn::SMEM_MAX,
                "CTAs per SM (decode_attention.ctas_per_sm)");
  auto kern = decode_tc<DH, PAD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nsplit = (rows + chunk - 1) / chunk;
  if (nsplit > 1 && part == nullptr) return cudaErrorInvalidValue;
  const long long blocks = static_cast<long long>(b) * kvh * nsplit *
                           ((g + G_TILE - 1) / G_TILE);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto* pp = static_cast<float*>(part);
  kern<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const attn::bf16*>(q), static_cast<const attn::bf16*>(k),
      static_cast<const attn::bf16*>(v), static_cast<attn::bf16*>(o), lse,
      pp, pos, s_cache, kvh, g, dh, rows, chunk, nsplit,
      scale * attn::LOG2E);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  return launch_combine<attn::bf16>(pp, static_cast<attn::bf16*>(o), lse,
                                    pos, b, s_cache, kvh, g, dh, rows, chunk,
                                    nsplit, stream);
}

// The instance of width W for Dh dh: the model width's own where dh is one
// (its code as it was before padded heads), else the padded one.
template <int W>
cudaError_t launch_w(int dh, const void* q, const void* k, const void* v,
                     void* o, float* lse, void* part, const int* pos, int b,
                     int s_cache, int kvh, int g, int rows, int chunk,
                     float scale, cudaStream_t stream) {
  constexpr bool OWN = W == 16 || W == 32 || W == 64 || W == 128 || W == 256;
  if constexpr (OWN)
    if (dh == W)
      return launch<W, false>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                              kvh, g, rows, chunk, scale, stream);
  return launch<W, true>(dh, q, k, v, o, lse, part, pos, b, s_cache, kvh, g,
                         rows, chunk, scale, stream);
}

}  // namespace tc

template <typename T>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      void* o, float* lse, void* part, const int* pos, int b,
                      int s_cache, int kvh, int g, int rows, int chunk,
                      float scale, cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, part, pos, b, s_cache,
                           kvh, g, rows, chunk, scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, part, pos, b, s_cache,
                           kvh, g, rows, chunk, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, part, pos, b, s_cache,
                           kvh, g, rows, chunk, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, part, pos, b, s_cache,
                           kvh, g, rows, chunk, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, part, pos, b, s_cache,
                           kvh, g, rows, chunk, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The CUDA-core design at dh in {16, 32, 64, 128, 256}. dtype: 0 = fp32,
// 1 = bf16. pos: null, and then
// rows = min(pos, S - 1) + 1 cache rows are read; or a device int32
// holding pos, and then rows is the plan's S and each CTA reads pos
// itself. The rows are planned in chunks of `chunk` rows (a multiple of
// 64); lse: null, or (B, KV, G) fp32 that receives each query row's
// log-sum-exp; part is fp32 scratch of b * kvh * ceil(rows / chunk) * g *
// (dh + 2) floats. Returns the cudaError_t of the launches.
int decode_attention_launch(int dtype, int dh, const void* q, const void* k,
                            const void* v, void* o, float* lse, void* part,
                            const int* pos, int b, int s_cache, int kvh,
                            int g, int rows, int chunk, float scale,
                            void* stream) {
  if (b < 1 || s_cache < 1 || kvh < 1 || g < 1 || rows < 1 ||
      rows > s_cache || chunk < 1 || chunk % BK != 0)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(dh, q, k, v, o, lse, part, pos, b, s_cache, kvh,
                            g, rows, chunk, scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, o, lse, part, pos, b,
                                    s_cache, kvh, g, rows, chunk, scale, s);
  return cudaErrorInvalidValue;
}

// The tensor-core design: bf16 only, every row of q and the caches on a
// 16-byte boundary (the wrapper checks; a misaligned call is refused, never
// sent elsewhere), dh a multiple of 8 up to 256, run on the instance of
// width w (the wrapper's flash_attention.tc_width(dh); w >= dh). With one
// chunk (rows <= chunk) a single launch writes o and part may be null; otherwise part is the scratch decode_attention_launch
// describes, and decode_combine runs after. Returns the cudaError_t of the
// launches. lse and pos as decode_attention_launch's.
int decode_attention_tc_launch(int dh, int w, const void* q, const void* k,
                               const void* v, void* o, float* lse, void* part,
                               const int* pos, int b, int s_cache, int kvh,
                               int g, int rows, int chunk, float scale,
                               void* stream) {
  if (b < 1 || s_cache < 1 || kvh < 1 || g < 1 || rows < 1 ||
      rows > s_cache || chunk < 1 || chunk % BK != 0 || dh < 8 ||
      dh % 8 != 0 || dh > w)
    return cudaErrorInvalidValue;
  if (!rows_aligned(2, dh, q, k, v)) return cudaErrorMisalignedAddress;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 16:
      return tc::launch_w<16>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                               kvh, g, rows, chunk, scale, s);
    case 32:
      return tc::launch_w<32>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                               kvh, g, rows, chunk, scale, s);
    case 48:
      return tc::launch_w<48>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                               kvh, g, rows, chunk, scale, s);
    case 64:
      return tc::launch_w<64>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                               kvh, g, rows, chunk, scale, s);
    case 80:
      return tc::launch_w<80>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                               kvh, g, rows, chunk, scale, s);
    case 96:
      return tc::launch_w<96>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                               kvh, g, rows, chunk, scale, s);
    case 112:
      return tc::launch_w<112>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                               kvh, g, rows, chunk, scale, s);
    case 128:
      return tc::launch_w<128>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                               kvh, g, rows, chunk, scale, s);
    case 160:
      return tc::launch_w<160>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                               kvh, g, rows, chunk, scale, s);
    case 192:
      return tc::launch_w<192>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                               kvh, g, rows, chunk, scale, s);
    case 224:
      return tc::launch_w<224>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                               kvh, g, rows, chunk, scale, s);
    case 256:
      return tc::launch_w<256>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                               kvh, g, rows, chunk, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The any-width CUDA-core design: fp32 (dtype 0) or bf16 (1), any dh from
// 1 to attn::DH_MAX; part is the scratch decode_attention_launch
// describes. Arguments as decode_attention_launch's.
int decode_attention_any_launch(int dtype, int dh, const void* q,
                                const void* k, const void* v, void* o,
                                float* lse, void* part, const int* pos, int b,
                                int s_cache, int kvh, int g, int rows,
                                int chunk, float scale, void* stream) {
  if (b < 1 || s_cache < 1 || kvh < 1 || g < 1 || rows < 1 ||
      rows > s_cache || chunk < 1 || chunk % BK != 0 || dh < 1 ||
      dh > attn::DH_MAX)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (rows_aligned(4, dh, q, k, v))
      return launch_any<float, 4>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                                  kvh, g, rows, chunk, scale, s);
    return launch_any<float, 1>(dh, q, k, v, o, lse, part, pos, b, s_cache,
                                kvh, g, rows, chunk, scale, s);
  }
  if (dtype == 1) {
    if (rows_aligned(2, dh, q, k, v))
      return launch_any<__nv_bfloat16, 8>(dh, q, k, v, o, lse, part, pos, b,
                                          s_cache, kvh, g, rows, chunk, scale,
                                          s);
    return launch_any<__nv_bfloat16, 1>(dh, q, k, v, o, lse, part, pos, b,
                                        s_cache, kvh, g, rows, chunk, scale,
                                        s);
  }
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
