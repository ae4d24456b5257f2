// ann_topk_quant.cu — the warm tier's coarse stage 1 on Hopper (sm_90a):
// int8 scores of an int8 query block against every row of the int8
// embedding matrix, rescaled and fused with the top-k selection.
//
// Replaces repro/kernels/ann_topk_quant.py::_annq_kernel (the Pallas TPU
// kernel) together with the finalist merge that follows it
// (ann_topk_quant.py:104-112).
//
// Contract (the reference's):
//   emb_q (N, D) int8, scales (N,) fp32, active (N,) bytes, qq (B, D) int8,
//   q_scales (B,) fp32 -> vals (B, k) fp32, rows (B, k) int32, any k >= 1.
//   Each score is the exact int32 dot, rescaled as float(i32) * row_scale,
//   then * q_scale, each product rounded to nearest; inactive rows score
//   NEG = -3e38. Order is value descending, then row ascending on ties.
//   The result is bitwise the numpy path's coarse scores and rows
//   (core/tiers.py::QuantIndex._coarse_brute); int8 scores tie exactly far
//   more often than fp32 ones, so the tie rule is load-bearing.
//
// What bounds it on an H100: a scan must read the active mask (N bytes),
// each active row's D int8 values and scale, and the queries, and do
// 2*D*B int8 operations per active row. Against 3.35 TB/s and 1979 TOP/s
// of int8 tensor-core rate the bytes bound it up to B ~ 300: at every
// batch the engine sends the scan is a memory-bound stream, and at the
// engine's own index (8192 x 128, mostly empty) a few microseconds of
// work, where launches and too few CTAs decide its time.
//
// Two designs, picked by the host (kernels/ann_topk_quant.py::pick_design);
// both sum exact int32 dots (any order gives the same integer) and rescale
// with dot::rescale, so their values are bitwise the same:
//
// "tc", int8 rows on a 16-byte boundary with D % 32 == 0 (D = 128 and 768,
//   every call of the warm tier): one launch on the int8 tensor cores
//   (mma.sync m16n8k32, s8 x s8 -> s32). One CTA per (tile of tile_n rows,
//   block of QB = 8 or 16 queries); the host sizes tile_n from N, B and the
//   SM count so that the scan fills the card (two CTAs per SM where N
//   allows). Rows are M, queries N (padded with zero queries to 8 or 16).
//   A warp takes 16 rows at a time: lane (g, t) loads 16 bytes of rows g
//   and g + 8 straight from device memory into registers (the four lanes
//   of a row read 64 contiguous bytes) and 16 bytes of query g from the
//   query block in shared memory (rows padded so these reads are free of
//   bank conflicts); the bytes map to the fragments' k positions by one
//   permutation on both sides, which leaves every int32 sum as it is. All
//   32 lanes work at any D; a lane loads 4 chunks of both rows before it
//   multiplies any. Groups of 16 rows with no active row skip their
//   payload. The rescaled scores go to shared memory, and the tile's
//   finalists and the merge in the last CTA of each query block are
//   sel::finish_tile's, as in ann_topk.cu's "fused" design.
// "dp4a", other widths or alignments: the first design. Pass 1,
//   annq_tile_topk: one CTA per (512-row tile, block of QB = 1, 4 or 16
//   queries), each warp 4 rows at once, lanes reading 16-byte chunks and
//   summing with __dp4a on the CUDA cores (at D = 128 only 8 of 32 lanes
//   hold a chunk); pass 2, sel::merge_topk: one CTA per query merges its
//   ntiles*k finalists.
// "wide", k above K_MAX = 64: "dp4a"'s tiles, each keeping its min(k, 512)
//   best in order, then ann_topk.cu's "wide" merge (sel::merge_lists).
// Any D: the host takes the largest query block whose shared memory fits
// (16 or 8 queries for "tc", 16, 4 or 1 for the others); where none does
// (D above about 200,000 bytes for "dp4a", 25,000 for "tc"), the smallest
// block reads its queries in place from device memory (qglobal; the host
// passes them on a 16-byte boundary; "tc" reads query nq - 1 again for the
// block's empty columns, whose scores it drops). Integer sums are exact in
// any order, so the values stay bitwise the same.
// No design allocates: the caller passes the finalist scratch and the
// tickets.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>

#include "dot.cuh"
#include "select.cuh"

namespace {

constexpr int TILE_N = 512;      // rows per CTA tile ("dp4a"; the most
                                 // "tc" takes)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;          // rows a warp scores at once ("dp4a")
constexpr int K_MAX = 64;       // the largest k of "tc" and "dp4a"
constexpr size_t SMEM_MAX = 232448;  // H100: 227 KB of dynamic shared memory

template <int VEC, int QB>
__global__ void __launch_bounds__(THREADS)
annq_tile_topk(const int8_t* __restrict__ emb, const float* __restrict__ scale,
               const uint8_t* __restrict__ active,
               const int8_t* __restrict__ qq, const float* __restrict__ qs,
               int n, int d, int b, int k, int ntiles, int nqb, int qglobal,
               float* __restrict__ fv, int* __restrict__ fr) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);  // [QB][TILE_N] tile scores
  int8_t* sq = reinterpret_cast<int8_t*>(sc + QB * TILE_N);  // [QB][d]
  const int qblk = blockIdx.x % nqb;
  const int tile = blockIdx.x / nqb;
  const int q0 = qblk * QB;
  const int nq = min(QB, b - q0);
  const int row0 = tile * TILE_N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  if (qglobal) {
    sq = const_cast<int8_t*>(qq) + static_cast<size_t>(q0) * d;  // read only
  } else {
    for (int i = threadIdx.x; i < nq * d; i += THREADS)
      sq[i] = qq[static_cast<size_t>(q0) * d + i];
  }
  __syncthreads();

  for (int r0 = warp * ROWS; r0 < TILE_N; r0 += WARPS * ROWS) {
    const int8_t* erow[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = min(row0 + r0 + r, n - 1);  // rows >= n masked below
      erow[r] = emb + static_cast<size_t>(row) * d;
    }
    int acc[ROWS][QB];
    dot::warp_dot_i8<VEC, ROWS, QB>(erow, sq, d, nq, lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = row0 + r0 + r;
        const bool live = row < n && active[row] != 0;
        const float rs = live ? scale[row] : 0.f;
#pragma unroll
        for (int j = 0; j < QB; ++j)
          if (j < nq)
            sc[j * TILE_N + r0 + r] =
                live ? dot::rescale(acc[r][j], rs, qs[q0 + j]) : sel::NEG;
      }
    }
  }
  __syncthreads();

  for (int j = warp; j < nq; j += WARPS) {
    const size_t out = (static_cast<size_t>(q0 + j) * ntiles + tile) * k;
    sel::warp_topk(sc + j * TILE_N, TILE_N, k, fv + out, fr + out, row0);
  }
}

template <int VEC, int QB>
cudaError_t launch_tiles(const int8_t* emb, const float* scale,
                         const uint8_t* active, const int8_t* qq,
                         const float* qs, int n, int d, int b, int k,
                         int ntiles, int qglobal, float* fv, int* fr,
                         cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(QB) * (TILE_N * sizeof(float) + (qglobal ? 0 : d));
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = annq_tile_topk<VEC, QB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nqb = (b + QB - 1) / QB;
  kern<<<ntiles * nqb, THREADS, smem, stream>>>(emb, scale, active, qq, qs, n,
                                                d, b, k, ntiles, nqb, qglobal,
                                                fv, fr);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_qb(int qb, const int8_t* emb, const float* scale,
                      const uint8_t* active, const int8_t* qq, const float* qs,
                      int n, int d, int b, int k, int ntiles, int qglobal,
                      float* fv, int* fr, cudaStream_t stream) {
  switch (qb) {
    case 1:
      return launch_tiles<VEC, 1>(emb, scale, active, qq, qs, n, d, b, k, ntiles, qglobal, fv, fr, stream);
    case 4:
      return launch_tiles<VEC, 4>(emb, scale, active, qq, qs, n, d, b, k, ntiles, qglobal, fv, fr, stream);
    case 16:
      return launch_tiles<VEC, 16>(emb, scale, active, qq, qs, n, d, b, k, ntiles, qglobal, fv, fr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Pass 1 of "dp4a" and "wide": each tile's k best (k <= TILE_N) into fv/fr
// ((b, ntiles, k)). Wide loads need rows that start on boundaries of their
// width (the shared query block's rows start on them whenever d is a
// multiple, and so do the queries read in place, on a 16-byte boundary).
cudaError_t tiles_pass(int qb, const void* emb_q, const void* scales,
                       const void* active, const void* qq,
                       const void* q_scales, int n, int d, int b, int k,
                       int ntiles, int qglobal, float* fv, int* fr,
                       cudaStream_t s) {
  const auto* e = static_cast<const int8_t*>(emb_q);
  const auto* sc = static_cast<const float*>(scales);
  const auto* act = static_cast<const uint8_t*>(active);
  const auto* q = static_cast<const int8_t*>(qq);
  const auto* qs = static_cast<const float*>(q_scales);
  const auto addr = reinterpret_cast<uintptr_t>(emb_q);
  if (addr % 16 == 0 && d % 16 == 0)
    return launch_qb<16>(qb, e, sc, act, q, qs, n, d, b, k, ntiles, qglobal, fv, fr, s);
  if (addr % 4 == 0 && d % 4 == 0)
    return launch_qb<4>(qb, e, sc, act, q, qs, n, d, b, k, ntiles, qglobal, fv, fr, s);
  return launch_qb<1>(qb, e, sc, act, q, qs, n, d, b, k, ntiles, qglobal, fv, fr, s);
}

// "tc": one CTA per (tile of tile_n rows, block of 8 NT queries), the
// int8 tensor cores, the merge in the last CTA of each query block (see
// the head of this file). qstride: bytes per query row in shared memory.
// QG: the query block is read in place from device memory; a template
// argument, so that the shared-memory instance keeps its shared loads.
template <int NT, bool QG>
__global__ void __launch_bounds__(THREADS)
annq_tc(const int8_t* __restrict__ emb, const float* __restrict__ scale,
        const uint8_t* __restrict__ active, const int8_t* __restrict__ qq,
        const float* __restrict__ qs, int n, int d, int b, int k, int tile_n,
        int ntiles, int nqb, int qvec, int qstride, float* fv, int* fr,
        int* tickets, float* vals, int* rows, int tbuf_at) {
  constexpr int QB = 8 * NT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc = reinterpret_cast<float*>(smem);               // [QB][tile_n]
  int8_t* sq = reinterpret_cast<int8_t*>(sc + QB * tile_n);  // [QB][qstride]
  // [tile_n] active bytes, after the query block unless it is read in place
  uint8_t* sa = reinterpret_cast<uint8_t*>(sq + (QG ? 0 : QB * qstride));
  const int qblk = blockIdx.x % nqb;
  const int tile = blockIdx.x / nqb;
  const int q0 = qblk * QB;
  const int nq = min(QB, b - q0);
  const int row0 = tile * tile_n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // the query block, zero past nq, in 16-byte words; read in place, query
  // nq - 1 again past nq (those columns' scores are dropped)
  const int words = QG ? 0 : d / 16;
  const int8_t* qbase = QG ? qq + static_cast<size_t>(q0) * d : sq;
  const int qrow = QG ? d : qstride;
  for (int i = threadIdx.x; i < QB * words; i += THREADS) {
    const int j = i / words, c = i % words;
    int4 v = make_int4(0, 0, 0, 0);
    if (j < nq) {
      const int8_t* src = qq + static_cast<size_t>(q0 + j) * d + 16 * c;
      if (qvec) {
        v = __ldg(reinterpret_cast<const int4*>(src));
      } else {
        int8_t tmp[16];
#pragma unroll
        for (int x = 0; x < 16; ++x) tmp[x] = src[x];
        memcpy(&v, tmp, 16);
      }
    }
    *reinterpret_cast<int4*>(sq + j * qstride + 16 * c) = v;
  }
  for (int i = threadIdx.x; i < tile_n; i += THREADS)
    sa[i] = row0 + i < n ? active[row0 + i] : 0;
  __syncthreads();

  const int nch = d / 64;  // 64-byte chunks; a 32-byte tail when d % 64
  for (int m0 = warp * 16; m0 < tile_n; m0 += WARPS * 16) {
    const unsigned live = __ballot_sync(dot::FULL, lane < 16 && sa[m0 + (lane & 15)]);
    if (live == 0) {  // no active row: skip the payload
      for (int i = lane; i < nq * 16; i += 32)
        sc[(i / 16) * tile_n + m0 + i % 16] = sel::NEG;
      continue;
    }
    const int ra = min(row0 + m0 + g, n - 1);  // rows >= n are inactive
    const int rb = min(row0 + m0 + g + 8, n - 1);
    const int8_t* pa = emb + static_cast<size_t>(ra) * d + 16 * t;
    const int8_t* pb = emb + static_cast<size_t>(rb) * d + 16 * t;
    const float sca = __ldg(scale + ra), scb = __ldg(scale + rb);
    int acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0;
    // k positions 4t..4t+3 and 16+4t..16+4t+3 of a 32-byte step are bytes
    // 16t..16t+7 (first step) or 16t+8..16t+15 (second) of a 64-byte chunk
    // on both operands. BATCH chunks of both rows are loaded before any is
    // used, so 2 BATCH 16-byte loads a lane are in flight.
    constexpr int BATCH = 4;
    for (int c0 = 0; c0 < nch; c0 += BATCH) {
      int4 a[BATCH], a8[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (c0 + u < nch) {
          a[u] = __ldg(reinterpret_cast<const int4*>(pa + 64 * (c0 + u)));
          a8[u] = __ldg(reinterpret_cast<const int4*>(pb + 64 * (c0 + u)));
        }
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (c0 + u < nch) {
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            const int4 w = *reinterpret_cast<const int4*>(
                qbase + (QG ? min(nt * 8 + g, nq - 1) : nt * 8 + g) * qrow +
                64 * (c0 + u) + 16 * t);
            dot::mma_s8(acc[nt], a[u].x, a8[u].x, a[u].y, a8[u].y, w.x, w.y);
            dot::mma_s8(acc[nt], a[u].z, a8[u].z, a[u].w, a8[u].w, w.z, w.w);
          }
        }
    }
    if (d & 32) {  // the tail: bytes 8t..8t+7 of the last 32
      const int off = 64 * nch - 8 * t;  // pa already holds + 16t
      const int2 a = __ldg(reinterpret_cast<const int2*>(pa + off));
      const int2 a8 = __ldg(reinterpret_cast<const int2*>(pb + off));
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int2 u = *reinterpret_cast<const int2*>(
            qbase + (QG ? min(nt * 8 + g, nq - 1) : nt * 8 + g) * qrow +
            64 * nch + 8 * t);
        dot::mma_s8(acc[nt], a.x, a8.x, a.y, a8.y, u.x, u.y);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + (e >> 1) * 8;
        const int j = nt * 8 + 2 * t + (e & 1);
        if (j < nq)
          sc[j * tile_n + m0 + r] =
              (live >> r & 1u) ? dot::rescale(acc[nt][e], e < 2 ? sca : scb,
                                              __ldg(qs + q0 + j))
                               : sel::NEG;
      }
  }
  __syncthreads();
  sel::finish_tile<THREADS>(sc, tile_n, nq, q0, k, tile, ntiles, row0, fv, fr,
                            tickets + qblk, vals, rows, smem,
                            smem + tbuf_at);
}

// query rows in shared memory: d bytes padded to a stride of 16-byte words
// that is 4 mod 8, so the 8 lanes of a quarter warp (two rows, four words
// each) read eight distinct 16-byte bank groups
inline int tc_qstride(int d) { return d + 16 * ((4 - d / 16) & 7); }

template <int NT>
cudaError_t launch_tc(const int8_t* emb, const float* scale,
                      const uint8_t* active, const int8_t* qq,
                      const float* qs, int n, int d, int b, int k, int tile_n,
                      int qvec, int qglobal, float* fv, int* fr, int* tickets,
                      float* vals, int* rows, cudaStream_t stream) {
  constexpr int QB = 8 * NT;
  const int qstride = tc_qstride(d);
  // the tile's scores, queries (unless read in place) and active bytes
  // (the last CTA's merge reuses them), then the tile's candidates
  // (kernels/ann_topk_quant.py::tc_smem)
  const size_t tbuf_at = (std::max(
      static_cast<size_t>(QB) * tile_n * sizeof(float) +
          static_cast<size_t>(QB) * (qglobal ? 0 : qstride) + tile_n,
      sel::merge_smem<THREADS>()) + 15) / 16 * 16;
  const size_t smem = tbuf_at + sel::tile_smem<THREADS>();
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = qglobal ? annq_tc<NT, true> : annq_tc<NT, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nqb = (b + QB - 1) / QB;
  const int ntiles = (n + tile_n - 1) / tile_n;
  kern<<<ntiles * nqb, THREADS, smem, stream>>>(
      emb, scale, active, qq, qs, n, d, b, k, tile_n, ntiles, nqb, qvec,
      qstride, fv, fr, tickets, vals, rows, static_cast<int>(tbuf_at));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Design "tc": emb_q on a 16-byte boundary, d % 32 == 0. tile_n: rows per
// CTA, a multiple of 16 in [k, 512] (kernels/ann_topk_quant.py's plan).
// qglobal: read the queries in place (qq on a 16-byte boundary).
// fv/fr: (b, ceil(n / tile_n), k) fp32/int32 finalist scratch; tickets:
// ceil(b / qb) int32, all 0, left 0. qb: queries per CTA, 8 or 16. One
// launch; returns its cudaError_t.
int ann_topk_quant_tc_launch(int qb, int tile_n, int qglobal,
                             const void* emb_q, const void* scales,
                             const void* active, const void* qq,
                             const void* q_scales, int n, int d, int b, int k,
                             void* fv, void* fr, void* tickets, void* vals,
                             void* rows, void* stream) {
  const int qvec = reinterpret_cast<uintptr_t>(qq) % 16 == 0;
  if (n < 1 || d < 1 || b < 1 || k < 1 || k > K_MAX || d % 32 != 0 ||
      reinterpret_cast<uintptr_t>(emb_q) % 16 != 0 || tile_n % 16 != 0 ||
      tile_n < k || tile_n > TILE_N || (qglobal && !qvec))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const int8_t*>(emb_q);
  const auto* sc = static_cast<const float*>(scales);
  const auto* act = static_cast<const uint8_t*>(active);
  const auto* q = static_cast<const int8_t*>(qq);
  const auto* qsp = static_cast<const float*>(q_scales);
  auto* pv = static_cast<float*>(fv);
  auto* pr = static_cast<int*>(fr);
  auto* pt = static_cast<int*>(tickets);
  auto* ov = static_cast<float*>(vals);
  auto* orow = static_cast<int*>(rows);
  switch (qb) {
    case 8:
      return launch_tc<1>(e, sc, act, q, qsp, n, d, b, k, tile_n, qvec, qglobal, pv, pr, pt, ov, orow, s);
    case 16:
      return launch_tc<2>(e, sc, act, q, qsp, n, d, b, k, tile_n, qvec, qglobal, pv, pr, pt, ov, orow, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Design "dp4a":

// fv/fr: (b, ceil(n / 512), k) fp32/int32 finalist scratch.
// qb: queries per CTA, 1, 4 or 16. qglobal: read the queries in place (qq
// on a 16-byte boundary). Returns the cudaError_t of the launches.
int ann_topk_quant_launch(int qb, int qglobal, const void* emb_q,
                          const void* scales, const void* active,
                          const void* qq, const void* q_scales, int n, int d,
                          int b, int k, void* fv, void* fr, void* vals,
                          void* rows, void* stream) {
  if (n < 1 || d < 1 || b < 1 || k < 1 || k > K_MAX ||
      (qglobal && reinterpret_cast<uintptr_t>(qq) % 16 != 0))
    return cudaErrorInvalidValue;
  const int ntiles = (n + TILE_N - 1) / TILE_N;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* pv = static_cast<float*>(fv);
  auto* pr = static_cast<int*>(fr);
  const cudaError_t err = tiles_pass(qb, emb_q, scales, active, qq, q_scales,
                                     n, d, b, k, ntiles, qglobal, pv, pr, s);
  if (err != cudaSuccess) return err;
  sel::merge_topk<THREADS><<<b, THREADS, 0, s>>>(pv, pr, ntiles * k, k,
                                                 static_cast<float*>(vals),
                                                 static_cast<int*>(rows));
  return cudaGetLastError();
}

// Design "wide", any k: "dp4a"'s tiles with lists of kt = min(k, 512), then
// ann_topk.cu's levels (kernels/ann_topk.py::merge_levels) through fv/fr
// and gv/gr (kernels/ann_topk.py::wide_scratch entries each) into
// vals/rows. Returns the cudaError_t of the launches.
int ann_topk_quant_wide_launch(int qb, int qglobal, const void* emb_q,
                               const void* scales, const void* active,
                               const void* qq, const void* q_scales, int n,
                               int d, int b, int k, void* fv, void* fr,
                               void* gv, void* gr, void* vals, void* rows,
                               void* stream) {
  if (n < 1 || d < 1 || b < 1 || k < 1 ||
      (qglobal && reinterpret_cast<uintptr_t>(qq) % 16 != 0))
    return cudaErrorInvalidValue;
  const int ntiles = (n + TILE_N - 1) / TILE_N;
  const int kt = std::min(k, TILE_N);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tiles_pass(
      qb, emb_q, scales, active, qq, q_scales, n, d, b, kt, ntiles, qglobal,
      static_cast<float*>(fv), static_cast<int*>(fr), s);
  if (err != cudaSuccess) return err;
  return sel::merge_lists<THREADS>(
      ntiles, kt, k, b, static_cast<float*>(fv), static_cast<int*>(fr),
      static_cast<float*>(gv), static_cast<int*>(gr),
      static_cast<float*>(vals), static_cast<int*>(rows), s);
}

const char* ann_topk_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
