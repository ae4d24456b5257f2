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
//   q_scales (B,) fp32 -> vals (B, k) fp32, rows (B, k) int32, k <= 64.
//   Each score is the exact int32 dot, rescaled as float(i32) * row_scale,
//   then * q_scale, each product rounded to nearest; inactive rows score
//   NEG = -3e38. Order is value descending, then row ascending on ties.
//   The result is bitwise the numpy path's coarse scores and rows
//   (core/tiers.py::QuantIndex._coarse_brute); int8 scores tie exactly far
//   more often than fp32 ones, so the tie rule is load-bearing.
//
// What bounds it on an H100: a scan must read the active mask (N bytes),
// each active row's D int8 values and scale, and the queries, and do
// 2*D*B int8 operations per active row; this kernel reads every row, as
// N*D + 5N + B*D bytes. Against 3.35 TB/s and 1979 TOP/s of int8
// tensor-core rate the bytes bound it up to B ~ 300: the scan is a
// memory-bound stream at every batch the engine sends.
//
// The simple design (speed is later work): the structure of ann_topk.cu.
//   pass 1, annq_tile_topk: one CTA per (512-row tile, block of QB = 1, 4
//     or 16 queries), the int8 query block in shared memory. Each warp
//     scores ROWS rows at once (dot.cuh): lanes read 16-byte chunks of the
//     rows and accumulate with __dp4a in int32, exact in any order; the
//     rescale is two separate round-to-nearest multiplies in the
//     reference's order. __dp4a runs on the CUDA cores, roughly 130 TOP/s
//     on an H100 by our estimate (4 products an instruction), so it keeps
//     up with the memory stream to B ~ 20, which covers the engine's
//     micro-batches; int8 tensor cores pay only beyond. Scores go to shared
//     memory; k warp-wide argmax passes per query (select.cuh, ties to the
//     lowest row) write the tile's k finalists.
//   pass 2, sel::merge_topk: one CTA per query takes the top k of its
//     ntiles*k finalists with the same total order.
// Neither pass allocates: the caller passes the finalist scratch buffers.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "dot.cuh"
#include "select.cuh"

namespace {

constexpr int TILE_N = 512;      // rows per CTA tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;          // rows a warp scores at once
constexpr int K_MAX = 64;
constexpr size_t SMEM_MAX = 232448;  // H100: 227 KB of dynamic shared memory

template <int VEC, int QB>
__global__ void __launch_bounds__(THREADS)
annq_tile_topk(const int8_t* __restrict__ emb, const float* __restrict__ scale,
               const uint8_t* __restrict__ active,
               const int8_t* __restrict__ qq, const float* __restrict__ qs,
               int n, int d, int b, int k, int ntiles, int nqb,
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

  for (int i = threadIdx.x; i < nq * d; i += THREADS)
    sq[i] = qq[static_cast<size_t>(q0) * d + i];
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
                         int ntiles, float* fv, int* fr, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(QB) * (TILE_N * sizeof(float) + d);
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
                                                d, b, k, ntiles, nqb, fv, fr);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_qb(int qb, const int8_t* emb, const float* scale,
                      const uint8_t* active, const int8_t* qq, const float* qs,
                      int n, int d, int b, int k, int ntiles, float* fv,
                      int* fr, cudaStream_t stream) {
  switch (qb) {
    case 1:
      return launch_tiles<VEC, 1>(emb, scale, active, qq, qs, n, d, b, k, ntiles, fv, fr, stream);
    case 4:
      return launch_tiles<VEC, 4>(emb, scale, active, qq, qs, n, d, b, k, ntiles, fv, fr, stream);
    case 16:
      return launch_tiles<VEC, 16>(emb, scale, active, qq, qs, n, d, b, k, ntiles, fv, fr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// fv/fr: (b, ceil(n / 512), k) fp32/int32 finalist scratch.
// qb: queries per CTA, 1, 4 or 16. Returns the cudaError_t of the launches.
int ann_topk_quant_launch(int qb, const void* emb_q, const void* scales,
                          const void* active, const void* qq,
                          const void* q_scales, int n, int d, int b, int k,
                          void* fv, void* fr, void* vals, void* rows,
                          void* stream) {
  if (n < 1 || d < 1 || b < 1 || k < 1 || k > K_MAX)
    return cudaErrorInvalidValue;
  const int ntiles = (n + TILE_N - 1) / TILE_N;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const int8_t*>(emb_q);
  const auto* sc = static_cast<const float*>(scales);
  const auto* act = static_cast<const uint8_t*>(active);
  const auto* q = static_cast<const int8_t*>(qq);
  const auto* qs = static_cast<const float*>(q_scales);
  auto* pv = static_cast<float*>(fv);
  auto* pr = static_cast<int*>(fr);
  // wide loads need rows that start on boundaries of their width (the
  // shared query block's rows start on them whenever d is a multiple)
  const auto addr = reinterpret_cast<uintptr_t>(emb_q);
  cudaError_t err;
  if (addr % 16 == 0 && d % 16 == 0)
    err = launch_qb<16>(qb, e, sc, act, q, qs, n, d, b, k, ntiles, pv, pr, s);
  else if (addr % 4 == 0 && d % 4 == 0)
    err = launch_qb<4>(qb, e, sc, act, q, qs, n, d, b, k, ntiles, pv, pr, s);
  else
    err = launch_qb<1>(qb, e, sc, act, q, qs, n, d, b, k, ntiles, pv, pr, s);
  if (err != cudaSuccess) return err;
  sel::merge_topk<THREADS><<<b, THREADS, 0, s>>>(pv, pr, ntiles * k, k,
                                                 static_cast<float*>(vals),
                                                 static_cast<int*>(rows));
  return cudaGetLastError();
}

const char* ann_topk_quant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
