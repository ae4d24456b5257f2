// ann_topk.cu — Seri stage 1 on Hopper (sm_90a): exact cosine scores of a
// query block against every row of the embedding matrix, fused with the
// top-k selection.
//
// Replaces repro/kernels/ann_topk.py::_ann_kernel (the Pallas TPU kernel)
// together with the finalist merge that follows it (ann_topk.py:84-92).
//
// Contract (the reference's):
//   emb (N, D) fp32 or bf16, active (N,) bytes, q (B, D) of emb's type
//   -> vals (B, k) fp32, rows (B, k) int32, k <= 64.
//   Products and sums in fp32; inactive rows score NEG = -3e38. Order is
//   value descending, then row ascending on ties. Entries whose value is
//   NEG carry unspecified rows.
//
// What bounds it on an H100: a scan must read the active mask (N bytes),
// the active rows (D*4 bytes each) and the queries, and do 2*D*B fp32
// operations per active row; this kernel reads every row, N*D*4 + N +
// B*D*4 bytes. At D = 768 the
// bytes bound it below B ~ 40 (3.35 TB/s against 67 TFLOP/s of fp32 CUDA-core
// rate) and the operations above. The engine's micro-batches are B <= 16, so
// the scan is a memory-bound stream.
//
// The simple design (speed is later work):
//   pass 1, ann_tile_topk: one CTA per (512-row tile, block of QB queries).
//     QB is 1, 4 or 16, picked by the caller from B: a block of 16 at B = 1
//     or 4 pays for the empty slots' registers and shuffles (chip_smoke.py
//     times both; PERF.md). The query block sits in shared memory as fp32.
//     Each warp scores ROWS rows at once in the summation order of
//     dot.cuh (lanes stream D with 16-byte loads, hold the ROWS x QB
//     partial sums in registers, so one shared-memory read of q feeds ROWS
//     FMAs, and finish with a fixed xor butterfly): every row gets the same
//     order, so exact-duplicate embeddings tie bitwise and the row-ascending
//     rule decides, as the reference assumes, and a row scores the same
//     here as in the routed scan (ann_topk_ivf.cu). No tensor cores: TF32
//     would break row parity with the host path. Scores go to shared
//     memory; then k warp-wide argmax passes per query (select.cuh, ties to
//     the lowest row) write the tile's k finalists.
//   pass 2, sel::merge_topk: one CTA per query takes the top k of its
//     ntiles*k finalists with the same total order.
// Neither pass allocates: the caller passes the finalist scratch buffers.

#include <cuda_bf16.h>
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

template <typename T, int VEC, int QB>
__global__ void __launch_bounds__(THREADS)
ann_tile_topk(const T* __restrict__ emb, const uint8_t* __restrict__ active,
              const T* __restrict__ q, int n, int d, int b, int k, int ntiles,
              int nqb, float* __restrict__ fv, int* __restrict__ fr) {
  extern __shared__ float smem[];
  float* sq = smem;               // [QB][d] query block, fp32
  float* sc = smem + QB * d;      // [QB][TILE_N] tile scores
  // query blocks of one tile are neighbours in launch order, so they find
  // the tile in L2
  const int qblk = blockIdx.x % nqb;
  const int tile = blockIdx.x / nqb;
  const int q0 = qblk * QB;
  const int nq = min(QB, b - q0);
  const int row0 = tile * TILE_N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < nq * d; i += THREADS)
    sq[i] = dot::to_f32(q[static_cast<size_t>(q0) * d + i]);
  __syncthreads();

  for (int r0 = warp * ROWS; r0 < TILE_N; r0 += WARPS * ROWS) {
    const T* erow[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int row = min(row0 + r0 + r, n - 1);  // rows >= n masked below
      erow[r] = emb + static_cast<size_t>(row) * d;
    }
    float acc[ROWS][QB];
    dot::warp_dot<T, VEC, ROWS, QB>(erow, sq, d, nq, lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = row0 + r0 + r;
        const bool live = row < n && active[row] != 0;
#pragma unroll
        for (int j = 0; j < QB; ++j)
          if (j < nq) sc[j * TILE_N + r0 + r] = live ? acc[r][j] : sel::NEG;
      }
    }
  }
  __syncthreads();

  // per-tile top-k: one warp per query, k argmax passes
  for (int j = warp; j < nq; j += WARPS) {
    const size_t out = (static_cast<size_t>(q0 + j) * ntiles + tile) * k;
    sel::warp_topk(sc + j * TILE_N, TILE_N, k, fv + out, fr + out, row0);
  }
}

template <typename T, int VEC, int QB>
cudaError_t launch_tiles(const void* emb, const uint8_t* active, const void* q,
                         int n, int d, int b, int k, int ntiles, float* fv,
                         int* fr, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(QB) * (d + TILE_N) * sizeof(float);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = ann_tile_topk<T, VEC, QB>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nqb = (b + QB - 1) / QB;
  kern<<<ntiles * nqb, THREADS, smem, stream>>>(
      static_cast<const T*>(emb), active, static_cast<const T*>(q), n, d, b, k,
      ntiles, nqb, fv, fr);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_qb(int qb, const void* emb, const uint8_t* active,
                      const void* q, int n, int d, int b, int k, int ntiles,
                      float* fv, int* fr, cudaStream_t stream) {
  switch (qb) {
    case 1:
      return launch_tiles<T, VEC, 1>(emb, active, q, n, d, b, k, ntiles, fv, fr, stream);
    case 4:
      return launch_tiles<T, VEC, 4>(emb, active, q, n, d, b, k, ntiles, fv, fr, stream);
    case 16:
      return launch_tiles<T, VEC, 16>(emb, active, q, n, d, b, k, ntiles, fv, fr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// fv/fr: (b, ceil(n / 512), k) fp32/int32 finalist scratch.
// dtype: 0 = fp32, 1 = bf16. qb: queries per CTA, 1, 4 or 16.
// Returns the cudaError_t of the launches.
int ann_topk_launch(int dtype, int qb, const void* emb, const void* active,
                    const void* q, int n, int d, int b, int k, void* fv,
                    void* fr, void* vals, void* rows, void* stream) {
  if (n < 1 || d < 1 || b < 1 || k < 1 || k > K_MAX || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int ntiles = (n + TILE_N - 1) / TILE_N;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* act = static_cast<const uint8_t*>(active);
  auto* pv = static_cast<float*>(fv);
  auto* pr = static_cast<int*>(fr);
  // 16-byte loads need rows that start on 16-byte boundaries
  const bool aligned = reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  cudaError_t err;
  if (dtype == 0) {
    err = (aligned && d % 4 == 0)
        ? launch_qb<float, 4>(qb, emb, act, q, n, d, b, k, ntiles, pv, pr, s)
        : launch_qb<float, 1>(qb, emb, act, q, n, d, b, k, ntiles, pv, pr, s);
  } else {
    err = (aligned && d % 8 == 0)
        ? launch_qb<__nv_bfloat16, 8>(qb, emb, act, q, n, d, b, k, ntiles, pv, pr, s)
        : launch_qb<__nv_bfloat16, 1>(qb, emb, act, q, n, d, b, k, ntiles, pv, pr, s);
  }
  if (err != cudaSuccess) return err;
  // one CTA per query merges its ntiles*k finalists
  sel::merge_topk<THREADS><<<b, THREADS, 0, s>>>(pv, pr, ntiles * k, k,
                                                 static_cast<float*>(vals),
                                                 static_cast<int*>(rows));
  return cudaGetLastError();
}

const char* ann_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
