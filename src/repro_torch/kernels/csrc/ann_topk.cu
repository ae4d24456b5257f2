// ann_topk.cu — Seri stage 1 on Hopper (sm_90a): exact cosine scores of a
// query block against every row of the embedding matrix, fused with the
// top-k selection.
//
// Replaces repro/kernels/ann_topk.py::_ann_kernel (the Pallas TPU kernel)
// together with the finalist merge that follows it (ann_topk.py:84-92).
//
// Contract (the reference's):
//   emb (N, D) fp32 or bf16, active (N,) bytes, q (B, D) of emb's type
//   -> vals (B, k) fp32, rows (B, k) int32, any k >= 1.
//   Products and sums in fp32; inactive rows score NEG = -3e38. Order is
//   value descending, then row ascending on ties. Entries whose value is
//   NEG carry unspecified rows.
//
// What bounds it on an H100: a scan must read the active mask (N bytes),
// the active rows (D*4 bytes each) and the queries, and do 2*D*B fp32
// operations per active row. At D = 768 the bytes bound it below B ~ 40
// (3.35 TB/s against 67 TFLOP/s of fp32 CUDA-core rate) and the operations
// above. At the engine's shapes (8192 x 128 rows, B = 1; routing over 64 or
// 512 centroids) a scan is a few microseconds of work, so launches and
// the latency of too few CTAs decide its time.
//
// Every design scores a (row, query) pair in dot.cuh's one order (lanes
// stream D in 16-byte chunks, a fixed xor tree combines their partial
// sums), so exact-duplicate embeddings tie bitwise and the row-ascending
// rule decides, as the reference assumes, and a row scores the same here
// as in the routed scan (ann_topk_ivf.cu). No tensor cores: TF32 would
// break row parity with the host path. Two designs, picked by the host
// (kernels/ann_topk.py::pick_design):
//
// "fused", fp32 rows on 16-byte boundaries with D % 4 == 0 (every call of
//   the engine and of the routing): one launch. One CTA per (tile of
//   tile_n rows, block of QB = 1, 4 or 16 queries); the host sizes tile_n
//   from N, B and the SM count so that the scan fills the card (two CTAs
//   per SM where N allows, tile_n <= 512). The CTA stages its queries and
//   its tile's active bytes in shared memory; each warp scores fused_rows
//   rows at once (8, or 4 at QB = 16: the rows x QB partial sums sit in
//   registers, so one shared-memory read of q feeds that many FMAs) and
//   skips the payload of a group with no active row. The tree runs
//   scattered (dot::warp_dot_scatter): each sum ends in one lane, M - 1
//   shuffles a lane for M sums instead of 5 M, and the lanes write the
//   scores in parallel. sel::finish_tile then picks each query's k
//   finalists of the tile (a sorting network up to 64 rows, above it a
//   threshold pass that sorts only scores at or above the k-th largest
//   lane maximum), and the CTA that finishes its query block last (an
//   atomic ticket it resets itself) merges the tiles' lists, a warp a
//   query, sorting only the entries at or above a lower bound of the k-th
//   best (select.cuh). Order is select.cuh's: value desc, row asc.
// "twopass", bf16 rows and misaligned or odd-width fp32 rows: the first
//   design. Pass 1, ann_tile_topk: one CTA per (512-row tile,
//   block of QB queries), each warp 4 rows at once through dot::warp_dot,
//   then the tile's k finalists; pass 2, sel::merge_topk: one CTA per
//   query takes the top k of its ntiles*k finalists.
// "wide", k above K_MAX = 64 (the networks' limit), any dtype: pass 1 is
//   twopass's, each tile keeping its kt = min(k, 512) best in order (k
//   argmax passes, which take any k); then sel::merge_pairs launches merge
//   the tiles' lists two by two, a thread an output entry finding its
//   place by merge path (a binary search of the two sorted lists), each
//   list cut to k, until one list of k is left
//   (kernels/ann_topk.py::merge_levels). Selection grows with k and no
//   list needs to fit in shared memory. Every tile holds 512 entries
//   (rows past N score NEG at their own index), so the NEG entries come
//   out in row order and, past the padded rows, as NEG at row p: the
//   plain version's stable sort, rows included.
// Any D: every design keeps its query block in shared memory where it
// fits (the host shrinks the block to 4 or 1 queries first); where not
// even one query fits (fp32 D above about 55,000), a block of one reads
// its query from device memory (qglobal; the host passes it as fp32 on a
// 16-byte boundary). The sums run in the same order either way.
// No design allocates: the caller passes the finalist scratch and the
// tickets.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "dot.cuh"
#include "select.cuh"

namespace {

constexpr int TILE_N = 512;      // rows per CTA tile ("twopass"; the most
                                 // "fused" takes)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;          // rows a warp scores at once ("twopass")
// and in "fused" (kernels/ann_topk.py::fused_rows): 8, so one shared-memory
// read of a query feeds 8 FMAs, but 4 for a block of 16 queries, where
// 8 x 16 sums take 254 registers and leave one CTA per SM
constexpr int fused_rows(int qb) { return qb == 16 ? 4 : 8; }
constexpr int K_MAX = 64;       // the largest k of "fused" and "twopass"
constexpr size_t SMEM_MAX = 232448;  // H100: 227 KB of dynamic shared memory

// k: the finalists a tile keeps (<= TILE_N), each tile's list k long.
// qf: null, or the queries as fp32 in device memory, read in place.
template <typename T, int VEC, int QB>
__global__ void __launch_bounds__(THREADS)
ann_tile_topk(const T* __restrict__ emb, const uint8_t* __restrict__ active,
              const T* __restrict__ q, const float* __restrict__ qf, int n,
              int d, int b, int k, int ntiles, int nqb,
              float* __restrict__ fv, int* __restrict__ fr) {
  extern __shared__ float smem[];
  // query blocks of one tile are neighbours in launch order, so they find
  // the tile in L2
  const int qblk = blockIdx.x % nqb;
  const int tile = blockIdx.x / nqb;
  const int q0 = qblk * QB;
  const int nq = min(QB, b - q0);
  const int row0 = tile * TILE_N;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // [QB][d] query block, fp32, then [QB][TILE_N] tile scores
  const float* sq = qf ? qf + static_cast<size_t>(q0) * d : smem;
  float* sc = qf ? smem : smem + QB * d;

  if (!qf) {
    for (int i = threadIdx.x; i < nq * d; i += THREADS)
      smem[i] = dot::to_f32(q[static_cast<size_t>(q0) * d + i]);
  }
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
                         const float* qf, int n, int d, int b, int k,
                         int ntiles, float* fv, int* fr,
                         cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(QB) * ((qf ? 0 : d) + TILE_N) * sizeof(float);
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
      static_cast<const T*>(emb), active, static_cast<const T*>(q), qf, n, d,
      b, k, ntiles, nqb, fv, fr);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_qb(int qb, const void* emb, const uint8_t* active,
                      const void* q, const float* qf, int n, int d, int b,
                      int k, int ntiles, float* fv, int* fr,
                      cudaStream_t stream) {
  switch (qb) {
    case 1:
      return launch_tiles<T, VEC, 1>(emb, active, q, qf, n, d, b, k, ntiles, fv, fr, stream);
    case 4:
      return launch_tiles<T, VEC, 4>(emb, active, q, qf, n, d, b, k, ntiles, fv, fr, stream);
    case 16:
      return launch_tiles<T, VEC, 16>(emb, active, q, qf, n, d, b, k, ntiles, fv, fr, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// Pass 1 of "twopass" and "wide": each tile's k best (k <= TILE_N) into
// fv/fr ((b, ntiles, k)), the load width by dtype and alignment.
cudaError_t tiles_pass(int dtype, int qb, const void* emb, const void* active,
                       const void* q, const float* qf, int n, int d, int b,
                       int k, int ntiles, float* fv, int* fr,
                       cudaStream_t s) {
  const auto* act = static_cast<const uint8_t*>(active);
  // 16-byte loads need rows that start on 16-byte boundaries
  const bool aligned = reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  if (dtype == 0) {
    return (aligned && d % 4 == 0)
        ? launch_qb<float, 4>(qb, emb, act, q, qf, n, d, b, k, ntiles, fv, fr, s)
        : launch_qb<float, 1>(qb, emb, act, q, qf, n, d, b, k, ntiles, fv, fr, s);
  }
  return (aligned && d % 8 == 0)
      ? launch_qb<__nv_bfloat16, 8>(qb, emb, act, q, qf, n, d, b, k, ntiles, fv, fr, s)
      : launch_qb<__nv_bfloat16, 1>(qb, emb, act, q, qf, n, d, b, k, ntiles, fv, fr, s);
}

// "fused": one CTA per (tile of tile_n rows, block of QB queries), the
// merge in the last CTA of each query block (see the head of this file).
// QG: the query block is read in place from device memory; a template
// argument, so that the shared-memory instance keeps its shared loads.
template <int QB, int FROWS, bool QG>
__global__ void __launch_bounds__(THREADS)
ann_fused(const float* __restrict__ emb, const uint8_t* __restrict__ active,
          const float* __restrict__ q, int n, int d, int b, int k,
          int tile_n, int ntiles, int nqb, int qvec, float* fv, int* fr,
          int* tickets, float* vals, int* rows, int tbuf_at) {
  using S = dot::Scatter<FROWS, QB>;
  extern __shared__ __align__(16) float smem[];
  // [QB][d] query block (unless QG), [QB][tile_n] tile scores, [tile_n]
  // active bytes
  float* sc = QG ? smem : smem + QB * d;
  auto* sa = reinterpret_cast<uint8_t*>(sc + QB * tile_n);
  const int qblk = blockIdx.x % nqb;
  const int tile = blockIdx.x / nqb;
  const int q0 = qblk * QB;
  const int nq = min(QB, b - q0);
  const int row0 = tile * tile_n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const float* qb = q + static_cast<size_t>(q0) * d;
  const float* sq = QG ? qb : smem;
  if constexpr (!QG) {
    if (qvec) {
      for (int i = threadIdx.x; i < nq * d / 4; i += THREADS)
        reinterpret_cast<float4*>(smem)[i] = __ldg(reinterpret_cast<const float4*>(qb) + i);
    } else {
      for (int i = threadIdx.x; i < nq * d; i += THREADS) smem[i] = qb[i];
    }
  }
  for (int i = threadIdx.x; i < tile_n; i += THREADS)
    sa[i] = row0 + i < n ? active[row0 + i] : 0;
  __syncthreads();

  for (int r0 = warp * FROWS; r0 < tile_n; r0 += WARPS * FROWS) {
    const unsigned live =
        __ballot_sync(dot::FULL, lane < FROWS && sa[r0 + min(lane, FROWS - 1)]);
    if (live == 0) {  // no active row: skip the payload
      for (int i = lane; i < nq * FROWS; i += 32)
        sc[(i / FROWS) * tile_n + r0 + i % FROWS] = sel::NEG;
      continue;
    }
    const float* erow[FROWS];
#pragma unroll
    for (int r = 0; r < FROWS; ++r) {
      const int row = min(row0 + r0 + r, n - 1);  // rows >= n are inactive
      erow[r] = emb + static_cast<size_t>(row) * d;
    }
    float out[S::E];
    dot::warp_dot_scatter<FROWS, QB>(erow, sq, d, nq, lane, out);
    if (lane % S::SHARE == 0) {
#pragma unroll
      for (int i = 0; i < S::E; ++i) {
        const int e = S::first(lane) + i;
        const int r = e / QB, j = e % QB;
        if (j < nq)
          sc[j * tile_n + r0 + r] = (live >> r & 1u) ? out[i] : sel::NEG;
      }
    }
  }
  __syncthreads();
  sel::finish_tile<THREADS>(sc, tile_n, nq, q0, k, tile, ntiles, row0, fv, fr,
                            tickets + qblk, vals, rows,
                            reinterpret_cast<unsigned char*>(smem),
                            reinterpret_cast<unsigned char*>(smem) + tbuf_at);
}

template <int QB, int FROWS>
cudaError_t launch_fused(const float* emb, const uint8_t* active,
                         const float* q, int n, int d, int b, int k,
                         int tile_n, int qvec, int qglobal, float* fv,
                         int* fr, int* tickets, float* vals, int* rows,
                         cudaStream_t stream) {
  // the tile's queries (unless read in place), scores and active bytes
  // (the last CTA's merge reuses them), then the tile's candidates
  // (kernels/ann_topk.py::fused_smem)
  const size_t tbuf_at = (std::max(
      static_cast<size_t>(QB) * ((qglobal ? 0 : d) + tile_n) * sizeof(float) +
          tile_n,
      sel::merge_smem<THREADS>()) + 15) / 16 * 16;
  const size_t smem = tbuf_at + sel::tile_smem<THREADS>();
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  auto kern = qglobal ? ann_fused<QB, FROWS, true> : ann_fused<QB, FROWS, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int nqb = (b + QB - 1) / QB;
  const int ntiles = (n + tile_n - 1) / tile_n;
  kern<<<ntiles * nqb, THREADS, smem, stream>>>(
      emb, active, q, n, d, b, k, tile_n, ntiles, nqb, qvec, fv, fr,
      tickets, vals, rows, static_cast<int>(tbuf_at));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Design "fused": fp32 emb on a 16-byte boundary, d % 4 == 0. tile_n: rows
// per CTA, a multiple of fused_rows(qb) in [k, 512]
// (kernels/ann_topk.py::tile_plan). qglobal: read the queries in place (q
// on a 16-byte boundary) instead of from shared memory.
// fv/fr: (b, ceil(n / tile_n), k) fp32/int32 finalist scratch; tickets:
// ceil(b / qb) int32, all 0, left 0. qb: queries per CTA, 1, 4 or 16.
// One launch; returns its cudaError_t.
int ann_topk_fused_launch(int qb, int tile_n, int qglobal, const void* emb,
                          const void* active, const void* q, int n, int d,
                          int b, int k, void* fv, void* fr,
                          void* tickets, void* vals, void* rows,
                          void* stream) {
  const int qvec = reinterpret_cast<uintptr_t>(q) % 16 == 0;
  if (n < 1 || d < 1 || b < 1 || k < 1 || k > K_MAX || d % 4 != 0 ||
      reinterpret_cast<uintptr_t>(emb) % 16 != 0 ||
      tile_n % fused_rows(qb) != 0 || tile_n < k || tile_n > TILE_N ||
      (qglobal && !qvec))
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* e = static_cast<const float*>(emb);
  const auto* act = static_cast<const uint8_t*>(active);
  const auto* qp = static_cast<const float*>(q);
  auto* pv = static_cast<float*>(fv);
  auto* pr = static_cast<int*>(fr);
  auto* pt = static_cast<int*>(tickets);
  auto* ov = static_cast<float*>(vals);
  auto* orow = static_cast<int*>(rows);
  switch (qb) {
    case 1:
      return launch_fused<1, fused_rows(1)>(e, act, qp, n, d, b, k, tile_n, qvec, qglobal, pv, pr, pt, ov, orow, s);
    case 4:
      return launch_fused<4, fused_rows(4)>(e, act, qp, n, d, b, k, tile_n, qvec, qglobal, pv, pr, pt, ov, orow, s);
    case 16:
      return launch_fused<16, fused_rows(16)>(e, act, qp, n, d, b, k, tile_n, qvec, qglobal, pv, pr, pt, ov, orow, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// Design "twopass": fv/fr: (b, ceil(n / 512), k) fp32/int32 finalist scratch.
// dtype: 0 = fp32, 1 = bf16. qb: queries per CTA, 1, 4 or 16. qf: null, or
// the queries as fp32 on a 16-byte boundary, read in place.
// Returns the cudaError_t of the launches.
int ann_topk_launch(int dtype, int qb, const void* emb, const void* active,
                    const void* q, const void* qf, int n, int d, int b, int k,
                    void* fv, void* fr, void* vals, void* rows, void* stream) {
  if (n < 1 || d < 1 || b < 1 || k < 1 || k > K_MAX || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int ntiles = (n + TILE_N - 1) / TILE_N;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* pv = static_cast<float*>(fv);
  auto* pr = static_cast<int*>(fr);
  const cudaError_t err =
      tiles_pass(dtype, qb, emb, active, q, static_cast<const float*>(qf), n,
                 d, b, k, ntiles, pv, pr, s);
  if (err != cudaSuccess) return err;
  // one CTA per query merges its ntiles*k finalists
  sel::merge_topk<THREADS><<<b, THREADS, 0, s>>>(pv, pr, ntiles * k, k,
                                                 static_cast<float*>(vals),
                                                 static_cast<int*>(rows));
  return cudaGetLastError();
}

// Design "wide", any k: pass 1 as "twopass" with lists of kt = min(k, 512),
// then the levels of kernels/ann_topk.py::merge_levels. fv/fr and gv/gr:
// fp32/int32 scratch of kernels/ann_topk.py::wide_scratch entries each;
// levels 0, 2, ... go to fv/fr, 1, 3, ... to gv/gr, the last to vals/rows.
// Returns the cudaError_t of the launches.
int ann_topk_wide_launch(int dtype, int qb, const void* emb,
                         const void* active, const void* q, const void* qf,
                         int n, int d, int b, int k, void* fv, void* fr,
                         void* gv, void* gr, void* vals, void* rows,
                         void* stream) {
  if (n < 1 || d < 1 || b < 1 || k < 1 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const int ntiles = (n + TILE_N - 1) / TILE_N;
  const int kt = std::min(k, TILE_N);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = tiles_pass(
      dtype, qb, emb, active, q, static_cast<const float*>(qf), n, d, b, kt,
      ntiles, static_cast<float*>(fv), static_cast<int*>(fr), s);
  if (err != cudaSuccess) return err;
  return sel::merge_lists<THREADS>(
      ntiles, kt, k, b, static_cast<float*>(fv), static_cast<int*>(fr),
      static_cast<float*>(gv), static_cast<int*>(gr),
      static_cast<float*>(vals), static_cast<int*>(rows), s);
}

const char* ann_topk_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
