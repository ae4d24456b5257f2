// ann_topk_ivf.cu — clustered (IVF) stage 1 on Hopper (sm_90a): each query
// scans only the cluster buckets it was routed to, unsharded or with the
// buckets partitioned into shards of contiguous cluster ranges.
//
// Replaces repro/kernels/ann_topk_ivf.py::_ivf_kernel (fp32, the hot tier)
// and ::_ivf_quant_kernel (int8, the warm tier's coarse scan), the Pallas
// TPU kernels whose scalar-prefetch index maps DMA bucket sel[b, j] for
// grid step (b, j); and repro/kernels/ann_topk_sharded.py's
// ann_topk_ivf_sharded / ann_topk_ivf_quant_sharded, which run those
// kernels once per shard. Routing (kernels/ops.py::_route) and the merges
// of the finalists (ops.py::_merge_probes, ::_merge_shards) stay outside,
// as in the reference.
//
// Contract (the reference's), for B queries and nprobe probes each:
//   sel, enabled (B, nprobe) int32; buckets (C, cap, D) fp32 with q (B, D)
//   fp32, or int8 with bucket_scale (C, cap) fp32, qq (B, D) int8 and
//   q_scales (B,) fp32; bucket_valid (C, cap) bytes
//   -> vals, slots (B, nprobe, k), k <= 64.
//   Probe (b, j) scores every slot of bucket sel[b, j] against query b;
//   invalid slots and disabled probes score NEG = -3e38; its k finalists
//   are in (value desc, slot asc) order. Where fewer than k slots remain,
//   or the probe is disabled, pass p writes NEG and slot p, as a stable
//   sort of the NEG-padded scores would. A sel outside [0, C) scores as a
//   disabled probe (no read outside the buckets).
//   fp32 scores use ann_topk.cu's summation order (dot.cuh), so a row
//   scores bitwise the same in the brute and the routed scan, and
//   duplicates in one bucket tie bitwise; int8 scores are exact int32 dots
//   rescaled as float(i32) * slot_scale, then * q_scale, each product
//   rounded to nearest, as the reference and the numpy path do.
// Sharded (the *_sharded_launch entry points), with S shards where shard s
// owns the clusters [bounds[s], bounds[s+1]) of the same (C, cap, D)
// layout, bucket_rows (C, cap) int32 the global row of each slot:
//   -> vals, rows (S, B, nprobe, k). Entry (s, b, j) holds probe (b, j)'s
//   finalists if shard s owns sel[b, j], with the slot's global row where
//   the value is a real score (> NEG / 2) and -1 elsewhere; every other
//   entry is NEG / -1. A repeated cut point is an empty shard. This is
//   the reference's per-shard loop (mask the probes to the shard's range,
//   scan its slice, map slots to global rows) in one launch.
//
// What bounds it on an H100: a scan must read, for each distinct probed
// bucket, its cap-byte valid mask and its valid slots, D*4 (fp32) or D + 4
// (int8 and the slot's scale) bytes each, and do 2*D operations per valid
// slot of each enabled probe. At B = 16 and nprobe = 64 over C = 512
// buckets the union is most of the buckets, so the bytes bound it (fp32:
// 3.35 TB/s against 67 TFLOP/s of CUDA-core rate; int8: against 1979 TOP/s).
// This kernel reads every slot of a probed bucket, valid or not, once per
// query that probes it. Sharded, the owner alone reads the bucket, so the
// bytes are the unsharded scan's plus the S-fold stack of finalists.
//
// The simple design (speed is later work): one kernel for both payload
// types over a scorer policy; one CTA per (query b, probe j), reading
// sel[b, j] and enabled[b, j] itself (the TPU's scalar prefetch) and
// offsetting into the bucket. The query sits in shared memory; warps
// score ROWS slots at once (dot.cuh) into a cap-long score array in
// dynamic shared memory (cap <= 32768 at D = 768: 227 KB), then the whole
// block runs k argmax passes (select.cuh, ties to the lowest slot; buckets
// hold their rows in ascending order, so that is the lowest row). CTAs of
// queries that probe the same bucket find it in L2 only by chance. The
// sharded CTA also reads the (S+1,) bounds to find the owner of its bucket
// and writes the whole (S, k) column of the stack: its finalists, with
// their rows read from bucket_rows, at the owner, NEG / -1 at the others.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "dot.cuh"
#include "select.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;          // slots a warp scores at once
constexpr int K_MAX = 64;
constexpr size_t SMEM_MAX = 232448;  // H100: 227 KB of dynamic shared memory

// shared memory layout: cap fp32 scores, then the query on a 16-byte
// boundary
__host__ __device__ inline size_t query_offset(int cap) {
  return (static_cast<size_t>(cap) * sizeof(float) + 15) & ~static_cast<size_t>(15);
}

// a disabled (or out-of-range) probe: NEG and slot p at pass p
__device__ __forceinline__ void write_disabled(float* ov, int* oi, int k) {
  for (int p = threadIdx.x; p < k; p += THREADS) {
    ov[p] = sel::NEG;
    oi[p] = p;
  }
}

// How ROWS slots of a bucket score against the query: fp32 rows in
// dot.cuh's summation order; int8 rows as exact int32 dots, rescaled by the
// slot's scale, then the query's (dot::rescale).
template <typename E, int VEC>
struct Scorer {
  using Acc = float;
  static __device__ __forceinline__ void rows(const E* const (&erow)[ROWS],
                                              const E* sq, int d, int lane,
                                              Acc (&acc)[ROWS][1]) {
    dot::warp_dot<E, VEC, ROWS, 1>(erow, sq, d, 1, lane, acc);
  }
  static __device__ __forceinline__ float finish(Acc acc, const float*,
                                                 float) {
    return acc;
  }
};

template <int VEC>
struct Scorer<int8_t, VEC> {
  using Acc = int;
  static __device__ __forceinline__ void rows(
      const int8_t* const (&erow)[ROWS], const int8_t* sq, int d, int lane,
      Acc (&acc)[ROWS][1]) {
    dot::warp_dot_i8<VEC, ROWS, 1>(erow, sq, d, 1, lane, acc);
  }
  static __device__ __forceinline__ float finish(Acc acc,
                                                 const float* slot_scale,
                                                 float q_scale) {
    return dot::rescale(acc, *slot_scale, q_scale);
  }
};

// The whole block scores bucket c against query bq and writes its k
// finalists (value desc, slot asc) to ov/oi. E = float (q, buckets fp32;
// qs and bscale unused) or int8_t (qq, buckets_q int8 with q_scales and
// bucket_scale).
template <typename E, int VEC>
__device__ __forceinline__ void scan_bucket(
    int c, int bq, const E* __restrict__ q, const float* __restrict__ qs,
    const E* __restrict__ buckets, const float* __restrict__ bscale,
    const uint8_t* __restrict__ valid, int cap, int d, int k,
    unsigned char* smem, float* red_v, int* red_i, float* ov, int* oi) {
  using S = Scorer<E, VEC>;
  constexpr bool kScaled = std::is_same_v<E, int8_t>;
  float* sc = reinterpret_cast<float*>(smem);              // [cap]
  E* sq = reinterpret_cast<E*>(smem + query_offset(cap));  // [d]
  const size_t base = static_cast<size_t>(c) * cap;
  const E* bucket = buckets + base * d;
  const uint8_t* bv = valid + base;
  const float* bs = kScaled ? bscale + base : nullptr;
  const float q_scale = kScaled ? qs[bq] : 1.f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int i = threadIdx.x; i < d; i += THREADS)
    sq[i] = q[static_cast<size_t>(bq) * d + i];
  __syncthreads();

  for (int r0 = warp * ROWS; r0 < cap; r0 += WARPS * ROWS) {
    const E* erow[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      erow[r] = bucket + static_cast<size_t>(min(r0 + r, cap - 1)) * d;
    typename S::Acc acc[ROWS][1];
    S::rows(erow, sq, d, lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int slot = r0 + r;
        if (slot < cap)
          sc[slot] = bv[slot] != 0
                         ? S::finish(acc[r][0], kScaled ? bs + slot : nullptr,
                                     q_scale)
                         : sel::NEG;
      }
    }
  }
  __syncthreads();
  sel::block_topk<THREADS>(sc, cap, k, ov, oi, red_v, red_i);
}

// One CTA per (query b, probe j).
template <typename E, int VEC>
__global__ void __launch_bounds__(THREADS)
ivf_topk(const int* __restrict__ sel_, const int* __restrict__ en,
         const E* __restrict__ q, const float* __restrict__ qs,
         const E* __restrict__ buckets, const float* __restrict__ bscale,
         const uint8_t* __restrict__ valid, int nprobe, int c_count, int cap,
         int d, int k, float* __restrict__ vals, int* __restrict__ slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];
  const int bj = blockIdx.x;
  float* ov = vals + static_cast<size_t>(bj) * k;
  int* oi = slots + static_cast<size_t>(bj) * k;
  const int c = sel_[bj];
  if (en[bj] == 0 || c < 0 || c >= c_count) {
    write_disabled(ov, oi, k);
    return;
  }
  scan_bucket<E, VEC>(c, bj / nprobe, q, qs, buckets, bscale, valid, cap, d,
                      k, smem, red_v, red_i, ov, oi);
}

__device__ __forceinline__ bool owns(const int* bounds, int s, int c) {
  return bounds[s] <= c && c < bounds[s + 1];
}

// One CTA per (query b, probe j), writing the (S, k) column of the stacks.
template <typename E, int VEC>
__global__ void __launch_bounds__(THREADS)
ivf_topk_sharded(const int* __restrict__ sel_, const int* __restrict__ en,
                 const E* __restrict__ q, const float* __restrict__ qs,
                 const E* __restrict__ buckets,
                 const float* __restrict__ bscale,
                 const uint8_t* __restrict__ valid,
                 const int* __restrict__ bucket_rows,
                 const int* __restrict__ bounds, int n_shards, int nprobe,
                 int c_count, int cap, int d, int k,
                 float* __restrict__ vals, int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];
  __shared__ float top_v[K_MAX];
  __shared__ int top_i[K_MAX];
  const int bj = blockIdx.x;
  const int c = sel_[bj];
  bool scan = en[bj] != 0 && c >= 0 && c < c_count;
  if (scan) {  // the same for every thread of the block
    bool owned = false;
    for (int s = 0; s < n_shards; ++s) owned |= owns(bounds, s, c);
    scan = owned;
  }
  if (scan) {
    scan_bucket<E, VEC>(c, bj / nprobe, q, qs, buckets, bscale, valid, cap,
                        d, k, smem, red_v, red_i, top_v, top_i);
    __syncthreads();
  }
  const size_t bn = static_cast<size_t>(gridDim.x);
  for (int i = threadIdx.x; i < n_shards * k; i += THREADS) {
    const int s = i / k;
    const int p = i - s * k;
    float v = sel::NEG;
    int r = -1;
    if (scan && owns(bounds, s, c)) {
      v = top_v[p];
      if (v > sel::NEG / 2)
        r = bucket_rows[static_cast<size_t>(c) * cap + top_i[p]];
    }
    const size_t o = (static_cast<size_t>(s) * bn + bj) * k + p;
    vals[o] = v;
    rows[o] = r;
  }
}

// Every entry point's arguments; bounds == nullptr is the unsharded scan.
struct Args {
  const int* sel;
  const int* en;
  const void* q;
  const float* qs;
  const void* buckets;
  const float* bscale;
  const uint8_t* valid;
  const int* bucket_rows;
  const int* bounds;
  int n_shards, b, nprobe, c, cap, d, k;
  float* vals;
  int* idx;  // slots, or the sharded scan's global rows
};

// kernels above 48 KB of dynamic shared memory must ask for it
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename E, int VEC>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const size_t smem =
      query_offset(a.cap) + static_cast<size_t>(a.d) * sizeof(E);
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  const auto* q = static_cast<const E*>(a.q);
  const auto* bk = static_cast<const E*>(a.buckets);
  const int grid = a.b * a.nprobe;
  cudaError_t err;
  if (a.bounds == nullptr) {
    auto kern = ivf_topk<E, VEC>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, s>>>(a.sel, a.en, q, a.qs, bk, a.bscale,
                                     a.valid, a.nprobe, a.c, a.cap, a.d, a.k,
                                     a.vals, a.idx);
  } else {
    auto kern = ivf_topk_sharded<E, VEC>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, s>>>(a.sel, a.en, q, a.qs, bk, a.bscale,
                                     a.valid, a.bucket_rows, a.bounds,
                                     a.n_shards, a.nprobe, a.c, a.cap, a.d,
                                     a.k, a.vals, a.idx);
  }
  return cudaGetLastError();
}

bool bad_shape(const Args& a) {
  return a.b < 1 || a.nprobe < 1 || a.c < 1 || a.cap < 1 || a.d < 1 ||
         a.k < 1 || a.k > K_MAX || a.n_shards < 1;
}

int launch_f32(const Args& a, void* stream) {
  if (bad_shape(a)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  // the same load width as ann_topk.cu picks for an fp32 matrix, so the
  // summation order matches
  const bool aligned = reinterpret_cast<uintptr_t>(a.buckets) % 16 == 0;
  return (aligned && a.d % 4 == 0) ? launch<float, 4>(a, s)
                                   : launch<float, 1>(a, s);
}

int launch_i8(const Args& a, void* stream) {
  if (bad_shape(a)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto addr = reinterpret_cast<uintptr_t>(a.buckets);
  if (addr % 16 == 0 && a.d % 16 == 0) return launch<int8_t, 16>(a, s);
  if (addr % 4 == 0 && a.d % 4 == 0) return launch<int8_t, 4>(a, s);
  return launch<int8_t, 1>(a, s);
}

}  // namespace

extern "C" {

// vals/slots: (b, nprobe, k) fp32/int32. Each returns the cudaError_t of
// the launch.
int ann_topk_ivf_launch(const void* sel_, const void* enabled, const void* q,
                        const void* buckets, const void* bucket_valid, int b,
                        int nprobe, int c, int cap, int d, int k, void* vals,
                        void* slots, void* stream) {
  return launch_f32(
      {static_cast<const int*>(sel_), static_cast<const int*>(enabled), q,
       nullptr, buckets, nullptr, static_cast<const uint8_t*>(bucket_valid),
       nullptr, nullptr, 1, b, nprobe, c, cap, d, k,
       static_cast<float*>(vals), static_cast<int*>(slots)},
      stream);
}

int ann_topk_ivf_quant_launch(const void* sel_, const void* enabled,
                              const void* qq, const void* q_scales,
                              const void* buckets_q, const void* bucket_scale,
                              const void* bucket_valid, int b, int nprobe,
                              int c, int cap, int d, int k, void* vals,
                              void* slots, void* stream) {
  return launch_i8(
      {static_cast<const int*>(sel_), static_cast<const int*>(enabled), qq,
       static_cast<const float*>(q_scales), buckets_q,
       static_cast<const float*>(bucket_scale),
       static_cast<const uint8_t*>(bucket_valid), nullptr, nullptr, 1, b,
       nprobe, c, cap, d, k, static_cast<float*>(vals),
       static_cast<int*>(slots)},
      stream);
}

// bucket_rows (c, cap) int32, bounds (s + 1,) int32; vals/rows:
// (s, b, nprobe, k) fp32/int32.
int ann_topk_ivf_sharded_launch(const void* sel_, const void* enabled,
                                const void* q, const void* buckets,
                                const void* bucket_valid,
                                const void* bucket_rows, const void* bounds,
                                int s, int b, int nprobe, int c, int cap,
                                int d, int k, void* vals, void* rows,
                                void* stream) {
  return launch_f32(
      {static_cast<const int*>(sel_), static_cast<const int*>(enabled), q,
       nullptr, buckets, nullptr, static_cast<const uint8_t*>(bucket_valid),
       static_cast<const int*>(bucket_rows), static_cast<const int*>(bounds),
       s, b, nprobe, c, cap, d, k, static_cast<float*>(vals),
       static_cast<int*>(rows)},
      stream);
}

int ann_topk_ivf_quant_sharded_launch(
    const void* sel_, const void* enabled, const void* qq,
    const void* q_scales, const void* buckets_q, const void* bucket_scale,
    const void* bucket_valid, const void* bucket_rows, const void* bounds,
    int s, int b, int nprobe, int c, int cap, int d, int k, void* vals,
    void* rows, void* stream) {
  return launch_i8(
      {static_cast<const int*>(sel_), static_cast<const int*>(enabled), qq,
       static_cast<const float*>(q_scales), buckets_q,
       static_cast<const float*>(bucket_scale),
       static_cast<const uint8_t*>(bucket_valid),
       static_cast<const int*>(bucket_rows), static_cast<const int*>(bounds),
       s, b, nprobe, c, cap, d, k, static_cast<float*>(vals),
       static_cast<int*>(rows)},
      stream);
}

const char* ann_topk_ivf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
