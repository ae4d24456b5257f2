// ann_topk_ivf.cu — clustered (IVF) stage 1 on Hopper (sm_90a): each query
// scans only the cluster buckets it was routed to.
//
// Replaces repro/kernels/ann_topk_ivf.py::_ivf_kernel (fp32, the hot tier)
// and ::_ivf_quant_kernel (int8, the warm tier's coarse scan), the Pallas
// TPU kernels whose scalar-prefetch index maps DMA bucket sel[b, j] for
// grid step (b, j). Routing (kernels/ops.py::_route) and the merge of the
// per-probe finalists (ops.py::_merge_probes) stay outside, as in the
// reference.
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
//
// What bounds it on an H100: a scan must read, for each distinct probed
// bucket, its cap-byte valid mask and its valid slots, D*4 (fp32) or D + 4
// (int8 and the slot's scale) bytes each, and do 2*D operations per valid
// slot of each enabled probe. At B = 16 and nprobe = 64 over C = 512
// buckets the union is most of the buckets, so the bytes bound it (fp32:
// 3.35 TB/s against 67 TFLOP/s of CUDA-core rate; int8: against 1979 TOP/s).
// This kernel reads every slot of a probed bucket, valid or not, once per
// query that probes it.
//
// The simple design (speed is later work): one kernel for both payload
// types over a scorer policy; one CTA per (query b, probe j), reading
// sel[b, j] and enabled[b, j] itself (the TPU's scalar prefetch) and
// offsetting into the bucket. The query sits in shared memory; warps
// score ROWS slots at once (dot.cuh) into a cap-long score array in
// dynamic shared memory (cap <= 32768 at D = 768: 227 KB), then the whole
// block runs k argmax passes (select.cuh, ties to the lowest slot; buckets
// hold their rows in ascending order, so that is the lowest row). CTAs of
// queries that probe the same bucket find it in L2 only by chance.

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

// One CTA per (query b, probe j). E = float (q, buckets fp32; qs and bscale
// unused) or int8_t (qq, buckets_q int8 with q_scales and bucket_scale).
template <typename E, int VEC>
__global__ void __launch_bounds__(THREADS)
ivf_topk(const int* __restrict__ sel_, const int* __restrict__ en,
         const E* __restrict__ q, const float* __restrict__ qs,
         const E* __restrict__ buckets, const float* __restrict__ bscale,
         const uint8_t* __restrict__ valid, int nprobe, int c_count, int cap,
         int d, int k, float* __restrict__ vals, int* __restrict__ slots) {
  using S = Scorer<E, VEC>;
  constexpr bool kScaled = std::is_same_v<E, int8_t>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];
  float* sc = reinterpret_cast<float*>(smem);              // [cap]
  E* sq = reinterpret_cast<E*>(smem + query_offset(cap));  // [d]
  const int bj = blockIdx.x;
  const int bq = bj / nprobe;
  float* ov = vals + static_cast<size_t>(bj) * k;
  int* oi = slots + static_cast<size_t>(bj) * k;
  const int c = sel_[bj];
  if (en[bj] == 0 || c < 0 || c >= c_count) {
    write_disabled(ov, oi, k);
    return;
  }
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

template <typename E, int VEC>
cudaError_t launch(const int* sel_, const int* en, const E* q,
                   const float* qs, const E* buckets, const float* bscale,
                   const uint8_t* valid, int b, int nprobe, int c, int cap,
                   int d, int k, float* vals, int* slots, cudaStream_t s) {
  const size_t smem = query_offset(cap) + static_cast<size_t>(d) * sizeof(E);
  auto kern = ivf_topk<E, VEC>;
  if (smem > SMEM_MAX) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<b * nprobe, THREADS, smem, s>>>(sel_, en, q, qs, buckets, bscale,
                                         valid, nprobe, c, cap, d, k, vals,
                                         slots);
  return cudaGetLastError();
}

bool bad_shape(int b, int nprobe, int c, int cap, int d, int k) {
  return b < 1 || nprobe < 1 || c < 1 || cap < 1 || d < 1 || k < 1 ||
         k > K_MAX;
}

}  // namespace

extern "C" {

// vals/slots: (b, nprobe, k) fp32/int32. Returns the cudaError_t of the
// launch.
int ann_topk_ivf_launch(const void* sel_, const void* enabled, const void* q,
                        const void* buckets, const void* bucket_valid, int b,
                        int nprobe, int c, int cap, int d, int k, void* vals,
                        void* slots, void* stream) {
  if (bad_shape(b, nprobe, c, cap, d, k)) return cudaErrorInvalidValue;
  const auto* se = static_cast<const int*>(sel_);
  const auto* en = static_cast<const int*>(enabled);
  const auto* qv = static_cast<const float*>(q);
  const auto* bk = static_cast<const float*>(buckets);
  const auto* bv = static_cast<const uint8_t*>(bucket_valid);
  auto* ov = static_cast<float*>(vals);
  auto* oi = static_cast<int*>(slots);
  const auto s = static_cast<cudaStream_t>(stream);
  // the same load width as ann_topk.cu picks for an fp32 matrix, so the
  // summation order matches
  const bool aligned = reinterpret_cast<uintptr_t>(buckets) % 16 == 0;
  return (aligned && d % 4 == 0)
      ? launch<float, 4>(se, en, qv, nullptr, bk, nullptr, bv, b, nprobe, c,
                         cap, d, k, ov, oi, s)
      : launch<float, 1>(se, en, qv, nullptr, bk, nullptr, bv, b, nprobe, c,
                         cap, d, k, ov, oi, s);
}

int ann_topk_ivf_quant_launch(const void* sel_, const void* enabled,
                              const void* qq, const void* q_scales,
                              const void* buckets_q, const void* bucket_scale,
                              const void* bucket_valid, int b, int nprobe,
                              int c, int cap, int d, int k, void* vals,
                              void* slots, void* stream) {
  if (bad_shape(b, nprobe, c, cap, d, k)) return cudaErrorInvalidValue;
  const auto* se = static_cast<const int*>(sel_);
  const auto* en = static_cast<const int*>(enabled);
  const auto* q = static_cast<const int8_t*>(qq);
  const auto* qs = static_cast<const float*>(q_scales);
  const auto* bk = static_cast<const int8_t*>(buckets_q);
  const auto* bs = static_cast<const float*>(bucket_scale);
  const auto* bv = static_cast<const uint8_t*>(bucket_valid);
  auto* ov = static_cast<float*>(vals);
  auto* oi = static_cast<int*>(slots);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto addr = reinterpret_cast<uintptr_t>(buckets_q);
  if (addr % 16 == 0 && d % 16 == 0)
    return launch<int8_t, 16>(se, en, q, qs, bk, bs, bv, b, nprobe, c, cap,
                              d, k, ov, oi, s);
  if (addr % 4 == 0 && d % 4 == 0)
    return launch<int8_t, 4>(se, en, q, qs, bk, bs, bv, b, nprobe, c, cap,
                             d, k, ov, oi, s);
  return launch<int8_t, 1>(se, en, q, qs, bk, bs, bv, b, nprobe, c, cap, d,
                           k, ov, oi, s);
}

const char* ann_topk_ivf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
