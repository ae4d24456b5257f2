// attention.cuh — what the attention kernels (flash_attention.cu,
// decode_attention.cu) share: fp32 conversion of the input types, the
// reference's masked score, and the staging of a block of rows (queries,
// keys, values) in shared memory as fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1.0e30f;   // the reference's masked score
constexpr size_t SMEM_MAX = 232448;  // H100: 227 KB of dynamic shared memory

// -inf: the score of a tile slot that is not a key at all (p = 0)
__device__ __forceinline__ float neg_inf() { return -__int_as_float(0x7f800000); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// VEC consecutive elements of a row as fp32: one 16-byte load (4 fp32 or
// 8 bf16) when VEC > 1, else one element.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&o)[VEC]) {
  if constexpr (VEC == 1) {
    o[0] = to_f32(p[0]);
  } else if constexpr (sizeof(T) == 4) {
    static_assert(VEC == 4, "fp32 vectors are 4 wide");
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    static_assert(VEC == 8, "bf16 vectors are 8 wide");
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
}

// One batch of a thread's chunks (see stage_rows): BATCH loads issued
// before their stores.
template <typename T, int DH, int ROWS, int THREADS, int VEC, int DST_STRIDE,
          int BATCH>
__device__ __forceinline__ void stage_batch(const T* __restrict__ base,
                                            long long stride, int j0,
                                            int jend, float* dst, int c0) {
  constexpr int CPR = DH / VEC;                      // chunks per row
  constexpr int CHUNKS = ROWS * CPR;
  float x[BATCH][VEC];
#pragma unroll
  for (int u = 0; u < BATCH; ++u) {
    const int c = (c0 + u) * THREADS + threadIdx.x;
    const int j = j0 + c / CPR;
    if (c < CHUNKS && j < jend) {
      load_vec<T, VEC>(base + j * stride + (c % CPR) * VEC, x[u]);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) x[u][i] = 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < BATCH; ++u) {
    const int c = (c0 + u) * THREADS + threadIdx.x;
    if (c < CHUNKS) {
      float* o = dst + (c / CPR) * DST_STRIDE + (c % CPR) * VEC;
#pragma unroll
      for (int i = 0; i < VEC; ++i) o[i] = x[u][i];
    }
  }
}

// Rows [j0, j0 + ROWS) of one head (row j at base + j * stride, DH
// contiguous elements) into shared memory as fp32, row r at dst + r *
// DST_STRIDE. Rows at or past `jend` are zero, so a p of 0 times them stays
// 0. Staging is latency-bound, not bandwidth-bound, when each thread waits
// for one element at a time; so with VEC > 1 (16-byte loads; the caller
// checks the alignment) each thread keeps 4 loads in flight, in batches
// unrolled whole. The element-wise fallback (VEC = 1) keeps its batches in
// a loop, which holds its registers down.
template <typename T, int DH, int ROWS, int THREADS, int VEC, int DST_STRIDE>
__device__ __forceinline__ void stage_rows(const T* __restrict__ base,
                                           long long stride, int j0,
                                           int jend, float* dst) {
  constexpr int CHUNKS = ROWS * (DH / VEC);
  constexpr int PER = (CHUNKS + THREADS - 1) / THREADS;  // chunks a thread
  constexpr int BATCH = PER < 4 ? PER : 4;
  static_assert(DH % VEC == 0, "row width is a whole number of chunks");
  static_assert(PER % BATCH == 0, "whole batches");
  if constexpr (VEC == 1) {
#pragma unroll 1
    for (int c0 = 0; c0 < PER; c0 += BATCH)
      stage_batch<T, DH, ROWS, THREADS, VEC, DST_STRIDE, BATCH>(
          base, stride, j0, jend, dst, c0);
  } else {
#pragma unroll
    for (int c0 = 0; c0 < PER; c0 += BATCH)
      stage_batch<T, DH, ROWS, THREADS, VEC, DST_STRIDE, BATCH>(
          base, stride, j0, jend, dst, c0);
  }
}

}  // namespace attn
