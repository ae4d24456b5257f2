// dot.cuh — the one summation order of the port's stage-1 kernels.
//
// A warp scores ROWS rows against QB queries at once. Lanes stream the
// rows' VEC-wide chunks (chunk c = lane, lane + 32, ...; 16-byte loads when
// the host picks VEC so), accumulate in chunk order and finish with a fixed
// xor butterfly that leaves the same sum in every lane. Every row goes
// through the same code whatever its position, its ROWS group or the
// kernel that scores it, so a row scores bitwise the same in the brute scan
// (ann_topk.cu) and the routed scan (ann_topk_ivf.cu), and exact-duplicate
// rows tie bitwise. fp32 rows sum with fmaf (no tensor cores: TF32 would
// break row parity with the host path); int8 rows sum with __dp4a in int32,
// exact in any order (|sum| <= D * 127^2 < 2^31).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace dot {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// VEC consecutive elements of one row, as fp32.
template <typename T, int VEC>
struct Loader;

template <>
struct Loader<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

template <>
struct Loader<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};

template <typename T>
struct Loader<T, 1> {
  static __device__ __forceinline__ void load(const T* p, float (&o)[1]) {
    o[0] = to_f32(p[0]);
  }
};

// VEC fp32 query values from shared memory (16-byte loads when VEC allows)
template <int VEC>
__device__ __forceinline__ void load_q(const float* p, float (&o)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      o[4 * i] = t.x; o[4 * i + 1] = t.y; o[4 * i + 2] = t.z; o[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int v = 0; v < VEC; ++v) o[v] = p[v];
  }
}

// fp32 scores of ROWS rows (erow, each d elements of T) against the first
// nq of QB queries (sq, fp32, QB x d in shared memory). The host picks VEC
// so that it divides d and the rows start on 16-byte boundaries.
template <typename T, int VEC, int ROWS, int QB>
__device__ __forceinline__ void warp_dot(const T* const (&erow)[ROWS],
                                         const float* sq, int d, int nq,
                                         int lane, float (&acc)[ROWS][QB]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < QB; ++j) acc[r][j] = 0.f;
  const int nvec = d / VEC;
  for (int c = lane; c < nvec; c += 32) {
    float e[ROWS][VEC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) Loader<T, VEC>::load(erow[r] + c * VEC, e[r]);
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      if (j < nq) {
        float qv[VEC];
        load_q<VEC>(sq + j * d + c * VEC, qv);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
#pragma unroll
          for (int v = 0; v < VEC; ++v)
            acc[r][j] = fmaf(e[r][v], qv[v], acc[r][j]);
      }
    }
  }
  // xor butterfly: a fixed tree, and every lane ends with the same sum
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < QB; ++j)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][j] += __shfl_xor_sync(FULL, acc[r][j], off);
}

// VEC int8 values of one row as int32 words: four packed bytes a word for
// VEC = 16 (one 16-byte load) and VEC = 4, one sign-extended byte for VEC = 1
template <int VEC>
struct Int8Words {
  static constexpr int W = VEC >= 4 ? VEC / 4 : 1;
  static __device__ __forceinline__ void load(const int8_t* p, int (&w)[W]) {
    if constexpr (VEC == 16) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(p));
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (VEC == 4) {
      w[0] = __ldg(reinterpret_cast<const int*>(p));
    } else {
      w[0] = p[0];
    }
  }
  static __device__ __forceinline__ void load_shared(const int8_t* p,
                                                     int (&w)[W]) {
    if constexpr (VEC == 16) {
      const int4 v = *reinterpret_cast<const int4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (VEC == 4) {
      w[0] = *reinterpret_cast<const int*>(p);
    } else {
      w[0] = p[0];
    }
  }
  static __device__ __forceinline__ int dot(const int (&a)[W], const int (&b)[W],
                                            int acc) {
    if constexpr (VEC >= 4) {
#pragma unroll
      for (int i = 0; i < W; ++i) acc = __dp4a(a[i], b[i], acc);
      return acc;
    } else {
      return acc + a[0] * b[0];
    }
  }
};

// exact int32 scores of ROWS int8 rows against the first nq of QB int8
// queries (sq, QB x d in shared memory); VEC bytes per load as above
template <int VEC, int ROWS, int QB>
__device__ __forceinline__ void warp_dot_i8(const int8_t* const (&erow)[ROWS],
                                            const int8_t* sq, int d, int nq,
                                            int lane, int (&acc)[ROWS][QB]) {
  using L = Int8Words<VEC>;
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < QB; ++j) acc[r][j] = 0;
  const int nvec = d / VEC;
  for (int c = lane; c < nvec; c += 32) {
    int e[ROWS][L::W];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) L::load(erow[r] + c * VEC, e[r]);
#pragma unroll
    for (int j = 0; j < QB; ++j) {
      if (j < nq) {
        int qv[L::W];
        L::load_shared(sq + j * d + c * VEC, qv);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r][j] = L::dot(e[r], qv, acc[r][j]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int j = 0; j < QB; ++j)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][j] += __shfl_xor_sync(FULL, acc[r][j], off);
}

// the reference's int8 rescale: float(i32) * row_scale, then * query_scale,
// each rounded to nearest (no fused multiply)
__device__ __forceinline__ float rescale(int acc, float row_scale,
                                         float q_scale) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), row_scale), q_scale);
}

}  // namespace dot
