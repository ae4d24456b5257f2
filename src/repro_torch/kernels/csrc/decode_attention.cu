// decode_attention.cu — one new token per (batch, KV head) against a KV
// cache on Hopper (sm_90a): every decode step of the continuous batcher.
//
// Replaces repro/kernels/decode_attention.py::_decode_kernel (the Pallas
// TPU kernel) with its contract:
//   q (B, KV, G, Dh), caches (B, S, KV, Dh) contiguous, fp32 or bf16, Dh in
//   {16, 32, 64, 128}, G <= 16, a position pos -> o (B, KV, G, Dh) in q's
//   type. The G query rows of one KV head attend over cache rows 0..pos
//   (rows past pos are the reference's masked -1e30 scores, whose weights
//   exp(-1e30 - m) are exactly 0 next to any real score); scores, max,
//   denominator and accumulator in fp32; o = acc / max(l, 1e-30).
//
// What bounds it on an H100: the bytes of rows 0..pos of K and V (the
// Pallas kernel streams the whole cache; this one reads only those rows),
// about 20 us for one batch row of the agent (KV 4, Dh 128, bf16) at
// pos = 32767. Four KV heads are four CTAs: a single pass per (b, kv)
// would stream 67 MB through 4 of 132 SMs. So this kernel takes the
// split-S (flash-decoding) form at every length:
//   pass 1, decode_partial: one CTA of 128 threads per (b, kv, chunk of
//     cache rows); the host picks the chunk so that about two CTAs per SM
//     are in flight (one chunk when the cache is short, as at the
//     batcher's max_len of 128). The CTA stages 64-row K/V tiles in shared
//     memory as fp32 with 16-byte loads, several in flight per thread
//     (attention.cuh), scores (g, row) pairs with fp32 FMAs,
//     runs the online softmax per query row with one warp per row, and
//     accumulates P.V with a thread per (Dh column, query rows). It writes
//     its (m, l, acc) per query row to an fp32 scratch the caller owns.
//   pass 2, decode_combine: one CTA per (b, kv) rescales the chunks'
//     partials to their common max and divides (a single chunk passes
//     through with weight exp(0) = 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention.cuh"

namespace {

constexpr int BK = 64;        // cache rows per tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int G_MAX = 16;     // query rows per KV head

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (G_MAX * DH + BK * (DH + 1) + BK * DH + G_MAX * BK + 3 * G_MAX);
}

template <typename T, int DH, int VEC>
__global__ void __launch_bounds__(THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ kc,
               const T* __restrict__ vc, float* __restrict__ part,
               int s_cache, int kvh, int g, int rows, int chunk, int nsplit,
               float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [G_MAX][DH] query rows
  float* ks = qs + G_MAX * DH;          // [BK][DH + 1] key tile
  float* vs = ks + BK * (DH + 1);       // [BK][DH] value tile
  float* ss = vs + BK * DH;             // [G_MAX][BK] scores, then p
  float* ms = ss + G_MAX * BK;          // [G_MAX] running max
  float* ls = ms + G_MAX;               // [G_MAX] running denominator
  float* as = ls + G_MAX;               // [G_MAX] this tile's rescale
  constexpr int TPD = THREADS / DH;     // threads per Dh column
  constexpr int GR = G_MAX / TPD;       // query rows per thread in P.V

  const int split = blockIdx.x % nsplit;
  const int bh = blockIdx.x / nsplit;   // b * kvh + kv
  const int b = bh / kvh;
  const int kv = bh % kvh;
  const int j0 = split * chunk;
  const int j1 = min(rows, j0 + chunk);
  const int tid = threadIdx.x;
  const long long row_stride = static_cast<long long>(kvh) * DH;
  const long long head0 =
      static_cast<long long>(b) * s_cache * row_stride +
      static_cast<long long>(kv) * DH;
  const T* kbase = kc + head0;
  const T* vbase = vc + head0;
  const T* qbase = q + static_cast<long long>(bh) * g * DH;

  for (int i = tid; i < g * DH; i += THREADS) qs[i] = attn::to_f32(qbase[i]);
  if (tid < g) {
    ms[tid] = attn::NEG;
    ls[tid] = 0.f;
  }
  const int d = tid % DH;
  const int g0 = tid / DH;
  float acc[GR];
#pragma unroll
  for (int r = 0; r < GR; ++r) acc[r] = 0.f;

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
      for (int gi = tid / BK; gi < g; gi += THREADS / BK) {
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
      for (int gi = warp; gi < g; gi += WARPS) {
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

    // acc += P . V: thread (Dh column d, query rows g0 + TPD r)
#pragma unroll
    for (int r = 0; r < GR; ++r)
      if (g0 + TPD * r < g) acc[r] *= as[g0 + TPD * r];
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float vx = vs[j * DH + d];
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        const int gi = g0 + TPD * r;
        if (gi < g) acc[r] = fmaf(ss[gi * BK + j], vx, acc[r]);
      }
    }
  }

  // partial of this chunk, per query row: [m, l, acc[DH]]
  float* out = part + (static_cast<long long>(bh) * nsplit + split) * g *
                          (DH + 2);
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    const int gi = g0 + TPD * r;
    if (gi < g) out[gi * (DH + 2) + 2 + d] = acc[r];
  }
  if (tid < g) {
    out[tid * (DH + 2)] = ms[tid];
    out[tid * (DH + 2) + 1] = ls[tid];
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
decode_combine(const float* __restrict__ part, T* __restrict__ o, int g,
               int nsplit) {
  const int bh = blockIdx.x;
  const long long sstride = static_cast<long long>(g) * (DH + 2);
  for (int i = threadIdx.x; i < g * DH; i += THREADS) {
    const int gi = i / DH;
    const int d = i % DH;
    const float* p = part + static_cast<long long>(bh) * nsplit * sstride +
                     gi * (DH + 2);
    float mx = attn::NEG;
    for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, p[s * sstride]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const float w = expf(p[s * sstride] - mx);
      l = fmaf(p[s * sstride + 1], w, l);
      a = fmaf(p[s * sstride + 2 + d], w, a);
    }
    o[static_cast<long long>(bh) * g * DH + i] =
        attn::from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* part, int b, int s_cache, int kvh, int g, int rows,
                   int chunk, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static_assert(smem <= attn::SMEM_MAX, "tiles exceed shared memory");
  // contiguous caches: every row starts on a 16-byte boundary when the
  // base pointers do (DH * sizeof(T) is a multiple of 16)
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
  const long long blocks = static_cast<long long>(b) * kvh * nsplit;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto* pp = static_cast<float*>(part);
  kern<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), pp, s_cache, kvh, g, rows, chunk, nsplit,
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine<T, DH><<<b * kvh, THREADS, 0, stream>>>(
      pp, static_cast<T*>(o), g, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      void* o, void* part, int b, int s_cache, int kvh, int g,
                      int rows, int chunk, float scale, cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16>(q, k, v, o, part, b, s_cache, kvh, g, rows, chunk,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, part, b, s_cache, kvh, g, rows, chunk,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, part, b, s_cache, kvh, g, rows, chunk,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, part, b, s_cache, kvh, g, rows,
                            chunk, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. rows = min(pos, S - 1) + 1 cache rows are
// read, in chunks of `chunk` rows (a multiple of 64); part is fp32 scratch
// of b * kvh * ceil(rows / chunk) * g * (dh + 2) floats. Returns the
// cudaError_t of the launches.
int decode_attention_launch(int dtype, int dh, const void* q, const void* k,
                            const void* v, void* o, void* part, int b,
                            int s_cache, int kvh, int g, int rows, int chunk,
                            float scale, void* stream) {
  if (b < 1 || s_cache < 1 || kvh < 1 || g < 1 || g > G_MAX || rows < 1 ||
      rows > s_cache || chunk < 1 || chunk % BK != 0)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dh<float>(dh, q, k, v, o, part, b, s_cache, kvh, g, rows,
                            chunk, scale, s);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(dh, q, k, v, o, part, b, s_cache, kvh,
                                    g, rows, chunk, scale, s);
  return cudaErrorInvalidValue;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
