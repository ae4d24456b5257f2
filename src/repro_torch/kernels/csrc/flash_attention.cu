// flash_attention.cu — GQA attention forward with an online softmax on
// Hopper (sm_90a): the prefill of the judge, the embedder and the agent.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel) with its public layout and contract:
//   q (B, Sq, KV, G, Dh), k/v (B, Sk, KV, Dh), fp32 or bf16, Dh in
//   {16, 32, 64, 128} -> o (B, Sq, KV, G, Dh) contiguous, in q's type.
//   Scores, running max m, denominator l and accumulator in fp32; masked
//   scores are -1e30 (causal kj <= qi; window kj > qi - window); the
//   output is acc / max(l, 1e-30).
//
// What bounds it on an H100: q, k, v read once and o written once (the
// bytes), against 4 * Dh operations per (query row, key) pair that the
// masks keep. The judge's micro-batch (8 x 128 tokens, KV 8, G 2, Dh 128,
// bf16) is bound by its 12.6 MB (3.8 us); an agent prefill of 4096 tokens
// by its operations.
//
// The simple design (wgmma, TMA and warp specialisation are later work):
//   one CTA of 128 threads per (batch, KV head, group member g, block of
//   BQ = 32 query rows). The reference flattens (B, KV, G) with moveaxis
//   copies and repeats K/V G times; here the CTA reads q through its batch
//   and sequence strides and its KV head kv = h / G in place. The TPU's
//   sequential k-block grid axis becomes a loop over BK = 64-key tiles,
//   each staged in shared memory as fp32 with 16-byte loads, several in
//   flight per thread (attention.cuh; element loads when a stride does not
//   keep rows 16-byte aligned). Thread (rg, cg)
//   of the 8 x 16 grid holds scores of rows 4rg..4rg+3 against keys
//   cg + 16j (j < 4), and the accumulator of the same rows at Dh columns
//   cg + 16c. Row max and row sum reduce over the 16 threads of a row
//   group with xor shuffles; p goes through shared memory to the P.V step.
//   Products are fp32 FMAs on the CUDA cores (no TF32: the fp32 check is
//   3e-5; bf16 is widened to fp32 on the way in).
//   Key tiles wholly above the diagonal or before the window are skipped
//   when Sq <= Sk: then every query row qi holds its own key kj = qi inside
//   the loop's range, so the online softmax would wash a skipped, fully
//   masked prefix out with alpha = exp(-1e30 - m) = 0 anyway. With
//   Sq > Sk a row may have no valid key at all (the reference then
//   averages every V), so no tile is skipped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "attention.cuh"

namespace {

constexpr int BQ = 32;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 8 row groups x 16 column groups
constexpr int RG = 4;         // query rows per thread
constexpr int CG = 4;         // keys per thread and tile

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (DH + 1) + BK * (DH + 1) + BK * DH + BQ * (BK + 1));
}

template <typename T, int DH, int VEC>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
          int kvh, int g, long long q_sb, long long q_ss, long long k_sb,
          long long k_ss, long long v_sb, long long v_ss, float scale,
          int causal, int window, int skip) {
  extern __shared__ float smem[];
  float* qs = smem;                     // [BQ][DH + 1] query block
  float* ks = qs + BQ * (DH + 1);       // [BK][DH + 1] key tile
  float* vs = ks + BK * (DH + 1);       // [BK][DH] value tile
  float* ps = vs + BK * DH;             // [BQ][BK + 1] probabilities
  constexpr int DC = DH / 16;           // Dh columns per thread

  const int nqb = (sq + BQ - 1) / BQ;
  const int qb = blockIdx.x % nqb;
  const int head = blockIdx.x / nqb;    // ((b * kvh) + kv) * g + gi
  const int gi = head % g;
  const int kv = (head / g) % kvh;
  const int b = head / (g * kvh);
  const int q0 = qb * BQ;
  const int tid = threadIdx.x;
  const int rg = tid / 16;              // rows RG*rg .. RG*rg + 3
  const int cg = tid % 16;              // keys cg + 16j, Dh columns cg + 16c

  const T* qbase = q + b * q_sb + static_cast<long long>(kv * g + gi) * DH;
  const T* kbase = k + b * k_sb + static_cast<long long>(kv) * DH;
  const T* vbase = v + b * v_sb + static_cast<long long>(kv) * DH;

  attn::stage_rows<T, DH, BQ, THREADS, VEC, DH + 1>(qbase, q_ss, q0, sq, qs);

  float acc[RG][DC];
  float m[RG], l[RG];
#pragma unroll
  for (int i = 0; i < RG; ++i) {
    m[i] = attn::NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int kbeg = 0, kend = sk;
  if (skip) {
    if (causal) kend = min(sk, q0 + BQ);
    if (window > 0) kbeg = max(0, q0 - window + 1);
    kbeg = (kbeg / BK) * BK;
  }

  for (int k0 = kbeg; k0 < kend; k0 += BK) {
    __syncthreads();  // the last tile's readers are done (and q is staged)
    attn::stage_rows<T, DH, BK, THREADS, VEC, DH + 1>(kbase, k_ss, k0, sk, ks);
    attn::stage_rows<T, DH, BK, THREADS, VEC, DH>(vbase, v_ss, k0, sk, vs);
    __syncthreads();

    float s[RG][CG];
#pragma unroll
    for (int i = 0; i < RG; ++i)
#pragma unroll
      for (int j = 0; j < CG; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DH; ++d) {
      float qv[RG], kx[CG];
#pragma unroll
      for (int i = 0; i < RG; ++i) qv[i] = qs[(RG * rg + i) * (DH + 1) + d];
#pragma unroll
      for (int j = 0; j < CG; ++j) kx[j] = ks[(cg + 16 * j) * (DH + 1) + d];
#pragma unroll
      for (int i = 0; i < RG; ++i)
#pragma unroll
        for (int j = 0; j < CG; ++j) s[i][j] = fmaf(qv[i], kx[j], s[i][j]);
    }

    // mask, then the online softmax of each row over this tile
#pragma unroll
    for (int i = 0; i < RG; ++i) {
      const int qi = q0 + RG * rg + i;
      float mx = attn::neg_inf();
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        const int kj = k0 + cg + 16 * j;
        float x = attn::neg_inf();  // past Sk: not a key at all, p = 0
        if (kj < sk) {
          bool ok = !causal || kj <= qi;
          if (window > 0) ok = ok && kj > qi - window;
          x = ok ? s[i][j] * scale : attn::NEG;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(attn::FULL, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CG; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(RG * rg + i) * (BK + 1) + cg + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(attn::FULL, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P . V
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float vx[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vx[c] = vs[j * DH + cg + 16 * c];
#pragma unroll
      for (int i = 0; i < RG; ++i) {
        const float p = ps[(RG * rg + i) * (BK + 1) + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vx[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RG; ++i) {
    const int qi = q0 + RG * rg + i;
    if (qi >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + ((static_cast<long long>(b) * sq + qi) * kvh + kv) *
                      static_cast<long long>(g) * DH +
              static_cast<long long>(gi) * DH;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      orow[cg + 16 * c] = attn::from_f32<T>(acc[i][c] / den);
  }
}

template <typename T, int DH, int VEC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int sq, int sk, int kvh, int g, long long q_sb,
                   long long q_ss, long long k_sb, long long k_ss,
                   long long v_sb, long long v_ss, float scale, int causal,
                   int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static_assert(smem <= attn::SMEM_MAX, "tiles exceed shared memory");
  auto kern = flash_fwd<T, DH, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks =
      static_cast<long long>(b) * kvh * g * ((sq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int skip = sq <= sk;
  kern<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, kvh, g, q_sb,
      q_ss, k_sb, k_ss, v_sb, v_ss, scale, causal, window, skip);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      void* o, int b, int sq, int sk, int kvh, int g,
                      long long q_sb, long long q_ss, long long k_sb,
                      long long k_ss, long long v_sb, long long v_ss,
                      float scale, int causal, int window,
                      cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16, VEC>(q, k, v, o, b, sq, sk, kvh, g, q_sb, q_ss,
                                k_sb, k_ss, v_sb, v_ss, scale, causal, window,
                                stream);
    case 32:
      return launch<T, 32, VEC>(q, k, v, o, b, sq, sk, kvh, g, q_sb, q_ss,
                                k_sb, k_ss, v_sb, v_ss, scale, causal, window,
                                stream);
    case 64:
      return launch<T, 64, VEC>(q, k, v, o, b, sq, sk, kvh, g, q_sb, q_ss,
                                k_sb, k_ss, v_sb, v_ss, scale, causal, window,
                                stream);
    case 128:
      return launch<T, 128, VEC>(q, k, v, o, b, sq, sk, kvh, g, q_sb, q_ss,
                                 k_sb, k_ss, v_sb, v_ss, scale, causal,
                                 window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// 16-byte loads need every row of q, k and v to start on a 16-byte
// boundary: aligned base pointers and batch/sequence strides.
bool rows_aligned(size_t elt, const void* q, const void* k, const void* v,
                  long long q_sb, long long q_ss, long long k_sb,
                  long long k_ss, long long v_sb, long long v_ss) {
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (long long st : {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss})
    if ((st * static_cast<long long>(elt)) % 16 != 0) return false;
  return true;
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16. Strides in elements; the head and Dh dims of
// q, k and v are dense. window <= 0: no window. Returns the cudaError_t
// of the launch.
int flash_attention_launch(int dtype, int dh, const void* q, const void* k,
                           const void* v, void* o, int b, int sq, int sk,
                           int kvh, int g, long long q_sb, long long q_ss,
                           long long k_sb, long long k_ss, long long v_sb,
                           long long v_ss, float scale, int causal,
                           int window, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || g < 1)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (rows_aligned(4, q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss))
      return launch_dh<float, 4>(dh, q, k, v, o, b, sq, sk, kvh, g, q_sb,
                                 q_ss, k_sb, k_ss, v_sb, v_ss, scale, causal,
                                 window, s);
    return launch_dh<float, 1>(dh, q, k, v, o, b, sq, sk, kvh, g, q_sb, q_ss,
                               k_sb, k_ss, v_sb, v_ss, scale, causal, window,
                               s);
  }
  if (dtype == 1) {
    if (rows_aligned(2, q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss))
      return launch_dh<__nv_bfloat16, 8>(dh, q, k, v, o, b, sq, sk, kvh, g,
                                         q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                         scale, causal, window, s);
    return launch_dh<__nv_bfloat16, 1>(dh, q, k, v, o, b, sq, sk, kvh, g,
                                       q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                       scale, causal, window, s);
  }
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
