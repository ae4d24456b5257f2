// flash_attention.cu — GQA attention forward with an online softmax on
// Hopper (sm_90a): the prefill of the judge, the embedder and the agent.
//
// Replaces repro/kernels/flash_attention.py::_flash_kernel (the Pallas TPU
// kernel) with its public layout and contract:
//   q (B, Sq, KV, G, Dh), k/v (B, Sk, KV, Dh), fp32 or bf16, any Dh from 1
//   to 1024 (attn::DH_MAX) and any G -> o (B, Sq, KV, G, Dh) contiguous, in
//   q's type. Dh 192 is MLA's prefill (the 128 + 64 nope and rope dims, v
//   zero-padded to 192), Dh 256 gemma3's heads, 24 the shrunk DeepSeek
//   configs' 16 + 8, 80 and 96 phi-2's and Phi-3-mini's.
//   Scores, running max m, denominator l and accumulator in fp32; masked
//   scores are -1e30 (causal kj <= qi; window kj > qi - window); the
//   output is acc / max(l, 1e-30).
//   Given a non-null lse pointer, each query row's log-sum-exp
//   m + log(max(l, 1e-30)) in natural-log units, (B, KV, G, Sq) fp32: the
//   residual of the reference's nn/flash.py::_flash_fwd that the training
//   backward (repro_torch/nn/flash.py) consumes. A row with no valid key
//   keeps m = -1e30, as the reference's does. A null pointer writes none.
//
// What bounds it on an H100: q, k, v read once and o written once (the
// bytes), against 4 * Dh operations per (query row, key) pair that the
// masks keep. The judge's micro-batch (8 x 128 tokens, KV 8, G 2, Dh 128,
// bf16) is bound by its 12.6 MB (3.8 us); an agent prefill of 4096 tokens
// by its operations (0.139 ms at the bf16 tensor-core peak).
//
// Three designs; the wrapper (kernels/flash_attention.py::pick_design)
// chooses, and each has its own entry point:
//
// flash_fwd_tc — bf16 whose rows start on 16-byte boundaries (every call
//   of the LM path), Dh a multiple of 8 up to 256. One instance a width of
//   the wrapper's 12 (tc_width, passed in as w): a head without its own
//   runs on the next (Dh 24 on 32), its rows zero-padded in shared memory by cp_rows, so that the
//   padding adds exact zeros to every score and fills accumulator columns
//   that are never written out. One CTA of 4 warps per (batch, KV head, group member,
//   block of BQ = 64 query rows), each warp owning 16 rows; the grid runs
//   the last query blocks (the longest under a causal mask) first. The CTA
//   reads its KV head in place through strides (no moveaxis, no G-fold
//   repeat of K/V). K and V stream in 64-key tiles kept in bf16 in a
//   2-stage shared-memory ring filled by 16-byte cp.async: tiles 0 and 1
//   load together, then each tile's copy overlaps the previous tile's
//   compute; rows are padded by 16 bytes so that ldmatrix is free of bank
//   conflicts; one barrier per tile releases the ring slot. Two CTAs share
//   an SM (87 KB of shared memory and about 250 registers a thread each at
//   Dh 128: 8 warps per SM). Q's fragments go into registers once
//   (ldmatrix). Wide heads (Dh 192, 256) would not fit that: at Dh 256
//   the fp32 accumulator alone is 128 registers a thread, Q's fragments 64
//   more, and 64-key tiles 165 KB of shared memory. So there the tiles
//   are 32 keys (101 KB at Dh 256, two CTAs still share an SM) and Q's
//   fragments are read from shared memory at every k-step (one ldmatrix
//   per 16 columns and tile). S = Q K^T runs on
//   mma.sync m16n8k16 (bf16 in, fp32 accumulate) with K through ldmatrix;
//   mask and online softmax work on the accumulator fragments in registers
//   (row max and sum over the quad with xor shuffles 1 and 2); P is
//   rounded to bf16 in registers (as the Pallas kernel rounds p to v's
//   type) and the two m16n8 score tiles of 16 keys are the m16k16 A
//   fragment of acc += P V, with V through ldmatrix.trans: P never touches
//   shared memory. The output goes out through the warp's own Q rows in
//   shared memory as 16-byte rows. The grid and tiles do not depend on B,
//   and each output row depends only on its own CTA, so the judge's scores
//   are the same in any micro-batch (DESIGN.md section 8).
//
// flash_fwd — fp32 (whose 3e-5 check rules out TF32 and bf16 products),
//   and bf16 rows off a 16-byte boundary (no 16-byte copies). One CTA of
//   128 threads per (batch, KV head, group member g, block of BQ = 32 query
//   rows), reading q through its batch and sequence strides and its KV
//   head kv = h / G in place. The TPU's sequential k-block grid axis
//   becomes a loop over BK = 64-key tiles, each staged in shared memory as
//   fp32 with 16-byte loads, several in flight per thread (attention.cuh;
//   element loads when a stride does not keep rows 16-byte aligned).
//   Wide heads take 173 KB of shared memory at Dh 256 (one CTA per SM).
//   Thread (rg, cg) of the 8 x 16 grid holds scores of rows 4rg..4rg+3
//   against keys cg + 16j (j < 4), and the accumulator of the same rows at
//   Dh columns cg + 16c. Row max and row sum reduce over the 16 threads of
//   a row group with xor shuffles; p goes through shared memory to the P.V
//   step. Products are fp32 FMAs on the CUDA cores. One instance a width of
//   {16, 32, 64, 128, 192, 256}.
//
// flash_fwd_any — the same for every other width (fp32, rows off a 16-byte
//   boundary, bf16 with Dh % 8 != 0, and above 256): Dh is a runtime
//   argument, so the accumulator cannot live in registers sized by it. A
//   CTA of 128 threads per (batch, KV head, group member, BQ query rows)
//   keeps the query block, a K and a V tile, P and the fp32 accumulator in
//   shared memory (attn::tile_any), the tiles (BQ, BK) the largest of
//   64 x 64 down to 16 x 8 that fit shared memory at ctas_per_sm_at(Dh)
//   CTAs an SM (16 x 8 at Dh 1024: 197 KB). Threads take (row, key) pairs
//   for the scores, a warp a row for the softmax, and (row, column) entries
//   for acc += P V. Right before fast: it serves widths no model of the
//   repo has.
//
// All three skip key tiles wholly above the diagonal or before the window when
// Sq <= Sk: then every query row qi holds its own key kj = qi inside the
// loop's range, so the online softmax would wash a skipped, fully masked
// prefix out with alpha = exp(-1e30 - m) = 0 anyway. With Sq > Sk a row may
// have no valid key at all (the reference then averages every V), so no
// tile is skipped.

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
          const T* __restrict__ v, T* __restrict__ o,
          float* __restrict__ lse, int sq, int sk, int kvh, int g,
          long long q_sb, long long q_ss, long long k_sb, long long k_ss,
          long long v_sb, long long v_ss, float scale, int causal,
          int window, int skip) {
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
    if (lse != nullptr && cg == 0)
      lse[static_cast<long long>(head) * sq + qi] = m[i] + logf(den);
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
                   float* lse, int b, int sq, int sk, int kvh, int g,
                   long long q_sb, long long q_ss, long long k_sb,
                   long long k_ss, long long v_sb, long long v_ss,
                   float scale, int causal, int window, cudaStream_t stream) {
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
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, kvh, g,
      q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, causal, window, skip);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_dh(int dh, const void* q, const void* k, const void* v,
                      void* o, float* lse, int b, int sq, int sk, int kvh,
                      int g, long long q_sb, long long q_ss, long long k_sb,
                      long long k_ss, long long v_sb, long long v_ss,
                      float scale, int causal, int window,
                      cudaStream_t stream) {
  switch (dh) {
    case 16:
      return launch<T, 16, VEC>(q, k, v, o, lse, b, sq, sk, kvh, g,
                                q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                                causal, window, stream);
    case 32:
      return launch<T, 32, VEC>(q, k, v, o, lse, b, sq, sk, kvh, g,
                                q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                                causal, window, stream);
    case 64:
      return launch<T, 64, VEC>(q, k, v, o, lse, b, sq, sk, kvh, g,
                                q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                                causal, window, stream);
    case 128:
      return launch<T, 128, VEC>(q, k, v, o, lse, b, sq, sk, kvh, g,
                                 q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                                 causal, window, stream);
    case 192:
      return launch<T, 192, VEC>(q, k, v, o, lse, b, sq, sk, kvh, g,
                                 q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                                 causal, window, stream);
    case 256:
      return launch<T, 256, VEC>(q, k, v, o, lse, b, sq, sk, kvh, g,
                                 q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                                 causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ any-width design

// (BQ, BK) from the largest down: the first whose shared memory fits
// ctas_per_sm_at(Dh) CTAs an SM
constexpr int ANY_TILES[][2] = {{64, 64}, {32, 64}, {32, 32},
                                {16, 32}, {16, 16}, {16, 8}};

size_t any_smem_bytes(int bq, int bk, int dh) {
  const size_t q = bq, k = bk, d = dh;
  return sizeof(float) * (q * d + k * attn::ld_any(dh) + k * d +
                          q * (k + 1) + q * d + 3 * q);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_any(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              float* __restrict__ lse, int sq, int sk, int kvh, int g,
              int dh, int bq, int bk, long long q_sb, long long q_ss,
              long long k_sb, long long k_ss, long long v_sb, long long v_ss,
              float scale, int causal, int window, int skip) {
  extern __shared__ float smem[];
  float* qs = smem;                        // [bq][dh] query block
  float* ks = qs + bq * dh;                // [bk][ld_any] key tile
  float* vs = ks + bk * attn::ld_any(dh);  // [bk][dh] value tile
  float* ps = vs + bk * dh;                // [bq][bk + 1] scores, then p
  float* acc = ps + bq * (bk + 1);         // [bq][dh] accumulator
  float* ms = acc + bq * dh;               // [bq] running max
  float* ls = ms + bq;                     // [bq] running denominator
  float* as = ls + bq;                     // [bq] this tile's rescale

  const int nqb = (sq + bq - 1) / bq;
  const int qb = blockIdx.x % nqb;
  const int head = blockIdx.x / nqb;       // ((b * kvh) + kv) * g + gi
  const int gi = head % g;
  const int kv = (head / g) % kvh;
  const int b = head / (g * kvh);
  const int q0 = qb * bq;
  const int tid = threadIdx.x;
  const T* qbase = q + b * q_sb + static_cast<long long>(kv * g + gi) * dh;
  const T* kbase = k + b * k_sb + static_cast<long long>(kv) * dh;
  const T* vbase = v + b * v_sb + static_cast<long long>(kv) * dh;

  attn::stage_rows_any<T, VEC, THREADS>(qbase, q_ss, q0, sq, bq, dh, qs, dh);
  for (int e = tid; e < bq * dh; e += THREADS) acc[e] = 0.f;
  for (int r = tid; r < bq; r += THREADS) {
    ms[r] = attn::NEG;
    ls[r] = 0.f;
  }

  int kbeg = 0, kend = sk;
  if (skip) {
    if (causal) kend = min(sk, q0 + bq);
    if (window > 0) kbeg = max(0, q0 - window + 1);
    kbeg = (kbeg / bk) * bk;
  }
  for (int k0 = kbeg; k0 < kend; k0 += bk) {
    __syncthreads();  // the last tile's readers are done (and q is staged)
    attn::stage_rows_any<T, VEC, THREADS>(kbase, k_ss, k0, sk, bk, dh, ks,
                                          attn::ld_any(dh));
    attn::stage_rows_any<T, VEC, THREADS>(vbase, v_ss, k0, sk, bk, dh, vs, dh);
    __syncthreads();
    attn::tile_any<THREADS>(
        qs, ks, vs, ps, acc, ms, ls, as, bq, bk, dh,
        [&](int r, int j, float x) {
          const int kj = k0 + j, qi = q0 + r;
          if (kj >= sk) return attn::neg_inf();  // not a key at all, p = 0
          bool ok = !causal || kj <= qi;
          if (window > 0) ok = ok && kj > qi - window;
          return ok ? x * scale : attn::NEG;
        });
  }
  __syncthreads();
  for (int e = tid; e < bq * dh; e += THREADS) {
    const int r = e / dh, d = e - r * dh;
    const int qi = q0 + r;
    if (qi >= sq) continue;
    const float den = fmaxf(ls[r], 1e-30f);
    if (lse != nullptr && d == 0)
      lse[static_cast<long long>(head) * sq + qi] = ms[r] + logf(den);
    o[((static_cast<long long>(b) * sq + qi) * kvh + kv) *
          static_cast<long long>(g) * dh +
      static_cast<long long>(gi) * dh + d] = attn::from_f32<T>(acc[e] / den);
  }
}

template <typename T, int VEC>
cudaError_t launch_any(int dh, const void* q, const void* k, const void* v,
                       void* o, float* lse, int b, int sq, int sk, int kvh,
                       int g, long long q_sb, long long q_ss, long long k_sb,
                       long long k_ss, long long v_sb, long long v_ss,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  int bq = 0, bk = 0;
  for (const auto& t : ANY_TILES)
    if (any_smem_bytes(t[0], t[1], dh) * attn::ctas_per_sm_at(dh) <=
        attn::SMEM_MAX) {
      bq = t[0];
      bk = t[1];
      break;
    }
  if (bq == 0) return cudaErrorInvalidValue;
  const size_t smem = any_smem_bytes(bq, bk, dh);
  auto kern = flash_fwd_any<T, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks =
      static_cast<long long>(b) * kvh * g * ((sq + bq - 1) / bq);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int skip = sq <= sk;
  kern<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, sk, kvh, g, dh,
      bq, bk, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale, causal, window,
      skip);
  return cudaGetLastError();
}

// ------------------------------------------------ tensor-core design

namespace tc {

constexpr int BQ = 64;        // query rows per CTA, 16 per warp
constexpr int THREADS = 128;  // 4 warps
constexpr int STAGES = 2;     // K/V ring depth

// keys per tile: 64, and 32 for wide heads, whose Q block and ring then
// take 101 KB at Dh 256 (not 165 KB), so that two CTAs still share an SM
// and a thread holds 16 score registers beside its 128 of accumulator
template <int DH>
__host__ __device__ constexpr int bk() {
  return attn::wide_head<DH>() ? 32 : 64;
}

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(attn::bf16) * attn::ld_bf16<DH>() *
         (BQ + STAGES * 2 * bk<DH>());
}

// PAD: a head narrower than DH (or at a width without a model's own
// instance) whose width dh_in is read at run time; without it dh = DH, as
// in the instances of {16, 32, 64, 128, 192, 256}, which keep their code.
template <int DH, bool PAD>
__global__ void __launch_bounds__(THREADS, 2)
flash_fwd_tc(const attn::bf16* __restrict__ q,
             const attn::bf16* __restrict__ k,
             const attn::bf16* __restrict__ v, attn::bf16* __restrict__ o,
             float* __restrict__ lse, int sq, int sk, int kvh, int g,
             int heads, int dh_in, long long q_sb, long long q_ss, long long k_sb,
             long long k_ss, long long v_sb, long long v_ss,
             float scale_log2, int causal, int window, int skip) {
  using attn::bf16;
  constexpr int LD = attn::ld_bf16<DH>();
  constexpr int NT = DH / 8;       // accumulator tiles of 8 columns
  constexpr int BK = bk<DH>();
  constexpr bool QREG = !attn::wide_head<DH>();  // Q's fragments in registers
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // [BQ][LD]
  bf16* ring = qs + BQ * LD;                    // [STAGES][K, V][BK][LD]

  const int nqb = (sq + BQ - 1) / BQ;
  const int qb = nqb - 1 - static_cast<int>(blockIdx.x) / heads;
  const int head = blockIdx.x % heads;  // ((b * kvh) + kv) * g + gi
  const int gi = head % g;
  const int kv = (head / g) % kvh;
  const int b = head / (g * kvh);
  const int q0 = qb * BQ;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int row0 = q0 + warp * 16 + lane / 4;  // this thread's rows: row0,
  const int row1 = row0 + 8;                   // row1
  const int col = 2 * (lane % 4);              // and columns col, col + 1
  const int dh = PAD ? dh_in : DH;
  const int cpr = dh / 8;  // the head's 16-byte chunks (DH / 8 padded)
  const bf16* qbase = q + b * q_sb + static_cast<long long>(kv * g + gi) * dh;
  const bf16* kbase = k + b * k_sb + static_cast<long long>(kv) * dh;
  const bf16* vbase = v + b * v_sb + static_cast<long long>(kv) * dh;

  int kbeg = 0, kend = sk;
  if (skip) {
    if (causal) kend = min(sk, q0 + BQ);
    if (window > 0) kbeg = max(0, q0 - window + 1);
    kbeg = (kbeg / BK) * BK;
  }
  const int ntiles = (kend - kbeg + BK - 1) / BK;
  auto load_tile = [&](int t) {
    bf16* kd = ring + (t % STAGES) * 2 * BK * LD;
    const int k0 = kbeg + t * BK;
    attn::cp_rows<DH, BK, THREADS>(kd, kbase, k_ss, k0, sk, tid, cpr);
    attn::cp_rows<DH, BK, THREADS>(kd + BK * LD, vbase, v_ss, k0, sk, tid,
                                   cpr);
  };
  // q and tile 0, then tile 1: both stages fill at once
  attn::cp_rows<DH, BQ, THREADS>(qs, qbase, q_ss, q0, sq, tid, cpr);
  load_tile(0);
  attn::cp_async_commit();
  if (ntiles > 1) load_tile(1);
  attn::cp_async_commit();

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {attn::NEG, attn::NEG}, l[2] = {0.f, 0.f};
  bf16* qw = qs + warp * 16 * LD;  // this warp's query rows
  unsigned qf[QREG ? DH / 16 : 1][4];

  for (int t = 0; t < ntiles; ++t) {
    if (t == 0)
      attn::cp_async_wait<1>();  // q and tile 0 landed (tile 1 may not) ...
    else
      attn::cp_async_wait<0>();  // tile t landed ...
    __syncthreads();  // ... for every thread; and all are done with t - 1
    if constexpr (QREG) {
      if (t == 0) attn::load_q_frags<DH>(qf, qw, lane);
    }
    if (t > 0 && t + 1 < ntiles)
      load_tile(t + 1);  // into the slot tile t - 1 left
    attn::cp_async_commit();
    const bf16* ks = ring + (t % STAGES) * 2 * BK * LD;
    const int k0 = kbeg + t * BK;

    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    if constexpr (QREG)
      attn::qk_tile<DH, BK / 16>(s, qf, ks, lane);
    else
      attn::qk_tile_smem<DH, BK / 16>(s, qw, ks, lane);

    // scale (into the log2 domain) and mask; only tiles on an edge test
    const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > q0) ||
                      (window > 0 && k0 <= q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int kj = k0 + j * 8 + col + (e & 1);
          const int qi = e < 2 ? row0 : row1;
          bool ok = !causal || kj <= qi;
          if (window > 0) ok = ok && kj > qi - window;
          x = kj >= sk ? attn::neg_inf() : ok ? x : attn::NEG;
        }
        s[j][e] = x;
      }
    attn::softmax_tile<BK / 8, DH>(s, m, l, acc);
    attn::pv_tile<DH, BK / 16>(acc, s, ks + BK * LD, lane);
  }

  // o = acc / l in bf16, through this warp's own rows of qs (only it read
  // them: into qf at tile 0, or at every tile for wide heads), then out in
  // 16-byte rows (the head's cpr chunks of each)
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(attn::quad_sum(l[r]), 1e-30f);
    const int qi = r ? row1 : row0;
    if (lse != nullptr && lane % 4 == 0 && qi < sq)
      // m is in the log2 domain; a row with no valid key keeps -1e30
      lse[static_cast<long long>(head) * sq + qi] =
          (m[r] <= attn::NEG ? attn::NEG : m[r] * attn::LN2) + logf(den);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(qw + (lane / 4 + 8 * r) * LD +
                                         n * 8 + col) =
          __floats2bfloat162_rn(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
  }
  __syncwarp();
  constexpr int CPR = DH / 8;  // 16-byte chunks per shared-memory row
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, x = c % CPR;
    const int qi = q0 + warp * 16 + r;
    if (qi < sq && x < cpr)
      *reinterpret_cast<uint4*>(
          o + ((static_cast<long long>(b) * sq + qi) * kvh + kv) *
                  static_cast<long long>(g) * dh +
          static_cast<long long>(gi) * dh + x * 8) =
          *reinterpret_cast<const uint4*>(qw + r * LD + x * 8);
  }
}

// Dh dh on the instance of width DH (dh <= DH)
template <int DH, bool PAD>
cudaError_t launch(int dh, const void* q, const void* k, const void* v,
                   void* o, float* lse, int b, int sq, int sk, int kvh, int g,
                   long long q_sb, long long q_ss, long long k_sb,
                   long long k_ss, long long v_sb, long long v_ss,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  static_assert(2 * smem <= attn::SMEM_MAX, "two CTAs per SM");
  auto kern = flash_fwd_tc<DH, PAD>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int heads = b * kvh * g;
  const long long blocks =
      static_cast<long long>(heads) * ((sq + BQ - 1) / BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int skip = sq <= sk;
  kern<<<static_cast<unsigned>(blocks), THREADS, smem, stream>>>(
      static_cast<const attn::bf16*>(q), static_cast<const attn::bf16*>(k),
      static_cast<const attn::bf16*>(v), static_cast<attn::bf16*>(o), lse,
      sq, sk, kvh, g, heads, dh, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
      scale * attn::LOG2E, causal, window, skip);
  return cudaGetLastError();
}

// The instance of width W for Dh dh: the model width's own where dh is one
// (its code as it was before padded heads), else the padded one.
template <int W>
cudaError_t launch_w(int dh, const void* q, const void* k, const void* v,
                     void* o, float* lse, int b, int sq, int sk, int kvh,
                     int g, long long q_sb, long long q_ss, long long k_sb,
                     long long k_ss, long long v_sb, long long v_ss,
                     float scale, int causal, int window,
                     cudaStream_t stream) {
  constexpr bool OWN = W == 16 || W == 32 || W == 64 || W == 128 ||
                       W == 192 || W == 256;
  if constexpr (OWN)
    if (dh == W)
      return launch<W, false>(dh, q, k, v, o, lse, b, sq, sk, kvh, g, q_sb,
                              q_ss, k_sb, k_ss, v_sb, v_ss, scale, causal,
                              window, stream);
  return launch<W, true>(dh, q, k, v, o, lse, b, sq, sk, kvh, g, q_sb, q_ss,
                         k_sb, k_ss, v_sb, v_ss, scale, causal, window,
                         stream);
}

}  // namespace tc

// 16-byte loads need every row of every head of q, k and v to start on a
// 16-byte boundary: aligned base pointers, batch/sequence strides and head
// width (a head starts Dh elements after the last).
bool rows_aligned(size_t elt, int dh, const void* q, const void* k,
                  const void* v, long long q_sb, long long q_ss,
                  long long k_sb, long long k_ss, long long v_sb,
                  long long v_ss) {
  if ((static_cast<size_t>(dh) * elt) % 16 != 0) return false;
  for (const void* p : {q, k, v})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (long long st : {q_sb, q_ss, k_sb, k_ss, v_sb, v_ss})
    if ((st * static_cast<long long>(elt)) % 16 != 0) return false;
  return true;
}

}  // namespace

extern "C" {

// The CUDA-core design. dtype: 0 = fp32, 1 = bf16. Strides in elements
// (0 for a dim of size 1); the head and Dh dims of q, k and v are dense.
// window <= 0: no window. lse: null, or (B, KV, G, Sq) fp32 that receives
// each query row's log-sum-exp of its scaled, masked scores (the training
// backward's residual). Returns the cudaError_t of the launch.
int flash_attention_launch(int dtype, int dh, const void* q, const void* k,
                           const void* v, void* o, float* lse, int b, int sq,
                           int sk, int kvh, int g, long long q_sb,
                           long long q_ss, long long k_sb, long long k_ss,
                           long long v_sb, long long v_ss, float scale,
                           int causal, int window, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || g < 1)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (rows_aligned(4, dh, q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss))
      return launch_dh<float, 4>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                                 q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                                 causal, window, s);
    return launch_dh<float, 1>(dh, q, k, v, o, lse, b, sq, sk, kvh, g, q_sb,
                               q_ss, k_sb, k_ss, v_sb, v_ss, scale, causal,
                               window, s);
  }
  if (dtype == 1) {
    if (rows_aligned(2, dh, q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss))
      return launch_dh<__nv_bfloat16, 8>(dh, q, k, v, o, lse, b, sq, sk,
                                         kvh, g, q_sb, q_ss, k_sb, k_ss,
                                         v_sb, v_ss, scale, causal, window,
                                         s);
    return launch_dh<__nv_bfloat16, 1>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                                       q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                       scale, causal, window, s);
  }
  return cudaErrorInvalidValue;
}

// The tensor-core design: bf16 only, every row of q, k and v on a 16-byte
// boundary (the wrapper checks; a misaligned call is refused, never sent
// elsewhere), dh a multiple of 8 up to 256, run on the instance of width w
// (the wrapper's tc_width(dh): 16, 32, 48, 64, 80, 96, 112, 128, 160, 192,
// 224 or 256; w >= dh). Arguments as flash_attention_launch's, with w in
// place of dtype.
int flash_attention_tc_launch(int dh, int w, const void* q, const void* k,
                              const void* v, void* o, float* lse, int b,
                              int sq, int sk, int kvh, int g,
                              long long q_sb, long long q_ss, long long k_sb,
                              long long k_ss, long long v_sb, long long v_ss,
                              float scale, int causal, int window,
                              void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || g < 1 || dh < 8 ||
      dh % 8 != 0 || dh > w)
    return cudaErrorInvalidValue;
  if (!rows_aligned(2, dh, q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss))
    return cudaErrorMisalignedAddress;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (w) {
    case 16:
      return tc::launch_w<16>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                               causal, window, s);
    case 32:
      return tc::launch_w<32>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                               causal, window, s);
    case 48:
      return tc::launch_w<48>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                               causal, window, s);
    case 64:
      return tc::launch_w<64>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                               causal, window, s);
    case 80:
      return tc::launch_w<80>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                               causal, window, s);
    case 96:
      return tc::launch_w<96>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                               causal, window, s);
    case 112:
      return tc::launch_w<112>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                               causal, window, s);
    case 128:
      return tc::launch_w<128>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                               causal, window, s);
    case 160:
      return tc::launch_w<160>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                               causal, window, s);
    case 192:
      return tc::launch_w<192>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                               causal, window, s);
    case 224:
      return tc::launch_w<224>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                               causal, window, s);
    case 256:
      return tc::launch_w<256>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                               q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                               causal, window, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// The any-width CUDA-core design: fp32 (dtype 0) or bf16 (1), any dh from
// 1 to attn::DH_MAX. Arguments as flash_attention_launch's.
int flash_attention_any_launch(int dtype, int dh, const void* q,
                               const void* k, const void* v, void* o,
                               float* lse, int b, int sq, int sk, int kvh,
                               int g, long long q_sb, long long q_ss,
                               long long k_sb, long long k_ss, long long v_sb,
                               long long v_ss, float scale, int causal,
                               int window, void* stream) {
  if (b < 1 || sq < 1 || sk < 1 || kvh < 1 || g < 1 || dh < 1 ||
      dh > attn::DH_MAX)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (rows_aligned(4, dh, q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss))
      return launch_any<float, 4>(dh, q, k, v, o, lse, b, sq, sk, kvh, g,
                                  q_sb, q_ss, k_sb, k_ss, v_sb, v_ss, scale,
                                  causal, window, s);
    return launch_any<float, 1>(dh, q, k, v, o, lse, b, sq, sk, kvh, g, q_sb,
                                q_ss, k_sb, k_ss, v_sb, v_ss, scale, causal,
                                window, s);
  }
  if (dtype == 1) {
    if (rows_aligned(2, dh, q, k, v, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss))
      return launch_any<__nv_bfloat16, 8>(dh, q, k, v, o, lse, b, sq, sk,
                                          kvh, g, q_sb, q_ss, k_sb, k_ss,
                                          v_sb, v_ss, scale, causal, window,
                                          s);
    return launch_any<__nv_bfloat16, 1>(dh, q, k, v, o, lse, b, sq, sk, kvh,
                                        g, q_sb, q_ss, k_sb, k_ss, v_sb, v_ss,
                                        scale, causal, window, s);
  }
  return cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
