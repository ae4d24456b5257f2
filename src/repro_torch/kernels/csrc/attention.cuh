// attention.cuh — what the attention kernels (flash_attention.cu,
// decode_attention.cu) share. Three designs each:
//   * CUDA-core (fp32 and rows off a 16-byte boundary) at the head widths
//     of the models (Dh a template argument): fp32 conversion of the input
//     types and the staging of a block of rows (queries, keys, values) in
//     shared memory as fp32;
//   * CUDA-core at any width (Dh a runtime argument, 1..DH_MAX; tile_any):
//     the same staging, tiles sized at launch to fit shared memory, and the
//     accumulator in shared memory instead of registers;
//   * tensor-core (bf16 rows on 16-byte boundaries, Dh a multiple of 8 up
//     to 256): rows copied to shared memory in bf16 with cp.async, read into
//     mma fragments with ldmatrix, products with mma.sync m16n8k16 (bf16 in,
//     fp32 accumulate); a width without an instance runs on the next one
//     (the wrapper's flash_attention.tc_width picks it), its rows
//     zero-padded in shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace attn {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1.0e30f;   // the reference's masked score
constexpr size_t SMEM_MAX = 232448;  // H100: 227 KB of dynamic shared memory
// The widest head either kernel takes: the any-width design's smallest
// tiles (16 query rows and their fp32 accumulator, 8 keys and 8 values)
// hold 4 x (2 x 16 + 2 x 8) x Dh bytes, 196,608 at Dh 1024, of SMEM_MAX.
constexpr int DH_MAX = 1024;

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

// stage_rows at a runtime width: `rows` rows of `dh` elements (dh % VEC ==
// 0) into dst with row stride ld, zeros at or past `jend`; chunk c of the
// block to thread c % THREADS.
template <typename T, int VEC, int THREADS>
__device__ __forceinline__ void stage_rows_any(const T* __restrict__ base,
                                               long long stride, int j0,
                                               int jend, int rows, int dh,
                                               float* dst, int ld) {
  const int cpr = dh / VEC;
  const int chunks = rows * cpr;
#pragma unroll 4
  for (int c = threadIdx.x; c < chunks; c += THREADS) {
    const int r = c / cpr, x = c - r * cpr;
    float v[VEC];
    if (j0 + r < jend) {
      load_vec<T, VEC>(base + (j0 + r) * stride + x * VEC, v);
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = 0.f;
    }
    float* o = dst + r * ld + x * VEC;
#pragma unroll
    for (int i = 0; i < VEC; ++i) o[i] = v[i];
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
  // up to 4 in flight, in batches that divide PER (6 at Dh 192 in bf16)
  constexpr int BATCH = PER % 4 == 0 ? 4 : PER % 3 == 0 ? 3
                        : PER % 2 == 0 ? 2 : 1;
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

// ------------------------------------------- the any-width CUDA-core design

// Shared-memory row stride of an fp32 key tile at width dh: odd, so that the
// 32 keys a warp scores at once sit in 32 distinct banks.
__host__ __device__ constexpr int ld_any(int dh) { return dh | 1; }

// One key tile of the any-width design for `nr` query rows: qs (row stride
// dh) against `bk` keys (ks, row stride ld_any(dh)) and values (vs, row
// stride dh). Every (row, key) score goes through score(r, j, s) (scale and
// mask; -inf for a slot that is no key) into ps (row stride bk + 1); then
// each row's online softmax, one warp a row (running max ms, denominator
// ls, this tile's rescale as); then acc = acc * alpha + P V with acc in
// shared memory (row stride dh). Threads take consecutive keys, then
// consecutive columns. The caller syncs before (the tile is staged) and
// after (before it stages the next one).
template <int THREADS, typename Score>
__device__ __forceinline__ void tile_any(const float* qs, const float* ks,
                                         const float* vs, float* ps,
                                         float* acc, float* ms, float* ls,
                                         float* as, int nr, int bk, int dh,
                                         Score score) {
  const int tid = threadIdx.x;
  const int ldk = ld_any(dh), ldp = bk + 1;
  for (int e = tid; e < nr * bk; e += THREADS) {
    const int r = e / bk, j = e - r * bk;
    const float* qr = qs + r * dh;
    const float* kr = ks + j * ldk;
    float s = 0.f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) s = fmaf(qr[d], kr[d], s);
    ps[r * ldp + j] = score(r, j, s);
  }
  __syncthreads();
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < nr; r += THREADS / 32) {
    float* pr = ps + r * ldp;
    float mx = neg_inf();
    for (int j = lane; j < bk; j += 32) mx = fmaxf(mx, pr[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
    const float m_old = ms[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int j = lane; j < bk; j += 32) {
      const float p = expf(pr[j] - m_new);
      pr[j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(FULL, sum, off);
    __syncwarp();
    if (lane == 0) {
      const float alpha = expf(m_old - m_new);
      ls[r] = ls[r] * alpha + sum;
      ms[r] = m_new;
      as[r] = alpha;
    }
  }
  __syncthreads();
  for (int e = tid; e < nr * dh; e += THREADS) {
    const int r = e / dh, d = e - r * dh;
    const float* pr = ps + r * ldp;
    float a = acc[e] * as[r];
#pragma unroll 4
    for (int j = 0; j < bk; ++j) a = fmaf(pr[j], vs[j * dh + d], a);
    acc[e] = a;
  }
}

// ------------------------------------------------ the tensor-core design

using bf16 = __nv_bfloat16;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory row stride of a bf16 tile with DH columns: 16 bytes of
// padding per row, so that the 8 rows an ldmatrix phase reads (at one
// 16-byte column) start (DH / 8 + 1) 16-byte units apart, an odd number:
// 8 distinct bank groups, no conflict, at every DH.
template <int DH>
__host__ __device__ constexpr int ld_bf16() { return DH + 8; }

// Wide heads (above Dh 128: MLA's folded q/k at 192 and gemma3's 256): the
// fp32 accumulator alone takes Dh / 2 registers a thread, so the
// tensor-core kernels read Q's fragments from shared memory at each k-step
// instead of keeping Dh / 4 more registers of them (qk_tile_smem), and
// their tiles fit one CTA per SM, not two. The any-width design sizes its
// tiles for the same count (ctas_per_sm_at; the wrapper's
// decode_attention.ctas_per_sm, whose wave split_rows fills, says the same).
__host__ __device__ constexpr int ctas_per_sm_at(int dh) {
  return dh > 128 ? 1 : 2;
}
template <int DH>
__host__ __device__ constexpr bool wide_head() { return DH > 128; }
template <int DH>
__host__ __device__ constexpr int ctas_per_sm() {
  return ctas_per_sm_at(DH);
}

// 16 bytes global -> shared without going through registers (cp.async.cg,
// L2 only). bytes = 16 copies; bytes = 0 writes 16 zero bytes (a row past
// the end: src is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + ROWS) of one head (row j at base + j * stride, cpr
// 16-byte chunks of contiguous bf16) into dst (row r at dst + r *
// ld_bf16<DH>(), DH / 8 chunks), by NT threads of which this is thread `t`;
// rows at or past `rend`, and the chunks of a row past its cpr (a head
// narrower than its instance), are zero: their products are 0, never NaN.
// The caller commits the group.
template <int DH, int ROWS, int NT>
__device__ __forceinline__ void cp_rows(bf16* dst, const bf16* base,
                                        long long stride, int r0, int rend,
                                        int t, int cpr) {
  constexpr int CPR = DH / 8;  // 16-byte chunks per shared-memory row
  constexpr int CHUNKS = ROWS * CPR;
#pragma unroll
  for (int i = 0; i < (CHUNKS + NT - 1) / NT; ++i) {
    const int c = i * NT + t;
    if (CHUNKS % NT == 0 || c < CHUNKS) {
      const int r = c / CPR, x = c % CPR;
      const bool ok = r0 + r < rend && x < cpr;
      const bf16* src = ok ? base + (r0 + r) * stride + x * 8 : base;
      cp_async16(dst + r * ld_bf16<DH>() + x * 8, src, ok ? 16 : 0);
    }
  }
}

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. ldsm_x4: lane l receives (row l / 4, columns
// 2 (l % 4), +1) of each matrix; ldsm_x4_trans the transpose's.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

// c += a . b on the tensor cores: a the 16x16 bf16 A fragment (row-major),
// b0/b1 the 16x8 B fragment (k rows 0-7 and 8-15), c the 16x8 fp32
// accumulator. With g = lane / 4 and t = lane % 4, c holds (row g, columns
// 2t, 2t+1) in c[0..1] and (row g + 8, the same columns) in c[2..3]; a
// holds (row g, k 2t..2t+1), (row g + 8, k 2t..), (row g, k 2t+8..) and
// (row g + 8, k 2t+8..).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to one bf16 pair, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// The A fragments of a 16-row block of Q (rows at q, stride ld_bf16<DH>())
// for every 16-column k-step of S = Q K^T, loaded once into registers.
template <int DH>
__device__ __forceinline__ void load_q_frags(unsigned (&qf)[DH / 16][4],
                                             const bf16* q, int lane) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
    ldsm_x4(qf[kk], q + (lane % 8 + 8 * ((lane / 8) % 2)) * ld_bf16<DH>() +
                        kk * 16 + 8 * (lane / 16));
}

// s[2 np .. 2 np + 1] += Q . K^T for keys 16 np .. 16 np + 15 of a tile
// (rows at k, stride ld_bf16<DH>(); K's B fragments through ldmatrix),
// NP = keys / 16.
template <int DH, int NP>
__device__ __forceinline__ void qk_tile(float (&s)[2 * NP][4],
                                        const unsigned (&qf)[DH / 16][4],
                                        const bf16* k, int lane) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk)
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      unsigned b[4];
      ldsm_x4(b, k + (np * 16 + lane % 8 + 8 * (lane / 16)) * ld_bf16<DH>() +
                     kk * 16 + 8 * ((lane / 8) % 2));
      mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
      mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
    }
}

// qk_tile with Q's A fragments read from shared memory (rows at q, stride
// ld_bf16<DH>()) at each 16-column k-step: one more ldmatrix per k-step
// and NP key blocks, and no registers held for Q across the tiles.
template <int DH, int NP>
__device__ __forceinline__ void qk_tile_smem(float (&s)[2 * NP][4],
                                             const bf16* q, const bf16* k,
                                             int lane) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    unsigned a[4];
    ldsm_x4(a, q + (lane % 8 + 8 * ((lane / 8) % 2)) * ld_bf16<DH>() +
                   kk * 16 + 8 * (lane / 16));
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      unsigned b[4];
      ldsm_x4(b, k + (np * 16 + lane % 8 + 8 * (lane / 16)) * ld_bf16<DH>() +
                     kk * 16 + 8 * ((lane / 8) % 2));
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc += P . V over keys 0 .. 16 NP - 1 of a tile (rows at v). P is rounded
// to bf16 in registers: the m16n8 accumulators of keys 16j.. and 16j + 8..
// (p[2j], p[2j + 1]) are the m16k16 A fragment of keys 16j .. 16j + 15; V
// comes through ldmatrix.trans.
template <int DH, int NP>
__device__ __forceinline__ void pv_tile(float (&acc)[DH / 8][4],
                                        const float (&p)[2 * NP][4],
                                        const bf16* v, int lane) {
  constexpr int LD = ld_bf16<DH>();
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    const unsigned a[4] = {pack_bf16(p[2 * j][0], p[2 * j][1]),
                           pack_bf16(p[2 * j][2], p[2 * j][3]),
                           pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]),
                           pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3])};
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      unsigned b[4];
      ldsm_x4_trans(b, v + (j * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * LD +
                           np * 16 + 8 * (lane / 16));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// One tile's online softmax over the score fragments s of 16 rows (log2
// domain: scores already times scale * log2 e), rows g (s[..][0..1]) and
// g + 8 (s[..][2..3]). Updates the running max m, this thread's share of
// the denominator l (the quad's shares are summed at the end), rescales
// acc, and leaves p = exp2(s - m) in s, in fp32: l sums the fp32 p, as the
// reference does; pv_tile rounds it to bf16.
template <int NT, int DH>
__device__ __forceinline__ void softmax_tile(float (&s)[NT][4], float (&m)[2],
                                             float (&l)[2],
                                             float (&acc)[DH / 8][4]) {
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2f(s[j][e] - m[e / 2]);
      rs[e / 2] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
}

// The quad's shares of a row's denominator, summed.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

}  // namespace attn
