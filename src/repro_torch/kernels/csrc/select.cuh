// select.cuh — the reference's top-k order for the port's stage-1 kernels:
// value descending, then index ascending on ties (the Pallas kernels'
// argmax and lax.top_k both prefer the lowest index). Selection is k
// argmax passes; a taken entry is set to -inf, below every score, NEG
// included. Scores are compared as one total order across lanes, warps and
// passes, so exact ties (duplicate rows, int8 scores) come out in index
// order whatever order the blocks ran in.

#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace sel {

constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -3.0e38f;  // the reference's masked-score sentinel

// (value desc, index asc): does (v, i) rank before (bv, bi)?
__device__ __forceinline__ bool ranks_before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// best (value, index, position) across the warp; every lane gets it
__device__ __forceinline__ void warp_best(float& best, int& bi, int& bp) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(FULL, best, off);
    const int oi = __shfl_xor_sync(FULL, bi, off);
    const int op = __shfl_xor_sync(FULL, bp, off);
    if (ranks_before(ov, oi, best, bi)) { best = ov; bi = oi; bp = op; }
  }
}

// One warp: k argmax passes over s[0..m), m >= k. Pass p writes ov[p] and
// oi[p] = base + index, then marks the entry taken.
__device__ __forceinline__ void warp_topk(float* s, int m, int k, float* ov,
                                          int* oi, int base) {
  const int lane = threadIdx.x & 31;
  for (int p = 0; p < k; ++p) {
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int i = lane; i < m; i += 32) {
      const float v = s[i];
      if (v > best) { best = v; bi = i; }  // i ascends: keeps the lowest
    }
    int bp = bi;
    warp_best(best, bi, bp);
    if (lane == 0) {
      ov[p] = best;
      oi[p] = base + bi;
      s[bi] = -INFINITY;
    }
    __syncwarp();
  }
}

// The whole block: k argmax passes over s[0..m) (shared memory). Pass p
// writes ov[p], oi[p]; once all m entries are taken (k > m) it writes NEG
// and index p, as a stable sort of the NEG-padded scores would. red_v and
// red_i are WARPS-long shared scratch.
template <int THREADS>
__device__ __forceinline__ void block_topk(float* s, int m, int k, float* ov,
                                           int* oi, float* red_v, int* red_i) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p = 0; p < k; ++p) {
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int i = threadIdx.x; i < m; i += THREADS) {
      const float v = s[i];
      if (v > best) { best = v; bi = i; }
    }
    int bp = bi;
    warp_best(best, bi, bp);
    if (lane == 0) { red_v[warp] = best; red_i[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      best = lane < WARPS ? red_v[lane] : -INFINITY;
      bi = lane < WARPS ? red_i[lane] : INT_MAX;
      bp = bi;
      warp_best(best, bi, bp);
      if (lane == 0) {
        if (bi == INT_MAX) {
          ov[p] = NEG;
          oi[p] = p;
        } else {
          ov[p] = best;
          oi[p] = bi;
          s[bi] = -INFINITY;
        }
      }
    }
    __syncthreads();
  }
}

// One CTA per query: top k of its m finalists (fv, fr: rows of m entries),
// by (value desc, row asc). Marks each winner taken in fv, which is scratch.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
merge_topk(float* fv, const int* fr, int m, int k, float* __restrict__ vals,
           int* __restrict__ rows) {
  constexpr int WARPS = THREADS / 32;
  __shared__ float sv[WARPS];
  __shared__ int sr[WARPS];
  __shared__ int sp[WARPS];
  const int bq = blockIdx.x;
  float* v = fv + static_cast<size_t>(bq) * m;
  const int* r = fr + static_cast<size_t>(bq) * m;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int p = 0; p < k; ++p) {
    float best = -INFINITY;
    int br = INT_MAX, bp = -1;
    for (int i = threadIdx.x; i < m; i += THREADS) {
      const float x = v[i];
      const int xr = r[i];
      if (ranks_before(x, xr, best, br)) { best = x; br = xr; bp = i; }
    }
    warp_best(best, br, bp);
    if (lane == 0) { sv[warp] = best; sr[warp] = br; sp[warp] = bp; }
    __syncthreads();
    if (warp == 0) {
      best = lane < WARPS ? sv[lane] : -INFINITY;
      br = lane < WARPS ? sr[lane] : INT_MAX;
      bp = lane < WARPS ? sp[lane] : -1;
      warp_best(best, br, bp);
      if (lane == 0) {
        vals[static_cast<size_t>(bq) * k + p] = best;
        rows[static_cast<size_t>(bq) * k + p] = br;
        v[bp] = -INFINITY;
      }
    }
    __syncthreads();
  }
}

}  // namespace sel
