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
// red_i are WARPS-long shared scratch; base is added to each taken index.
template <int THREADS>
__device__ __forceinline__ void block_topk(float* s, int m, int k, float* ov,
                                           int* oi, float* red_v, int* red_i,
                                           int base = 0) {
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
          oi[p] = base + bi;
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

// ------------------------------------------------------ any k
// The "wide" designs of ann_topk.cu and ann_topk_quant.cu, for k above the
// networks' 64: each tile's list of its kt best in ranks_before order,
// then levels that merge the lists two by two, each list cut to k, until
// one is left (kernels/ann_topk.py::merge_levels). Nothing is kept in
// shared memory, so no k is too large.

// Entry p of the merge of lists a (la entries) and b (lb), each in
// ranks_before order, into (v, r). Merge path: the number i of entries of
// list a among the first p of the merge is found by binary search (a's
// entry mid is among them unless b's entry p - mid - 1 ranks before it; a
// first on equal pairs), and entry p is the one of a[i], b[p - i] that
// ranks first. Positions past both lists hold the pad (-inf, INT_MAX),
// which ranks last. On the last level (the result) a pad becomes NEG at
// row p: it is reached only where no list was ever cut, so the rows before
// p are every row of the padded tiles, and the stable sort of the
// NEG-padded scores puts row p there. CG: read through L2 only (lists
// that other CTAs wrote).
template <bool CG>
__device__ __forceinline__ void merge_path(const float* av, const int* ar,
                                           int la, const float* bv,
                                           const int* br, int lb, int p,
                                           bool last, float& v, int& r) {
  const auto ldv = [](const float* x) { return CG ? __ldcg(x) : *x; };
  const auto ldr = [](const int* x) { return CG ? __ldcg(x) : *x; };
  v = -INFINITY;
  r = INT_MAX;
  if (p < la + lb) {
    int lo = max(0, p - lb), hi = min(p, la);
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int j = p - mid - 1;
      if (ranks_before(ldv(bv + j), ldr(br + j), ldv(av + mid),
                       ldr(ar + mid))) {
        hi = mid;
      } else {
        lo = mid + 1;
      }
    }
    const int j = p - lo;
    if (lo < la && (j >= lb || !ranks_before(ldv(bv + j), ldr(br + j),
                                             ldv(av + lo), ldr(ar + lo)))) {
      v = ldv(av + lo);
      r = ldr(ar + lo);
    } else {
      v = ldv(bv + j);
      r = ldr(br + j);
    }
  }
  if (last && v == -INFINITY) {
    v = NEG;
    r = p;
  }
}

// One thread per output entry (query, list o, position p) of a level:
// entry p of the merge of source lists 2o and 2o + 1 (a last list without
// a partner merges with nothing), each len long, of cnt lists a query.
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
merge_pairs(const float* __restrict__ sv, const int* __restrict__ sr, int cnt,
            int len, float* __restrict__ dv, int* __restrict__ dr, int ncnt,
            int nlen, int b, int last) {
  const size_t at = static_cast<size_t>(blockIdx.x) * THREADS + threadIdx.x;
  const size_t per_q = static_cast<size_t>(ncnt) * nlen;
  if (at >= per_q * b) return;
  const size_t bq = at / per_q;
  const int o = static_cast<int>((at % per_q) / nlen);
  const int p = static_cast<int>(at % nlen);
  const size_t a0 = (bq * cnt + 2 * static_cast<size_t>(o)) * len;
  float v;
  int r;
  merge_path<false>(sv + a0, sr + a0, len, sv + a0 + len, sr + a0 + len,
                    2 * o + 1 < cnt ? len : 0, p, last != 0, v, r);
  dv[at] = v;
  dr[at] = r;
}

// The levels after the tiles' lists (ntiles lists of kt a query in fv/fr):
// levels 1, 3, ... into gv/gr, 2, 4, ... into fv/fr, the last (one list
// of k) into vals/rows. Returns the cudaError_t of the launches.
template <int THREADS>
cudaError_t merge_lists(int ntiles, int kt, int k, int b, float* fv, int* fr,
                        float* gv, int* gr, float* vals, int* rows,
                        cudaStream_t s) {
  int cnt = ntiles, len = kt;
  float* src_v = fv;
  int* src_r = fr;
  for (int level = 1;; ++level) {
    const int ncnt = (cnt + 1) / 2;
    const int last = ncnt == 1;
    const int nlen = last ? k : (2 * len < k ? 2 * len : k);
    float* dst_v = last ? vals : (level % 2 ? gv : fv);
    int* dst_r = last ? rows : (level % 2 ? gr : fr);
    const size_t n = static_cast<size_t>(b) * ncnt * nlen;
    merge_pairs<THREADS><<<static_cast<unsigned>((n + THREADS - 1) / THREADS),
                           THREADS, 0, s>>>(src_v, src_r, cnt, len, dst_v,
                                            dst_r, ncnt, nlen, b, last);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || last) return err;
    cnt = ncnt;
    len = nlen;
    src_v = dst_v;
    src_r = dst_r;
  }
}

// The whole block: the best (value, index) of s[0..m) by ranks_before
// order on (value, position), into *out_v, *out_i (shared memory; index
// INT_MAX where every entry is -inf, i.e. taken). red_v, red_i:
// WARPS-long shared scratch. Ends with a block barrier.
template <int THREADS>
__device__ __forceinline__ void block_argmax(const float* s, int m,
                                             float* red_v, int* red_i,
                                             float* out_v, int* out_i) {
  constexpr int WARPS = THREADS / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
      *out_v = best;
      *out_i = bi;
    }
  }
  __syncthreads();
}

// ------------------------------------------------- one-launch scans
// The one-launch designs of ann_topk.cu ("fused") and ann_topk_quant.cu
// ("tc") end every tile CTA with finish_tile: the tile's finalists go to
// scratch, and the CTA that finishes last for its query block merges them.
// Sorting networks order (value, row) pairs by ranks_before, a strict total
// order where rows differ; pads (-inf, INT_MAX) rank last.

constexpr int MERGE_CAP = 512;  // candidates a warp keeps in shared memory
constexpr int MERGE_BATCH = 8;  // loads a lane has in flight in a merge

__device__ __forceinline__ void order_pair(float& va, int& ra, float& vb,
                                           int& rb, bool a_first) {
  if (a_first ? ranks_before(vb, rb, va, ra) : ranks_before(va, ra, vb, rb)) {
    const float tv = va;
    const int tr = ra;
    va = vb;
    ra = rb;
    vb = tv;
    rb = tr;
  }
}

// One warp sorts 32 E pairs held in registers (entry lane + 32 j in
// v[j], r[j], E = 1 or 2) into ranks_before order: a bitonic network,
// pairs across lanes through shuffles. With N < 32 E (a power of two) only
// the network's first log2(N) merges run: entries 0 .. N - 1 come out in
// ranks_before order, the others in blocks of N of no use to the caller.
template <int E, int N = 32 * E>
__device__ __forceinline__ void warp_sort_regs(float (&v)[E], int (&r)[E]) {
  const int lane = threadIdx.x & 31;
  for (int size = 2; size <= N; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride == 32) {  // E == 2: entries lane and lane + 32
        if constexpr (E == 2) order_pair(v[0], r[0], v[1], r[1], true);
        continue;
      }
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const int e = lane + 32 * j;
        const float ov = __shfl_xor_sync(FULL, v[j], stride);
        const int orow = __shfl_xor_sync(FULL, r[j], stride);
        // the lower entry of a pair takes the one that ranks first in
        // blocks that end best first, the other takes the rest
        const bool first = ((e & stride) == 0) == ((e & size) == 0);
        const bool other_first = ranks_before(ov, orow, v[j], r[j]);
        if (first == other_first) {
          v[j] = ov;
          r[j] = orow;
        }
      }
    }
  }
}

// One warp sorts c <= MERGE_CAP (value, row) pairs in shared memory into
// ranks_before order: a bitonic network over the next power of two.
__device__ __forceinline__ void warp_sort(float* cv, int* cr, int c) {
  const int lane = threadIdx.x & 31;
  int p2 = 1;
  while (p2 < c) p2 <<= 1;
  for (int i = c + lane; i < p2; i += 32) {
    cv[i] = -INFINITY;
    cr[i] = INT_MAX;
  }
  __syncwarp();
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = lane; i < p2 / 2; i += 32) {
        const int lo = 2 * i - (i & (stride - 1));
        order_pair(cv[lo], cr[lo], cv[lo + stride], cr[lo + stride],
                   (lo & size) == 0);
      }
      __syncwarp();
    }
  }
}

// One warp: the k best of m <= 64 (value, row) pairs, in ranks_before
// order, into ov[0..k), oi[0..k), k <= m; get(i) gives pair i. With
// ``tight`` the network for m <= 16 spans 8 or 16 lanes instead of all
// 32 (6 or 10 stages instead of 15).
template <typename Get>
__device__ __forceinline__ void warp_best_of_few(int m, int k, Get get,
                                                 float* ov, int* oi,
                                                 bool tight = false) {
  const int lane = threadIdx.x & 31;
  float v[2];
  int r[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = lane + 32 * j;
    if (i < m) {
      get(i, v[j], r[j]);
    } else {
      v[j] = -INFINITY;
      r[j] = INT_MAX;
    }
  }
  if (m <= 32) {
    float v1[1] = {v[0]};
    int r1[1] = {r[0]};
    if (tight && m <= 8) {
      warp_sort_regs<1, 8>(v1, r1);
    } else if (tight && m <= 16) {
      warp_sort_regs<1, 16>(v1, r1);
    } else {
      warp_sort_regs<1>(v1, r1);
    }
    if (lane < k) {
      ov[lane] = v1[0];
      oi[lane] = r1[0];
    }
  } else {
    warp_sort_regs<2>(v, r);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (lane + 32 * j < k) {
        ov[lane + 32 * j] = v[j];
        oi[lane + 32 * j] = r[j];
      }
  }
}

// One warp: the top k of one query's ntiles finalist lists (v, r: list t
// at t * k, each in ranks_before order) into ov[0..k), oi[0..k), in that
// order. Two lower bounds L of the k-th best value, each the value of an
// entry with k entries at or above it: the best list's k-th entry, and for
// k <= 16 the k-th largest of the lanes' two best list heads (lane l looks
// at lists l, l + 32, ...). Only entries >= L are candidates, a prefix of
// each list whose head is >= L: lanes walk their lists' prefixes into the
// warp's MERGE_CAP slots of shared memory (cv, cr; *count counts them),
// and a sorting network orders them. Where L is NEG (fewer than k real
// scores in reach of the bounds) the candidates are the real scores, and
// the NEG entries that follow them are the first in list order, which are
// the lowest rows, as the order ranks them. Should the candidates
// overflow, k argmax passes run over the lists themselves (v is scratch:
// a taken entry is set to -inf). Other CTAs wrote the lists, so they are
// read through L2 (ld.cg), MERGE_BATCH loads a lane at a time.
__device__ __forceinline__ void warp_merge(float* v, const int* r, int ntiles,
                                           int k, float* ov, int* oi,
                                           float* cv, int* cr, int* count) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int m = ntiles * k;
  float lo = -INFINITY, h1 = -INFINITY, h2 = -INFINITY;
  for (int t0 = 0; t0 < ntiles; t0 += 32 * MERGE_BATCH) {
    float kth[MERGE_BATCH], head[MERGE_BATCH];
#pragma unroll
    for (int u = 0; u < MERGE_BATCH; ++u) {
      const int t = t0 + 32 * u + lane;
      const size_t at = static_cast<size_t>(t) * k;
      kth[u] = t < ntiles ? __ldcg(v + at + k - 1) : -INFINITY;
      head[u] = t < ntiles ? __ldcg(v + at) : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < MERGE_BATCH; ++u) {
      lo = fmaxf(lo, kth[u]);
      if (head[u] > h1) {
        h2 = h1;
        h1 = head[u];
      } else {
        h2 = fmaxf(h2, head[u]);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lo = fmaxf(lo, __shfl_xor_sync(FULL, lo, off));
  // the k-th largest of the 64 heads: k pops of the warp's best
  for (int p = 0; p < k && k <= 16; ++p) {
    float best = h1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      best = fmaxf(best, __shfl_xor_sync(FULL, best, off));
    if (p == k - 1) lo = fmaxf(lo, best);
    const unsigned has = __ballot_sync(FULL, h1 == best);
    if (lane == __ffs(has) - 1) {
      h1 = h2;
      h2 = -INFINITY;
    }
  }
  const bool strict = lo <= NEG;
  auto keep = [&](float x) { return strict ? x > NEG : x >= lo; };
  if (lane == 0) *count = 0;
  __syncwarp();
  for (int t0 = 0; t0 < ntiles; t0 += 32 * MERGE_BATCH) {
    float head[MERGE_BATCH];
#pragma unroll
    for (int u = 0; u < MERGE_BATCH; ++u) {
      const int t = t0 + 32 * u + lane;
      head[u] = t < ntiles ? __ldcg(v + static_cast<size_t>(t) * k)
                           : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < MERGE_BATCH; ++u) {
      if (!keep(head[u])) continue;
      const size_t list = static_cast<size_t>(t0 + 32 * u + lane) * k;
      bool more = true;
      for (int p0 = 0; p0 < k && more; p0 += MERGE_BATCH) {
        float x[MERGE_BATCH];
        int xr[MERGE_BATCH];
#pragma unroll
        for (int w = 0; w < MERGE_BATCH; ++w) {
          const bool in = p0 + w < k;
          x[w] = in ? __ldcg(v + list + p0 + w) : -INFINITY;
          xr[w] = in ? __ldcg(r + list + p0 + w) : INT_MAX;
        }
        int n_keep = 0;
#pragma unroll
        for (int w = 0; w < MERGE_BATCH; ++w) {
          more = more && keep(x[w]);
          n_keep += more;
        }
        const int at = n_keep ? atomicAdd(count, n_keep) : 0;
#pragma unroll
        for (int w = 0; w < MERGE_BATCH; ++w)
          if (w < n_keep && at + w < MERGE_CAP) {
            cv[at + w] = x[w];
            cr[at + w] = xr[w];
          }
      }
    }
  }
  __syncwarp();
  const int c = *count;
  if (c <= MERGE_CAP) {
    const int real = min(c, k);
    if (c <= 64) {
      warp_best_of_few(c, real, [&](int i, float& x, int& xr) {
        x = cv[i];
        xr = cr[i];
      }, ov, oi);
    } else {
      warp_sort(cv, cr, c);
      for (int p = lane; p < real; p += 32) {
        ov[p] = cv[p];
        oi[p] = cr[p];
      }
    }
    // fewer real scores than k: the first NEG entries in list order
    int taken = 0;
    for (int base = 0; real + taken < k; base += 32) {
      const int i = base + lane;
      const bool neg = i < m && __ldcg(v + i) <= NEG;
      const unsigned mask = __ballot_sync(FULL, neg);
      const int at = real + taken + __popc(mask & below);
      if (neg && at < k) {
        ov[at] = NEG;
        oi[at] = __ldcg(r + i);
      }
      taken += __popc(mask);
    }
    return;
  }
  for (int p = 0; p < k; ++p) {
    float best = -INFINITY;
    int br = INT_MAX, bp = -1;
    for (int i = lane; i < m; i += 32) {
      const float x = __ldcg(v + i);
      const int xr = __ldcg(r + i);
      if (ranks_before(x, xr, best, br)) {
        best = x;
        br = xr;
        bp = i;
      }
    }
    warp_best(best, br, bp);
    if (lane == 0) {
      ov[p] = best;
      oi[p] = br;
      v[bp] = -INFINITY;
    }
    __syncwarp();
  }
}

constexpr int TILE_CAP = 64;  // candidates of a tile's threshold pass

// One warp: the k best of s[0..m) (shared memory; entry i is row base + i)
// in ranks_before order into ov[0..k), oi[0..k); 64 < m, k <= 32. The
// k-th largest of the lanes' maxima (lane l looks at l, l + 32, ...) is a
// lower bound L of the k-th best, so only entries >= L are candidates:
// up to TILE_CAP of them go to buf (the warp's TILE_CAP pairs) and a
// sorting network orders them; past TILE_CAP, k argmax passes
// (warp_topk) run over s itself.
__device__ __forceinline__ void warp_tile_topk(float* s, int m, int k,
                                               float* ov, int* oi, int base,
                                               float* bv, int* br) {
  const int lane = threadIdx.x & 31;
  float mx[1] = {-INFINITY};
  int ml[1] = {lane};
  for (int i = lane; i < m; i += 32) mx[0] = fmaxf(mx[0], s[i]);
  warp_sort_regs<1>(mx, ml);
  const float lo = __shfl_sync(FULL, mx[0], k - 1);
  int c = 0;
  for (int i0 = 0; i0 < m; i0 += 32) {
    const int i = i0 + lane;
    const float x = i < m ? s[i] : -INFINITY;
    const bool keep = x >= lo;
    const unsigned mask = __ballot_sync(FULL, keep);
    const int at = c + __popc(mask & ((1u << lane) - 1u));
    if (keep && at < TILE_CAP) {
      bv[at] = x;
      br[at] = base + i;
    }
    c += __popc(mask);
  }
  __syncwarp();
  if (c > TILE_CAP) {
    warp_topk(s, m, k, ov, oi, base);
    return;
  }
  warp_best_of_few(c, k, [&](int i, float& x, int& xr) {
    x = bv[i];
    xr = br[i];
  }, ov, oi);
}

// Bytes of dynamic shared memory the tiles' threshold passes take, beside
// the kernel's own.
template <int THREADS>
constexpr size_t tile_smem() {
  return static_cast<size_t>(THREADS / 32) * TILE_CAP *
         (sizeof(float) + sizeof(int));
}

// Bytes of dynamic shared memory the last CTA's merge takes (the kernels
// allocate at least this much and reuse it once the tile is done).
template <int THREADS>
constexpr size_t merge_smem() {
  return static_cast<size_t>(THREADS / 32) * MERGE_CAP *
         (sizeof(float) + sizeof(int));
}

// The end of a one-launch scan CTA (every thread calls it). sc: the tile's
// scores, nq rows of tile_n in shared memory, position i being row row0 + i
// (NEG for inactive rows and rows past N); tile_n >= k. smem: the CTA's
// dynamic shared memory, at least merge_smem<THREADS>() bytes, 16-byte
// aligned; tbuf: tile_smem<THREADS>() more bytes. Each query's k best (a
// sorting network up to 64 rows, warp_tile_topk above, k argmax passes
// for k > 32) go to its list in fv/fr ((B, ntiles, k) scratch). Then an
// atomic ticket per query block counts the finished tiles: the CTA that
// takes the last ticket resets it to 0 for the next launch and merges
// every tile's lists into vals/rows ((B, k)), a warp a query (warp_merge),
// reusing smem.
template <int THREADS>
__device__ __forceinline__ void finish_tile(float* sc, int tile_n, int nq,
                                            int q0, int k, int tile,
                                            int ntiles, int row0, float* fv,
                                            int* fr, int* ticket,
                                            float* vals, int* rows,
                                            unsigned char* smem,
                                            unsigned char* tbuf) {
  constexpr int WARPS = THREADS / 32;
  __shared__ int last;
  __shared__ int count[WARPS];
  const int warp = threadIdx.x >> 5;
  float* bv = reinterpret_cast<float*>(tbuf) + warp * TILE_CAP;
  int* br = reinterpret_cast<int*>(tbuf) + (WARPS + warp) * TILE_CAP;
  for (int j = warp; j < nq; j += WARPS) {
    const size_t out = ((q0 + j) * static_cast<size_t>(ntiles) + tile) * k;
    float* s = sc + j * tile_n;
    if (tile_n <= 64) {
      warp_best_of_few(tile_n, k, [&](int i, float& x, int& xr) {
        x = s[i];
        xr = row0 + i;
      }, fv + out, fr + out);
    } else if (k <= 32) {
      warp_tile_topk(s, tile_n, k, fv + out, fr + out, row0, bv, br);
    } else {
      warp_topk(s, tile_n, k, fv + out, fr + out, row0);
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(ticket, 1) == ntiles - 1;
    if (last) atomicExch(ticket, 0);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float* cv = reinterpret_cast<float*>(smem) + warp * MERGE_CAP;
  int* cr = reinterpret_cast<int*>(smem) + (WARPS + warp) * MERGE_CAP;
  for (int j = warp; j < nq; j += WARPS) {
    const size_t q = q0 + j;
    const size_t list = q * ntiles * k;
    warp_merge(fv + list, fr + list, ntiles, k, vals + q * k, rows + q * k,
               cv, cr, count + warp);
  }
}

}  // namespace sel
