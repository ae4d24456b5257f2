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
//   -> vals, slots (B, nprobe, k), any k >= 1, any cap, any D.
//   Probe (b, j) scores every slot of bucket sel[b, j] against query b;
//   invalid slots and disabled probes score NEG = -3e38; its k finalists
//   are in (value desc, slot asc) order. Where fewer than k slots remain,
//   or the probe is disabled, pass p writes NEG and slot p, as a stable
//   sort of the NEG-padded scores would. A sel outside [0, C) scores as a
//   disabled probe (no read outside the buckets). A NEG entry's slot is
//   the same on both designs: after the real scores come the invalid
//   slots in ascending order, then the pads cap, cap + 1, ...; a probe
//   that scans nothing writes slots 0 .. k - 1 ("block": the argmax passes
//   take NEG entries lowest slot first, then write slot p once the cap
//   entries are taken; "warp": the network ranks NEG at slot i after NEG
//   at every lower slot, and write_disabled writes slot p).
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
// "block" reads every slot of a probed bucket, valid or not, "warp" every
// row group that holds a valid slot, once per query that probes it.
// Sharded, the owner alone reads the bucket, so the bytes are the
// unsharded scan's plus the S-fold stack of finalists.
//
// Three designs for every scan, fp32 and int8, unsharded (kernels 3 and 4)
// and sharded (kernel 5); the wrappers' one pick_design sends buckets of
// at most WARP_CAP = 64 slots (every bucket the engine lays out) at k <= 64
// to "warp", larger ones (the real-size router's) and any k to "block",
// and buckets whose scores and query overflow shared memory to "chunked".
//
// Design "block" (ivf_topk, ivf_topk_sharded): one kernel for both payload
// types over a scorer policy; one CTA per (query b, probe j), reading
// sel[b, j] and enabled[b, j] itself (the TPU's scalar prefetch) and
// offsetting into the bucket. The query sits in shared memory; warps
// score ROWS slots at once (dot.cuh) into a cap-long score array in
// dynamic shared memory (cap below about 57,000 at D = 768), then the whole
// block runs k argmax passes (select.cuh, ties to the lowest slot; buckets
// hold their rows in ascending order, so that is the lowest row), any k.
// CTAs of queries that probe the same bucket find it in L2 only by chance.
// The sharded CTA also reads the (S+1,) bounds to find the owner of its
// bucket and writes the whole (S, k) column of the stack: its finalists
// (staged in dynamic shared memory after the query), with their rows read
// from bucket_rows, at the owner, NEG / -1 at the others.
//
// Design "chunked" (ivf_chunked, ivf_chunked_sharded; buckets whose cap
// scores and query overflow shared memory): "block" over chunks of the
// bucket that fit. One CTA per (query, probe) reads its query in place
// from device memory (on a 16-byte boundary) and scores chunk after chunk
// of `chunk` slots into shared memory with the same dot.cuh code, so
// every score is bitwise "block"'s. The probe's running list, its best
// min(k, slots so far) in (value desc, slot asc) order, lives in device
// memory, in the output row and a scratch row taken in turns; each chunk
// merges into it by k passes that take the better of the list's next
// entry and the chunk's best (a block argmax, run again only when the
// chunk's best was taken). Every earlier slot is lower than the chunk's,
// so the list wins a tie, as the one-chunk argmax would have it. Past the
// bucket's cap the last chunk writes NEG and slot p, as "block" does. No
// list needs shared memory, so neither k nor cap has a limit.
//
// Design "warp" (ivf_warp, ivf_warp_sharded; buckets of at most 64
// slots): at B = 1, nprobe = 8 and cap 16 the block design keeps 4 of its
// 8 warps idle and spends most of its time in block barriers: the query's,
// the scores', and two in each of the k argmax passes. Here one warp owns
// one (query, probe) and WARP_PROBES probes share a CTA, with no block
// barrier at all. Both writers run one probe body (warp_probe): the warp
// issues every load that needs only its bucket id at once (the valid bytes
// and scales of its two slots a lane and the query; sharded, also the
// slots' rows and the cut points, and one ballot finds the owner), and
// scores only the row groups that hold a valid slot (the engine keeps a
// bucket's members as a prefix, so the loads stop at the member count), 8
// or 16 rows at once through the same dot.cuh code as the block design,
// so every score is bitwise the same. Each lane keeps the scores of slots
// lane and lane + 32; one bitonic network over the first max(valid
// prefix, k) entries (select.cuh::warp_best_of_few, later slots scoring
// NEG at their own index, as a stable sort of the NEG-padded scores orders
// them) gives all k finalists at once. The unsharded writer's lanes store
// them straight to the probe's (k,) row of vals/slots; the sharded one
// stages them in shared memory and writes the (S, k) column with rows. What
// is left is latency: three dependent trips to memory (the probe's bucket
// id, the bucket's metadata, its rows) and, per row group, a chain of dot
// products and shuffles (PERF.md).

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
constexpr int K_MAX = 64;        // "warp": the largest k
constexpr size_t SMEM_MAX = 232448;  // H100: 227 KB of dynamic shared memory
constexpr int WARP_PROBES = 4;  // "warp": probes (warps) a CTA
constexpr int WARP_CAP = 64;    // "warp": the largest bucket, two slots a lane
enum Design { BLOCK = 0, WARP = 1, CHUNKED = 2 };

// shared memory layout of "block": cap fp32 scores, then the query on a
// 16-byte boundary, then (sharded) the k finalists' values and slots
__host__ __device__ inline size_t query_offset(int cap) {
  return (static_cast<size_t>(cap) * sizeof(float) + 15) & ~static_cast<size_t>(15);
}
__host__ __device__ inline size_t top_offset(int cap, int d, size_t elem) {
  return (query_offset(cap) + static_cast<size_t>(d) * elem + 15) &
         ~static_cast<size_t>(15);
}

// a probe no design scanned (disabled, or out of range): NEG and slot p
// at pass p, threads from, from + step, ... writing
__device__ __forceinline__ void write_disabled(float* ov, int* oi, int k,
                                               int from, int step) {
  for (int p = from; p < k; p += step) {
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
  template <int R>
  static __device__ __forceinline__ void rows(const E* const (&erow)[R],
                                              const E* sq, int d, int lane,
                                              Acc (&acc)[R][1]) {
    dot::warp_dot<E, VEC, R, 1>(erow, sq, d, 1, lane, acc);
  }
  static __device__ __forceinline__ float finish(Acc acc, const float*,
                                                 float) {
    return acc;
  }
};

template <int VEC>
struct Scorer<int8_t, VEC> {
  using Acc = int;
  template <int R>
  static __device__ __forceinline__ void rows(
      const int8_t* const (&erow)[R], const int8_t* sq, int d, int lane,
      Acc (&acc)[R][1]) {
    dot::warp_dot_i8<VEC, R, 1>(erow, sq, d, 1, lane, acc);
  }
  static __device__ __forceinline__ float finish(Acc acc,
                                                 const float* slot_scale,
                                                 float q_scale) {
    return dot::rescale(acc, *slot_scale, q_scale);
  }
};

// The whole block scores slots c0 .. c0 + m - 1 of a bucket (its payload
// `bucket`, valid bytes bv, int8 scales bs) against the query sq into
// sc[0..m), ROWS slots a warp at once; NEG where a slot is invalid.
template <typename E, int VEC>
__device__ __forceinline__ void score_slots(const E* bucket,
                                            const uint8_t* bv,
                                            const float* bs, const E* sq,
                                            float q_scale, int c0, int m,
                                            int cap, int d, float* sc) {
  using S = Scorer<E, VEC>;
  constexpr bool kScaled = std::is_same_v<E, int8_t>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r0 = warp * ROWS; r0 < m; r0 += WARPS * ROWS) {
    const E* erow[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      erow[r] = bucket + static_cast<size_t>(min(c0 + r0 + r, cap - 1)) * d;
    typename S::Acc acc[ROWS][1];
    S::rows(erow, sq, d, lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int i = r0 + r, slot = c0 + i;
        if (i < m)
          sc[i] = bv[slot] != 0
                      ? S::finish(acc[r][0], kScaled ? bs + slot : nullptr,
                                  q_scale)
                      : sel::NEG;
      }
    }
  }
}

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
  constexpr bool kScaled = std::is_same_v<E, int8_t>;
  float* sc = reinterpret_cast<float*>(smem);              // [cap]
  E* sq = reinterpret_cast<E*>(smem + query_offset(cap));  // [d]
  const size_t base = static_cast<size_t>(c) * cap;

  for (int i = threadIdx.x; i < d; i += THREADS)
    sq[i] = q[static_cast<size_t>(bq) * d + i];
  __syncthreads();
  score_slots<E, VEC>(buckets + base * d, valid + base,
                      kScaled ? bscale + base : nullptr, sq,
                      kScaled ? qs[bq] : 1.f, 0, cap, cap, d, sc);
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
    write_disabled(ov, oi, k, threadIdx.x, THREADS);
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
  // the finalists, after the scores and the query (block_smem)
  float* top_v = reinterpret_cast<float*>(smem + top_offset(cap, d, sizeof(E)));
  int* top_i = reinterpret_cast<int*>(top_v + k);
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

// "chunked": the whole block scans bucket c against query bq in chunks of
// `chunk` slots (sc: chunk scores in shared memory) and leaves the probe's
// k finalists (value desc, slot asc) in ov/oi, device memory; tv/ti: a
// k-long scratch row. Thread 0 alone reads and writes the running lists.
template <typename E, int VEC>
__device__ __forceinline__ void scan_chunked(
    int c, int bq, const E* __restrict__ q, const float* __restrict__ qs,
    const E* __restrict__ buckets, const float* __restrict__ bscale,
    const uint8_t* __restrict__ valid, int cap, int d, int k, int chunk,
    float* sc, float* ov, int* oi, float* tv, int* ti) {
  constexpr bool kScaled = std::is_same_v<E, int8_t>;
  __shared__ float red_v[WARPS];
  __shared__ int red_i[WARPS];
  __shared__ float cb_v;   // the chunk's best untaken score, its position
  __shared__ int cb_i;
  __shared__ int took[2];  // by pass parity: did pass p take cb?
  const size_t base = static_cast<size_t>(c) * cap;
  const float* bs = kScaled ? bscale + base : nullptr;
  const float q_scale = kScaled ? qs[bq] : 1.f;
  const E* sq = q + static_cast<size_t>(bq) * d;  // read in place
  const int nch = (cap + chunk - 1) / chunk;
  int rlen = 0;  // the running list's length: min(k, slots scanned)
  for (int t = 0; t < nch; ++t) {
    const int c0 = t * chunk;
    const int m = min(chunk, cap - c0);
    // the last chunk's list is the output: the lists alternate backwards
    const bool to_out = (nch - 1 - t) % 2 == 0;
    float* dv = to_out ? ov : tv;
    int* di = to_out ? oi : ti;
    const float* rv = to_out ? tv : ov;
    const int* ri_ = to_out ? ti : oi;
    score_slots<E, VEC>(buckets + base * d, valid + base, bs, sq, q_scale,
                        c0, m, cap, d, sc);
    __syncthreads();
    const int len = min(k, rlen + m);
    const int fill = t == nch - 1 ? k : len;
    int head = 0;      // the running list's next entry (thread 0)
    bool need = true;  // find the chunk's best before this pass
    for (int p = 0; p < fill; ++p) {
      if (p < len && need)
        sel::block_argmax<THREADS>(sc, m, red_v, red_i, &cb_v, &cb_i);
      if (threadIdx.x == 0) {
        float v = sel::NEG;
        int slot = p;  // past the cap: NEG at slot p
        int take = 0;
        if (p < len) {
          const bool from_list =
              head < rlen &&
              (cb_i == INT_MAX ||
               sel::ranks_before(rv[head], ri_[head], cb_v, c0 + cb_i));
          if (from_list) {
            v = rv[head];
            slot = ri_[head];
            ++head;
          } else {
            v = cb_v;
            slot = c0 + cb_i;
            sc[cb_i] = -INFINITY;
            take = 1;
          }
        }
        dv[p] = v;
        di[p] = slot;
        took[p & 1] = take;
      }
      __syncthreads();
      need = took[p & 1] != 0;
    }
    rlen = len;
    __syncthreads();  // the next chunk overwrites sc
  }
}

// One CTA per (query b, probe j): the unsharded writer of "chunked".
template <typename E, int VEC>
__global__ void __launch_bounds__(THREADS)
ivf_chunked(const int* __restrict__ sel_, const int* __restrict__ en,
            const E* __restrict__ q, const float* __restrict__ qs,
            const E* __restrict__ buckets, const float* __restrict__ bscale,
            const uint8_t* __restrict__ valid, int nprobe, int c_count,
            int cap, int d, int k, int chunk, float* __restrict__ tmp_v,
            int* __restrict__ tmp_i, float* __restrict__ vals,
            int* __restrict__ slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bj = blockIdx.x;
  const size_t at = static_cast<size_t>(bj) * k;
  const int c = sel_[bj];
  if (en[bj] == 0 || c < 0 || c >= c_count) {
    write_disabled(vals + at, slots + at, k, threadIdx.x, THREADS);
    return;
  }
  scan_chunked<E, VEC>(c, bj / nprobe, q, qs, buckets, bscale, valid, cap, d,
                       k, chunk, reinterpret_cast<float*>(smem), vals + at,
                       slots + at, tmp_v + at, tmp_i + at);
}

// One CTA per (query b, probe j): the sharded writer of "chunked". The
// running lists end in the owner's row of the stacks, whose slots then
// become global rows; the other shards' rows get NEG / -1.
template <typename E, int VEC>
__global__ void __launch_bounds__(THREADS)
ivf_chunked_sharded(const int* __restrict__ sel_, const int* __restrict__ en,
                    const E* __restrict__ q, const float* __restrict__ qs,
                    const E* __restrict__ buckets,
                    const float* __restrict__ bscale,
                    const uint8_t* __restrict__ valid,
                    const int* __restrict__ bucket_rows,
                    const int* __restrict__ bounds, int n_shards, int nprobe,
                    int c_count, int cap, int d, int k, int chunk,
                    float* __restrict__ tmp_v, int* __restrict__ tmp_i,
                    float* __restrict__ vals, int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int bj = blockIdx.x;
  const size_t bn = static_cast<size_t>(gridDim.x);
  const int c = sel_[bj];
  int owner = -1;
  if (en[bj] != 0 && c >= 0 && c < c_count)
    for (int s = 0; s < n_shards && owner < 0; ++s)
      if (owns(bounds, s, c)) owner = s;
  if (owner >= 0) {  // the same for every thread of the block
    const size_t o = (static_cast<size_t>(owner) * bn + bj) * k;
    scan_chunked<E, VEC>(c, bj / nprobe, q, qs, buckets, bscale, valid, cap,
                         d, k, chunk, reinterpret_cast<float*>(smem),
                         vals + o, rows + o,
                         tmp_v + static_cast<size_t>(bj) * k,
                         tmp_i + static_cast<size_t>(bj) * k);
  }
  for (int i = threadIdx.x; i < n_shards * k; i += THREADS) {
    const int s = i / k;
    const size_t o = (static_cast<size_t>(s) * bn + bj) * k + (i - s * k);
    if (s == owner) {  // the slot becomes its global row
      rows[o] = vals[o] > sel::NEG / 2
                    ? bucket_rows[static_cast<size_t>(c) * cap + rows[o]]
                    : -1;
    } else {
      vals[o] = sel::NEG;
      rows[o] = -1;
    }
  }
}

// Bytes of a warp's query slice in the "warp" design's dynamic shared
// memory (16-byte aligned, for the scorers' wide query reads).
__host__ __device__ inline size_t warp_query_bytes(int d, size_t elem) {
  return (static_cast<size_t>(d) * elem + 15) & ~static_cast<size_t>(15);
}

// One warp: the raw scores (before Scorer::finish) of the slots below hi
// of a bucket, R slots at once, skipping the groups of R with no valid
// slot (vmask); slot i lands in raw[i / 32] of lane i % 32.
template <int R, typename E, int VEC, typename Acc>
__device__ __forceinline__ void score_groups(const E* bucket, const E* sq,
                                             int d, int cap, int hi,
                                             unsigned long long vmask,
                                             int lane, Acc (&raw)[2]) {
  for (int r0 = 0; r0 < hi; r0 += R) {
    if (((vmask >> r0) & ((1ull << R) - 1)) == 0) continue;
    const E* erow[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      erow[r] = bucket + static_cast<size_t>(min(r0 + r, cap - 1)) * d;
    Acc acc[R][1];
    Scorer<E, VEC>::rows(erow, sq, d, lane, acc);
    // slots r0 .. r0 + R - 1 sit in lanes r0 % 32 .. of half r0 / 32
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane == ((r0 + r) & 31)) {
        if (r0 < 32) raw[0] = acc[r][0];
        else raw[1] = acc[r][0];
      }
    }
  }
}

// One warp scans probe bj = (query bq, probe j), cap <= WARP_CAP: the body
// both writers of the "warp" design share. The lanes' finalists go to
// ov[0..k), oi[0..k) (slots) in ranks_before order. Sharded (kSharded),
// the warp also finds the shard that owns the probe's bucket, with one
// ballot over the cut points, and stages the bucket's global rows in
// slot_row; it scans only an owned bucket. Returns the owner (0 unsharded)
// if the warp scanned the probe, else -1 (disabled, out of range or not
// owned), and then writes nothing. A query off a 16-byte boundary is
// copied to the warp's slice of dynamic shared memory (smem). The body
// stays one guarded block with the query slice found inside it: with
// early returns and the slice found first, ptxas gave the int8 instances
// fewer registers, a spill and a slower scan (PERF.md).
template <typename E, int VEC, bool kSharded>
__device__ __forceinline__ int warp_probe(
    int bj, const int* __restrict__ sel_, const int* __restrict__ en,
    const E* __restrict__ q, const float* __restrict__ qs,
    const E* __restrict__ buckets, const float* __restrict__ bscale,
    const uint8_t* __restrict__ valid, const int* __restrict__ bucket_rows,
    const int* __restrict__ bounds, int n_shards, int nprobe, int c_count,
    int cap, int d, int k, unsigned char* smem, float* ov, int* oi,
    int* slot_row) {
  using Acc = typename Scorer<E, VEC>::Acc;
  constexpr bool kScaled = std::is_same_v<E, int8_t>;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = sel_[bj];
  int owner = -1;
  if (en[bj] != 0 && c >= 0 && c < c_count) {
    // Every load that needs only c is issued before the first use of any
    // of them (the bucket's valid bytes, slot rows and scales, the first
    // 32 cut points, the query), so that they share one trip to memory.
    const size_t base = static_cast<size_t>(c) * cap;
    int vb[2] = {0, 0}, srow[2] = {-1, -1};  // this lane's slots lane, lane + 32
    float scale[2] = {1.f, 1.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int slot = lane + 32 * j;
      if (slot < cap) {
        vb[j] = valid[base + slot];
        if constexpr (kSharded) srow[j] = bucket_rows[base + slot];
        if constexpr (kScaled) scale[j] = bscale[base + slot];
      }
    }
    int b_lo = 0, b_hi = 0;
    if constexpr (kSharded) {
      b_lo = bounds[min(lane, n_shards)];
      b_hi = bounds[min(lane + 1, n_shards)];
    }
    const int bq = bj / nprobe;
    const float q_scale = kScaled ? qs[bq] : 1.f;
    // The dot products read each lane's own query chunks (dot.cuh: chunks
    // lane, lane + 32, ... of VEC elements) in place where the query
    // starts on a 16-byte boundary, else from the lane's own copy in the
    // warp's slice of shared memory.
    E* sq = reinterpret_cast<E*>(smem + warp * warp_query_bytes(d, sizeof(E)));
    const E* qb = q + static_cast<size_t>(bq) * d;
    const bool qaligned = reinterpret_cast<uintptr_t>(qb) % 16 == 0;
    if (!qaligned) {
#pragma unroll 2
      for (int c0 = lane * VEC; c0 < d; c0 += 32 * VEC) {
        E t[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) t[v] = qb[c0 + v];
#pragma unroll
        for (int v = 0; v < VEC; ++v) sq[c0 + v] = t[v];
      }
    }
    const E* qsrc = qaligned ? qb : sq;
    const bool ok[2] = {vb[0] != 0, vb[1] != 0};
    if constexpr (kSharded) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (lane + 32 * j < cap) slot_row[lane + 32 * j] = srow[j];
      // the owner: the one shard whose range holds c
      int s0 = 0;
      unsigned own = __ballot_sync(sel::FULL,
                                   lane < n_shards && b_lo <= c && c < b_hi);
      while (own == 0 && (s0 += 32) < n_shards) {
        const int sh = s0 + lane;
        own = __ballot_sync(
            sel::FULL, sh < n_shards && bounds[sh] <= c && c < bounds[sh + 1]);
      }
      if (own) owner = s0 + __ffs(own) - 1;
    } else {
      owner = 0;
    }
    if (owner >= 0) {
      const unsigned long long vmask =
          __ballot_sync(sel::FULL, ok[0]) |
          (static_cast<unsigned long long>(__ballot_sync(sel::FULL, ok[1]))
           << 32);
      const int hi = 64 - __clzll(vmask);  // past the last valid slot
      __syncwarp();
      // a group of 8 slots for the smallest buckets, of 16 above: one
      // warp's dot products are a chain of dependent shuffles, so fewer
      // and wider groups finish sooner once more than 8 slots are valid
      Acc raw[2] = {Acc(0), Acc(0)};
      const E* bucket = buckets + base * d;
      if (hi <= 8) {
        score_groups<8, E, VEC>(bucket, qsrc, d, cap, hi, vmask, lane, raw);
      } else {
        score_groups<16, E, VEC>(bucket, qsrc, d, cap, hi, vmask, lane, raw);
      }
      float score[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // Scorer::finish's arithmetic, from the scale held in a register
        float x;
        if constexpr (kScaled) x = dot::rescale(raw[j], scale[j], q_scale);
        else x = raw[j];
        score[j] = ok[j] ? x : sel::NEG;
      }
      // slots past hi score NEG at their own index (invalid slots, and up
      // to k the stable sort's pads past cap), below every real score and
      // after every NEG of a lower slot: the k best of the first max(hi, k)
      // are the k best of all; warp_best_of_few pads past them itself
      sel::warp_best_of_few(max(hi, k), k, [&](int i, float& x, int& xr) {
        x = i < 32 ? score[0] : score[1];
        xr = i;
      }, ov, oi, true);
      if constexpr (kSharded) __syncwarp();  // the writer reads ov, oi
    }
  }
  return owner;
}

// One warp per (query b, probe j), WARP_PROBES probes a CTA, cap <=
// WARP_CAP: the unsharded writer. The lanes write the probe's k finalists
// (value, slot) straight to (b, j)'s row of vals/slots; a probe the warp
// did not scan gets NEG and slot p, as ivf_topk writes it.
template <typename E, int VEC>
__global__ void __launch_bounds__(WARP_PROBES * 32)
ivf_warp(const int* __restrict__ sel_, const int* __restrict__ en,
         const E* __restrict__ q, const float* __restrict__ qs,
         const E* __restrict__ buckets, const float* __restrict__ bscale,
         const uint8_t* __restrict__ valid, int n_probes, int nprobe,
         int c_count, int cap, int d, int k, float* __restrict__ vals,
         int* __restrict__ slots) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bj = blockIdx.x * WARP_PROBES + warp;
  if (bj >= n_probes) return;  // the whole warp; no block barrier follows
  float* ov = vals + static_cast<size_t>(bj) * k;
  int* oi = slots + static_cast<size_t>(bj) * k;
  if (warp_probe<E, VEC, false>(bj, sel_, en, q, qs, buckets, bscale, valid,
                                nullptr, nullptr, 1, nprobe, c_count, cap, d,
                                k, smem, ov, oi, nullptr) < 0)
    write_disabled(ov, oi, k, lane, 32);
}

// One warp per (query b, probe j), WARP_PROBES probes a CTA, cap <=
// WARP_CAP: the sharded writer. It writes the (S, k) column of the stacks
// as ivf_topk_sharded does, with the same scores and the same order.
template <typename E, int VEC>
__global__ void __launch_bounds__(WARP_PROBES * 32)
ivf_warp_sharded(const int* __restrict__ sel_, const int* __restrict__ en,
                 const E* __restrict__ q, const float* __restrict__ qs,
                 const E* __restrict__ buckets,
                 const float* __restrict__ bscale,
                 const uint8_t* __restrict__ valid,
                 const int* __restrict__ bucket_rows,
                 const int* __restrict__ bounds, int n_shards, int n_probes,
                 int nprobe, int c_count, int cap, int d, int k,
                 float* __restrict__ vals, int* __restrict__ rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float top_v[WARP_PROBES][K_MAX];
  __shared__ int top_i[WARP_PROBES][K_MAX];
  __shared__ int slot_row[WARP_PROBES][WARP_CAP];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int bj = blockIdx.x * WARP_PROBES + warp;
  if (bj >= n_probes) return;  // the whole warp; no block barrier follows
  const int owner = warp_probe<E, VEC, true>(
      bj, sel_, en, q, qs, buckets, bscale, valid, bucket_rows, bounds,
      n_shards, nprobe, c_count, cap, d, k, smem, top_v[warp], top_i[warp],
      slot_row[warp]);
  // the (S, k) column, entry i = s * k + p: the finalists at the owner,
  // NEG / -1 at every other shard ((s, p) stepped, not divided)
  const size_t bn = static_cast<size_t>(n_probes);
  int s = lane / k, p = lane % k;
  for (int i = lane; i < n_shards * k; i += 32) {
    float v = sel::NEG;
    int r = -1;
    if (s == owner) {
      v = top_v[warp][p];
      if (v > sel::NEG / 2) r = slot_row[warp][top_i[warp][p]];
    }
    const size_t o = (static_cast<size_t>(s) * bn + bj) * k + p;
    vals[o] = v;
    rows[o] = r;
    s += 32 / k;
    p += 32 % k;
    if (p >= k) {
      p -= k;
      ++s;
    }
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
  int design;  // Design
  float* vals;
  int* idx;  // slots, or the sharded scan's global rows
  int chunk = 0;  // "chunked": slots a chunk, and its k-long scratch rows
  float* tmp_v = nullptr;
  int* tmp_i = nullptr;
};

// kernels above 48 KB of dynamic shared memory must ask for it
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// static shared memory of ivf_warp_sharded (finalists and slot rows);
// ivf_warp has none
constexpr size_t WARP_SHARDED_STATIC_SMEM =
    WARP_PROBES * (K_MAX * (sizeof(float) + sizeof(int)) +
                   WARP_CAP * sizeof(int));
// "warp": ivf_warp_sharded with bounds, else ivf_warp
template <typename E, int VEC>
cudaError_t launch_warp(const Args& a, cudaStream_t s) {
  const bool sharded = a.bounds != nullptr;
  const size_t smem = WARP_PROBES * warp_query_bytes(a.d, sizeof(E));
  const size_t fixed = sharded ? WARP_SHARDED_STATIC_SMEM : 0;
  if (a.cap > WARP_CAP || smem + fixed > SMEM_MAX)
    return cudaErrorInvalidValue;
  const int n_probes = a.b * a.nprobe;
  const int grid = (n_probes + WARP_PROBES - 1) / WARP_PROBES;
  const auto* q = static_cast<const E*>(a.q);
  const auto* bk = static_cast<const E*>(a.buckets);
  cudaError_t err;
  if (sharded) {
    auto kern = ivf_warp_sharded<E, VEC>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<grid, WARP_PROBES * 32, smem, s>>>(
        a.sel, a.en, q, a.qs, bk, a.bscale, a.valid, a.bucket_rows, a.bounds,
        a.n_shards, n_probes, a.nprobe, a.c, a.cap, a.d, a.k, a.vals, a.idx);
  } else {
    auto kern = ivf_warp<E, VEC>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<grid, WARP_PROBES * 32, smem, s>>>(
        a.sel, a.en, q, a.qs, bk, a.bscale, a.valid, n_probes, a.nprobe, a.c,
        a.cap, a.d, a.k, a.vals, a.idx);
  }
  return cudaGetLastError();
}

// "chunked": ivf_chunked_sharded with bounds, else ivf_chunked
template <typename E, int VEC>
cudaError_t launch_chunked(const Args& a, cudaStream_t s) {
  const size_t smem = static_cast<size_t>(a.chunk) * sizeof(float);
  if (a.chunk < 1 || smem > SMEM_MAX || a.tmp_v == nullptr ||
      a.tmp_i == nullptr ||
      reinterpret_cast<uintptr_t>(a.q) % 16 != 0)
    return cudaErrorInvalidValue;
  const auto* q = static_cast<const E*>(a.q);
  const auto* bk = static_cast<const E*>(a.buckets);
  const int grid = a.b * a.nprobe;
  cudaError_t err;
  if (a.bounds == nullptr) {
    auto kern = ivf_chunked<E, VEC>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, s>>>(a.sel, a.en, q, a.qs, bk, a.bscale,
                                     a.valid, a.nprobe, a.c, a.cap, a.d, a.k,
                                     a.chunk, a.tmp_v, a.tmp_i, a.vals,
                                     a.idx);
  } else {
    auto kern = ivf_chunked_sharded<E, VEC>;
    if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
    kern<<<grid, THREADS, smem, s>>>(a.sel, a.en, q, a.qs, bk, a.bscale,
                                     a.valid, a.bucket_rows, a.bounds,
                                     a.n_shards, a.nprobe, a.c, a.cap, a.d,
                                     a.k, a.chunk, a.tmp_v, a.tmp_i, a.vals,
                                     a.idx);
  }
  return cudaGetLastError();
}

template <typename E, int VEC>
cudaError_t launch(const Args& a, cudaStream_t s) {
  if (a.design == WARP) return launch_warp<E, VEC>(a, s);
  if (a.design == CHUNKED) return launch_chunked<E, VEC>(a, s);
  // scores, query, and for the sharded writer its finalists (block_smem)
  const size_t smem =
      a.bounds == nullptr
          ? query_offset(a.cap) + static_cast<size_t>(a.d) * sizeof(E)
          : top_offset(a.cap, a.d, sizeof(E)) +
                static_cast<size_t>(a.k) * (sizeof(float) + sizeof(int));
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
         a.k < 1 || a.n_shards < 1 || (a.design == WARP && a.k > K_MAX) ||
         (a.design != BLOCK && a.design != WARP && a.design != CHUNKED);
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

// design 0 "block", 1 "warp" (cap <= 64, k <= 64); vals/slots: (b, nprobe,
// k) fp32/int32. Each entry point returns the cudaError_t of the launch.
int ann_topk_ivf_launch(const void* sel_, const void* enabled, const void* q,
                        const void* buckets, const void* bucket_valid, int b,
                        int nprobe, int c, int cap, int d, int k, int design,
                        void* vals, void* slots, void* stream) {
  return launch_f32(
      {static_cast<const int*>(sel_), static_cast<const int*>(enabled), q,
       nullptr, buckets, nullptr, static_cast<const uint8_t*>(bucket_valid),
       nullptr, nullptr, 1, b, nprobe, c, cap, d, k, design,
       static_cast<float*>(vals), static_cast<int*>(slots)},
      stream);
}

int ann_topk_ivf_quant_launch(const void* sel_, const void* enabled,
                              const void* qq, const void* q_scales,
                              const void* buckets_q, const void* bucket_scale,
                              const void* bucket_valid, int b, int nprobe,
                              int c, int cap, int d, int k, int design,
                              void* vals, void* slots, void* stream) {
  return launch_i8(
      {static_cast<const int*>(sel_), static_cast<const int*>(enabled), qq,
       static_cast<const float*>(q_scales), buckets_q,
       static_cast<const float*>(bucket_scale),
       static_cast<const uint8_t*>(bucket_valid), nullptr, nullptr, 1, b,
       nprobe, c, cap, d, k, design, static_cast<float*>(vals),
       static_cast<int*>(slots)},
      stream);
}

// bucket_rows (c, cap) int32, bounds (s + 1,) int32; design as above;
// vals/rows: (s, b, nprobe, k) fp32/int32.
int ann_topk_ivf_sharded_launch(const void* sel_, const void* enabled,
                                const void* q, const void* buckets,
                                const void* bucket_valid,
                                const void* bucket_rows, const void* bounds,
                                int s, int b, int nprobe, int c, int cap,
                                int d, int k, int design, void* vals,
                                void* rows, void* stream) {
  return launch_f32(
      {static_cast<const int*>(sel_), static_cast<const int*>(enabled), q,
       nullptr, buckets, nullptr, static_cast<const uint8_t*>(bucket_valid),
       static_cast<const int*>(bucket_rows), static_cast<const int*>(bounds),
       s, b, nprobe, c, cap, d, k, design, static_cast<float*>(vals),
       static_cast<int*>(rows)},
      stream);
}

int ann_topk_ivf_quant_sharded_launch(
    const void* sel_, const void* enabled, const void* qq,
    const void* q_scales, const void* buckets_q, const void* bucket_scale,
    const void* bucket_valid, const void* bucket_rows, const void* bounds,
    int s, int b, int nprobe, int c, int cap, int d, int k, int design,
    void* vals, void* rows, void* stream) {
  return launch_i8(
      {static_cast<const int*>(sel_), static_cast<const int*>(enabled), qq,
       static_cast<const float*>(q_scales), buckets_q,
       static_cast<const float*>(bucket_scale),
       static_cast<const uint8_t*>(bucket_valid),
       static_cast<const int*>(bucket_rows), static_cast<const int*>(bounds),
       s, b, nprobe, c, cap, d, k, design, static_cast<float*>(vals),
       static_cast<int*>(rows)},
      stream);
}

// Design "chunked", every scan: quant 0 (fp32: q, buckets; q_scales and
// bucket_scale null) or 1 (int8 with both scales); bucket_rows and bounds
// null for the unsharded scans, else as above (s shards). q on a 16-byte
// boundary. chunk: slots a chunk (chunk * 4 bytes of shared memory);
// tmp_v/tmp_i: (b, nprobe, k) fp32/int32 scratch; vals/idx as the other
// entry points give them. Returns the cudaError_t of the launch.
int ann_topk_ivf_chunked_launch(int quant, const void* sel_,
                                const void* enabled, const void* q,
                                const void* q_scales, const void* buckets,
                                const void* bucket_scale,
                                const void* bucket_valid,
                                const void* bucket_rows, const void* bounds,
                                int s, int b, int nprobe, int c, int cap,
                                int d, int k, int chunk, void* tmp_v,
                                void* tmp_i, void* vals, void* idx,
                                void* stream) {
  Args a{static_cast<const int*>(sel_), static_cast<const int*>(enabled), q,
         static_cast<const float*>(q_scales), buckets,
         static_cast<const float*>(bucket_scale),
         static_cast<const uint8_t*>(bucket_valid),
         static_cast<const int*>(bucket_rows), static_cast<const int*>(bounds),
         s, b, nprobe, c, cap, d, k, CHUNKED, static_cast<float*>(vals),
         static_cast<int*>(idx), chunk, static_cast<float*>(tmp_v),
         static_cast<int*>(tmp_i)};
  return quant ? launch_i8(a, stream) : launch_f32(a, stream);
}

const char* ann_topk_ivf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
