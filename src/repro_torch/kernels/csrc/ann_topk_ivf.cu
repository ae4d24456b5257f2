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
//   the same on every design: after the real scores come the invalid
//   slots in ascending order, then the pads cap, cap + 1, ...; a probe
//   that scans nothing writes slots 0 .. k - 1 ("block": the argmax passes
//   take NEG entries lowest slot first, then write slot p once the cap
//   entries are taken; "warp": the network ranks NEG at slot i after NEG
//   at every lower slot, and write_disabled writes slot p; "grouped": a
//   slot past cap is a NEG entry at its own slot).
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
//   entry is NEG / -1. The cut points ascend; a repeated one is an empty
//   shard, and a cluster outside [bounds[0], bounds[S]) has no owner (its
//   probes' columns are NEG / -1 throughout). This is the reference's
//   per-shard loop (mask the probes to the shard's range, scan its slice,
//   map slots to global rows) in one call.
//
// What bounds it on an H100: a scan must read, for each distinct probed
// bucket, its cap-byte valid mask and its valid slots, D*4 (fp32) or D + 4
// (int8 and the slot's scale) bytes each, and do 2*D operations per valid
// slot of each enabled probe. At B = 16 and nprobe = 64 over C = 512
// buckets the union is most of the buckets, so the bytes bound it (fp32:
// 3.35 TB/s against 67 TFLOP/s of CUDA-core rate; int8: against 1979 TOP/s).
// Sharded, the owner alone reads the bucket, so the bytes are the
// unsharded scan's plus the S-fold stack of finalists.
//
// Four designs; the wrappers' one pick_design sends buckets of at most
// WARP_CAP = 64 slots (every bucket the engine lays out) at k <= 64 to
// "warp". Above that every scan, unsharded (kernels 3 and 4) or sharded
// (kernel 5), takes "grouped", whatever the cap, D, k or S. "block" and
// "chunked" stay launchable for every scan as the designs "grouped" is
// held and timed against.
//
// Design "grouped" (ivf_grouped_probes, then ivf_grouped; every scan above
// 64 slots). "block" and "chunked" lose to two faults: one CTA
// per (query, probe), so a bucket that several queries probe is read once
// per query (at B = 16 x nprobe 64 over 512 buckets, 1024 reads of
// 12.6 MB for about 451 distinct buckets; reuse in the 50 MB L2 only by
// chance), and where there are few probes one CTA streams a whole bucket
// by itself (B = 1; cap 65,536); and every slot is read and scored, valid
// or not. "grouped" reads each probed bucket once for all the probes on
// it, splits it over CTAs by tiles of slots, and reads only valid rows:
// 1. ivf_grouped_probes (one CTA of 1024 threads) groups the enabled,
//    in-range probes by bucket with a counting sort over C in device
//    scratch: counts, their exclusive scan, and up to QB probes a group
//    (a bucket with more probes forms more groups); it zeroes the groups'
//    tickets, and writes NEG and slot p for every disabled or
//    out-of-range probe, as write_disabled does, a warp a probe. The
//    order of probes within a bucket comes from atomics and may differ
//    between calls; no output depends on it.
// 2. ivf_grouped<E, VEC, QB>: one CTA per (group, tile of T slots), T a
//    multiple of the scorer's row step (8 warps x ROWS). The CTA stages
//    the group's queries in shared memory (or, one query too wide for
//    it, reads it in place), compacts the tile's valid slots with one
//    ballot a warp, and scores each valid row once against all of the
//    group's queries: dot.cuh's QB path, whose every (row, query) sum is
//    the same fmaf chain and xor tree as "block"'s one-query path, so
//    every score is bitwise "block"'s (int8: exact int32 dots through
//    dot::rescale). Invalid slots, and slots past cap in the last tile,
//    are NEG at their own slot. Each (probe, tile) keeps its min(k, T)
//    best in ranks_before order (select.cuh's warp selections, a warp a
//    probe; above K_MAX block_topk, the whole block a probe), straight
//    into the probe's (k,) row where the bucket is one tile (then NEG and
//    slot p past T), else into a list of kt = min(k, T) in scratch.
// 3. The merge: the CTA that takes a group's last ticket merges each of
//    its probes' tile lists. A ticket, and not a level launch over
//    select.cuh::merge_pairs, because a level launch waits for every
//    group's scan and costs a launch a level (log2 of the tile count),
//    where the last CTA merges a group while the others still scan; the
//    call stays at two CUDA launches. Where the lists hold k entries each
//    (T >= k) and their network fits shared memory (shared_merge), one
//    network (merge_lists): the largest k-th entry of the lists is a
//    value Lv with k entries at or above it, so no finalist is below it,
//    and each list holds all of its entries above it (fewer than k);
//    those go to shared memory and one bitonic network sorts them
//    (ranks_before), of which the first k are finalists; where fewer than
//    k are above Lv the rest are entries equal to Lv in list order, which
//    is slot order (tiles ascend). Else (T < k, or more lists than the
//    network takes) the same CTA merges them by levels in device memory
//    (merge_levels): select.cuh::merge_path two lists at a time, each cut
//    to k, one block barrier a level, a pad on the last level NEG at its
//    own position. Either way ties go to the lower slot, and the NEG
//    entries and pads come out as "block" writes them: invalid slots
//    ascending, then cap, cap + 1, ...
// The result depends neither on T nor on QB nor on the order within a
// group. Shared memory: QB x T scores, T compacted slots, the queries and
// the warps' selection buffers, and the network where the lists merge
// there; the wrapper (ann_topk_ivf.py::grouped_plan) grows T until the
// network takes the bucket, up to the largest T whose scan fits with the
// query read in place, then takes QB down, then reads a query in place,
// until they fit. No cap, D, k, B or nprobe is refused: past the network
// the merge runs in device memory, past the largest tile the lists hold T
// entries each. Scratch: the tile lists (P x ntiles x kt pairs) and the
// levels' (2 level_entries pairs a probe).
// Sharded (kernel 5: the same two launches, bounds given): step 1 groups
// the probes by their global bucket and takes only those whose bucket a
// shard owns (the shards are contiguous cluster ranges, so a bucket has
// one owner); it writes the whole (S, k) column of every other probe NEG
// / -1, a warp a probe. In step 2 a probe's finalists go to its owner's
// row of the stacks (straight from the tile for a one-tile bucket, from
// the last CTA's merge otherwise), whose CTA then maps their slots to
// global rows (bucket_rows; -1 where the value is NEG); the tile-0 CTA of
// each group writes its probes' other S - 1 rows NEG / -1. No CTA's share
// of the writes grows with S x B x nprobe, and the scratch does not grow
// with S. Every score and order is the unsharded path's, so the stacks
// are bitwise "block"'s and "chunked"'s, and at S = 1 kernel 3's
// "grouped" output after the slot -> row map.

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
// Design "chunked" (ivf_chunked, ivf_chunked_sharded; no dispatch takes it
// since every scan above 64 slots takes "grouped", and it takes buckets
// whose cap scores and query overflow shared memory): "block" over chunks
// of the bucket that fit. One CTA per (query, probe) reads its query in place
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
enum Design { BLOCK = 0, WARP = 1, CHUNKED = 2, GROUPED = 3 };
constexpr int GROUP_THREADS = 1024;        // "grouped": the grouping CTA
constexpr int GROUP_ROWS = WARPS * ROWS;   // "grouped": the scorer's row step

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
  // R rows against the first nq of QB queries (sq: QB x d)
  template <int R, int QB>
  static __device__ __forceinline__ void rows_q(const E* const (&erow)[R],
                                                const E* sq, int d, int nq,
                                                int lane, Acc (&acc)[R][QB]) {
    dot::warp_dot<E, VEC, R, QB>(erow, sq, d, nq, lane, acc);
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
  template <int R, int QB>
  static __device__ __forceinline__ void rows_q(
      const int8_t* const (&erow)[R], const int8_t* sq, int d, int nq,
      int lane, Acc (&acc)[R][QB]) {
    dot::warp_dot_i8<VEC, R, QB>(erow, sq, d, nq, lane, acc);
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

// ------------------------------------------------------------ "grouped"

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~static_cast<size_t>(15);
}

// the warps' buffers of select.cuh's threshold pass (warp_tile_topk)
constexpr size_t GROUP_TBUF = sel::tile_smem<THREADS>();
// the dynamic shared memory a CTA of "grouped" may take: SMEM_MAX less
// 1 KB for its static variables (the group's probes, the merge's)
constexpr size_t GROUPED_SMEM = SMEM_MAX - 1024;

// The int32 scratch of "grouped", in this order: per bucket its probe
// count, their exclusive scan (then the placement cursor) and its first
// group; the probes ordered by bucket; per group its bucket, its first
// probe in that order, its probe count and its ticket; the group count.
struct GroupScratch {
  int *cnt, *start, *gofs, *order, *gbucket, *gfirst, *gcount, *ticket,
      *n_groups;
  __host__ __device__ GroupScratch(int* s, int c, int p, int g)
      : cnt(s), start(s + c), gofs(s + 2 * c), order(s + 3 * c),
        gbucket(order + p), gfirst(gbucket + g), gcount(gfirst + g),
        ticket(gcount + g), n_groups(ticket + g) {}
};

// Block-wide exclusive scan of in[0..n) into out[0..n) (they may be the
// same array); returns the total to every thread. sh: NT / 32 + 1 ints of
// shared scratch. Ends with a block barrier.
template <int NT>
__device__ int block_scan(const int* in, int* out, int n, int* sh) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < n; base += NT) {
    const int i = base + threadIdx.x;
    const int x = i < n ? in[i] : 0;
    int incl = x;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(sel::FULL, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) sh[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const int w = lane < NW ? sh[lane] : 0;
      int wi = w;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(sel::FULL, wi, off);
        if (lane >= off) wi += y;
      }
      __syncwarp();
      if (lane < NW) sh[lane] = wi - w;
      if (lane == NW - 1) sh[NW] = wi;
    }
    __syncthreads();
    if (i < n) out[i] = carry + sh[warp] + incl - x;
    carry += sh[NW];
    __syncthreads();
  }
  return carry;
}

// The largest index i in [0, n) with a[i] <= x (a ascending, a[0] <= x).
__device__ __forceinline__ int last_at_most(const int* a, int n, int x) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a[mid] <= x) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// The shard of "grouped"'s sharded writer that owns bucket c: the s with
// bounds[s] <= c < bounds[s + 1], or -1 where none does. The cut points
// ascend (a repeated one is an empty shard), so at most one shard owns c
// and it is the last s with bounds[s] <= c. The unsharded scan (bounds
// null) writes every bucket's probes at "shard" 0.
__device__ __forceinline__ int owner_of(const int* bounds, int n_shards,
                                        int c) {
  if (bounds == nullptr) return 0;
  if (c < bounds[0]) return -1;
  const int s = last_at_most(bounds, n_shards, c);
  return c < bounds[s + 1] ? s : -1;
}

// Does "grouped" scan probe p: enabled, its bucket in [0, C) and owned?
__device__ __forceinline__ bool grouped_probe(const int* sel_, const int* en,
                                              int p, int c_count,
                                              const int* bounds,
                                              int n_shards) {
  const int c = sel_[p];
  return en[p] != 0 && c >= 0 && c < c_count &&
         owner_of(bounds, n_shards, c) >= 0;
}

// Step 1 of "grouped", one CTA: the probes it scans (grouped_probe)
// grouped by bucket (counting sort over the C global buckets), at most qb
// probes a group; the groups' tickets zeroed; every other probe's whole
// column written, a warp a probe: NEG and slot p (unsharded), or NEG / -1
// at every one of the S shards.
__global__ void __launch_bounds__(GROUP_THREADS)
ivf_grouped_probes(const int* __restrict__ sel_, const int* __restrict__ en,
                   const int* __restrict__ bounds, int n_shards,
                   int n_probes, int c_count, int qb, int g_max, int k,
                   int* __restrict__ scratch, float* __restrict__ vals,
                   int* __restrict__ slots) {
  __shared__ int sh[GROUP_THREADS / 32 + 1];
  const GroupScratch gs(scratch, c_count, n_probes, g_max);
  const int lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < c_count; i += GROUP_THREADS) gs.cnt[i] = 0;
  for (int i = threadIdx.x; i < g_max; i += GROUP_THREADS) gs.ticket[i] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < n_probes; p += GROUP_THREADS)
    if (grouped_probe(sel_, en, p, c_count, bounds, n_shards))
      atomicAdd(gs.cnt + sel_[p], 1);
  const int column = bounds == nullptr ? k : n_shards * k;
  for (int p = threadIdx.x >> 5; p < n_probes; p += GROUP_THREADS / 32) {
    if (grouped_probe(sel_, en, p, c_count, bounds, n_shards)) continue;
    for (int e = lane; e < column; e += 32) {
      const int s = e / k;
      const int i = e - s * k;
      const size_t o = (static_cast<size_t>(s) * n_probes + p) * k + i;
      vals[o] = sel::NEG;
      slots[o] = bounds == nullptr ? i : -1;
    }
  }
  __syncthreads();
  block_scan<GROUP_THREADS>(gs.cnt, gs.start, c_count, sh);
  for (int c = threadIdx.x; c < c_count; c += GROUP_THREADS)
    gs.gofs[c] = (gs.cnt[c] + qb - 1) / qb;
  __syncthreads();
  const int total = block_scan<GROUP_THREADS>(gs.gofs, gs.gofs, c_count, sh);
  for (int c = threadIdx.x; c < c_count; c += GROUP_THREADS) {
    const int n = gs.cnt[c];
    for (int i = 0; i * qb < n; ++i) {
      const int g = gs.gofs[c] + i;
      gs.gbucket[g] = c;
      gs.gfirst[g] = gs.start[c] + i * qb;
      gs.gcount[g] = min(qb, n - i * qb);
    }
  }
  if (threadIdx.x == 0) *gs.n_groups = total;
  __syncthreads();  // start becomes the placement cursor
  for (int p = threadIdx.x; p < n_probes; p += GROUP_THREADS)
    if (grouped_probe(sel_, en, p, c_count, bounds, n_shards))
      gs.order[atomicAdd(gs.start + sel_[p], 1)] = p;
}

// Entries of a power-of-two network at least n long (1 for n = 0).
__host__ __device__ inline size_t pow2_at_least(size_t n) {
  size_t p2 = 1;
  while (p2 < n) p2 <<= 1;
  return p2;
}

// Bytes of "grouped"'s dynamic shared memory for the merge: per list its
// count above Lv, its count at Lv and their scans, the scans' scratch, and
// the entries above Lv (at most k - 1 a list) as (value, slot) pairs over
// a power-of-two network, on 16 bytes.
__host__ __device__ inline size_t merge_bytes(int ntiles, int k) {
  return align16((4 * static_cast<size_t>(ntiles) + WARPS + 1) * sizeof(int)) +
         pow2_at_least(static_cast<size_t>(ntiles) * (k - 1)) *
             (sizeof(float) + sizeof(int));
}

// Does a bucket of ntiles tiles of T slots merge in shared memory
// (merge_lists)? Its lists must hold k entries each (T >= k) and its
// network fit; else its lists merge by levels in device memory
// (merge_levels).
__host__ __device__ inline bool shared_merge(int ntiles, int tile, int k) {
  return tile >= k && merge_bytes(ntiles, k) <= GROUPED_SMEM;
}

// Entries of one half of a probe's level scratch for merge_levels: the
// largest level but the last (which writes the probe's row), of ntiles
// lists of kt; 0 where one level merges them all.
__host__ __device__ inline size_t level_entries(int ntiles, int kt, int k) {
  size_t most = 0;
  for (int cnt = ntiles, len = kt; cnt > 2;) {
    cnt = (cnt + 1) / 2;
    len = 2 * len < k ? 2 * len : k;
    const size_t n = static_cast<size_t>(cnt) * len;
    most = n > most ? n : most;
  }
  return most;
}

// The whole block sorts n (value, slot) pairs in shared memory into
// ranks_before order: a bitonic network over the next power of two, pads
// (-inf, INT_MAX) last (select.cuh::warp_sort, block-wide). Ends with a
// block barrier.
__device__ void block_sort(float* cv, int* cr, int n) {
  const int p2 = static_cast<int>(pow2_at_least(n));
  for (int i = n + threadIdx.x; i < p2; i += THREADS) {
    cv[i] = -INFINITY;
    cr[i] = INT_MAX;
  }
  __syncthreads();
  for (int size = 2; size <= p2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p2 / 2; i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        sel::order_pair(cv[lo], cr[lo], cv[lo + stride], cr[lo + stride],
                        (lo & size) == 0);
      }
      __syncthreads();
    }
  }
}

// The whole block merges one probe's ntiles lists (v, r: list t at t * k,
// each its tile's k best in ranks_before order, slots of one tile below
// the next tile's) into its k best, ov/oi. ms: merge_bytes of shared
// memory. Other CTAs wrote the lists, so they are read through L2.
__device__ void merge_lists(const float* v, const int* r, int ntiles, int k,
                            float* ov, int* oi, unsigned char* ms) {
  __shared__ float red[WARPS];
  __shared__ float lv_s;
  int* above = reinterpret_cast<int*>(ms);
  int* at_lv = above + ntiles;
  int* off_above = at_lv + ntiles;
  int* off_at = off_above + ntiles;
  int* sh = off_at + ntiles;
  const size_t net =
      pow2_at_least(static_cast<size_t>(ntiles) * (k - 1));
  float* cv = reinterpret_cast<float*>(
      ms + align16((4 * static_cast<size_t>(ntiles) + WARPS + 1) *
                   sizeof(int)));
  int* cr = reinterpret_cast<int*>(cv + net);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // Lv: the largest k-th entry of the lists. k entries are at or above
  // it, so no finalist is below it, and a list holds every one of its
  // entries above it (at most k - 1: its k-th is not above Lv).
  float x = -INFINITY;
  for (int t = threadIdx.x; t < ntiles; t += THREADS) {
    x = fmaxf(x, __ldcg(v + static_cast<size_t>(t) * k + k - 1));
    above[t] = 0;
    at_lv[t] = 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(sel::FULL, x, off));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float best = red[0];
    for (int w = 1; w < WARPS; ++w) best = fmaxf(best, red[w]);
    lv_s = best;
  }
  __syncthreads();
  const float lv = lv_s;
  const int m = ntiles * k;
  for (int e = threadIdx.x; e < m; e += THREADS) {
    const float y = __ldcg(v + e);
    if (y > lv) atomicAdd(above + e / k, 1);
    else if (y == lv) atomicAdd(at_lv + e / k, 1);
  }
  __syncthreads();
  const int na = block_scan<THREADS>(above, off_above, ntiles, sh);
  block_scan<THREADS>(at_lv, off_at, ntiles, sh);
  // the entries above Lv (a prefix of each list), sorted: the first k of
  // them are finalists
  for (int e = threadIdx.x; e < m; e += THREADS) {
    const int t = e / k;
    const int i = e - t * k;
    if (i < above[t]) {
      cv[off_above[t] + i] = __ldcg(v + e);
      cr[off_above[t] + i] = __ldcg(r + e);
    }
  }
  if (na > 0) {
    block_sort(cv, cr, na);
    for (int p = threadIdx.x; p < min(k, na); p += THREADS) {
      ov[p] = cv[p];
      oi[p] = cr[p];
    }
  }
  // fewer than k above Lv: the rest are entries at Lv in list order (the
  // lowest slots first). The list whose k-th entry is Lv holds enough of
  // them by itself, and every list before it holds all of its own.
  for (int j = threadIdx.x; j < k - na; j += THREADS) {
    const int t = last_at_most(off_at, ntiles, j);
    const size_t at = static_cast<size_t>(t) * k + above[t] + j - off_at[t];
    ov[na + j] = __ldcg(v + at);
    oi[na + j] = __ldcg(r + at);
  }
  __syncthreads();  // ms is the next probe's
}

// The whole block merges one probe's ntiles lists of kt (v, r: list t at
// t * kt, in ranks_before order) into its k best, ov/oi, in device
// memory: each level merges the lists two by two (select.cuh::merge_path,
// the merge "wide"'s levels run), each cut to k, into one half of the
// probe's level scratch (gv/gr, 2 * level_entries) and the next level
// into the other; the last level writes ov/oi, a pad there NEG at its own
// position. One block barrier a level and no shared memory, so neither k
// nor the tile count is bounded.
__device__ void merge_levels(const float* v, const int* r, int ntiles,
                             int kt, int k, float* gv, int* gr, float* ov,
                             int* oi) {
  const size_t half = level_entries(ntiles, kt, k);
  const float* sv = v;
  const int* sr = r;
  for (int cnt = ntiles, len = kt, level = 0;; ++level) {
    const int ncnt = (cnt + 1) / 2;
    const bool last = ncnt == 1;
    const int nlen = last ? k : (2 * len < k ? 2 * len : k);
    float* dv = last ? ov : gv + (level & 1) * half;
    int* dr = last ? oi : gr + (level & 1) * half;
    for (int e = threadIdx.x; e < ncnt * nlen; e += THREADS) {
      const int o = e / nlen;
      const size_t a0 = 2 * static_cast<size_t>(o) * len;
      sel::merge_path<true>(sv + a0, sr + a0, len, sv + a0 + len,
                            sr + a0 + len, 2 * o + 1 < cnt ? len : 0,
                            e - o * nlen, last, dv[e], dr[e]);
    }
    __syncthreads();
    if (last) return;
    cnt = ncnt;
    len = nlen;
    sv = dv;
    sr = dr;
  }
}

// One warp: the kt best of a tile's m scores s[0..m) (position i is slot
// s0 + i) in ranks_before order into ov/oi; kt <= m. bv, br: the warp's
// TILE_CAP pairs of select.cuh's threshold pass.
__device__ __forceinline__ void tile_best(float* s, int m, int kt, int s0,
                                          float* ov, int* oi, float* bv,
                                          int* br) {
  if (m <= 64) {
    sel::warp_best_of_few(m, kt, [&](int i, float& x, int& xr) {
      x = s[i];
      xr = s0 + i;
    }, ov, oi);
  } else if (kt <= 32) {
    sel::warp_tile_topk(s, m, kt, ov, oi, s0, bv, br);
  } else {
    sel::warp_topk(s, m, kt, ov, oi, s0);
  }
}

// Bytes of "grouped"'s dynamic shared memory for the scan: QB x T scores,
// T compacted slots, the warps' threshold buffers, and (unless read in
// place) QB queries; each part on 16 bytes.
__host__ __device__ inline size_t grouped_scan_bytes(int qb, int tile, int d,
                                                     size_t elem,
                                                     bool qglobal) {
  return align16(static_cast<size_t>(qb) * tile * sizeof(float)) +
         align16(static_cast<size_t>(tile) * sizeof(int)) +
         GROUP_TBUF +
         (qglobal ? 0 : align16(static_cast<size_t>(qb) * d * elem));
}

// The sharded writer's last step, the whole block: in the owner's rows of
// the group's probes (row (owner, bj) at (obase + bj) * k), each
// finalist's slot becomes its global row, srow[slot] (the bucket's
// bucket_rows), or -1 where its value is NEG. The block wrote those rows
// before its last barrier.
__device__ __forceinline__ void slots_to_rows(const float* vals, int* rows,
                                              const int* probe, int nq,
                                              size_t obase, int k,
                                              const int* srow) {
  for (int e = threadIdx.x; e < nq * k; e += THREADS) {
    const int j = e / k;
    const size_t o = (obase + probe[j]) * k + (e - j * k);
    rows[o] = vals[o] > sel::NEG / 2 ? srow[rows[o]] : -1;
  }
}

// Step 2 of "grouped": one CTA per (group g, tile t), blockIdx.x = g *
// ntiles + t; grid CTAs past the group count return at once. Unsharded
// (bounds null) probe bj's finalists go to its (k,) row of vals/slots;
// sharded, to row (owner, bj) of the (S, P, k) stacks, the tile-0 CTA of
// each group writing its probes' other S - 1 rows NEG / -1, and the slots
// become global rows once the row is final.
template <typename E, int VEC, int QB>
__global__ void __launch_bounds__(THREADS)
ivf_grouped(int* __restrict__ scratch, const E* __restrict__ q,
            const float* __restrict__ qs, const E* __restrict__ buckets,
            const float* __restrict__ bscale,
            const uint8_t* __restrict__ valid,
            const int* __restrict__ bucket_rows,
            const int* __restrict__ bounds, int n_shards, int n_probes,
            int nprobe, int c_count, int cap, int d, int k, int tile,
            int ntiles, int g_max, int qglobal, float* __restrict__ fv,
            int* __restrict__ fr, float* __restrict__ gv,
            int* __restrict__ gr, float* __restrict__ vals,
            int* __restrict__ slots) {
  using S = Scorer<E, VEC>;
  constexpr bool kScaled = std::is_same_v<E, int8_t>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int probe[QB];
  __shared__ int qrow[QB];
  __shared__ float qscale[QB];
  __shared__ int nrows;
  __shared__ int last;
  const GroupScratch gs(scratch, c_count, n_probes, g_max);
  const int g = blockIdx.x / ntiles;
  const int t = blockIdx.x - g * ntiles;
  if (g >= *gs.n_groups) return;  // the whole block
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = gs.gbucket[g];
  const int first = gs.gfirst[g];
  const int nq = gs.gcount[g];
  float* sc = reinterpret_cast<float*>(smem);  // [nq][tile]
  size_t off = align16(static_cast<size_t>(QB) * tile * sizeof(float));
  int* rows = reinterpret_cast<int*>(smem + off);  // the tile's valid slots
  off += align16(static_cast<size_t>(tile) * sizeof(int));
  unsigned char* tbuf = smem + off;
  off += GROUP_TBUF;
  E* sq = reinterpret_cast<E*>(smem + off);  // [nq][d] unless qglobal
  if (threadIdx.x < nq) {
    const int bj = gs.order[first + threadIdx.x];
    probe[threadIdx.x] = bj;
    qrow[threadIdx.x] = bj / nprobe;
    qscale[threadIdx.x] = kScaled ? qs[bj / nprobe] : 1.f;
  }
  if (threadIdx.x == 0) nrows = 0;
  const int s0 = t * tile;
  const int m = min(tile, cap - s0);
  const size_t base = static_cast<size_t>(c) * cap;
  // the row of (owner, bj) is at (obase + bj) * k; every grouped probe's
  // bucket has an owner (ivf_grouped_probes)
  const int owner = owner_of(bounds, n_shards, c);
  const size_t obase = static_cast<size_t>(owner) * n_probes;
  for (int i = threadIdx.x; i < nq * tile; i += THREADS) sc[i] = sel::NEG;
  __syncthreads();
  if (bounds != nullptr && t == 0) {
    // the group's probes at every other shard: NEG / -1
    const int column = n_shards * k;
    for (int e = threadIdx.x; e < nq * column; e += THREADS) {
      const int j = e / column;
      const int s = (e - j * column) / k;
      if (s == owner) continue;
      const size_t o = (static_cast<size_t>(s) * n_probes + probe[j]) * k +
                       (e - j * column - s * k);
      vals[o] = sel::NEG;
      slots[o] = -1;
    }
  }
  if (!qglobal) {
    for (int j = 0; j < nq; ++j) {
      const E* src = q + static_cast<size_t>(qrow[j]) * d;
      for (int i = threadIdx.x; i < d; i += THREADS) sq[j * d + i] = src[i];
    }
  }
  const E* qsrc = qglobal ? q + static_cast<size_t>(qrow[0]) * d : sq;
  // the valid slots of the tile, compacted (any order: each score lands
  // at its own position)
  const unsigned below = (1u << lane) - 1u;
  for (int i0 = 0; i0 < m; i0 += THREADS) {
    const int i = i0 + threadIdx.x;
    const bool ok = i < m && valid[base + s0 + i] != 0;
    const unsigned ball = __ballot_sync(sel::FULL, ok);
    int at = 0;
    if (lane == 0 && ball != 0) at = atomicAdd(&nrows, __popc(ball));
    at = __shfl_sync(sel::FULL, at, 0);
    if (ok) rows[at + __popc(ball & below)] = i;
  }
  __syncthreads();
  const int n = nrows;
  const E* bucket = buckets + (base + s0) * d;
  const float* bs = kScaled ? bscale + base + s0 : nullptr;
  for (int r0 = warp * ROWS; r0 < n; r0 += WARPS * ROWS) {
    const E* erow[ROWS];
    int pos[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      pos[r] = rows[min(r0 + r, n - 1)];
      erow[r] = bucket + static_cast<size_t>(pos[r]) * d;
    }
    typename S::Acc acc[ROWS][QB];
    S::template rows_q<ROWS, QB>(erow, qsrc, d, nq, lane, acc);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r0 + r < n) {
#pragma unroll
          for (int j = 0; j < QB; ++j)
            if (j < nq)
              sc[j * tile + pos[r]] = S::finish(
                  acc[r][j], kScaled ? bs + pos[r] : nullptr, qscale[j]);
        }
      }
    }
  }
  __syncthreads();
  // each probe's best of the tile: its (k,) row where the bucket is one
  // tile (NEG and slot p past T), else its list of this tile, kt long; a
  // warp a probe, or above K_MAX the whole block a probe at a time (kt
  // argmax passes by one warp would be the floor)
  const int kt = min(k, tile);
  const bool by_block = kt > K_MAX;
  for (int j = by_block ? 0 : warp; j < nq; j += by_block ? 1 : WARPS) {
    const int bj = probe[j];
    const size_t at = ntiles == 1
                          ? (obase + bj) * k
                          : (static_cast<size_t>(bj) * ntiles + t) * kt;
    float* ov = (ntiles == 1 ? vals : fv) + at;
    int* oi = (ntiles == 1 ? slots : fr) + at;
    if (by_block) {
      sel::block_topk<THREADS>(sc + j * tile, tile, kt, ov, oi,
                               reinterpret_cast<float*>(tbuf),
                               reinterpret_cast<int*>(tbuf) + WARPS, s0);
    } else {
      tile_best(sc + j * tile, tile, kt, s0, ov, oi,
                reinterpret_cast<float*>(tbuf) + warp * sel::TILE_CAP,
                reinterpret_cast<int*>(tbuf) +
                    (WARPS + warp) * sel::TILE_CAP);
    }
    if (ntiles == 1) {
      const int i0 = by_block ? threadIdx.x : lane;
      for (int p = kt + i0; p < k; p += by_block ? THREADS : 32) {
        ov[p] = sel::NEG;
        oi[p] = p;
      }
    }
  }
  if (ntiles == 1) {
    if (bounds != nullptr) {
      __syncthreads();
      slots_to_rows(vals, slots, probe, nq, obase, k, bucket_rows + base);
    }
    return;
  }
  // the last CTA of the group merges its probes' lists
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(gs.ticket + g, 1) == ntiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const bool in_smem = shared_merge(ntiles, tile, k);
  const size_t levels = 2 * level_entries(ntiles, kt, k);
  for (int j = 0; j < nq; ++j) {
    const size_t bj = static_cast<size_t>(probe[j]);
    const size_t list = bj * ntiles * kt;
    const size_t at = (obase + bj) * k;
    if (in_smem) {
      merge_lists(fv + list, fr + list, ntiles, k, vals + at, slots + at,
                  smem);
    } else {
      merge_levels(fv + list, fr + list, ntiles, kt, k, gv + bj * levels,
                   gr + bj * levels, vals + at, slots + at);
    }
  }
  // each merge ends with a block barrier
  if (bounds != nullptr)
    slots_to_rows(vals, slots, probe, nq, obase, k, bucket_rows + base);
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
  float* tmp_v = nullptr;  // "grouped": the tile lists, (b, nprobe, ntiles, kt)
  int* tmp_i = nullptr;
  int qb = 0;       // "grouped": probes a group (1 or 4), slots a tile,
  int tile = 0;     // the grid's groups, queries read in place, and the
  int groups = 0;   // int32 scratch (GroupScratch::ints)
  int qglobal = 0;
  int* scratch = nullptr;
  float* lev_v = nullptr;  // "grouped": merge_levels' scratch, (b, nprobe,
  int* lev_i = nullptr;    // 2 * level_entries)
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

// "grouped": ivf_grouped_probes, then ivf_grouped<E, VEC, QB>
template <typename E, int VEC, int QB>
cudaError_t launch_grouped_qb(const Args& a, cudaStream_t s) {
  const int n_probes = a.b * a.nprobe;
  const int ntiles = (a.cap + a.tile - 1) / a.tile;
  const size_t scan =
      grouped_scan_bytes(QB, a.tile, a.d, sizeof(E), a.qglobal != 0);
  const bool in_smem = shared_merge(ntiles, a.tile, a.k);
  const size_t merge = ntiles > 1 && in_smem ? merge_bytes(ntiles, a.k) : 0;
  const size_t smem = scan > merge ? scan : merge;
  const int kt = a.k < a.tile ? a.k : a.tile;
  const size_t grid = static_cast<size_t>(a.groups) * ntiles;
  if (smem > GROUPED_SMEM || grid > INT_MAX || a.groups < 1 ||
      (ntiles > 1 && (a.tmp_v == nullptr || a.tmp_i == nullptr)) ||
      (ntiles > 1 && !in_smem && level_entries(ntiles, kt, a.k) > 0 &&
       (a.lev_v == nullptr || a.lev_i == nullptr)) ||
      (a.qglobal && (QB != 1 || reinterpret_cast<uintptr_t>(a.q) % 16 != 0)))
    return cudaErrorInvalidValue;
  ivf_grouped_probes<<<1, GROUP_THREADS, 0, s>>>(
      a.sel, a.en, a.bounds, a.n_shards, n_probes, a.c, QB, a.groups, a.k,
      a.scratch, a.vals, a.idx);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = ivf_grouped<E, VEC, QB>;
  if ((err = allow_smem(kern, smem)) != cudaSuccess) return err;
  kern<<<static_cast<unsigned>(grid), THREADS, smem, s>>>(
      a.scratch, static_cast<const E*>(a.q), a.qs,
      static_cast<const E*>(a.buckets), a.bscale, a.valid, a.bucket_rows,
      a.bounds, a.n_shards, n_probes, a.nprobe, a.c, a.cap, a.d, a.k, a.tile,
      ntiles, a.groups, a.qglobal, a.tmp_v, a.tmp_i, a.lev_v, a.lev_i,
      a.vals, a.idx);
  return cudaGetLastError();
}

// "grouped", unsharded (bounds null) or with the sharded writer
template <typename E, int VEC>
cudaError_t launch_grouped(const Args& a, cudaStream_t s) {
  if (a.scratch == nullptr || a.tile < GROUP_ROWS ||
      a.tile % GROUP_ROWS != 0 ||
      (a.bounds != nullptr && a.bucket_rows == nullptr))
    return cudaErrorInvalidValue;
  switch (a.qb) {
    case 1: return launch_grouped_qb<E, VEC, 1>(a, s);
    case 4: return launch_grouped_qb<E, VEC, 4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename E, int VEC>
cudaError_t launch(const Args& a, cudaStream_t s) {
  if (a.design == WARP) return launch_warp<E, VEC>(a, s);
  if (a.design == GROUPED) return launch_grouped<E, VEC>(a, s);
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
         (a.design != BLOCK && a.design != WARP && a.design != CHUNKED &&
          a.design != GROUPED);
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
// "chunked" and "grouped" have entry points of their own, below.
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

// Design "grouped", every scan: quant 0 (fp32: q, buckets; q_scales and
// bucket_scale null) or 1 (int8 with both scales); bucket_rows and bounds
// null for the unsharded scans, else as the sharded entry points take
// them (s shards). qb: probes a group (1 or 4); tile: slots a tile (a
// multiple of 32); groups: the grid's groups, at least the groups any sel
// can make (min(P, min(P, c) + P / qb) for P = b * nprobe probes);
// qglobal: read the query in place (qb 1, q on a 16-byte boundary);
// scratch: 3 c + P + 4 groups + 1 int32 (GroupScratch); tmp_v/tmp_i: (b,
// nprobe, ntiles, min(k, tile)) fp32/int32 tile lists (null for one
// tile); lev_v/lev_i: (b, nprobe, 2 * level_entries) fp32/int32 for
// merge_levels (null where the lists merge in shared memory,
// shared_merge, or in one level); none of them grows with s. vals/idx as
// the other entry points give them. Returns the cudaError_t of the
// launches.
int ann_topk_ivf_grouped_launch(int quant, const void* sel_,
                                const void* enabled, const void* q,
                                const void* q_scales, const void* buckets,
                                const void* bucket_scale,
                                const void* bucket_valid,
                                const void* bucket_rows, const void* bounds,
                                int s, int b, int nprobe, int c, int cap,
                                int d, int k, int qb, int tile, int groups,
                                int qglobal, void* scratch, void* tmp_v,
                                void* tmp_i, void* lev_v, void* lev_i,
                                void* vals, void* idx, void* stream) {
  Args a{static_cast<const int*>(sel_), static_cast<const int*>(enabled), q,
         static_cast<const float*>(q_scales), buckets,
         static_cast<const float*>(bucket_scale),
         static_cast<const uint8_t*>(bucket_valid),
         static_cast<const int*>(bucket_rows), static_cast<const int*>(bounds),
         s, b, nprobe, c, cap, d, k, GROUPED, static_cast<float*>(vals),
         static_cast<int*>(idx), 0, static_cast<float*>(tmp_v),
         static_cast<int*>(tmp_i), qb, tile, groups, qglobal,
         static_cast<int*>(scratch), static_cast<float*>(lev_v),
         static_cast<int*>(lev_i)};
  return quant ? launch_i8(a, stream) : launch_f32(a, stream);
}

const char* ann_topk_ivf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
