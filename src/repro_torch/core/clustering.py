"""Clustered (IVF-style) stage-1 routing — DESIGN.md §12.

The paper's Seri front end is a Faiss IVF index; until this module our
stage 1 brute-force scanned every row of the embedding matrix on every
lookup, so stage-1 cost grew linearly with the cache and became the
bottleneck at large N (the MeanCache observation). This module makes
stage 1 sublinear with a clustered two-level index:

  * **route** — score the query block against ``n_clusters`` centroids
    (spherical mini-batch k-means over the cached embeddings) and select
    the ``nprobe`` nearest clusters per query;
  * **scan** — gather only the member rows of the selected clusters and
    run the usual masked top-k over that union.

Per query the scan touches ``n_clusters + nprobe·N/n_clusters`` rows in
expectation instead of N — minimized at ``n_clusters ≈ sqrt(nprobe·N)``.

The router is *free-list aware*: it composes with
:class:`~repro.core.seri.RowIndex` row recycling. ``note_add`` buckets a
new row under its nearest centroid immediately (no rebuild), and
``note_remove`` unbuckets freed rows, so routing stays correct through
insert/evict/demote/promote churn. Centroids drift as the cached
distribution shifts, so they are **refreshed on a mutation budget**
(``refresh_every`` adds+removes): a few seeded mini-batch k-means steps
followed by one full re-bucketing pass — amortized
O(N·C·D / refresh_every) per mutation.

``nprobe=None`` probes every non-empty cluster: the scanned set is then
exactly the active row set (ascending row order, like the brute-force
scan), which is what makes the brute-vs-IVF parity gates bit-exact.

Everything is seeded and counter-driven — same seed + same mutation
sequence ⇒ same centroids, buckets, and retrieval results — so the
benchmark suite's same-seed bit-identity gates extend to clustered runs.

In the port everything but the kernel layouts
(:meth:`ClusterRouter.kernel_layout` and
:meth:`ClusterRouter.kernel_shard_buckets`) is the reference's numpy code,
unchanged: the same mutation sequence gives bitwise the same centroids,
assignments, member lists and shard bounds. The kernel layout is built on
the index's device from its mirror, and the shard layout adds only its
bounds to it; with one device per shard (the reference's ``shard_map``
mode, ``kernels/ann_topk_sharded.shard_devices``) each device keeps only
its own shard's slice instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.kernels.ann_topk_sharded import ShardPart, shard_devices

NEG = -3.0e38  # masked-score sentinel shared with the ANN kernels

_ASSIGN_CHUNK = 8192   # rows per chunk in the full re-bucketing pass
_MIGRATE_CHUNK = 4096  # rows per cross-shard migration chunk (rebalance)


@dataclasses.dataclass
class ClusterConfig:
    """Knobs for one :class:`ClusterRouter` (one per index tier)."""

    n_clusters: int = 64
    # clusters probed per query; None = all non-empty clusters (the
    # brute-force-parity mode: same candidate set, same tie order)
    nprobe: Optional[int] = 8
    refresh_every: int = 1024   # mutations (adds+removes) per refresh
    min_train: int = 256        # active rows before the first training
    batch_size: int = 1024      # mini-batch rows per k-means step
    iters: int = 4              # mini-batch steps per refresh
    seed: int = 0
    # mesh shards the index is partitioned over (DESIGN.md §13): each
    # shard owns a CONTIGUOUS cluster range and scans only its members.
    # 1 = unsharded (every pre-§13 path unchanged). Sharding never
    # touches training or routing — centroids, assignments, and the
    # routed candidate set are shard-count invariant by construction.
    n_shards: int = 1


@dataclasses.dataclass
class KernelLayout:
    """The routed-scan kernels' inputs on one device (see
    :meth:`ClusterRouter.kernel_layout`)."""

    payload: Any                 # (C, cap, D) fp32 | ((C, cap, D) int8, (C, cap) f32)
    bucket_rows: torch.Tensor    # (C, cap) int32, -1 = empty slot
    bucket_valid: torch.Tensor   # (C, cap) bool
    centroids: torch.Tensor      # (C, D) fp32
    live: torch.Tensor           # (C,) bool: clusters with members


@dataclasses.dataclass
class ShardLayout:
    """The shard-owned routed scans' inputs (see
    :meth:`ClusterRouter.kernel_shard_buckets`)."""

    layout: KernelLayout         # the unsharded layout, on the device
    bounds_dev: torch.Tensor     # (S+1,) int32 cut points, on the device
    shard_rows: np.ndarray       # (S, Cmax, cap) int32, -1 = empty slot
    shard_valid: np.ndarray      # (S, Cmax, cap) int32
    bounds: np.ndarray           # (S+1,) int64 cut points
    # one device per shard: each shard's slice on its device (None for an
    # empty shard), and ``layout`` without its payload; else None
    parts: Optional[list] = None


class ClusterRouter:
    """Incremental spherical mini-batch k-means over an index's rows.

    Owns the centroid matrix, the row→cluster assignment (row-aligned
    with the index, -1 = unassigned/inactive), and the per-cluster
    member lists. The owning index calls ``note_add``/``note_remove``
    from its row lifecycle and ``route`` from its search path; before
    the first training (``min_train`` active rows) the router reports
    ``ready == False`` and the index brute-force scans as before.
    """

    def __init__(self, capacity: int, dim: int,
                 cfg: Optional[ClusterConfig] = None):
        self.cfg = cfg or ClusterConfig()
        self.capacity = capacity
        self.dim = dim
        c = self.cfg.n_clusters
        self.centroids = np.zeros((c, dim), np.float32)
        self.counts = np.zeros(c, np.int64)
        self.assign = np.full(capacity, -1, np.int32)
        self.trained = False
        self.rng = np.random.default_rng(self.cfg.seed)
        self.refreshes = 0
        self._muts = 0
        # a training run needs at least a few rows per centroid
        self._min_train = max(self.cfg.min_train, 2 * c)
        # mini-batch per-center sample counts (the k-means learning-rate
        # denominators); persist across refreshes so centroids stabilize
        self._mb_counts = np.zeros(c, np.int64)
        # per-cluster member rows, maintained INCREMENTALLY (append on
        # add, remove on free) — a full rebuild per mutation would cost
        # O(N log N) on every serving-traffic stage-1 pass and eat the
        # host-side sublinearity this module exists for
        self._member_lists: list[list[int]] = [[] for _ in range(c)]
        self._bucket_cache = None             # KernelLayout on the device
        # ---- mesh-shard ownership (DESIGN.md §13) -------------------
        # shard s owns the contiguous cluster range
        # [shard_bounds[s], shard_bounds[s+1]); shard_of[ci] is the
        # owner of cluster ci. Seeded with an even cluster split;
        # refresh() rebalances the cut points to the member-count
        # distribution (and counts the member rows that change owner).
        s = max(1, int(self.cfg.n_shards))
        self.n_shards = s
        self.shard_bounds = (np.arange(s + 1, dtype=np.int64) * c) // s
        self.shard_of = self._owners_from_bounds(self.shard_bounds)
        self.rebalances = 0        # refreshes that moved ≥1 cluster
        self.migrated_rows = 0     # member rows that changed shards
        self.migration_chunks = 0  # ≤ _MIGRATE_CHUNK-row transfers
        self._shard_cache = None   # ShardLayout

    @property
    def ready(self) -> bool:
        return self.trained

    # ------------------------------------------------ shard ownership

    def _owners_from_bounds(self, bounds: np.ndarray) -> np.ndarray:
        """Per-cluster owning shard from the cut-point prefix (repeated
        cut points = empty shards, which are legal)."""
        cs = np.arange(self.cfg.n_clusters)
        owners = np.searchsorted(bounds, cs, side="right") - 1
        return np.clip(owners, 0, self.n_shards - 1).astype(np.int32)

    def _rebalance_shards(self, count_migration: bool) -> None:
        """Re-cut cluster ownership to balance member counts across
        shards (contiguous ranges only, so routing stays a range test).

        Runs at the tail of every :meth:`refresh`, i.e. on the existing
        mutation budget — no extra scheduling. Each cut point lands on
        the member-count cumsum nearest to its ideal ``total·s/S``
        target. Clusters whose owner changes migrate their member rows
        in ≤ ``_MIGRATE_CHUNK``-row transfers; with the global SoA
        store the migration is pure accounting (ownership metadata +
        the counters the benchmarks report), mirroring what a
        multi-host deployment would ship over the interconnect.
        ``count_migration`` is False on the very first training pass —
        initial placement is not a migration.
        """
        s = self.n_shards
        if s <= 1:
            return
        c = self.cfg.n_clusters
        csum = np.concatenate(([0], np.cumsum(self.counts)))
        total = int(csum[-1])
        targets = np.arange(1, s, dtype=np.float64) * (total / s)
        cuts = np.searchsorted(csum[1:], targets, side="left") + 1
        bounds = np.maximum.accumulate(np.concatenate(
            ([0], np.minimum(cuts, c), [c])
        )).astype(np.int64)
        owners = self._owners_from_bounds(bounds)
        if count_migration:
            moved = self.counts[owners != self.shard_of]
            moved = moved[moved > 0]
            if len(moved):
                self.rebalances += 1
                self.migrated_rows += int(moved.sum())
                self.migration_chunks += int(
                    np.ceil(moved / _MIGRATE_CHUNK).sum())
        self.shard_bounds = bounds
        self.shard_of = owners
        self._shard_cache = None

    # ------------------------------------------------- lifecycle hooks

    def note_add(self, row: int, emb: np.ndarray, index) -> None:
        """Bucket a freshly-allocated row under its nearest centroid
        (or train the router once the index is big enough)."""
        if self.trained:
            sims = self.centroids @ np.asarray(emb, np.float32)
            c = int(np.argmax(sims))
            self.assign[row] = c
            self.counts[c] += 1
            self._member_lists[c].append(int(row))
            self._bucket_cache = None
        self._muts += 1
        if not self.trained:
            if len(index) >= self._min_train:
                self.refresh(index)
        elif self._muts >= self.cfg.refresh_every:
            self.refresh(index)

    def note_add_batch(self, rows: np.ndarray, embs: np.ndarray,
                       index) -> None:
        """Vectorized :meth:`note_add` for a block of freshly-allocated
        rows (bulk prefill). Only valid once trained — callers stay on
        the scalar hook until training flips so the first refresh fires
        at the same index size either way.

        Mutation-for-mutation equivalent to the scalar hook: chunks
        split at exactly ``refresh_every - _muts`` so refreshes fire at
        the same mutation counts as a sequential add loop, and the
        chunked (m, C) GEMM assignment matches the scalar GEMV argmax
        on tie-free (non-degenerate) scores — the float-summation-order
        caveat is the same one the chunked re-bucketing pass already
        carries.
        """
        assert self.trained, "note_add_batch requires a trained router"
        rows = np.asarray(rows, dtype=np.int64)
        embs = np.asarray(embs, dtype=np.float32)
        c = self.cfg.n_clusters
        n, i = len(rows), 0
        while i < n:
            room = self.cfg.refresh_every - self._muts
            take = min(n - i, max(1, room), _ASSIGN_CHUNK)
            r, e = rows[i:i + take], embs[i:i + take]
            a = np.argmax(e @ self.centroids.T, axis=1).astype(np.int32)
            self.assign[r] = a
            self.counts += np.bincount(a, minlength=c)
            order = np.argsort(a, kind="stable")  # keeps rows in order
            rs, asort = r[order], a[order]
            bnd = np.searchsorted(asort, np.arange(c + 1))
            for ci in np.unique(asort):
                self._member_lists[ci].extend(
                    int(x) for x in rs[bnd[ci]:bnd[ci + 1]])
            self._bucket_cache = None
            self._muts += take
            i += take
            if self._muts >= self.cfg.refresh_every:
                self.refresh(index)

    def note_remove(self, rows: np.ndarray) -> None:
        """Unbucket freed rows (TTL purge, eviction, demotion)."""
        ra = np.asarray(rows)
        cs = self.assign[ra]
        live = cs >= 0
        if live.any():
            np.subtract.at(self.counts, cs[live], 1)
            for r, c in zip(ra[live], cs[live]):
                self._member_lists[c].remove(int(r))
            self.assign[ra[live]] = -1
            self._bucket_cache = None
        self._muts += len(ra)
        # no refresh here: removals fire mid-eviction while the owning
        # cache is mutating; the budget check runs on the next add

    # --------------------------------------------------------- training

    def _mb_step(self, embs: np.ndarray) -> None:
        """One mini-batch k-means step (sklearn-style per-center rates):
        assign the sample, pull each centroid toward its sample mean with
        step size m_c / (mb_counts_c + m_c), then renormalize (spherical
        k-means — rows are unit vectors, assignment is by max dot)."""
        a = np.argmax(embs @ self.centroids.T, axis=1)
        for c in np.unique(a):
            pts = embs[a == c]
            m = len(pts)
            self._mb_counts[c] += m
            eta = m / float(self._mb_counts[c])
            self.centroids[c] = (1.0 - eta) * self.centroids[c] \
                + eta * pts.mean(axis=0)
        norms = np.linalg.norm(self.centroids, axis=1, keepdims=True)
        np.divide(self.centroids, norms, out=self.centroids,
                  where=norms > 0)

    def _rebucket(self, index) -> None:
        """Full re-bucketing: assign every active row to its nearest
        centroid, chunked so the (N, C) score block stays small."""
        rows = np.flatnonzero(index.active)
        self.assign[:] = -1
        for off in range(0, len(rows), _ASSIGN_CHUNK):
            chunk = rows[off:off + _ASSIGN_CHUNK]
            e = index.route_embs(chunk)
            self.assign[chunk] = np.argmax(
                e @ self.centroids.T, axis=1
            ).astype(np.int32)
        self.counts = np.bincount(
            self.assign[rows], minlength=self.cfg.n_clusters
        ).astype(np.int64)
        c = self.cfg.n_clusters
        a = self.assign[rows]
        order = np.argsort(a, kind="stable")  # keeps rows ascending
        rs, asort = rows[order], a[order]
        bounds = np.searchsorted(asort, np.arange(c + 1))
        self._member_lists = [
            rs[bounds[i]:bounds[i + 1]].tolist() for i in range(c)
        ]
        self._bucket_cache = None

    def refresh(self, index) -> None:
        """Centroid refresh on the mutation budget: (first call) seed
        centroids from a random row sample, then ``iters`` mini-batch
        steps and one full re-bucketing pass. Deterministic given the
        seed and the mutation history."""
        rows = np.flatnonzero(index.active)
        if len(rows) == 0:
            return
        first = not self.trained
        if not self.trained:
            pick = self.rng.choice(
                len(rows), size=min(self.cfg.n_clusters, len(rows)),
                replace=False,
            )
            init = index.route_embs(rows[pick])
            self.centroids[:len(init)] = init
            if len(init) < self.cfg.n_clusters:
                # tiny index: duplicate seeds so every centroid is valid
                reps = self.rng.choice(len(init),
                                       self.cfg.n_clusters - len(init))
                self.centroids[len(init):] = init[reps]
        for _ in range(self.cfg.iters):
            m = min(self.cfg.batch_size, len(rows))
            pick = self.rng.choice(len(rows), size=m, replace=False)
            self._mb_step(index.route_embs(rows[pick]))
        self._rebucket(index)
        self.trained = True
        self._muts = 0
        self.refreshes += 1
        self._rebalance_shards(count_migration=not first)

    # ---------------------------------------------------------- routing

    def members(self) -> list:
        """Per-cluster member-row arrays (insertion order — routing
        sorts the gathered union, so bucket-internal order is free).
        Materializes the incremental lists; the hot ``route`` path
        gathers only the selected clusters and never calls this."""
        return [np.asarray(m, dtype=np.int64) for m in self._member_lists]

    def route(self, q: np.ndarray):
        """Select clusters for a query block and gather their members.

        q (B, D) fp32 → ``(g_rows, allowed, rows_scanned)`` or None when
        nothing is bucketed (caller falls back to brute force):

          * g_rows  (G,)   — union of member rows across every selected
                             cluster in the block, ascending (at
                             nprobe=all this is exactly the active row
                             set in brute-force scan order);
          * allowed (B, G) — per-query mask: row j is scannable for
                             query i iff j's cluster is in i's selection;
          * rows_scanned   — centroids scored + rows gathered, the
                             work term of the scan-proportional latency
                             model (DESIGN.md §12).
        """
        from repro_torch.core.seri import topk_desc

        nonempty = self.counts > 0
        n_live = int(nonempty.sum())
        if n_live == 0:
            return None
        nprobe = n_live if self.cfg.nprobe is None \
            else min(self.cfg.nprobe, n_live)
        cs = np.where(nonempty[None, :],
                      np.asarray(q, np.float32) @ self.centroids.T, NEG)
        sel, svals = topk_desc(cs, nprobe)               # (B, nprobe)
        ok = svals > NEG / 2       # nprobe ≤ n_live ⇒ all True; belt+braces
        uniq = np.unique(sel[ok])
        parts = [self._member_lists[c] for c in uniq
                 if self._member_lists[c]]
        if not parts:
            return None
        g_rows = np.sort(np.concatenate(
            [np.asarray(p, dtype=np.int64) for p in parts]
        ))
        onehot = np.zeros((q.shape[0], self.cfg.n_clusters), bool)
        np.put_along_axis(onehot, sel, ok, axis=1)
        allowed = onehot[:, self.assign[g_rows]]
        return g_rows, allowed, len(g_rows) + n_live

    # ----------------------------------------------------- kernel layout

    def kernel_layout(self, index, quant: bool = False,
                      payload: bool = True) -> KernelLayout:
        """Everything the routed-scan kernels (``kernels/ann_topk_ivf``)
        read, on the index's device: the cluster-major buckets and the
        routing inputs. Rebuilt lazily after a mutation, where the
        reference clears ``_bucket_cache``.

        ``bucket_rows``/``bucket_valid`` are built on the host exactly as
        the reference's :meth:`kernel_buckets` builds them: every cluster's
        members in one fixed-capacity bucket, in ascending row order (so the
        kernel's per-bucket argmax breaks exact-score ties by lowest row,
        matching topk_desc's rule; ties BETWEEN buckets merge in
        centroid-score order — a kernel-backend caveat the numpy path does
        not share), ``cap`` a power of two of at least 8. The payload is
        gathered on the device from the index's mirror (``emb_dev``, or
        ``emb_q_dev``/``scale_dev`` for the int8 tier): only the (C, cap)
        row map goes up, where the reference builds the (C, cap, D) array
        on the host and copies it on every search. The centroids and the
        live-cluster mask change only where the buckets do, so they are
        uploaded with them. ``payload=False`` leaves the payload out (one
        device per shard: each keeps its own slice)."""
        lay = self._bucket_cache
        if lay is not None and (lay.payload is not None or not payload):
            return lay
        members = self.members()
        c = self.cfg.n_clusters
        top = int(max((len(m) for m in members), default=1))
        cap = 1 << max(3, int(np.ceil(np.log2(max(1, top)))))
        bucket_rows = np.full((c, cap), -1, np.int32)
        for ci, mem in enumerate(members):
            if len(mem):
                bucket_rows[ci, :len(mem)] = np.sort(mem)
        dev = index.active_dev.device
        rows = torch.from_numpy(bucket_rows).to(dev)
        self._bucket_cache = KernelLayout(
            payload=_gather(index, rows, quant) if payload else None,
            bucket_rows=rows, bucket_valid=rows >= 0,
            centroids=torch.from_numpy(self.centroids).to(dev),
            live=torch.from_numpy(self.counts > 0).to(dev))
        return self._bucket_cache

    def kernel_shard_buckets(self, index, quant: bool = False
                             ) -> ShardLayout:
        """The shard layout for the shard-owned routed scans
        (``kernels/ann_topk_sharded``): shard s owns the cluster range
        [bounds[s], bounds[s+1]) of :meth:`kernel_layout`.

        ``shard_rows``/``shard_valid`` (S, Cmax, cap) and ``bounds``
        (S+1,) are built on the host exactly as the reference's
        ``kernel_shard_buckets`` builds them: shard s's slice holds its
        owned cluster range, padded to the widest ownership span (empty
        shards and S > C are legal). The reference also builds the
        (S, Cmax, cap, D) payload from them, for a device mesh; the port
        scans every shard on the index's one device, where each slice is a
        contiguous range of the unsharded layout, so the device side is
        that layout and the bounds, and no payload is copied. Cached
        against the layout: a mutation or a rebalance invalidates it.

        With one device per shard (the dispatch rule of
        ``kernels/ann_topk_sharded.shard_devices``) the layout keeps no
        payload, and ``parts[s]`` holds shard s's payload, ``bucket_rows``
        and ``bucket_valid`` on device s, gathered from the mirror a shard
        at a time and rebuilt only with the layout."""
        devs = shard_devices(self.n_shards, index.active_dev.device)
        base = self.kernel_layout(index, quant=quant, payload=devs is None)
        if self._shard_cache is not None and self._shard_cache.layout is base:
            return self._shard_cache
        s, bounds = self.n_shards, self.shard_bounds
        cmax = int(max(1, np.diff(bounds).max()))
        bucket_rows = base.bucket_rows.cpu().numpy()
        cap = bucket_rows.shape[1]
        shard_rows = np.full((s, cmax, cap), -1, np.int32)
        shard_valid = np.zeros((s, cmax, cap), np.int32)
        for si in range(s):
            lo, hi = int(bounds[si]), int(bounds[si + 1])
            shard_rows[si, :hi - lo] = bucket_rows[lo:hi]
            shard_valid[si, :hi - lo] = bucket_rows[lo:hi] >= 0
        parts = None
        if devs is not None:
            parts = [shard_part(index, base, quant, devs[si],
                                int(bounds[si]), int(bounds[si + 1]))
                     for si in range(s)]
        self._shard_cache = ShardLayout(
            layout=base, bounds_dev=torch.from_numpy(
                bounds.astype(np.int32)).to(base.bucket_rows.device),
            shard_rows=shard_rows, shard_valid=shard_valid,
            bounds=bounds.astype(np.int64), parts=parts)
        return self._shard_cache


def _gather(index, rows: torch.Tensor, quant: bool):
    """The payload of a (n, cap) row map, gathered on the device from the
    index's mirror, zero in the empty slots."""
    valid = rows >= 0
    gather = rows.clamp(min=0).long()
    if quant:
        payload = (index.emb_q_dev[gather], index.scale_dev[gather])
        payload[0][~valid] = 0
        payload[1][~valid] = 0.0
    else:
        payload = index.emb_dev[gather]
        payload[~valid] = 0.0
    return payload


def shard_part(index, base: KernelLayout, quant: bool, dev, lo: int,
               hi: int) -> Optional[ShardPart]:
    """Shard ``[lo, hi)``'s slice of ``base`` on ``dev`` (None if empty):
    gathered on the mirror's device, then moved."""
    if hi <= lo:
        return None
    rows = base.bucket_rows[lo:hi]
    payload = _gather(index, rows, quant)
    payload = tuple(x.to(dev) for x in payload) if quant \
        else payload.to(dev)
    rows = rows.to(dev, copy=True)
    return ShardPart(device=torch.device(dev), lo=lo, hi=hi,
                     payload=payload, bucket_valid=rows >= 0,
                     bucket_rows=rows,
                     bounds=torch.tensor([0, hi - lo], dtype=torch.int32,
                                         device=dev))
