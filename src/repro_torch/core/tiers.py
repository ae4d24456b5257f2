"""Tiered SE storage: fp32 HOT tier + int8/zlib WARM tier (DESIGN.md §10).

The single-tier cache discards every LCFU victim outright, so the next
semantically-equal query pays the full WAN fetch even when the SE's own
cost/latency metadata says it was worth keeping in a cheaper form. This
module turns eviction into a *lifecycle*:

  * **demote** — HOT LCFU victims move into the WARM tier: embedding
    int8 symmetric per-row quantized (4× rows per byte), value
    zlib-compressed, all SoA metadata (freq/cost/latency/staticity/
    provenance) carried over, **absolute expiry preserved** — demotion
    never extends a TTL, mirroring the federation lease rule.
  * **warm hit** — a query whose HOT stage 1 comes up empty runs the
    quantized coarse scan (the CUDA ``kernels/ann_topk_quant`` kernel on
    the kernel backend, the bit-matching numpy path on the host) followed
    by an fp32 rescore of the
    top-R finalists, then the NORMAL judge gate — the two-stage Seri
    pipeline is exactly what makes a lossy tier safe, because every warm
    hit is re-validated before it counts.
  * **promote** — a validated warm hit moves the entry back to HOT
    (dequantized embedding, decompressed value), again at its original
    absolute expiry.
  * **true eviction** — only WARM LCFU victims (and victims too large
    for the warm tier) leave the system; those are what
    ``CacheStats.evictions`` counts under a :class:`TieredCache`.

Capacity accounting stays value-byte-based in both tiers (embeddings are
an HBM budget, not a cache-byte budget, matching the HOT tier's existing
convention): a warm entry charges ``ceil(size × value_ratio)`` bytes —
the compression-ratio-scaled footprint of its zlib'd payload — so at
equal total bytes the warm tier retains ~1/value_ratio× more entries.
"""
from __future__ import annotations

import dataclasses
import math
import pickle
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.cache import CortexCache
from repro_torch.core.clustering import ClusterConfig, ClusterRouter
from repro_torch.core.se_store import SEStore
from repro_torch.core.semantic_element import SemanticElement
from repro_torch.core.seri import (RowIndex, Seri, VectorIndex,
                                   sharded_topk_merge, topk_desc,
                                   topk_desc_stable)
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (ann_topk_ivf_quant_batch,
                                     ann_topk_quant_batch)

NEG = -3.0e38  # matches kernels/ann_topk_quant.NEG (masked-row sentinel)


# --------------------------------------------------------------- quantize

def quantize_rows(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8: scale = amax/127, q = rint(x/scale).

    Deterministic round-half-to-even (np.rint == jnp rounding), so the
    numpy and Pallas coarse paths score identical integers. All-zero rows
    get scale 1.0 to avoid 0/0."""
    x = np.asarray(x, np.float32)
    amax = np.max(np.abs(x), axis=-1)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(x / scale[..., None]), -127, 127).astype(np.int8)
    return q, scale


def _pack(value: Any) -> bytes:
    return zlib.compress(pickle.dumps(value, protocol=4), 6)


def _unpack(blob: bytes) -> Any:
    return pickle.loads(zlib.decompress(blob))


# ------------------------------------------------------------ quant index

class QuantIndex(RowIndex):
    """Fixed-capacity int8 embedding store with two-phase retrieval.

    Row management (free list, active mask, se_id mapping) comes from
    the :class:`~repro_torch.core.seri.RowIndex` base the hot
    ``VectorIndex`` also uses, so the two tiers' row lifecycles agree by
    construction. Coarse: fully-quantized matmul (int8 emb × int8 query,
    int32 accumulate) selecting the top ``rescore_mult × k`` candidates
    per query. Fine: fp32 query · dequantized candidate rows, which
    removes the query-quantization error before the τ_sim gate. The
    numpy and ``kernel`` (CUDA) backends multiply the scale factors in
    the same order, so the coarse scores agree bit-for-bit.

    ``backend="kernel"`` keeps a device mirror on ``device``:
    ``emb_q_dev`` (int8), ``scale_dev`` (fp32) and ``active_dev``, written
    at every write site of the host arrays (``_alloc``, ``remove_rows``,
    ``add``, ``_clear_rows``), so the coarse scan moves only the quantized
    query block up and the (B, R) finalists down. The fine rescore reads
    the host arrays, as the reference does.
    """

    def __init__(self, capacity: int, dim: int, backend: str = "kernel",
                 rescore_mult: int = 4, router=None, device="cuda"):
        if backend not in ("numpy", "kernel"):
            raise ValueError(f"backend must be 'numpy' or 'kernel', "
                             f"got {backend!r}")
        super().__init__(capacity, dim, router=router)
        self.backend = backend
        self.rescore_mult = rescore_mult
        self.emb_q = np.zeros((capacity, dim), np.int8)
        self.scale = np.zeros(capacity, np.float32)
        self.emb_q_dev: Optional[torch.Tensor] = None
        self.scale_dev: Optional[torch.Tensor] = None
        # int32 mirror of emb_q for the numpy coarse matmul (numpy would
        # otherwise overflow int8 accumulation — and per-search .astype
        # copies of the whole matrix are the hot-path cost to avoid).
        # The kernel backend reads the int8 device mirror and never
        # needs it.
        self._emb_i32 = None
        if backend == "kernel":
            dev = resolve_device(device)
            self.emb_q_dev = torch.zeros((capacity, dim), dtype=torch.int8,
                                         device=dev)
            self.scale_dev = torch.zeros(capacity, dtype=torch.float32,
                                         device=dev)
            self.active_dev = torch.zeros(capacity, dtype=torch.bool,
                                          device=dev)
        else:
            self._emb_i32 = np.zeros((capacity, dim), np.int32)

    def add(self, se_id: int, embedding: np.ndarray) -> int:
        row = self._alloc(se_id)
        q, s = quantize_rows(np.asarray(embedding, np.float32)[None])
        self.emb_q[row] = q[0]
        self.scale[row] = s[0]
        if self._emb_i32 is not None:
            self._emb_i32[row] = q[0]
        if self.emb_q_dev is not None:
            self.emb_q_dev[row] = torch.from_numpy(self.emb_q[row])
            self.scale_dev[row] = float(self.scale[row])
        if self.router is not None:
            self.router.note_add(
                row, np.asarray(embedding, np.float32), self
            )
        return row

    def _clear_rows(self, ra: np.ndarray) -> None:
        self.emb_q[ra] = 0
        self.scale[ra] = 0.0
        if self._emb_i32 is not None:
            self._emb_i32[ra] = 0
        if self.emb_q_dev is not None:
            rd = self._dev_rows(ra)
            self.emb_q_dev[rd] = 0
            self.scale_dev[rd] = 0.0

    def route_embs(self, rows: np.ndarray) -> np.ndarray:
        """Dequantized, renormalized fp32 rows for centroid training —
        the router sees (near enough) the same vectors the fine rescore
        phase does, so quantization error cannot skew routing."""
        v = self.emb_q[rows].astype(np.float32) * self.scale[rows][:, None]
        n = np.linalg.norm(v, axis=1, keepdims=True)
        return v / np.maximum(n, 1e-30)

    def dequantize(self, row: int) -> np.ndarray:
        """fp32 reconstruction, renormalized to unit length (the hot
        index assumes unit-norm rows for cosine)."""
        v = self.emb_q[row].astype(np.float32) * float(self.scale[row])
        n = float(np.linalg.norm(v))
        return v / n if n > 0 else v

    # ----------------------------------------------------------- search

    def search(self, q: np.ndarray, k: int, tau_sim: float):
        return self.search_batch(q[None], k, tau_sim)[0]

    def _coarse_routed(self, qq, qs, r: int, routed):
        """Quantized coarse scan over the routed cluster union only —
        same int32 math and scale-multiply order as the brute path, so
        at nprobe=all the scored matrix is the brute matrix restricted
        to active rows (same values, same tie order)."""
        g_rows, allowed, self.last_scanned = routed
        rt = self.router
        s = (qq.astype(np.int32) @ self._emb_i32[g_rows].T
             ).astype(np.float32)
        s = s * self.scale[g_rows][None, :]
        s = s * qs[:, None]
        s = np.where(allowed, s, NEG)
        if rt.n_shards > 1:
            # same shard-parallel selection as the hot index — the
            # score matrix is identical, so the merge is bit-identical
            # to the unsharded coarse pass (DESIGN.md §13)
            owners = rt.shard_of[rt.assign[g_rows]]
            n_cent = self.last_scanned - len(g_rows)
            self.last_scanned_max_shard = n_cent + int(
                np.bincount(owners, minlength=rt.n_shards).max())
            lrows, vals = sharded_topk_merge(s, owners, rt.n_shards, r)
        else:
            self.last_scanned_max_shard = self.last_scanned
            lrows, vals = topk_desc(s, r)                     # (B, r)
        return g_rows[lrows], vals

    def _coarse_routed_kernel(self, q, qq, qs, r: int):
        """Routed coarse scan on the kernel backend: routing (fp32 query
        vs centroids, through the ``ann_topk`` kernel) and the int8 bucket
        scan (``ann_topk_ivf_quant``) run on the device, no host-side
        route()/gather; rows-scanned derives from the kernel's own
        cluster selection."""
        lay, nprobe = self._kernel_probe(quant=True)
        bq, bscale = lay.payload
        vals, rows, sel, en = ann_topk_ivf_quant_batch(
            lay.centroids, lay.live, bq, bscale, lay.bucket_rows,
            lay.bucket_valid, q, qq, qs, nprobe, r)
        self._note_probed(sel, en)
        return rows.cpu().numpy(), vals.cpu().numpy()

    def _coarse_brute(self, qq, qs, r: int):
        if self.emb_q_dev is not None:
            vals, rows = ann_topk_quant_batch(
                self.emb_q_dev, self.scale_dev, self.active_dev, qq, qs, r)
            return rows.cpu().numpy(), vals.cpu().numpy()
        # (B, N) row-major, same layout rationale as VectorIndex;
        # scale multiply order matches the kernel exactly
        s = (qq.astype(np.int32) @ self._emb_i32.T).astype(np.float32)
        s = s * self.scale[None, :]
        s = s * qs[:, None]
        s = np.where(self.active[None, :], s, NEG)
        rows, vals = topk_desc(s, r)                          # (B, r)
        return rows, vals

    def search_batch(self, q: np.ndarray, k: int, tau_sim: float):
        """q (B, dim) fp32 unit-norm -> list of B (se_ids, sims) pairs,
        similarity-descending, gated at tau_sim on the RESCORED sims."""
        b = q.shape[0]
        if len(self) == 0:
            self.last_scanned = 0
            self.last_scanned_max_shard = 0
            empty = ([], np.zeros(0, np.float32))
            return [empty] * b
        q = np.asarray(q, np.float32)
        r = max(k * self.rescore_mult, k)
        qq, qs = quantize_rows(q)
        rows, vals, routed = self._routed_dispatch(
            q,
            lambda: self._coarse_routed_kernel(q, qq, qs, r),
            lambda info: self._coarse_routed(qq, qs, r, info),
            lambda: self._coarse_brute(qq, qs, r),
        )
        out = []
        for i in range(b):
            keep = vals[i] > NEG / 2          # drop masked/duplicate slots
            if routed:
                keep &= rows[i] >= 0   # kernel NEG slots carry row -1
            rs = rows[i][keep]
            if not len(rs):
                out.append(([], np.zeros(0, np.float32)))
                continue
            # fine phase: exact fp32 query against dequantized rows
            deq = self.emb_q[rs].astype(np.float32) * \
                self.scale[rs][:, None]
            sims = deq @ q[i]
            # top-k of the R finalists via argpartition with exact
            # stable-argsort tie parity (the full-sort audit)
            order = topk_desc_stable(sims, min(k, len(rs)))
            sims_k = sims[order].astype(np.float32)
            gate = sims_k >= tau_sim
            # row→se_id as ONE int64 gather (no per-candidate loop)
            out.append((self.row_se[rs[order][gate]].tolist(),
                        sims_k[gate]))
        return out


# ------------------------------------------------------------ warm views

class WarmElement:
    """Read view onto one WARM-tier row. Mirrors the SemanticElement
    surface the judge/engine/federation paths touch (key, value, expiry,
    staticity, economics); ``value`` decompresses on access. A promotion
    retires the row, after which the view is dead (``valid`` is False) —
    consumers snapshot key/value before triggering hit accounting."""

    __slots__ = ("_tier", "_row", "se_id")
    tier = "warm"

    def __init__(self, tier: "WarmTier", row: int):
        self._tier = tier
        self._row = int(row)
        self.se_id = int(tier.soa.se_id[row])

    @property
    def valid(self) -> bool:
        return int(self._tier.soa.se_id[self._row]) == self.se_id

    @property
    def key(self) -> str:
        return self._tier.soa.key[self._row]

    @property
    def value(self) -> Any:
        return _unpack(self._tier.soa.value[self._row])

    @property
    def size(self) -> int:
        """ORIGINAL (uncompressed) byte size — what a transfer moves and
        what the entry will charge once promoted back to HOT."""
        return int(self._tier.orig_size[self._row])

    @property
    def warm_bytes(self) -> int:
        return int(self._tier.soa.size[self._row])

    @property
    def row(self) -> int:
        return self._row

    def expired(self, now: float) -> bool:
        return now >= self.expires_at

    def __repr__(self) -> str:
        return (f"WarmElement(se_id={self.se_id}, key={self.key!r}, "
                f"freq={self.freq}, warm_bytes={self.warm_bytes})")


def _warm_field(name, cast):
    def get(self):
        return cast(getattr(self._tier.soa, name)[self._row])

    return property(get)


for _name, _cast in (("freq", int), ("staticity", int), ("cost", float),
                     ("latency", float), ("created_at", float),
                     ("expires_at", float), ("last_access", float),
                     ("prefetched", bool), ("intent", lambda v: v),
                     ("origin", lambda v: v), ("version", int),
                     ("fetched_at", float)):
    setattr(WarmElement, _name, _warm_field(_name, _cast))


# -------------------------------------------------------------- warm tier

class WarmTier:
    """Quantized/compressed second tier with its own SoA metadata.

    Owns a :class:`QuantIndex` + :class:`SEStore` pair (row-aligned, same
    free-list discipline as the hot pair) and byte accounting over the
    COMPRESSED footprint. Mutations return counts so the owning
    :class:`TieredCache` does all stats bookkeeping in one place.
    """

    def __init__(self, capacity_bytes: int, dim: int, *,
                 index_capacity: int = 8192, backend: str = "kernel",
                 value_ratio: float = 0.4, rescore_mult: int = 4,
                 router=None, device="cuda"):
        # NOTE: the warm tier's extra access latency is an ENGINE-side
        # virtual-time cost (EngineConfig.t_cache_warm, like t_cache_cpu)
        # — it is deliberately not duplicated here
        self.capacity_bytes = capacity_bytes
        self.value_ratio = value_ratio
        self.index = QuantIndex(index_capacity, dim, backend=backend,
                                rescore_mult=rescore_mult, router=router,
                                device=device)
        self.soa = SEStore(index_capacity)
        # soa.size holds the WARM (compressed) footprint for capacity and
        # per-byte LCFU scoring; the original size rides alongside for
        # promotion and federation transfers
        self.orig_size = np.zeros(index_capacity, np.int64)
        self.usage = 0

    def __len__(self) -> int:
        return len(self.soa)

    def warm_size(self, orig_size: int) -> int:
        """ceil(size × value_ratio), as DESIGN.md §10 specifies — the
        charge never understates the compressed footprint."""
        return max(1, math.ceil(orig_size * self.value_ratio))

    def view(self, se_id: int) -> WarmElement:
        return WarmElement(self, self.soa.id2row[se_id])

    # --------------------------------------------------------- mutation

    def remove_row(self, row: int) -> None:
        """Free one warm row (promotion/purge/eviction tail; no stats)."""
        self.usage -= int(self.soa.size[row])
        self.index.remove_rows([row])
        self.soa.remove_row(row)
        self.orig_size[row] = 0

    def purge_expired(self, now: float) -> int:
        dead = self.soa.expired_rows(now)
        for r in dead:
            self.remove_row(int(r))
        return len(dead)

    def _make_room(self, incoming: int, now: float,
                   eviction: str) -> tuple[int, int]:
        """Free bytes for an incoming demotion. Returns (ttl_purged,
        evicted) — warm victims are the cache's TRUE evictions."""
        if self.usage + incoming <= self.capacity_bytes and \
                not self.index.full:
            return 0, 0
        ttl_n = self.purge_expired(now)
        need = self.usage + incoming - self.capacity_bytes
        ev = 0
        if need > 0:
            victims = self.soa.victim_rows(now, eviction, need_bytes=need)
            for r in victims:
                self.remove_row(int(r))
            ev += len(victims)
        if self.index.full:
            victims = self.soa.victim_rows(now, eviction, n=1)
            for r in victims:
                self.remove_row(int(r))
            ev += len(victims)
        return ttl_n, ev

    def admit(self, meta: dict, emb: np.ndarray, now: float,
              eviction: str) -> tuple[bool, int, int]:
        """Admit one demoted SE. Returns (admitted, ttl_purged, evicted).

        ``meta`` carries the full hot-tier SoA snapshot: expiry stays
        ABSOLUTE (never re-derived from staticity), freq/last_access/
        provenance ride along so a later promotion restores the entry
        exactly as it left."""
        wsize = self.warm_size(meta["size"])
        if wsize > self.capacity_bytes:
            return False, 0, 0
        ttl_n, ev = self._make_room(wsize, now, eviction)
        row = self.index.add(meta["se_id"], emb)
        # every field rides along verbatim; only the value representation
        # (compressed) and the charged size (compressed footprint) change
        self.soa.add_meta(
            row, {**meta, "value": _pack(meta["value"]), "size": wsize}
        )
        self.orig_size[row] = meta["size"]
        self.usage += wsize
        return True, ttl_n, ev

    def take(self, se_id: int) -> Optional[tuple[dict, np.ndarray]]:
        """Remove an entry and return its full metadata snapshot +
        dequantized embedding (the promotion handoff), or None if the
        entry vanished (evicted between stage 1 and judge completion)."""
        row = self.soa.id2row.get(se_id)
        if row is None:
            return None
        meta = self.soa.snapshot_row(row)
        meta["value"] = _unpack(meta["value"])
        meta["size"] = int(self.orig_size[row])
        emb = self.index.dequantize(row)
        self.remove_row(row)
        return meta, emb

    # ----------------------------------------------------------- search

    def search_batch(self, q_embs: np.ndarray, k: int, tau_sim: float,
                     now: float):
        """Stage-1 over the warm tier: per query (cands, sims), sims
        aligned with the surviving (unexpired) candidates."""
        found = self.index.search_batch(np.asarray(q_embs), k, tau_sim)
        out = []
        for se_ids, sims in found:
            keep = [
                j for j, i in enumerate(se_ids)
                if i in self.soa.id2row
                and now < self.soa.expires_at[self.soa.id2row[i]]
            ]
            cands = [WarmElement(self, self.soa.id2row[se_ids[j]])
                     for j in keep]
            out.append((cands, np.asarray(sims[keep], np.float32)))
        return out


# ------------------------------------------------------------ tiered cache

@dataclasses.dataclass
class TierStats:
    demotions: int = 0         # HOT victims rehomed in WARM
    promotions: int = 0        # validated warm hits moved back to HOT
    warm_lookups: int = 0      # queries whose stage 1 consulted WARM
    warm_hits: int = 0         # hits served from a WARM candidate
    warm_evictions: int = 0    # WARM LCFU victims (true evictions)
    warm_ttl_evictions: int = 0
    demote_drops: int = 0      # victims that could not fit in WARM


class TieredCache(CortexCache):
    """CortexCache whose LCFU victims demote to a WARM tier instead of
    vanishing. ``CacheStats.evictions`` keeps meaning "left the system"
    (warm victims + demote drops), so single-tier comparisons hold."""

    def __init__(self, seri: Seri, *, warm: WarmTier, **kw):
        super().__init__(seri, **kw)
        self.warm = warm
        self.tier_stats = TierStats()

    # --------------------------------------------------------- lifecycle

    def _demote_rows(self, rows: np.ndarray, now: float) -> None:
        """Move hot victims into the warm tier (Algorithm 2 victims, in
        eviction order). Already-expired victims just die (TTL count);
        victims the warm tier cannot hold at all are true evictions."""
        if not len(rows):
            return
        metas = [
            (self.soa.snapshot_row(int(r)),
             np.array(self.seri.index.emb[int(r)], copy=True),
             bool(self.soa.revalidating[int(r)]))
            for r in rows
        ]
        self._drop_rows(np.asarray(rows))
        for meta, emb, revalidating in metas:
            if revalidating:
                # KNOWN-stale victim (refetch in flight): demoting would
                # park the stale value in WARM where the refresh cannot
                # find it — it just leaves the system
                self.stats.invalidations += 1
                continue
            if meta["expires_at"] <= now:
                self.stats.ttl_evictions += 1
                continue
            ok, ttl_n, ev = self.warm.admit(meta, emb, now, self.eviction)
            self.stats.ttl_evictions += ttl_n
            self.tier_stats.warm_ttl_evictions += ttl_n
            self.stats.evictions += ev
            self.tier_stats.warm_evictions += ev
            if ok:
                self.tier_stats.demotions += 1
            else:
                self.stats.evictions += 1
                self.tier_stats.demote_drops += 1

    def _promote(self, we: WarmElement,
                 now: float) -> Optional[SemanticElement]:
        """Move a validated warm winner back to HOT with every field —
        including the ABSOLUTE expiry — exactly as it left. Returns the
        live hot view, or None if the entry vanished or expired."""
        taken = self.warm.take(we.se_id)
        if taken is None:
            return None
        meta, emb = taken
        if meta["expires_at"] <= now:
            self.stats.ttl_evictions += 1
            return None
        # hot admission may itself demote victims; the promoted entry is
        # already out of the warm tier, so no cycle
        self._make_room(meta["size"], now)
        if self.seri.index.full:
            self._evict_n(1, now)
        row = self.seri.index.add(meta["se_id"], emb)
        self.soa.add_meta(row, meta)
        self.usage += meta["size"]
        self.stats.bytes_stored = self.usage
        self.tier_stats.promotions += 1
        se = self.store[meta["se_id"]]
        if self.on_promote is not None:
            # refresh-ahead timers die during a warm sojourn — tell the
            # freshness layer this entry is hot (and renewable) again
            self.on_promote(se)
        return se

    # --------------------------------------------------- eviction hooks

    def _retire_victims(self, victims: np.ndarray, now: float) -> None:
        self._demote_rows(victims, now)

    def purge_expired(self, now: float) -> int:
        n = super().purge_expired(now)
        wn = self.warm.purge_expired(now)
        self.stats.ttl_evictions += wn
        self.tier_stats.warm_ttl_evictions += wn
        return n + wn

    # ------------------------------------------------------------ lookup

    def _stage1_blocks(self, q_embs: np.ndarray, now: float):
        """Per-query (cands, sims): HOT stage 1 for the whole block, then
        one batched WARM scan for exactly the queries HOT turned up empty
        — the warm tier sits BEHIND the hot tier, not beside it. Every
        lookup flavor (scalar, batched, engine staged) inherits this seam
        from CortexCache, so the tiers cannot diverge per path.

        Tier membership is observed at BLOCK START: a promotion triggered
        by query j lands after query j+1's stage 1 already ran, so j+1
        may hold a warm view of an entry that is hot by the time the
        judge returns — ``_rebind`` redirects those to the live hot row.
        Hit/miss outcomes match the scalar path; only the warm-consult
        COUNT is batch-granularity dependent."""
        q_embs = np.asarray(q_embs)
        out, flags = super()._stage1_blocks(q_embs, now)
        warm_qi = [bi for bi, (cands, _) in enumerate(out)
                   if not cands and len(self.warm)]
        if warm_qi:
            self.tier_stats.warm_lookups += len(warm_qi)
            wfound = self.warm.search_batch(
                q_embs[warm_qi], self.seri.top_k, self.seri.stage1_gate,
                now
            )
            # the warm coarse scan's rows join the pass's scan-
            # proportional latency term (DESIGN.md §12); its busiest
            # shard joins the max-over-shards critical path (§13)
            self.scan.add_warm_pass(
                self.warm.index.last_scanned,
                self.warm.index.last_scanned_max_shard,
            )
            for bi, (wc, wsims) in zip(warm_qi, wfound):
                # the consult FACT (flowing back through
                # stage1_batch_flagged) feeds the engine's per-tier
                # latency accounting — consults that come back empty
                # still paid the warm scan
                flags[bi] = True
                if wc:
                    out[bi] = (wc, wsims)
        return out, flags

    def _rebind(self, se, now: float):
        if se.tier == "warm":
            if se.se_id in self.store:
                # an earlier query in this batch (or judge micro-batch)
                # already promoted it — bind to the live hot view
                return self.store[se.se_id]
            pse = self._promote(se, now)
            if pse is not None:
                self.tier_stats.warm_hits += 1
            return pse
        if se.se_id in self.store:
            # always re-resolve through id2row: tier promotions reassign
            # rows, so a stage-1 view's row may now hold a DIFFERENT SE
            # (returning `se` here served the wrong entry's value once a
            # promote→demote cycle reused its row mid-batch)
            live = self.store[se.se_id]
            return None if live.revalidating else live
        if se.se_id in self.warm.soa.id2row:
            # a HOT candidate demoted mid-batch (an earlier promotion's
            # make_room): the entry is alive in WARM — pull it back
            # rather than scoring a spurious miss. Not a warm_hit: the
            # match was discovered by the hot stage 1.
            return self._promote(self.warm.view(se.se_id), now)
        return None

    def account_hit(self, se, now: float) -> None:
        """The nojudge ablation hands stage-1 winners straight here; a
        warm winner must still promote so the freq bump lands on a live
        hot row (callers snapshot key/value first — promotion retires
        the warm view)."""
        if getattr(se, "tier", "hot") == "warm":
            if se.se_id in self.store:      # already promoted this window
                se = self.store[se.se_id]
            else:
                pse = self._promote(se, now)
                if pse is None:
                    # vanished mid-flight: count the hit, nothing to mutate
                    self.stats.hits += 1
                    return
                self.tier_stats.warm_hits += 1
                se = pse
        super().account_hit(se, now)

    # --------------------------------------------------------- freshness

    def ses_for_intent(self, intent) -> list:
        """Hot views first (se_id order), then warm — a change-feed
        notice must reach BOTH tiers: a stale warm entry would otherwise
        promote with its stale value on the next judge-validated hit."""
        out = super().ses_for_intent(intent)
        wids = self.warm.soa.by_intent.get(intent)
        if wids:
            out.extend(self.warm.view(i) for i in sorted(wids))
        return out

    def has_intent(self, intent) -> bool:
        return super().has_intent(intent) or \
            intent in self.warm.soa.by_intent

    def invalidate_se(self, se_id: int, now: float) -> bool:
        if se_id in self.soa.id2row:
            return super().invalidate_se(se_id, now)
        row = self.warm.soa.id2row.get(se_id)
        if row is None:
            return False
        self.warm.remove_row(row)
        self.stats.invalidations += 1
        return True

    def peek_semantic_scored(self, query: str, q_emb: np.ndarray,
                             now: float):
        """Both tiers, hot first — federation peers can lease warm
        entries (a warm lease carries the ORIGINAL size/value; the warm
        copy stays put, only a promotion moves it). Overriding the
        SCORED peek means ``peek_semantic`` and ``peek_lease`` (the
        judge-pipeline-validated federation path) inherit warm-tier
        consultation for free."""
        hit = super().peek_semantic_scored(query, q_emb, now)
        if hit is not None or not len(self.warm):
            return hit
        (cands, sims), = self.warm.search_batch(
            q_emb[None], self.seri.top_k, self.seri.stage1_gate, now
        )
        return (cands[0], float(sims[0])) if cands else None

    @property
    def total_usage(self) -> int:
        """Bytes across both tiers (hot fp32 values + warm compressed)."""
        return self.usage + self.warm.usage


def make_tiered_cache(
    *,
    hot_bytes: int,
    warm_bytes: int,
    dim: int,
    judge,
    index_capacity: int = 8192,
    warm_index_capacity: Optional[int] = None,
    tau_sim: float = 0.9,
    tau_lsm: float = 0.9,
    top_k: int = 4,
    eviction: str = "lcfu",
    max_ttl: float = 3600.0,
    backend: str = "kernel",
    warm_backend: Optional[str] = None,
    warm_value_ratio: float = 0.4,
    rescore_mult: int = 4,
    cluster: Optional[ClusterConfig] = None,
    device="cuda",
) -> TieredCache:
    """Factory mirroring ``make_cache``: hot fp32 index + seri in front of
    an int8 warm tier. ``warm_backend`` defaults to the hot backend
    ("kernel" → the CUDA ``ann_topk_quant`` kernel over a mirror on
    ``device``). ``cluster`` enables the clustered stage-1 routing
    (DESIGN.md §12) on BOTH tiers — each tier gets its own router
    instance (the warm seed offset by 1 so the two tiers' mini-batch
    draws are independent)."""
    hot_router = warm_router = None
    if cluster is not None:
        wcap = warm_index_capacity or index_capacity
        hot_router = ClusterRouter(index_capacity, dim, cluster)
        warm_router = ClusterRouter(
            wcap, dim,
            dataclasses.replace(cluster, seed=cluster.seed + 1),
        )
    index = VectorIndex(index_capacity, dim, backend=backend,
                        router=hot_router, device=device)
    seri = Seri(index, judge, tau_sim=tau_sim, tau_lsm=tau_lsm, top_k=top_k)
    warm = WarmTier(
        warm_bytes, dim,
        index_capacity=warm_index_capacity or index_capacity,
        backend=warm_backend or backend,
        value_ratio=warm_value_ratio,
        rescore_mult=rescore_mult,
        router=warm_router,
        device=device,
    )
    return TieredCache(
        seri, warm=warm, capacity_bytes=hot_bytes, max_ttl=max_ttl,
        eviction=eviction,
    )
