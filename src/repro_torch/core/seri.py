"""Seri — the Semantic Retrieval Index (paper §4.2).

Stage 1 (coarse): exact cosine top-k over the SE embedding matrix with the
τ_sim gate. With ``backend="kernel"`` it runs as the hand-written CUDA
``ann_topk`` kernel over a device-resident mirror of the matrix (its plain
PyTorch version when the mirror lives on the CPU); ``backend="numpy"`` is
the host path, unchanged from the reference.

Stage 2 (fine): the semantic judge validates each candidate's *result*
against the new query; the first candidate with S_lsm ≥ τ_lsm is a
semantic-aware cache hit.

Both stages are batched (DESIGN.md §8): ``search_batch`` pushes a whole
(B, D) query block through one masked matmul (or one ``ann_topk`` launch),
and ``CortexCache._judge_blocks`` scores the candidates of *all* queries in
a single ``judge.score_pairs`` call. The scalar entry points are one-query
wrappers over the batched path, so scalar and batched execution are the
same code and produce identical results.

With a :class:`~repro_torch.core.clustering.ClusterRouter` attached,
stage 1 runs as a clustered (IVF) routed scan once the router has trained:
the CUDA ``ann_topk_ivf`` kernel over a bucket layout gathered from the
device mirror (kernel backend; ``ann_topk_ivf_sharded`` when the router
partitions the clusters into shards), or the reference's numpy routed
scan.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.semantic_element import SemanticElement
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (ann_topk_batch, ann_topk_ivf_batch,
                                     ann_topk_ivf_sharded_batch)


def probe_count(cfg) -> int:
    """Clusters each query probes on the kernel backend (all of them for
    ``nprobe=None``), as the reference's kernel paths compute it."""
    return cfg.n_clusters if cfg.nprobe is None \
        else min(cfg.nprobe, cfg.n_clusters)


class RowIndex:
    """Fixed-capacity free-list row allocator — the management half
    shared by the fp32 hot index below and the int8 warm index
    (``core/tiers.py::QuantIndex``): active mask, row→se_id mapping, row
    alloc/free. Subclasses own the storage arrays and zero them in
    ``_clear_rows``, so the two tiers' row lifecycles cannot drift.

    ``row_se`` is an int64 array (-1 = free) so batched search paths
    resolve row→se_id with one fancy-indexed gather instead of a
    per-candidate Python loop. An optional
    :class:`~repro_torch.core.clustering.ClusterRouter` observes the row
    lifecycle (``note_add``/``note_remove``) to keep its cluster
    buckets free-list-consistent (DESIGN.md §12).

    ``active_dev`` is the device mirror of ``active`` when the subclass
    keeps one (the kernel backend; None otherwise); every write to
    ``active`` writes it too."""

    def __init__(self, capacity: int, dim: int, router=None):
        self.capacity = capacity
        self.dim = dim
        self.active = np.zeros(capacity, bool)
        self.row_se = np.full(capacity, -1, np.int64)
        self.router = router
        self.active_dev: Optional[torch.Tensor] = None
        # rows touched by the most recent search_batch call (active rows
        # for brute force; centroids + gathered members for the routed
        # scan) — the engine's scan-proportional latency term
        self.last_scanned = 0
        # the busiest shard's share of last_scanned (DESIGN.md §13);
        # equal to last_scanned for brute force and unsharded routing
        self.last_scanned_max_shard = 0
        self._free = list(range(capacity - 1, -1, -1))

    def __len__(self) -> int:
        return int(self.active.sum())

    @property
    def full(self) -> bool:
        return not self._free

    def _dev_rows(self, rows: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(rows, np.int64)).to(
            self.active_dev.device)

    def _alloc(self, se_id: int) -> int:
        if not self._free:
            raise RuntimeError("index full — evict first")
        row = self._free.pop()
        self.active[row] = True
        if self.active_dev is not None:
            self.active_dev[row] = True
        self.row_se[row] = se_id
        return row

    def _clear_rows(self, ra: np.ndarray) -> None:
        raise NotImplementedError

    def _routed_dispatch(self, q: np.ndarray, kernel_scan, routed_scan,
                         brute_scan):
        """The one stage-1 dispatch both index flavors share: the CUDA
        routed scan when the index is on the kernel backend and clusters
        exist, the numpy routed scan when the router is trained, brute
        force otherwise. Returns ``(rows, scores, routed)`` — ``routed``
        tells the caller to apply the kernel NEG-slot row filter."""
        ready = self.router is not None and self.router.ready
        if ready and self.active_dev is not None and \
                np.any(self.router.counts > 0):
            return (*kernel_scan(), True)
        if ready:
            info = self.router.route(q)
            if info is not None:
                return (*routed_scan(info), True)
        self.last_scanned = len(self)
        self.last_scanned_max_shard = self.last_scanned
        return (*brute_scan(), False)

    def _note_probed(self, sel: torch.Tensor, enabled: torch.Tensor) -> None:
        """Rows-scanned accounting from the kernel's own cluster selection:
        the live centroids plus the members of every probed cluster, and
        under a sharded router the busiest shard's share of the probed
        members (the engine charges max-over-shards)."""
        rt = self.router
        sel, enabled = sel.cpu().numpy(), enabled.cpu().numpy()
        probed = np.unique(sel[enabled > 0])
        n_cent = int((rt.counts > 0).sum())
        self.last_scanned = n_cent + int(rt.counts[probed].sum())
        if rt.n_shards > 1:
            per_shard = np.bincount(
                rt.shard_of[probed], weights=rt.counts[probed],
                minlength=rt.n_shards)
            self.last_scanned_max_shard = n_cent + int(per_shard.max())
        else:
            self.last_scanned_max_shard = self.last_scanned

    def remove_rows(self, rows) -> None:
        """Batched removal: one fancy-indexed store per field."""
        rows = [r for r in rows if self.active[r]]
        if not rows:
            return
        ra = np.asarray(rows)
        self.active[ra] = False
        if self.active_dev is not None:
            self.active_dev[self._dev_rows(ra)] = False
        self._clear_rows(ra)
        self.row_se[ra] = -1
        if self.router is not None:
            self.router.note_remove(ra)
        for r in rows:
            self._free.append(r)


def topk_desc(s: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-row top-k, similarity-descending, over a (B, N) score matrix
    (mutates ``s``): negate in place, ``argpartition``, then a
    boundary-tie-exact stable sort — the one selection idiom both the
    fp32 and int8 (core/tiers.py) indexes use, so their tie-break
    semantics cannot drift. Returns (rows (B, k), vals (B, k)).

    Ties break by ascending COLUMN index — an exact rule, not
    argpartition luck: the candidate set is expanded to every value
    tying the k-th (the ``topk_desc_stable`` idiom) so the result is
    independent of the matrix layout. That is what makes the clustered
    index's nprobe=all mode bit-identical to brute force (DESIGN.md
    §12): the routed union scores the same values at different column
    positions, and a layout-dependent tie pick (exact-duplicate
    embeddings — judge false-negative re-inserts — tying at the
    boundary) would diverge. Ascending-column also matches the Pallas
    kernels' tie order (per-tile argmax + lax.top_k both prefer the
    lowest index)."""
    b, m = s.shape
    k_eff = min(k, m)
    np.negative(s, out=s)                             # sort ascending
    part = np.argpartition(s, k_eff - 1, axis=1)[:, :k_eff]
    psc = np.take_along_axis(s, part, axis=1)
    rows = np.empty((b, k_eff), part.dtype)
    vals = np.empty((b, k_eff), s.dtype)
    for i in range(b):
        thr = psc[i].max()
        sel = np.flatnonzero(s[i] <= thr)   # superset incl. boundary ties
        order = sel[np.argsort(s[i, sel], kind="stable")][:k_eff]
        rows[i] = order
        vals[i] = -s[i, order]
    return rows, vals


def topk_desc_stable(v: np.ndarray, k: int) -> np.ndarray:
    """Indices of the ``k`` largest values of 1-D ``v``, descending,
    ties broken by ascending position — EXACTLY
    ``np.argsort(-v, kind="stable")[:k]``, but O(n + t·log t) via
    ``argpartition`` with the boundary-tie expansion trick the SoA
    victim selector uses (``se_store._smallest_in_order``): the
    partition's candidate set is widened to every value tying the k-th,
    so a tie group split by the partition boundary cannot change which
    elements survive. The per-candidate rescore selections
    (``core/tiers.py``) use this instead of a full sort."""
    m = v.shape[0]
    k = min(k, m)
    if k <= 0:
        return np.zeros(0, np.intp)
    if k >= m:
        return np.argsort(-v, kind="stable")
    neg = -v
    part = np.argpartition(neg, k - 1)[:k]
    thr = neg[part].max()
    sel = np.flatnonzero(neg <= thr)       # superset incl. boundary ties
    return sel[np.argsort(neg[sel], kind="stable")][:k]


def sharded_topk_merge(s: np.ndarray, owners: np.ndarray, n_shards: int,
                       k: int) -> tuple[np.ndarray, np.ndarray]:
    """Shard-parallel top-k over a (B, G) score matrix whose columns
    are partitioned by ``owners`` (column → shard), merged to one
    global (rows, vals) — bit-identical to ``topk_desc(s, k)``.

    Each shard runs :func:`topk_desc` over its own column slice, then
    the ≤ S·k finalists merge under the same total order topk_desc
    uses: value descending, GLOBAL column ascending (``lexsort`` keys).
    Every global winner is by definition inside its own shard's top-k
    under that order, so the shard union always contains the global
    top-k and the merge reproduces it exactly — including duplicate
    scores straddling a shard boundary. This is the host-path model of
    the shard_map + cross-shard ``lax.top_k`` kernel (DESIGN.md §13);
    unlike :func:`topk_desc` it does NOT mutate ``s`` (the per-shard
    column gathers are copies).
    """
    b, m = s.shape
    k_eff = min(k, m)
    ccols, cvals = [], []
    for sh in range(n_shards):
        cols = np.flatnonzero(owners == sh)
        if not len(cols):
            continue
        lr, lv = topk_desc(s[:, cols], k)    # fancy-index copy of s
        ccols.append(cols[lr])
        cvals.append(lv)
    cc = np.concatenate(ccols, axis=1)
    cv = np.concatenate(cvals, axis=1)
    rows = np.empty((b, k_eff), np.intp)
    vals = np.empty((b, k_eff), s.dtype)
    for i in range(b):
        order = np.lexsort((cc[i], -cv[i]))[:k_eff]
        rows[i] = cc[i][order]
        vals[i] = cv[i][order]
    return rows, vals


class VectorIndex(RowIndex):
    """Fixed-capacity embedding store with free-list row management.

    ``emb``/``active`` are the host master copy; the numpy backend and all
    host code read them. ``backend="kernel"`` also keeps ``emb_dev`` and
    ``active_dev`` on ``device``, written at every write site of the host
    arrays (``_alloc``, ``remove_rows``, ``add``, ``add_batch``,
    ``_clear_rows``), so a search moves only the (B, D) query block to the
    device and the (B, k) results back — never the matrix.

    With a :class:`~repro_torch.core.clustering.ClusterRouter` attached,
    stage 1 runs as a clustered (IVF-style) routed scan — centroids
    first, then only the selected clusters' member rows — instead of
    the full-matrix brute force (DESIGN.md §12). Until the router has
    trained (or without one) the brute path runs unchanged."""

    def __init__(self, capacity: int, dim: int, backend: str = "kernel",
                 router=None, device="cuda"):
        if backend not in ("numpy", "kernel"):
            raise ValueError(f"backend must be 'numpy' or 'kernel', "
                             f"got {backend!r}")
        super().__init__(capacity, dim, router=router)
        self.backend = backend
        self.emb = np.zeros((capacity, dim), np.float32)
        self.emb_dev: Optional[torch.Tensor] = None
        if backend == "kernel":
            dev = resolve_device(device)
            self.emb_dev = torch.zeros((capacity, dim), dtype=torch.float32,
                                       device=dev)
            self.active_dev = torch.zeros(capacity, dtype=torch.bool,
                                          device=dev)

    def add(self, se_id: int, embedding: np.ndarray) -> int:
        row = self._alloc(se_id)
        self.emb[row] = embedding
        if self.emb_dev is not None:
            self.emb_dev[row] = torch.from_numpy(self.emb[row])
        if self.router is not None:
            self.router.note_add(row, self.emb[row], self)
        return row

    def add_batch(self, se_ids, embeddings) -> np.ndarray:
        """Bulk add for large prefills (the million-entry sweeps): one
        vectorized alloc+store per block instead of n scalar calls.

        Stays on the scalar :meth:`add` path until the router trains —
        the first refresh must trigger at the same index size as a
        sequential loop would hit — then switches to bulk allocation +
        ``note_add_batch`` (which itself splits at the router's exact
        refresh points). Every block goes to the device mirror too.
        Returns the allocated rows, ascending.
        """
        embs = np.asarray(embeddings, np.float32)
        ids = np.asarray(se_ids, np.int64)
        n = len(ids)
        if len(self._free) < n:
            raise RuntimeError("index full — evict first")
        rows = np.empty(n, np.int64)
        i = 0
        while i < n and self.router is not None \
                and not self.router.trained:
            rows[i] = self.add(int(ids[i]), embs[i])
            i += 1
        rt = self.router
        while i < n:
            # allocate only up to the router's next refresh boundary: a
            # refresh sees exactly the rows a sequential loop would have
            # active (bulk-allocating ahead would leak not-yet-noted
            # rows into the training sample and re-bucketing pass)
            take = n - i
            if rt is not None:
                take = min(take, max(1, rt.cfg.refresh_every - rt._muts))
            ra = np.array([self._free.pop() for _ in range(take)],
                          np.int64)
            self.active[ra] = True
            self.row_se[ra] = ids[i:i + take]
            self.emb[ra] = embs[i:i + take]
            if self.emb_dev is not None:
                rd = self._dev_rows(ra)
                self.active_dev[rd] = True
                self.emb_dev[rd] = torch.from_numpy(self.emb[ra]).to(
                    rd.device)
            rows[i:i + take] = ra
            if rt is not None:
                rt.note_add_batch(ra, self.emb[ra], self)
            i += take
        return rows

    def _clear_rows(self, ra: np.ndarray) -> None:
        self.emb[ra] = 0.0
        if self.emb_dev is not None:
            self.emb_dev[self._dev_rows(ra)] = 0.0

    def route_embs(self, rows: np.ndarray) -> np.ndarray:
        """Unit-norm fp32 rows for centroid training/assignment."""
        return self.emb[rows]

    # ----------------------------------------------------------- search

    def search(self, q: np.ndarray, k: int, tau_sim: float):
        """Top-k rows with cosine ≥ tau_sim. q: (dim,) unit-norm.
        Returns (se_ids, sims) sorted by similarity desc."""
        return self.search_batch(q[None], k, tau_sim)[0]

    def _search_routed(self, q: np.ndarray, k: int, routed):
        """Scan only the routed clusters' member rows. The gathered
        union is in ascending row order and the not-allowed mask uses
        the same -1.0 sentinel as the brute path's inactive mask, so at
        nprobe=all the scored matrix is exactly the brute matrix
        restricted to active rows — same values, same tie order."""
        g_rows, allowed, self.last_scanned = routed
        rt = self.router
        s = np.where(allowed, q @ self.emb[g_rows].T, -1.0)
        if rt.n_shards > 1:
            # shard-parallel selection over the SAME score matrix: each
            # shard top-k's its owned member columns, finalists merge
            # under topk_desc's (value desc, row asc) order — so the
            # result is bit-identical to the unsharded path and the
            # float-reduction tolerance across shard counts is zero
            owners = rt.shard_of[rt.assign[g_rows]]
            n_cent = self.last_scanned - len(g_rows)
            self.last_scanned_max_shard = n_cent + int(
                np.bincount(owners, minlength=rt.n_shards).max())
            lrows, sims = sharded_topk_merge(s, owners, rt.n_shards, k)
        else:
            self.last_scanned_max_shard = self.last_scanned
            lrows, sims = topk_desc(s, k)                      # (B, k)
        return g_rows[lrows], sims

    def _search_routed_kernel(self, q: np.ndarray, k: int):
        """Routed scan on the kernel backend: routing (centroid scores +
        top-nprobe, through the ``ann_topk`` kernel) and the bucket scan
        (``ann_topk_ivf``) run on the device, so no host-side
        route()/gather happens at all — rows-scanned accounting derives
        from the kernel's own cluster selection."""
        rt = self.router
        if rt.n_shards > 1:
            return self._search_routed_kernel_sharded(q, k)
        lay = rt.kernel_layout(self)
        sims, rows, sel, en = ann_topk_ivf_batch(
            lay.centroids, lay.live, lay.payload, lay.bucket_rows,
            lay.bucket_valid, q, probe_count(rt.cfg), k)
        self._note_probed(sel, en)
        return rows.cpu().numpy(), sims.cpu().numpy()

    def _search_routed_kernel_sharded(self, q: np.ndarray, k: int):
        """Shard-parallel routed scan on the kernel backend (DESIGN.md
        §13): routing stays global; each probed bucket is scanned by its
        owning shard (``ann_topk_ivf_sharded``: every shard on the index's
        device, or each on its own, ``ShardLayout.parts``) and the
        S·nprobe·k finalists merge once on the index's device. Scan
        accounting splits the probed members by owner so the engine can charge
        max-over-shards."""
        rt = self.router
        sh = rt.kernel_shard_buckets(self)
        lay = sh.layout
        sims, rows, sel, en = ann_topk_ivf_sharded_batch(
            lay.centroids, lay.live, lay.payload, lay.bucket_rows,
            lay.bucket_valid, sh.bounds_dev, q, probe_count(rt.cfg), k,
            parts=sh.parts)
        self._note_probed(sel, en)
        return rows.cpu().numpy(), sims.cpu().numpy()

    def _search_brute(self, q: np.ndarray, k: int):
        if self.emb_dev is not None:
            sims, rows = ann_topk_batch(self.emb_dev, self.active_dev, q, k)
            return rows.cpu().numpy(), sims.cpu().numpy()
        # (B, N) row-major so the per-query partition/sort runs over
        # contiguous lanes (axis=0 on (N, B) is strided and ~3× slower
        # at large N·B)
        s = np.where(self.active[None, :], q @ self.emb.T, -1.0)
        rows, sims = topk_desc(s, k)                           # (B, k)
        return rows, sims

    def search_batch(self, q: np.ndarray, k: int, tau_sim: float):
        """Batched stage-1: q (B, dim) -> list of B (se_ids, sims) pairs.

        One masked matmul over the whole query block (numpy brute) or over
        the routed cluster union (numpy IVF), or one kernel launch (kernel
        backend). Each query is selected on its own, so batching never
        changes retrieval semantics. Kernel entries below the gate
        (NEG-scored inactive rows included) are dropped with the τ_sim
        filter, and routed NEG slots by their row -1.
        """
        b = q.shape[0]
        if len(self) == 0:
            self.last_scanned = 0
            self.last_scanned_max_shard = 0
            empty = ([], np.zeros(0, np.float32))
            return [empty] * b
        q = np.asarray(q, np.float32)
        rows, sims, routed = self._routed_dispatch(
            q,
            lambda: self._search_routed_kernel(q, k),
            lambda info: self._search_routed(q, k, info),
            lambda: self._search_brute(q, k),
        )
        out = []
        for i in range(b):
            keep = sims[i] >= tau_sim
            if routed:
                keep &= rows[i] >= 0   # kernel NEG slots carry row -1
            r = rows[i][keep]
            # row→se_id as ONE int64 gather (no per-candidate Python loop)
            out.append((self.row_se[r].tolist(),
                        sims[i][keep].astype(np.float32)))
        return out


@dataclasses.dataclass
class SeriResult:
    hit: bool
    se: Optional[SemanticElement]
    n_candidates: int
    judge_calls: int
    best_score: float
    # stage-1 similarities ALIGNED with the surviving candidate list:
    # sims[j] is the cosine of the j-th candidate the judge scored
    # (expired stage-1 matches are dropped from both)
    sims: np.ndarray


class Seri:
    """Two-stage retrieval configuration over a SE store.

    Holds the stage-1 index, the judge, and the thresholds. The
    retrieval pipeline itself lives in ``CortexCache._stage1_blocks`` /
    ``_judge_blocks`` (one implementation for the scalar, batched, and
    engine-staged paths — and the seam the tiered cache overrides);
    keeping a second copy here is how sims/candidate misalignment bugs
    happen twice."""

    def __init__(self, index: VectorIndex, judge, *, tau_sim: float = 0.9,
                 tau_lsm: float = 0.9, top_k: int = 4):
        from repro_torch.core.judge_pipeline import as_pipeline

        self.index = index
        # every stage-2 interaction goes through ONE JudgePipeline
        # (DESIGN.md §14); a raw judge object is wrapped in a default
        # pipeline (no admission band, FLOPs-derived token cost)
        self.pipeline = as_pipeline(judge)
        self.tau_sim = tau_sim
        self.tau_lsm = tau_lsm
        self.top_k = top_k

    @property
    def judge(self):
        """Back-compat: the decision scorer behind the pipeline."""
        return self.pipeline.decisions

    @property
    def stage1_gate(self) -> float:
        """Similarity gate stage 1 applies: the admission band's lower
        edge when armed, τ_sim otherwise."""
        return self.pipeline.stage1_gate(self.tau_sim)
