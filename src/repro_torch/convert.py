"""Carry state from the reference package into the port.

The port's main path runs no model, so its state is the stage-1 indexes
and their cluster routers: the embedding matrices (fp32 hot, int8 warm),
the active masks, the row→se_id maps, the free-lists, and each router's
centroids, assignments, member lists and random state. Tests and
``chip_smoke.py`` start both packages, or both backends, from one index
state with these. ``ModelJudge`` parameters join this module with the
ROADMAP slice "Real stage-2 compute".
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.clustering import ClusterConfig, ClusterRouter
from repro_torch.core.seri import VectorIndex
from repro_torch.core.tiers import QuantIndex


def _rows_into(index, active, row_se, free) -> None:
    index.active[:] = np.asarray(active, bool)
    index.row_se[:] = np.asarray(row_se, np.int64)
    index._free = [int(r) for r in free]
    if index.active_dev is not None:
        index.active_dev.copy_(torch.from_numpy(index.active))


def vector_index_from_numpy(emb, active, row_se, free, *,
                            backend: str = "kernel", device="cuda",
                            router=None) -> VectorIndex:
    """A port ``VectorIndex`` holding the given index state: ``emb``
    (capacity, D) fp32, ``active`` (capacity,), ``row_se`` (capacity,)
    and ``free``, the reference's free-list in its own order (the next
    allocation pops its LAST element), so the next ``add`` picks the same
    row as the reference would. The host arrays are copied; with
    ``backend="kernel"`` the device mirror is uploaded from them.
    ``router`` (see :func:`cluster_router_from_numpy`) is attached as
    it is."""
    emb = np.asarray(emb, np.float32)
    capacity, dim = emb.shape
    index = VectorIndex(capacity, dim, backend=backend, router=router,
                        device=device)
    index.emb[:] = emb
    if index.emb_dev is not None:
        index.emb_dev.copy_(torch.from_numpy(index.emb))
    _rows_into(index, active, row_se, free)
    return index


def quant_index_from_numpy(emb_q, scale, active, row_se, free, *,
                           backend: str = "kernel", device="cuda",
                           rescore_mult: int = 4,
                           router=None) -> QuantIndex:
    """A port ``QuantIndex`` (the warm tier's int8 index) holding the
    given state: ``emb_q`` (capacity, D) int8 and ``scale`` (capacity,)
    fp32 as ``core/tiers.py::quantize_rows`` made them, plus ``active``,
    ``row_se`` and ``free`` as for :func:`vector_index_from_numpy`."""
    emb_q = np.asarray(emb_q, np.int8)
    capacity, dim = emb_q.shape
    index = QuantIndex(capacity, dim, backend=backend,
                       rescore_mult=rescore_mult, router=router,
                       device=device)
    index.emb_q[:] = emb_q
    index.scale[:] = np.asarray(scale, np.float32)
    if index._emb_i32 is not None:
        index._emb_i32[:] = index.emb_q
    if index.emb_q_dev is not None:
        index.emb_q_dev.copy_(torch.from_numpy(index.emb_q))
        index.scale_dev.copy_(torch.from_numpy(index.scale))
    _rows_into(index, active, row_se, free)
    return index


def cluster_router_from_numpy(cfg: ClusterConfig, capacity: int, *,
                              centroids, counts, assign, members, rng_state,
                              muts: int, mb_counts, trained: bool,
                              refreshes: int = 0) -> ClusterRouter:
    """A port ``ClusterRouter`` in the given state: the (C, D) centroids,
    per-cluster ``counts``, the row→cluster ``assign`` (-1 = none), the
    per-cluster ``members`` lists in their own order, the numpy
    generator's ``bit_generator.state``, the mutation count since the
    last refresh (``muts``), the mini-batch per-centroid counts and the
    ``trained`` flag. The same mutations then give the same refreshes,
    centroids and buckets as the router the state came from. Unsharded
    only (``cfg.n_shards == 1``)."""
    if cfg.n_shards != 1:
        raise NotImplementedError(
            "carrying a sharded router is not ported yet (ROADMAP slice "
            "'Sharded stage 1')")
    centroids = np.asarray(centroids, np.float32)
    rt = ClusterRouter(capacity, centroids.shape[1], cfg)
    rt.centroids[:] = centroids
    rt.counts = np.asarray(counts, np.int64).copy()
    rt.assign[:] = np.asarray(assign, np.int32)
    rt._member_lists = [[int(r) for r in m] for m in members]
    rt.rng.bit_generator.state = rng_state
    rt._muts = int(muts)
    rt._mb_counts = np.asarray(mb_counts, np.int64).copy()
    rt.trained = bool(trained)
    rt.refreshes = int(refreshes)
    return rt
