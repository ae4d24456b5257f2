"""Carry state from the reference package into the port.

Two kinds of state: the stage-1 indexes and their cluster routers (the
embedding matrices, fp32 hot and int8 warm, the active masks, the
row→se_id maps, the free-lists, and each router's centroids,
assignments, member lists and random state), and the language models'
parameters and AdamW state (:func:`lm_params_from_numpy`,
:func:`opt_state_from_numpy`). Tests and ``chip_smoke.py`` start both
packages, or both backends, from one state with these.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.clustering import ClusterConfig, ClusterRouter
from repro_torch.core.seri import VectorIndex
from repro_torch.core.tiers import QuantIndex
from repro_torch.device import resolve_device
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.param import ParamSpec


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
                              refreshes: int = 0, shard_bounds=None,
                              rebalances: int = 0, migrated_rows: int = 0,
                              migration_chunks: int = 0) -> ClusterRouter:
    """A port ``ClusterRouter`` in the given state: the (C, D) centroids,
    per-cluster ``counts``, the row→cluster ``assign`` (-1 = none), the
    per-cluster ``members`` lists in their own order, the numpy
    generator's ``bit_generator.state``, the mutation count since the
    last refresh (``muts``), the mini-batch per-centroid counts and the
    ``trained`` flag; for a sharded router (``cfg.n_shards > 1``) also the
    (S+1,) ``shard_bounds`` (None: the initial even split) and the
    rebalance counters. The cluster→shard map follows from the bounds, as
    the router derives it. The same mutations then give the same
    refreshes, centroids, buckets and shard cuts as the router the state
    came from."""
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
    if shard_bounds is not None:
        bounds = np.asarray(shard_bounds, np.int64).copy()
        if bounds.shape != rt.shard_bounds.shape:
            raise ValueError(f"want {rt.n_shards + 1} shard bounds for "
                             f"n_shards={rt.n_shards}, got {bounds.shape}")
        rt.shard_bounds = bounds
        rt.shard_of = rt._owners_from_bounds(bounds)
    rt.rebalances = int(rebalances)
    rt.migrated_rows = int(migrated_rows)
    rt.migration_chunks = int(migration_chunks)
    return rt


def _tensor(a) -> torch.Tensor:
    """A host array as a tensor. A JAX bf16 leaf arrives as an
    ``ml_dtypes`` bfloat16 array, which torch cannot read: its raw bits go
    over as int16 and are viewed as ``torch.bfloat16``."""
    a = np.array(a)  # a writable copy the tensor owns
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_numpy(tree, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's LM parameter tree (``LM.param_specs`` of
    ``repro.models.lm``, leaves as numpy arrays; the ``prefix`` layers as
    a list, each superblock position ``blocks/l{i}`` stacked over
    ``n_repeat`` when ``n_repeat > 1``) as the port's
    ``repro_torch.models.lm.LM`` parameters on ``device``: the same
    leaves (MLA's, the MoE's with its fp32 router and bias, the shared
    experts', Mamba's, mLSTM's and sLSTM's, cross-attention's,
    ``frontend_proj``, ``enc_norm`` and the ``mtp`` block too), the layers
    as a list in ``cfg.layer_iter()`` order, prefix first, and an
    encoder's ``enc_blocks`` (stacked over ``enc_repeat`` when it is above
    1) as the list ``enc_layers``. Each leaf must have its spec's shape
    and dtype."""
    return _lm_tree_from_numpy(tree, cfg, device)


def opt_state_from_numpy(state, cfg: ModelConfig, device="cuda") -> dict:
    """The reference's AdamW state ``{"step", "m", "v"}`` of an LM
    (``train/optim.init_state`` over its parameter tree, leaves as numpy
    arrays) as the port's (``repro_torch.train.optim``): ``step`` an int32
    0-d tensor, ``m`` and ``v`` laid out as :func:`lm_params_from_numpy`
    lays out the parameters, each leaf in the state's own dtype."""
    dev = resolve_device(device)
    sdt = _tensor(np.asarray(state["m"]["final_norm"]["scale"])).dtype
    return {"step": _tensor(np.asarray(state["step"], np.int32)).to(dev),
            "m": _lm_tree_from_numpy(state["m"], cfg, device, sdt),
            "v": _lm_tree_from_numpy(state["v"], cfg, device, sdt)}


def _lm_tree_from_numpy(tree, cfg: ModelConfig, device, dtype=None) -> dict:
    """:func:`lm_params_from_numpy`, every leaf in ``dtype`` if given."""
    from repro_torch.models.lm import LM

    dev = resolve_device(device)
    specs = LM(cfg).param_specs()

    def pick(sub, fn):
        if isinstance(sub, dict):
            return {k: pick(v, fn) for k, v in sub.items()}
        return fn(sub)

    def unstack(blocks, n_blocks: int, repeat: int) -> list:
        """A superblock tree, each position stacked over ``repeat`` when
        it is above 1, as the list of its ``repeat * n_blocks`` layers."""
        def at(r):
            return lambda a: np.asarray(a)[r] if repeat > 1 else a
        return [pick(blocks[f"l{i % n_blocks}"], at(i // n_blocks))
                for i in range(repeat * n_blocks)]

    src = {k: tree[k] for k in ("embed", "final_norm", "head",
                                 "frontend_proj", "mtp", "enc_norm")
           if k in tree}
    src["layers"] = list(tree.get("prefix", [])) + unstack(
        tree["blocks"], len(cfg.blocks), cfg.n_repeat)
    if cfg.enc_dec:
        src["enc_layers"] = unstack(tree["enc_blocks"], len(cfg.enc_blocks),
                                    cfg.enc_repeat)

    def leaf(spec: ParamSpec, a) -> torch.Tensor:
        t = _tensor(a)
        if tuple(t.shape) != spec.shape or t.dtype != (dtype or spec.dtype):
            raise ValueError(f"leaf {tuple(t.shape)} {t.dtype} does not match "
                             f"its spec {spec.shape} {spec.dtype}")
        return t.to(dev)

    def walk(spec, sub):
        if isinstance(spec, ParamSpec):
            return leaf(spec, sub)
        if isinstance(spec, dict):
            if set(spec) != set(sub):
                raise ValueError(f"keys {sorted(sub)} != {sorted(spec)}")
            return {k: walk(v, sub[k]) for k, v in spec.items()}
        return [walk(v, s) for v, s in zip(spec, sub, strict=True)]

    return walk(specs, src)
