"""Step factories, the port of the reference's ``launch/steps.py``: the
training step (loss, gradients over microbatches, AdamW), and thin
prefill and decode steps. Without a mesh every step runs on the
parameters' device; with one (``mesh``, ``shard_cfg``) it is the model's
DTensor program over it (``nn.sharding.ShardCtx``), its parameters,
state and inputs DTensors. :class:`TrainStepGraph` runs the donated
training step as the reference's trainer runs its jitted one: compiled
once (on CUDA, one CUDA graph) over state and batch buffers it owns.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.lm import LM
from repro_torch.nn import runtime
from repro_torch.nn.config import ModelConfig
from repro_torch.nn.sharding import (ShardCtx, batch_map, dtensor_of,
                                     local_part, local_shape)
from repro_torch.train import tree as tr
from repro_torch.train.optim import AdamWConfig, adamw_update


def value_and_grad(lm: LM, params, batch: dict, remat: str = "none"):
    """``(loss, grads)`` of ``lm.loss_and_aux`` at ``params`` (a tree of
    tensors that require no grad), the gradients a tree of the
    parameters' shapes and dtypes; a leaf the loss does not reach (a
    sigmoid router's bias, an unused frontend) gets zeros, as under
    ``jax.grad``."""
    flat, treedef = tr.flatten(params)
    xs = [p.detach().requires_grad_() for p in flat]
    with lm.ctx.scope():
        loss, _ = lm.loss_and_aux(tr.unflatten(treedef, xs), batch,
                                  remat=remat)
        grads = torch.autograd.grad(loss, xs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else _placed_like(g, x)
             for x, g in zip(xs, grads)]
    return loss.detach(), tr.unflatten(treedef, grads)


def _placed_like(g, x):
    """A DTensor gradient at its parameter's placements (a Partial sum
    reduce-scattered or reduced); a tensor as it is."""
    if getattr(g, "placements", None) is None or \
            tuple(g.placements) == tuple(x.placements):
        return g
    return g.redistribute(x.device_mesh, x.placements)


def split_mb(batch: dict, microbatches: int, ctx=None) -> list[dict]:
    """The reference's microbatch split: each leaf's batch dim (dim 1 of
    (3, B, S) M-RoPE positions) cut into ``microbatches`` equal runs; on a
    mesh each rank cuts its own batch shard."""
    def cut(key, t):
        dim = 1 if key == "positions" and t.ndim == 3 else 0
        if t.shape[dim] % microbatches:
            raise ValueError(f"{key}: batch {t.shape[dim]} does not split "
                             f"into {microbatches} microbatches")
        if ctx is None or ctx.mesh is None:
            return torch.chunk(t, microbatches, dim=dim)

        def local(x):
            if x.shape[dim] % microbatches:
                raise ValueError(f"{key}: a rank's batch of {x.shape[dim]} "
                                 f"does not split into {microbatches} "
                                 f"microbatches")
            return torch.chunk(x, microbatches, dim)

        return batch_map(ctx, local, (t,), (dim,), (dim,) * microbatches)

    parts = {k: cut(k, v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(microbatches)]


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    remat: str = "dots", microbatches: int = 1,
                    accum_dtype=torch.float32, donate: bool = False, *,
                    mesh=None, shard_cfg=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with gradient accumulation over ``microbatches``: the
    gradients summed in ``accum_dtype`` and divided by the count, the loss
    the microbatches' mean. ``donate`` updates ``params`` and
    ``opt_state`` in place (``adamw_update(in_place=True)``), as the
    reference's trainer donates them to its jitted step; otherwise the step
    is pure. ``mesh`` and ``shard_cfg`` (a ``ShardingConfig``) run it as a
    DTensor program over the mesh."""
    ctx = ShardCtx(mesh, shard_cfg)
    lm = LM(cfg, ctx)

    def step(params, opt_state, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(lm, params, batch, remat)
        else:
            acc = tr.tree_map(lambda p: torch.zeros_like(
                p, dtype=accum_dtype), params)
            loss = None     # the first microbatch's starts the sum: no
            #                 zero made on the host and copied up
            # all of them (the dry run's counter may run the first ones)
            for mb in runtime.microbatches(split_mb(batch, microbatches,
                                                    ctx)):
                l_mb, g = value_and_grad(lm, params, mb, remat)
                for a, x in zip(tr.leaves(acc), tr.leaves(g)):
                    a.add_(x.to(a.dtype))
                del g  # before the next microbatch's backward
                loss = l_mb.float() if loss is None else loss + l_mb.float()
            for a in tr.leaves(acc):
                a.div_(microbatches)
            grads, loss = acc, loss / microbatches
        new_params, new_state, metrics = adamw_update(
            opt_cfg, params, grads, opt_state, in_place=donate)
        return new_params, new_state, {"loss": loss, **metrics}

    def train_step(params, opt_state, batch):
        with ctx.scope():
            return step(params, opt_state, batch)

    return train_step


class TrainStepGraph:
    """The reference trainer's ``jax.jit(step, donate_argnums=(0, 1))``:
    ``step`` (``make_train_step(..., donate=True)``, over ``mesh`` when
    one is given) over tensors this object owns, the parameters and AdamW
    state (``state``: ``{"params", "opt"}``, updated in place by every
    step) and a static batch of ``layout``'s keys, global shapes and
    dtypes (``batch``). ``layout`` maps each key to ``(shape, dtype)`` or
    ``(shape, dtype, pspec)`` (``configs/common.input_layout``).

    On a mesh the state's leaves are DTensors over local shards, and the
    static batch is DTensors over per-rank local buffers at their pspecs
    (``nn/sharding.dtensor_of``): each rank stages and copies up only its
    own slice of the global batch, with no collective.

    On CUDA the step is captured once into a CUDA graph
    (``kernels/graphs.StepGraph``: one eager warm-up on a side stream,
    under ``set_sync_debug_mode("error")``, then the capture; on a mesh
    each rank captures its own program, collectives included, and every
    rank replays once a step). ``reset()`` writes the initial state into
    ``state`` in place; it runs before the warm-up and again after it,
    because the warm-up stepped the state, so that the first replay is
    the first step. A call copies its batch into a pinned staging buffer,
    then up in one copy per dtype, replays the graph, and returns the
    step's metrics (``loss``, ``lr``, ``grad_norm``: tensors the next
    call rewrites). A capture that fails raises. On the CPU a call runs
    the step eagerly on the same buffers.
    """

    def __init__(self, step, state: dict, layout: dict, reset, mesh=None):
        self.state = state
        self.reset = reset
        # (a DTensor's device is its local shard's)
        device = tr.leaves(state["params"])[0].device
        cuda = device.type == "cuda"
        self.layout = {k: (tuple(v[0]), v[1]) for k, v in layout.items()}
        self._pspecs = pspecs = {k: tuple(v[2]) if len(v) > 2 else ()
                                 for k, v in layout.items()}
        groups: dict = {}
        for k, (_, dt) in self.layout.items():
            groups.setdefault(dt, []).append(k)
        self.batch, self._host, self._up = {}, {}, []
        for dt, keys in groups.items():
            shapes = {k: local_shape(mesh, self.layout[k][0], pspecs[k])
                      for k in keys}
            n = sum(math.prod(shapes[k]) for k in keys)
            dev_buf = torch.zeros(n, dtype=dt, device=device)
            host_buf = torch.zeros(n, dtype=dt, pin_memory=True) if cuda \
                else dev_buf
            off = 0
            for k in keys:
                n_k = math.prod(shapes[k])
                local = dev_buf[off:off + n_k].view(shapes[k])
                self._host[k] = host_buf[off:off + n_k].view(shapes[k])
                self.batch[k] = dtensor_of(mesh, local, self.layout[k][0],
                                           pspecs[k])
                off += n_k
            if cuda:
                self._up.append((dev_buf, host_buf))
        self.mesh = mesh
        self._copied = None
        batch = self.batch      # (the graph's step holds no self)
        self._step = lambda: step(state["params"], state["opt"], batch)[2]
        self.graph = None
        # what the capture added to the graph's pool, and the wrappers'
        # counts of one replay (kernels/graphs.counts() keys)
        self.pool_bytes, self.launches = 0, {}
        reset()
        if cuda:
            from repro_torch.kernels.graphs import StepGraph

            self.graph = StepGraph(self._step, torch.cuda.graph_pool_handle())
            self.pool_bytes = self.graph.pool_bytes
            self.launches = self.graph.launches
            reset()

    def load(self, batch: dict) -> None:
        """``batch`` (numpy arrays or host tensors of the layout's keys,
        global shapes and dtypes) into the static buffers: on a mesh
        only this rank's slice of each is staged and copied up."""
        if set(batch) != set(self.layout):
            raise ValueError(f"batch keys {sorted(batch)}, the step's are "
                             f"{sorted(self.layout)}")
        if self._copied is not None:
            self._copied.synchronize()   # the last copy up read the staging
        for k, v in batch.items():
            v = torch.as_tensor(v)
            shape, dt = self.layout[k]
            if tuple(v.shape) != shape or v.dtype != dt:
                raise ValueError(f"{k}: {tuple(v.shape)} {v.dtype}, the "
                                 f"step's static batch holds {shape} {dt}")
            self._host[k].copy_(local_part(v, self.mesh, self._pspecs[k]))
        if self._up:
            for dev_buf, host_buf in self._up:
                dev_buf.copy_(host_buf, non_blocking=True)
            self._copied = torch.cuda.Event()
            self._copied.record()

    def __call__(self, batch: dict) -> dict:
        """One training step on ``batch``; returns its metrics."""
        self.load(batch)
        return self._step() if self.graph is None else self.graph.replay()


def make_prefill_step(cfg: ModelConfig, mesh=None, shard_cfg=None):
    lm = LM(cfg, ShardCtx(mesh, shard_cfg))

    def prefill_step(params, batch: dict):
        return lm.prefill(params, batch["tokens"],
                          **{k: v for k, v in batch.items()
                             if k != "tokens"})

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh=None, shard_cfg=None):
    lm = LM(cfg, ShardCtx(mesh, shard_cfg))

    def serve_step(params, tokens, caches, pos):
        return lm.decode(params, tokens, caches, pos)

    return serve_step
