"""Declarative parameter system.

Every module describes its parameters as a tree (dicts and lists) of
:class:`ParamSpec`; :func:`init_params` materialises one on a device from a
``torch.Generator``, with the reference's distributions (``nn/param.py``):
normal with std ``scale`` or 1/sqrt(fan_in), zeros, ones, or uniform in
±``scale``. A layer stack is a Python list of per-layer trees, not a
scan-stacked leading axis.

Each spec also carries the reference's *logical* sharding axes, one entry
per dim ("model", "fsdp", "dp", ...), which ``nn/sharding`` resolves
against a device mesh. :func:`struct_tree` turns a spec tree into
stand-ins that never allocate: ``meta`` tensors, or on a mesh DTensors
whose local shards are ``meta`` tensors (the sharded dry run's inputs).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | scaled | uniform
    scale: float | None = None  # stddev override for "normal"/"scaled"
    # logical sharding axes, one entry per dim: an axis name, a tuple of
    # names, or None (replicated); () for a spec with no plan
    axes: tuple[Any, ...] = ()

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank mismatch with shape {self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def map_specs(fn: Callable[[ParamSpec], Any], tree):
    """``fn`` applied to every spec of a tree of dicts and lists, in the
    tree's own order (dict keys as inserted, lists in order)."""
    if isinstance(tree, ParamSpec):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map_specs(fn, v) for v in tree]
    raise TypeError(f"not a spec tree node: {type(tree).__name__}")


def _leaves(tree) -> list[ParamSpec]:
    out: list[ParamSpec] = []
    map_specs(out.append, tree)
    return out


def param_count(tree) -> int:
    return sum(s.size for s in _leaves(tree))


def param_bytes(tree) -> int:
    return sum(s.size * s.dtype.itemsize for s in _leaves(tree))


def _fan_in(shape: tuple[int, ...]) -> int:
    if len(shape) == 0:
        return 1
    if len(shape) == 1:
        return shape[0]
    # weight matrices are (in, out) by convention here
    return shape[-2]


def init_leaf(spec: ParamSpec, generator: torch.Generator,
              device) -> torch.Tensor:
    """One parameter, drawn on ``device`` (in fp32, then cast)."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "uniform":
        lim = spec.scale or 0.01
        u = torch.rand(spec.shape, generator=generator, device=device)
        return (u * (2 * lim) - lim).to(spec.dtype)
    if spec.init in ("normal", "scaled"):
        std = spec.scale
        if std is None:
            std = 1.0 / math.sqrt(max(_fan_in(spec.shape), 1))
        x = torch.randn(spec.shape, generator=generator, device=device)
        # scaled in place: one fp32 temporary, not two (an expert stack of
        # deepseek-v3 is 15 GB in fp32)
        return x.mul_(std).to(spec.dtype)
    raise ValueError(f"unknown init {spec.init}")


def init_params(specs, generator: torch.Generator, device):
    """Materialise a spec tree on ``device``. ``generator`` must live on
    that device, so nothing is drawn on the host and copied over."""
    return map_specs(lambda s: init_leaf(s, generator, device), specs)


def struct_tree(tree, mesh=None, resolve=None):
    """A tree of stand-ins for a spec tree that allocates nothing: without
    a mesh ``meta`` tensors of each spec's shape and dtype; with one,
    DTensors over ``mesh`` placed by ``resolve(spec)`` (a pspec, e.g.
    ``nn.sharding.param_pspec``; replicated without it), each holding its
    per-device shard as a ``meta`` tensor."""
    if mesh is None:
        return map_specs(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                               device="meta"), tree)
    from repro_torch.nn.sharding import meta_dtensor

    return map_specs(lambda s: meta_dtensor(
        mesh, s.shape, s.dtype, resolve(s) if resolve else ()), tree)
