"""Declarative parameter system, mesh-free.

Every module describes its parameters as a tree (dicts and lists) of
:class:`ParamSpec`; :func:`init_params` materialises one on a device from a
``torch.Generator``, with the reference's distributions (``nn/param.py``):
normal with std ``scale`` or 1/sqrt(fan_in), zeros, ones, or uniform in
±``scale``. A layer stack is a Python list of per-layer trees, not a
scan-stacked leading axis.

The reference also derives ``jax.ShapeDtypeStruct`` and ``PartitionSpec``
trees from a spec tree for the sharded dry run; those belong to the launch
and dry-run layer (:func:`struct_tree` raises).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

DRYRUN = "ROADMAP slice 12 'Launch and dry-run layer'"


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""

    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | scaled | uniform
    scale: float | None = None  # stddev override for "normal"/"scaled"

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


def struct_tree(*args, **kwargs):
    raise NotImplementedError(
        f"shape/sharding stand-in trees are not ported yet ({DRYRUN})")
