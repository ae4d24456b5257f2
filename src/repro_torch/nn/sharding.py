"""Mesh-aware sharding resolution, the port of the reference's
``nn/sharding.py``, with DTensor over a ``DeviceMesh`` where the reference
has GSPMD over a ``jax.sharding.Mesh``.

Parameters carry *logical* axis names ("model", "fsdp", "expert", ...).
This module resolves them against a concrete mesh with divisibility checks:
an axis is only applied when the dimension divides the mesh axis size,
otherwise the dim falls back to replication (best-effort sharding). The
resolution (``resolve_pspec``) is pure logic over the mesh's axis sizes, so
it takes a ``DeviceMesh``, a ``jax.sharding.Mesh`` or any object with a
``shape`` dict and ``axis_names``; a pspec is a tuple with one entry per
leading dim (a mesh axis name, a tuple of names, or None), trailing Nones
dropped, as ``tuple(PartitionSpec(...))`` reads.

:func:`placements` turns a pspec into DTensor placements, and
:class:`ShardCtx` carries the mesh through the model: ``constrain`` is a
``redistribute`` to the resolved placements (the reference's
``with_sharding_constraint``), ``region`` a ``local_map`` body with the
explicit collectives below (the reference's fully-manual ``shard_map``
regions), both the identity without a mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch

# Logical axis -> mesh axis-name tuple. "dp" covers pod+data (pure DP);
# "fsdp" shards parameters/optimizer state over the data axis (ZeRO-3 style);
# "expert"/"model" are tensor/expert parallel over the model axis.
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "dp": ("pod", "data"),
    "data": ("data",),
    "fsdp": ("data",),
    "model": ("model",),
    "expert": ("model",),
    "seq": ("pod", "data"),  # long-context KV/sequence sharding (batch=1)
    # decode KV caches: batch shards over dp, sequence over the model axis
    # (kv heads < TP width, so the seq dim is the shardable one; attention
    # over the sharded cache is a flash-decoding-style distributed softmax)
    "kv_seq": ("model",),
}


# FSDP-only plan (no tensor parallelism): batch shards over every mesh
# axis, parameters ZeRO-3-shard over (data, model).
FSDP_ONLY_RULES: dict[str, tuple[str, ...]] = {
    "dp": ("pod", "data", "model"),
    "data": ("data",),
    "fsdp": ("data", "model"),
    "model": (),
    "expert": (),
    "seq": ("pod", "data"),
    "kv_seq": (),
}


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    rules: dict[str, tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES)
    )
    # ZeRO-3/FSDP: additionally shard params over the data axis when the
    # logical spec asks for "fsdp".
    enable_fsdp: bool = True

    @staticmethod
    def fsdp_only() -> "ShardingConfig":
        return ShardingConfig(rules=dict(FSDP_ONLY_RULES))

    @staticmethod
    def fsdp_hybrid() -> "ShardingConfig":
        """No-TP plan with batch over data only (leaves room for grad
        accumulation): params ZeRO-3 over all chips, batch 16-way + mu."""
        rules = dict(FSDP_ONLY_RULES)
        rules["dp"] = ("pod", "data")
        return ShardingConfig(rules=rules)

    def mesh_axes(self, logical: Any) -> tuple[str, ...]:
        if logical is None:
            return ()
        if isinstance(logical, (tuple, list)):
            out: list[str] = []
            for item in logical:
                out.extend(self.mesh_axes(item))
            return tuple(out)
        if logical == "fsdp" and not self.enable_fsdp:
            return ()
        return self.rules.get(logical, ())


def mesh_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (whose ``shape`` is a
    tuple) or of a mesh whose ``shape`` is already that dict."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, names: tuple[str, ...]) -> int:
    sizes = mesh_sizes(mesh)
    size = 1
    for n in names:
        size *= sizes.get(n, 1)
    return size


def resolve_pspec(mesh, spec_axes: tuple[Any, ...], shape: tuple[int, ...],
                  cfg: ShardingConfig | None = None) -> tuple:
    """Resolve logical axes to a pspec, dropping non-divisible axes
    (without a mesh nothing is split: ``()``)."""
    if mesh is None or not spec_axes:
        return ()
    cfg = cfg or ShardingConfig()
    sizes = mesh_sizes(mesh)
    entries: list[Any] = []
    used: set[str] = set()
    for dim, logical in zip(shape, spec_axes):
        names = [n for n in cfg.mesh_axes(logical)
                 if n in sizes and n not in used]
        # keep the largest prefix of axis names whose product divides the dim
        kept: list[str] = []
        prod = 1
        for n in names:
            if dim % (prod * sizes[n]) == 0:
                kept.append(n)
                prod *= sizes[n]
        used.update(kept)
        if not kept:
            entries.append(None)
        elif len(kept) == 1:
            entries.append(kept[0])
        else:
            entries.append(tuple(kept))
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def param_pspec(mesh, spec, cfg: ShardingConfig | None = None) -> tuple:
    return resolve_pspec(mesh, spec.axes, spec.shape, cfg)


def placements(mesh, pspec: tuple) -> tuple:
    """DTensor placements (one per mesh dim) of a pspec: ``Shard(d)`` on
    every mesh dim named by tensor dim d's entry, ``Replicate()`` on the
    rest. A dim split over two mesh axes, e.g. ("pod", "data"), gets
    ``Shard(d)`` on both (a mesh dim of size 1 stays ``Replicate()``);
    DTensor splits a dim over its mesh dims in mesh
    order, the first mesh dim outermost, so the names must come in mesh
    order for the shard of device (i, j) to be block ``i * n_data + j``,
    as ``NamedSharding`` places it (the first-named axis major)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(pspec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"pspec entry {entry} is not in mesh order "
                             f"{tuple(names)}")
        for i in idx:
            # a mesh dim of size 1 splits nothing: left replicated, so
            # that DTensor never refuses a view of a "sharded" dim
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def _axes(entry) -> tuple[str, ...]:
    """The mesh axes of one pspec entry (a name, a tuple of names, or
    None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shape(mesh, shape: tuple[int, ...], pspec: tuple) -> tuple:
    """The per-device shard shape of a tensor of ``shape`` under ``pspec``
    (dims divide evenly: ``resolve_pspec`` keeps only dividing axes);
    ``shape`` itself without a mesh."""
    if mesh is None:
        return tuple(shape)
    sizes = mesh_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(pspec):
        out[d] //= math.prod(sizes[a] for a in _axes(entry))
    return tuple(out)


def local_part(x, mesh, pspec: tuple):
    """This rank's shard of ``x`` (a whole tensor or numpy array) under
    ``pspec``, cut on this rank (a view; ``x`` itself without a mesh):
    along each dim, block ``i * n_b + j`` of ``local_shape``'s size for
    mesh coordinates (i, j) on the entry's axes (a, b), the first-named
    axis major, as ``placements`` and ``NamedSharding`` place it."""
    if mesh is None:
        return x
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = mesh_sizes(mesh)
    cut = []
    for d, n in enumerate(local_shape(mesh, tuple(x.shape), pspec)):
        block = 0
        for a in _axes(pspec[d] if d < len(pspec) else None):
            block = block * sizes[a] + coord[a]
        cut.append(slice(block * n, (block + 1) * n))
    return x[tuple(cut)]


def pspec_of(x) -> tuple:
    """The pspec that places the DTensor ``x`` (``placements``' inverse,
    a mesh dim of size 1 left out, no trailing None, as ``resolve_pspec``
    gives it)."""
    axes: list[list[str]] = [[] for _ in range(x.ndim)]
    for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
        if p.is_shard():
            axes[p.dim].append(name)
    while axes and not axes[-1]:
        axes.pop()
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in axes)


def dtensor_of(mesh, local: torch.Tensor, shape: tuple[int, ...],
               pspec: tuple):
    """The DTensor of global ``shape`` placed by ``pspec`` over ``local``,
    this rank's shard (of ``local_shape``), which the caller owns: no
    copy and no collective, so a write into ``local`` is a write into the
    DTensor (a CUDA graph's static input, a state updated in place).
    Without a mesh, ``local`` itself."""
    if mesh is None:
        return local
    from torch.distributed.tensor import DTensor

    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements(mesh, pspec),
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def meta_dtensor(mesh, shape: tuple[int, ...], dtype, pspec: tuple):
    """A DTensor of global ``shape`` placed by ``pspec`` whose local shard
    is a ``meta`` tensor: the dry run's stand-in, never allocated."""
    local = torch.empty(local_shape(mesh, shape, pspec), dtype=dtype,
                        device="meta")
    return dtensor_of(mesh, local, shape, pspec)


def distribute(mesh, x: torch.Tensor, pspec: tuple):
    """The DTensor of a full tensor that every rank holds, equal on every
    rank (drawn from one seed or read from one file), placed by ``pspec``:
    each rank keeps a copy of its own shard of its own ``x``, with no
    collective. A value that each rank computed for itself may differ
    between ranks in its last bits; its caller makes the ranks agree
    first (a broadcast), or the replicas would quietly differ."""
    local = local_part(x.detach(), mesh, pspec).clone(
        memory_format=torch.contiguous_format)
    return dtensor_of(mesh, local, tuple(x.shape),
                      pspec).requires_grad_(x.requires_grad)


# ------------------------------------------------------------ collectives


def _reduce(x: torch.Tensor, op: str, groups) -> torch.Tensor:
    """All-reduce of a local tensor over each process group in turn (a
    dim split over two mesh axes reduces over both)."""
    for g in groups:
        x = torch.ops._c10d_functional.all_reduce(x, op, g.group_name)
        x = torch.ops._c10d_functional.wait_tensor(x)
    return x


class _SumReplicated(torch.autograd.Function):
    """``psum`` inside a region: the forward all-reduces each rank's
    partial sum; the result is the same on every rank, so its gradient
    reaches each partial unchanged (the backward is the identity)."""

    @staticmethod
    def forward(ctx, x, groups):
        return _reduce(x, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def psum(x: torch.Tensor, groups) -> torch.Tensor:
    return _SumReplicated.apply(x, tuple(groups)) if groups else x


class _SumSplit(torch.autograd.Function):
    """``psum`` inside a region whose result each rank then uses on its
    own shard (its own channels): each rank's gradient of the sum is only
    its shard's part, so the backward all-reduces as the forward does."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return _reduce(x, "sum", groups)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, "sum", ctx.groups), None


def psum_split(x: torch.Tensor, groups) -> torch.Tensor:
    return _SumSplit.apply(x, tuple(groups)) if groups else x


def pmax(x: torch.Tensor, groups) -> torch.Tensor:
    """``pmax`` of a value that carries no gradient (the softmax
    stabiliser): all-reduce max of the detached tensor."""
    return _reduce(x.detach(), "max", groups) if groups else x.detach()


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """All-gather of a local tensor along ``dim`` over ``group``, the
    ranks' parts in rank order."""
    n = group.size()
    y = torch.ops._c10d_functional.all_gather_into_tensor(
        x.unsqueeze(0).contiguous(), n, group.group_name)
    y = torch.ops._c10d_functional.wait_tensor(y)
    return torch.movedim(y, 0, dim).flatten(dim, dim + 1)


def _scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Reduce-scatter of a local tensor along ``dim`` over ``group``: the
    sum over the ranks of rank i's part, on rank i (``_gather``'s
    adjoint)."""
    n = group.size()
    parts = torch.movedim(x.unflatten(dim, (n, x.shape[dim] // n)), dim, 0)
    y = torch.ops._c10d_functional.reduce_scatter_tensor(
        parts.contiguous(), "sum", n, group.group_name)
    return torch.ops._c10d_functional.wait_tensor(y).squeeze(0)


class _GatherSplit(torch.autograd.Function):
    """All-gather inside a region whose result each rank then uses on its
    own part of the work: each rank's gradient of the whole is only its
    own part's, so the backward sums them and hands each rank the rows of
    its own piece (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.dim, ctx.group), None, None


def gather_split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherSplit.apply(x, dim % x.ndim, group)


def head_group(mesh, n_heads: int):
    """The process group of the model ranks that share this rank's head
    when ``n_heads`` heads split over the model axis of tp = n_heads · g
    ranks by their columns: the g consecutive model ranks of head r // g
    (model rank r holds block r of a column-parallel weight, block r % g
    of that head's columns). The last dim of a ``DeviceMesh`` whose model
    axis is split into ("head", "col"), made outside any dispatch mode (a
    counter's fake tensors) once per mesh and ``n_heads``: every rank
    makes it where the model first needs it, in the same order, so on
    NCCL that is a pass before any CUDA-graph capture. A mesh's groups
    are kept on the mesh itself, not by its value: a new mesh equal to
    one whose process group was destroyed makes its own."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.utils._python_dispatch import _disable_current_modes

    groups = mesh.__dict__.setdefault("_head_groups", {})
    if n_heads not in groups:
        names = list(mesh.mesh_dim_names)
        i = names.index("model")
        with _disable_current_modes():
            ranks = torch.movedim(mesh.mesh, i, -1)
            ranks = ranks.reshape(*ranks.shape[:-1], n_heads,
                                  ranks.shape[-1] // n_heads)
            sub = DeviceMesh(mesh.device_type, ranks, mesh_dim_names=(
                *names[:i], *names[i + 1:], "head", "col"))
        groups[n_heads] = sub.get_group("col")
    return groups[n_heads]


# ------------------------------------------------------------ context


class ShardCtx:
    """Carries the mesh + rules through model apply functions.

    ``constrain(x, *logical_axes)`` redistributes the DTensor ``x`` to the
    placements the logical axes resolve to (the reference's
    ``with_sharding_constraint``), with the same best-effort divisibility
    resolution used for params. Without a mesh every method is the
    identity, so the same model code runs on one device and on a mesh.
    """

    def __init__(self, mesh=None, cfg: ShardingConfig | None = None):
        self.mesh = mesh
        self.cfg = cfg or ShardingConfig()

    def pspec(self, logical_axes: tuple[Any, ...],
              shape: tuple[int, ...]) -> tuple:
        if self.mesh is None:
            return ()
        return resolve_pspec(self.mesh, logical_axes, shape, self.cfg)

    def placements(self, logical_axes: tuple[Any, ...],
                   shape: tuple[int, ...]) -> tuple:
        return placements(self.mesh, self.pspec(tuple(logical_axes), shape))

    def constrain(self, x: torch.Tensor, *logical_axes: Any) -> torch.Tensor:
        if self.mesh is None:
            return x
        x = self._reduce_partial(self.as_dtensor(x))
        return x.redistribute(self.mesh,
                              self.placements(tuple(logical_axes), x.shape))

    def _reduce_partial(self, x):
        """``x`` with its Partial sums all-reduced (the row-parallel sum),
        as a region whose gradient is the identity: the sum is the same on
        every rank, so each rank's partial takes the whole gradient
        (Megatron's g), where DTensor's own redistribute would hand back a
        Partial gradient and reduce it again at the next product."""
        from torch.distributed.tensor import Replicate

        part = [i for i, p in enumerate(x.placements) if p.is_partial()]
        if not part:
            return x
        mid = tuple(Replicate() if i in part else p
                    for i, p in enumerate(x.placements))
        groups = [self.mesh.get_group(i) for i in part]
        return self.region(lambda t: psum(t, groups), mid, (x.placements,),
                           (mid,), x)

    def as_dtensor(self, x: torch.Tensor):
        """``x`` itself if it is a DTensor, else ``x`` (a tensor every rank
        holds whole) as a replicated one."""
        from torch.distributed.tensor import DTensor, Replicate

        if isinstance(x, DTensor):
            return x
        return DTensor.from_local(x, self.mesh,
                                  [Replicate()] * self.mesh.ndim,
                                  run_check=False)

    def fsdp_gather(self, tree):
        """A tree of parameters with every DTensor leaf gathered over the
        mesh axes that "fsdp" names (ZeRO-3: a layer's weights gathered
        whole on the data axis before its products, their gradients
        reduce-scattered back by the redistribute's backward), its
        tensor-parallel sharding kept; the tree itself without a mesh."""
        if self.mesh is None:
            return tree
        from torch.distributed.tensor import DTensor, Replicate

        names = list(self.mesh.mesh_dim_names)
        dims = {names.index(a) for a in self.cfg.mesh_axes("fsdp")
                if a in names}

        def one(x):
            if not isinstance(x, DTensor):
                return x
            pl = tuple(Replicate() if i in dims else p
                       for i, p in enumerate(x.placements))
            return x if pl == tuple(x.placements) else \
                x.redistribute(self.mesh, pl)

        return _map_tree(one, tree)

    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        return axis_size(self.mesh, self.cfg.mesh_axes("dp"))

    def tp_size(self) -> int:
        if self.mesh is None:
            return 1
        return axis_size(self.mesh, self.cfg.mesh_axes("model"))

    def local_rows(self, b: int) -> int:
        """The rows of a batch of ``b`` that each rank holds when the
        batch is split over the dp axes that divide it."""
        if self.mesh is None:
            return b
        return local_shape(self.mesh, (b,), self.pspec(("dp",), (b,)))[0]

    # ---- regions: local_map bodies with explicit collectives

    def axes_of(self, logical: str) -> tuple[str, ...]:
        """The mesh axes (present in the mesh) a logical axis names."""
        sizes = mesh_sizes(self.mesh)
        return tuple(a for a in self.cfg.mesh_axes(logical) if a in sizes)

    def groups(self, axes) -> list:
        """The process groups of the mesh axes ``axes`` of size > 1."""
        sizes = mesh_sizes(self.mesh)
        return [self.mesh.get_group(a) for a in axes if sizes[a] > 1]

    def coord(self, axis: str) -> int:
        """This rank's index along mesh axis ``axis``."""
        return self.mesh.get_local_rank(axis)

    def rep(self):
        """Placements replicated over the whole mesh."""
        from torch.distributed.tensor import Replicate

        return tuple(Replicate() for _ in range(self.mesh.ndim))

    def with_dims(self, base, axes, placement):
        """``base`` placements with ``placement`` on the mesh dims of
        ``axes`` (those of size > 1; a size-1 dim keeps ``base``'s)."""
        sizes = mesh_sizes(self.mesh)
        names = list(self.mesh.mesh_dim_names)
        out = list(base)
        for a in axes:
            if a in names and sizes[a] > 1:
                out[names.index(a)] = placement
        return tuple(out)

    def region(self, fn, out_placements, in_placements, in_grad_placements,
               *args):
        """``fn(*local args)`` as a ``local_map`` body: each DTensor
        argument redistributed to its ``in_placements`` entry (None for a
        non-tensor) and passed as its local shard, the gradient of that
        shard taken to have ``in_grad_placements`` (None: an input that
        takes none keeps its own); the outputs wrapped with
        ``out_placements`` (one placement tuple for a single tensor, a
        tuple of them for a tuple of outputs). None arguments pass
        through."""
        from torch.distributed.tensor.experimental import local_map

        if in_grad_placements is None:
            in_grad_placements = in_placements
        keep = [i for i, a in enumerate(args) if a is not None]
        in_pl = tuple(in_placements[i] for i in keep)
        grad_pl = tuple(in_placements[i] if in_grad_placements[i] is None
                        else in_grad_placements[i] for i in keep)

        def body(*kept):
            full = [None] * len(args)
            for i, a in zip(keep, kept):
                full[i] = a
            return fn(*full)

        if out_placements and not isinstance(out_placements[0], tuple):
            out_placements = list(out_placements)   # one output
        return local_map(body, out_placements=out_placements,
                         in_placements=in_pl, in_grad_placements=grad_pl,
                         device_mesh=self.mesh,
                         redistribute_inputs=True)(*(args[i] for i in keep))

    @contextlib.contextmanager
    def scope(self):
        """Where plain tensors (masks, rope frequencies, zeros) meet
        DTensors in a forward, they count as replicated (DTensor's implicit
        replication, restored to what it was on exit, so scopes nest);
        nothing without a mesh. The model keeps plain tensors out of what
        its backward reads: rope tables are DTensors."""
        if self.mesh is None:
            yield
            return
        from torch.distributed.tensor import DTensor

        disp = DTensor._op_dispatcher
        before = disp._allow_implicit_replication
        disp._allow_implicit_replication = True
        try:
            yield
        finally:
            disp._allow_implicit_replication = before

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` (a tensor every rank holds whole, or a DTensor) as a
        DTensor replicated over the mesh; ``x`` itself without one."""
        if self.mesh is None:
            return x
        return self.as_dtensor(x).redistribute(self.mesh, self.rep())


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


NO_MESH = ShardCtx(None)


def make_test_mesh(device_type: str = "cpu"):
    """1-device mesh with the production axis names (for tests), over the
    default process group (which must have one rank)."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))


def batch_map(ctx: ShardCtx, fn, args, batch_dims, out_batch_dims,
              rows_over_model: bool = False):
    """``fn(*local args)`` on each rank's shard of the batch, replicated
    over every other mesh axis: the region of a piece with no DTensor
    rule, or none worth sharding, run redundantly across the model axis.
    With ``rows_over_model`` each rank's batch shard is split again over
    the model axis (which the caller has checked divides it), so that no
    rank repeats another's rows.

    ``batch_dims[i]`` is argument i's batch dim (split over the dp axes
    that divide the batch), None for a parameter or a non-tensor (whole on
    every rank); ``out_batch_dims[j]`` likewise for output j (a tuple of
    outputs, or one output when ``out_batch_dims`` is an int). A
    parameter's gradient is a sum over the ranks that split the batch
    (Partial there). Without a mesh, ``fn(*args)``."""
    if ctx.mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Partial, Shard

    b = next(a.shape[d] for a, d in zip(args, batch_dims) if d is not None)
    bp = ctx.placements(("dp",), (b,))
    if rows_over_model:
        bp = ctx.with_dims(bp, ctx.axes_of("model"), Shard(0))
    split = [i for i, p in enumerate(bp) if isinstance(p, Shard)]

    def at(d):
        if d is None:
            return ctx.rep()
        return tuple(Shard(d) if i in split else p
                     for i, p in enumerate(ctx.rep()))

    part = tuple(Partial() if i in split else p
                 for i, p in enumerate(ctx.rep()))
    tensor = [isinstance(a, torch.Tensor) for a in args]
    in_pl = tuple(at(d) if t else None for t, d in zip(tensor, batch_dims))
    grad_pl = tuple((at(d) if d is not None else part) if t else None
                    for t, d in zip(tensor, batch_dims))
    if isinstance(out_batch_dims, int) or out_batch_dims is None:
        out_pl = at(out_batch_dims)
    else:
        out_pl = tuple(at(d) if d != "none" else None
                       for d in out_batch_dims)
    return ctx.region(fn, out_pl, in_pl, grad_pl, *args)


def write_states(ctx: ShardCtx, cache, new: dict):
    """A recurrent mixer's states after a step: ``new`` itself after a
    prefill (no ``cache``), else ``cache`` holding them. The mixer's
    region wrote its local shards in place; on a mesh the region took
    copies of any state it gathers, so the values go back into ``cache``
    at the cache's own placements."""
    if cache is None:
        return new
    if ctx.mesh is not None:
        for name, t in new.items():
            cache[name].copy_(t.redistribute(ctx.mesh,
                                             cache[name].placements))
    return cache


def distribute_tree(mesh, specs, tree, cfg: ShardingConfig | None = None):
    """A tree of full tensors (every rank holding the same) as DTensors
    placed by ``param_pspec`` of the spec tree ``specs`` of its shape."""
    if isinstance(tree, dict):
        return {k: distribute_tree(mesh, specs[k], v, cfg)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [distribute_tree(mesh, s, v, cfg) for s, v in zip(specs, tree)]
    return distribute(mesh, tree, param_pspec(mesh, specs, cfg))
