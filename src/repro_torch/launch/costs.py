"""Per-device cost counter for the dry run, in place of XLA's
``cost_analysis`` and ``memory_analysis``.

:class:`CostMode` is a ``FakeTensorMode`` entered around a step whose
inputs are DTensors with ``meta`` shards (``nn.param.struct_tree``). DTensor
runs each op as local ops on every rank's shard, and the mode sees those:
one rank's program. It counts

* FLOPs: matmul, bmm, addmm and the attention kernels' ops as
  ``torch.utils.flop_counter`` counts them (its registry, where kernels 6
  and 7 register their products over the (query, key) pairs their masks
  keep; on ``meta`` the ops return their outputs' shapes alone);
* bytes accessed: the input plus output bytes of every local op that is
  not a view or a query of metadata (XLA's "bytes accessed");
* the peak of live local storage: each op's new storages from their
  creation until the last tensor on them dies;
* the collectives (op, bytes of the result, process group).

A loop written with ``nn/runtime.scan`` finds the mode on
``runtime.COUNTERS`` (the mode puts itself there while entered), runs a
few trips, and has the mode count one of them as the trips it stands for
(:meth:`CostMode.mark`, :meth:`CostMode.repeat`, :meth:`CostMode.release`;
where autograd records the trips, :meth:`CostMode.token` holds the
storage they keep for the backward until it ends). ``microbatches`` cuts
a training step to its first microbatches (``nn/runtime.microbatches``),
and the mode then keeps the peak of each segment of the step apart
(:meth:`CostMode.boundary`), for the dry run to extrapolate in depth.

The mode also sees DTensor's own calls: at global shapes on the DTensors
themselves, and its sharding propagation's at global shapes on fake
tensors of the mesh's device type. Only ops whose tensors all lie on
``meta`` are counted, so neither is.
"""
from __future__ import annotations

import dataclasses
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.nn import runtime

_COLLECTIVES = {"all_reduce", "all_gather_into_tensor",
                "reduce_scatter_tensor", "all_to_all_single", "broadcast"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True)
class Mark:
    """The counts at the start of a loop's trip (:meth:`CostMode.mark`)."""
    flops: float
    bytes: float
    n_collectives: int
    live: int
    peak: int
    keys: frozenset | None = None


class CostMode(FakeTensorMode):
    """Counts one rank's local ops while entered (see the module's
    docstring): ``flops``, ``bytes``, ``peak`` / ``live`` (bytes of
    storage made inside the mode) and ``collectives`` (a list of ``(op,
    bytes, group name)``). ``microbatches`` (None: all) is how many of a
    training step's microbatches run (``nn/runtime.microbatches``);
    ``trip`` is then the last one's FLOPs, bytes and span of
    ``collectives``, ``shift`` the live bytes it added, and ``segments``
    the peak of each segment of the step (:meth:`boundary`)."""

    def __init__(self, microbatches: int | None = None):
        super().__init__(allow_non_fake_inputs=True)
        self.microbatches = microbatches
        self.trip = None
        self.shift = 0
        # the dry run's variants keep the peak of each segment of the
        # step too (:meth:`boundary`)
        self.segmented = microbatches is not None
        self.segments: list[tuple[tuple, int]] = []
        self.trip_index = 0
        self._segment = ("start", 0)
        self._segment_peak = 0
        self.flops = 0.0
        self.bytes = 0.0
        self.live = 0
        self.peak = 0
        self.collectives: list[tuple[str, int, str]] = []
        self._storages: dict[int, list[int]] = {}
        self._depth = 0

    def __enter__(self):
        out = super().__enter__()
        runtime.COUNTERS.append(self)
        return out

    def __exit__(self, *exc):
        runtime.COUNTERS.remove(self)
        return super().__exit__(*exc)

    def mark(self, keys: bool = False) -> Mark:
        """The counts before a trip; the peak from here on is the trip's
        own, until :meth:`repeat`. ``keys`` also notes the live storages,
        for :meth:`made_since`."""
        m = Mark(self.flops, self.bytes, len(self.collectives), self.live,
                 self.peak, frozenset(self._storages) if keys else None)
        self.peak = self.live
        return m

    def made_since(self, mark: Mark) -> list:
        """The live storages made since ``mark`` (taken with ``keys``)."""
        return [(k, e) for k, e in self._storages.items()
                if k not in mark.keys]

    def live_bytes(self, storages: list) -> int:
        """The bytes of those of ``storages`` (:meth:`made_since`) that
        are still live."""
        return sum(e[0] for k, e in storages if self._storages.get(k) is e)

    def token(self) -> torch.Tensor:
        """An empty tensor whose storage counts as live bytes from
        :meth:`grow` until the tensor dies."""
        with _disable_current_modes():
            t = torch.empty(0, device="meta")
        key = t.untyped_storage()._cdata
        self._storages[key] = [0, 1]
        weakref.finalize(t, self._release, key)
        return t

    def grow(self, token: torch.Tensor, nbytes: int) -> None:
        """``nbytes`` more live on ``token``'s storage."""
        self._storages[token.untyped_storage()._cdata][0] += nbytes
        self.live += nbytes
        self._reach(self.live)

    def _reach(self, nbytes: int) -> None:
        """``nbytes`` live at once: the peak, and the segment's."""
        self.peak = max(self.peak, nbytes)
        self._segment_peak = max(self._segment_peak, nbytes)

    def boundary(self, label) -> None:
        """A segment of the step ends and the next, ``(label, trip
        index)``, starts: the ended one's peak goes to ``segments``. The
        dry run marks the edges of the layer stacks, forward and backward,
        and of each microbatch, so that the live bytes in a segment rise
        with depth in one way (``launch/dryrun.extrapolated_metrics``)."""
        self.segments.append((self._segment, self._segment_peak))
        self._segment = (label, self.trip_index)
        self._segment_peak = self.live

    def repeat(self, mark: Mark, times: int) -> int:
        """Count the trip since ``mark`` ``times`` more times: its FLOPs,
        bytes and collectives, and the storage it left live (a loop's
        stacked outputs), held until :meth:`release` of the bytes
        returned. The peak is the larger of the one before the trip and
        the trip's own on top of the held bytes, as the last of ``times
        + 1`` trips would reach it."""
        self.flops += times * (self.flops - mark.flops)
        self.bytes += times * (self.bytes - mark.bytes)
        self.collectives.extend(self.collectives[mark.n_collectives:]
                                * times)
        held = max(0, times * (self.live - mark.live))
        own = self.peak
        self.peak = max(mark.peak, own + held)
        self._segment_peak = max(self._segment_peak, own + held)
        self.live += held
        return held

    def trip_ends(self, mark: Mark) -> None:
        """The trip since ``mark`` ends: its FLOPs, bytes and collectives
        are kept as ``trip``, the live bytes it added as ``shift``."""
        self.trip = (self.flops - mark.flops, self.bytes - mark.bytes,
                     (mark.n_collectives, len(self.collectives)))
        self.shift = self.live - mark.live
        self.peak = max(mark.peak, self.peak)

    def release(self, held: int) -> None:
        """The bytes :meth:`repeat` held die (the loop's outputs)."""
        self.live -= held

    def dispatch(self, func, types, args=(), kwargs=None):
        self._depth += 1
        try:
            out = super().dispatch(func, types, args, kwargs)
        finally:
            self._depth -= 1
        if self._depth:
            # an op of another op's decomposition (the fake mode's first
            # call of a signature, not its cached ones): counted there
            return out
        kwargs = kwargs or {}
        ins = [a for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
        if any(isinstance(t, DTensor) for t in ins + outs) or \
                not all(t.device.type == "meta" for t in ins + outs):
            return out
        if (not outs and not ins) or func.namespace == "prim":
            return out      # prim: a query of metadata (``prim.device``)
        if func.namespace == "_c10d_functional":
            name = func._opname
            if name in _COLLECTIVES:
                group = args[-1] if isinstance(args[-1], str) else \
                    kwargs.get("group_name")
                self.collectives.append((name, sum(_nbytes(o) for o in outs),
                                         group))
            return out
        from torch.utils.flop_counter import flop_registry

        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += sum(_nbytes(t) for t in ins + outs)
        for o in outs:
            self._track(o)
        return out

    def _track(self, t: torch.Tensor) -> None:
        key = t.untyped_storage()._cdata
        entry = self._storages.get(key)
        if entry is None:
            n = t.untyped_storage().nbytes()
            entry = self._storages[key] = [n, 0]
            self.live += n
            self._reach(self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        entry = self._storages.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]
