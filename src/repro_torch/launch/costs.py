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
``runtime.COUNTERS`` (the mode puts itself there while entered), runs two
trips, and has the mode count the second ``n - 2`` more times
(:meth:`CostMode.mark`, :meth:`CostMode.repeat`, :meth:`CostMode.release`).

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


class CostMode(FakeTensorMode):
    """Counts one rank's local ops while entered (see the module's
    docstring): ``flops``, ``bytes``, ``peak`` / ``live`` (bytes of
    storage made inside the mode) and ``collectives`` (a list of ``(op,
    bytes, group name)``)."""

    def __init__(self):
        super().__init__(allow_non_fake_inputs=True)
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

    def mark(self) -> Mark:
        """The counts before a trip; the peak from here on is the trip's
        own, until :meth:`repeat`."""
        m = Mark(self.flops, self.bytes, len(self.collectives), self.live,
                 self.peak)
        self.peak = self.live
        return m

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
        self.peak = max(mark.peak, self.peak + held)
        self.live += held
        return held

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
            self.peak = max(self.peak, self.live)
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
