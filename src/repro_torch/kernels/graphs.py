"""A step captured once into a CUDA graph and replayed: the port's
counterpart of the reference's ``jax.jit`` of its serving steps (the
batcher's decode step, ``serving/generator.py``; the model judge's score,
``core/judge.py``), which compile each step into one device program.

:class:`StepGraph` runs the step once eagerly on a side stream (with
``torch.cuda.set_sync_debug_mode("error")``, so that a hidden host sync
raises there with its stack, before the capture would fail on it), then
captures it into a ``torch.cuda.CUDAGraph`` on the memory pool its owner
gives. Inputs are the step's own static tensors, which the owner refills
in place before each :meth:`StepGraph.replay`; the output is the tensor
the capture returned, rewritten by every replay. A capture that fails
raises: there is no eager fall back.

The attention kernels' wrappers count the calls that launched
(``launches``, ``launches_tc``, ``launches_simt``; ``plain_calls``). A
captured call launches at each replay and not at its capture, so the
capture's counts are taken back and added again at every replay. The
eager warm-up did launch, and stays counted.
"""
from __future__ import annotations

import gc

import torch

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention_fwd

COUNTED = (flash_attention_fwd, decode_attention)
COUNTS = ("launches", "launches_tc", "launches_simt", "plain_calls")


def counts() -> dict:
    """Every counter of the attention kernels' wrappers."""
    return {(w, n): getattr(w, n) for w in COUNTED for n in COUNTS}


def _add(delta: dict) -> None:
    for (w, n), d in delta.items():
        if d:
            setattr(w, n, getattr(w, n) + d)


class StepGraph:
    """``fn()`` (no arguments: it reads its owner's static inputs)
    captured into one CUDA graph on ``pool`` (``torch.cuda.
    graph_pool_handle()``, shared by the owner's graphs). ``pool_bytes``
    is what the capture added to the pool; ``launches`` the wrappers'
    counts of one replay."""

    def __init__(self, fn, pool=None):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        before = counts()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool):
                self.out = fn()
        finally:
            after = counts()
            _add({k: before[k] - v for k, v in after.items()})
        self.launches = {k: v - before[k] for k, v in after.items()}
        self.pool_bytes = torch.cuda.memory_reserved() - reserved

    def replay(self):
        """Run the captured step on the current stream; returns its
        output tensor (read it before the next replay rewrites it)."""
        self.graph.replay()
        _add(self.launches)
        return self.out
