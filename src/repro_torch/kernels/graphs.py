"""A step captured once into a CUDA graph and replayed: the port's
counterpart of the reference's ``jax.jit`` of its four device programs
(the batcher's decode step, ``serving/generator.py``; the model judge's
score, ``core/judge.py``; the model embedder's encode,
``core/embedder.py``; the trainer's donated step, with or without a
mesh, ``launch/steps.py`` ``TrainStepGraph``), which compile each into
one device program.

:class:`StepGraph` runs the step once eagerly on the device's side
stream (:func:`side_stream`; with ``torch.cuda.set_sync_debug_mode(
"error")``, so that a hidden host sync raises there with its stack,
before the capture would fail on it), then captures it on the same
stream into a ``torch.cuda.CUDAGraph`` on the memory pool its owner
gives. A step over a mesh captures its NCCL collectives with it: the
warm-up's first collectives make the process group's communicators, and
each ``wait_tensor`` joins NCCL's stream back into the capturing one.
Inputs are the step's own static tensors, which the owner refills in
place before each :meth:`StepGraph.replay`; the output is what the
capture returned (a tensor, or a dict of tensors), rewritten by every
replay. A capture that fails raises: there is no eager fall back.

The attention kernels' wrappers count the calls that launched
(``launches``, ``launches_tc``, ``launches_simt``,
``launches_simt_any``; ``plain_calls``). A
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
COUNTS = ("launches", "launches_tc", "launches_simt", "launches_simt_any",
          "plain_calls")
_SIDE: dict = {}        # device index -> the warm-ups' and captures' stream


def side_stream() -> torch.cuda.Stream:
    """The one stream of every warm-up and capture on the current device.
    cuBLAS keeps a workspace per (handle, stream), made at the first
    product on that stream: made at an eager warm-up it lives in the
    ordinary pool and every capture reuses it, where one made inside a
    capture would land in that graph's pool and hold its segment after
    the graph is gone."""
    dev = torch.cuda.current_device()
    if dev not in _SIDE:
        _SIDE[dev] = torch.cuda.Stream()
    return _SIDE[dev]


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
        side = side_stream()
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
            # "thread_local": only this thread's calls are checked against
            # the capture. Under the default "global" mode a call that
            # is unsafe during a capture fails in any thread, and
            # ProcessGroupNCCL's watchdog thread queries its collectives'
            # CUDA events all along, so a step over a mesh could not be
            # captured; no other thread of the port launches work.
            with torch.cuda.graph(self.graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                self.out = fn()
        finally:
            after = counts()
            _add({k: before[k] - v for k, v in after.items()})
        self.launches = {k: v - before[k] for k, v in after.items()}
        self.pool_bytes = torch.cuda.memory_reserved() - reserved

    def replay(self):
        """Run the captured step on the current stream; returns its
        output (read it before the next replay rewrites it)."""
        self.graph.replay()
        _add(self.launches)
        return self.out
