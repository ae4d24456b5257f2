"""A loop of trips that all have the same shapes, in the role of the
reference's ``nn/runtime.py``.

The reference's structural loops are ``lax.scan``s, and XLA's cost
analysis counts a loop body once, so its dry run compiled unrolled
variants and extrapolated. Eager code runs every trip, and so does a
count of it (``launch/costs.CostMode``): at xlstm-350m's ``prefill_32k``
that is 32,768 sLSTM steps a layer. A loop written with :func:`scan` runs
every trip eagerly, but while a counter is active (``CostMode`` puts
itself on :data:`COUNTERS` when it is entered) it runs a few trips and
has the counter count one of them as the trips it stands for
(``CostMode.mark`` / ``CostMode.repeat``): FLOPs, bytes, collectives and
the peak come out as a count of every trip.

* Where autograd does not record the trips, trips 0 and 1 run, trip 1
  counted ``n - 1`` times. The output is joined at its full shape from
  the two trips' outputs (the second one ``n - 1`` times), which moves
  the same bytes as the whole loop's join.
* Where autograd records them (a training step, or its recompute under
  remat), trips 0, 1 and 2 run, trip 1 counted ``n - 2`` times in the
  forward and in the backward. Trip 1 is the one that stands for the
  middle trips of the backward: the last trip's gets no gradient of its
  carry, and its gradients of the tensors that every trip reads (sLSTM's
  ``wx``, the weights) reach their sums first, with no add, where each
  later trip's is added. Identity nodes on the carry before trips 1 and 2
  (:class:`_Gate`) bracket trip 1's backward, which autograd runs between
  them, since it runs nodes in the reverse order of their making. The
  storage that trip 1 keeps for its backward is held ``n - 3`` more times
  from the forward (or the recompute) until that backward ends, and the
  join sends the gradient of the copies of trip 1's output nowhere, as
  the whole loop's join sends each slice to its own trip.

A step's microbatches are same-shaped trips too: :func:`microbatches`
runs all of them, or as many as a counter asks for (the dry run counts a
step at two microbatches and extrapolates), and :func:`stack_edge` marks
the edges of a stack of layers for the counter's peak.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_leaves, tree_unflatten

# The active counters, innermost last (see the module's docstring).
COUNTERS: list = []


def _recorded(*trees) -> bool:
    """Whether autograd records the ops that made these tensors."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(trees)
        if isinstance(t, torch.Tensor))


def microbatches(mbs: list):
    """The microbatches a step runs, in order: all of ``mbs``, or the
    first of them where the active counter's ``microbatches`` asks for
    fewer. There each starts a segment of the counter's peak
    (``CostMode.boundary``), and the counter notes the last one's counts
    and the live bytes it added (``CostMode.trip_ends``): a microbatch
    left out would start from the state that one leaves."""
    counter = COUNTERS[-1] if COUNTERS else None
    k = getattr(counter, "microbatches", None) if counter else None
    if k is None:
        yield from mbs
        return
    k = min(k, len(mbs))
    for i, mb in enumerate(mbs[:k]):
        counter.trip_index = i
        counter.boundary("microbatch")
        if i == k - 1 and k > 1:
            mark = counter.mark()
        yield mb
    if k > 1:
        counter.trip_ends(mark)
    counter.trip_index = None
    counter.boundary("tail")


def stack_edge(x: torch.Tensor, name: str, start: bool) -> torch.Tensor:
    """``x`` at the start or the end of a stack of layers (the decoder's
    repeated superblocks, the encoder's). Where the active counter keeps
    its peak by segments (``CostMode.segmented``), a segment starts here
    in the forward, and in the backward where the stack's gradient begins
    (its end) or is done (its start), at an identity node on ``x``."""
    counter = COUNTERS[-1] if COUNTERS else None
    if counter is None or not counter.segmented:
        return x
    counter.boundary((name, "forward" if start else "after forward"))
    if not _recorded(x):
        return x
    label = (name, "after backward" if start else "backward")
    return _Gate.apply(lambda: counter.boundary(label), None, x)[0]


class _Gate(torch.autograd.Function):
    """The identity on some tensors (a loop's carry, a stack's
    activations), whose backward calls ``hook`` once all their gradients
    are in, and ends the life of ``token`` (saved for the backward, so
    that a remat's recompute keeps its own token until then)."""

    @staticmethod
    def forward(ctx, hook, token, *xs):
        ctx.hook = hook
        ctx.token = token
        if token is not None:
            ctx.save_for_backward(token)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.hook()
        if ctx.token is not None:
            ctx.saved_tensors     # the recompute's token: released here
        ctx.token = None
        return (None, None, *grads)


def _gated(carry, hook, token=None):
    """``carry`` through a :class:`_Gate` (its tensors that autograd
    records; None if it records none)."""
    flat, spec = tree_flatten(carry)
    idx = [i for i, t in enumerate(flat)
           if isinstance(t, torch.Tensor) and t.requires_grad]
    if not idx:
        return None
    out = _Gate.apply(hook, token, *(flat[i] for i in idx))
    for i, t in zip(idx, out):
        flat[i] = t
    return tree_unflatten(flat, spec)


def scan(step, carry, n: int, dim: int = 1, stack: bool = True):
    """``step(t, carry) -> (carry, y)`` for t in 0..n-1 (n at least 1),
    every trip's shapes the same: ``(carry, ys)``, the trips' ``y``
    stacked along ``dim`` (joined along it by ``torch.cat`` when not
    ``stack``). Under a counter, trips 0 and 1 (0, 1 and 2 where autograd
    records them) run and are counted as ``n`` trips."""
    join = torch.stack if stack else torch.cat
    counter = COUNTERS[-1] if COUNTERS else None
    carry, y = step(0, carry)
    ys = [y]
    recorded = counter is not None and _recorded(carry, y)
    if counter is None or n <= (3 if recorded else 2):
        for t in range(1, n):
            carry, y = step(t, carry)
            ys.append(y)
        return carry, join(ys, dim)
    if recorded:
        return _scan_recorded(counter, step, carry, y, n, join, dim)
    mark = counter.mark()
    carry, y = step(1, carry)
    ys.append(y)
    held = counter.repeat(mark, n - 2)
    out = join([ys[0]] + [ys[1]] * (n - 1), dim)
    counter.release(held)
    return carry, out


def _scan_recorded(counter, step, carry, y0, n, join, dim):
    """Trips 1 and 2 of a recorded loop whose trip 0 ran (see the module's
    docstring)."""
    times = n - 3
    token = counter.token()
    back = {}

    def trip_1_ends():
        counter.repeat(back.pop("mark"), times)

    gated = _gated(carry, trip_1_ends, token)
    if gated is None:       # no gradient through the carry: every trip
        ys = [y0]
        for t in range(1, n):
            carry, y = step(t, carry)
            ys.append(y)
        return carry, join(ys, dim)
    mark = counter.mark(keys=True)
    carry, y1 = step(1, gated)
    held = counter.repeat(mark, times)
    kept = counter.made_since(mark)
    carry, y2 = step(2, _gated(carry,
                              lambda: back.__setitem__("mark",
                                                       counter.mark())))
    copy = y1.detach()
    out = join([y0, y1] + [copy] * times + [y2], dim)
    del y0, y1, y2, copy, gated, mark
    counter.release(held)
    counter.grow(token, times * counter.live_bytes(kept))
    return carry, out
