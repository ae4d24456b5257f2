"""A loop of trips that all have the same shapes, in the role of the
reference's ``nn/runtime.py``.

The reference's structural loops are ``lax.scan``s, and XLA's cost
analysis counts a loop body once, so its dry run compiled unrolled
variants and extrapolated. Eager code runs every trip, and so does a
count of it (``launch/costs.CostMode``): at xlstm-350m's ``prefill_32k``
that is 32,768 sLSTM steps a layer. A loop written with :func:`scan` runs
every trip eagerly, but while a counter is active (``CostMode`` puts
itself on :data:`COUNTERS` when it is entered) it runs trips 1 and 2 and
has the counter add trip 2's counts ``n - 2`` more times
(``CostMode.mark`` / ``CostMode.repeat``): FLOPs, bytes, collectives and
the peak come out as a count of every trip. The output is joined at its
full shape from the two trips' outputs (the second one ``n - 1`` times),
which moves the same bytes as the whole loop's join. Where autograd
records the trips (a training step), every trip runs under the counter
too, since its backward must see them all.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_leaves

# The active counters, innermost last (see the module's docstring).
COUNTERS: list = []


def _recorded(*trees) -> bool:
    """Whether autograd records the ops that made these tensors."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(trees)
        if isinstance(t, torch.Tensor))


def scan(step, carry, n: int, dim: int = 1, stack: bool = True):
    """``step(t, carry) -> (carry, y)`` for t in 0..n-1 (n at least 1),
    every trip's shapes the same: ``(carry, ys)``, the trips' ``y``
    stacked along ``dim`` (joined along it by ``torch.cat`` when not
    ``stack``). Under a counter and no autograd, trips 1 and 2 run and are
    counted as ``n`` trips."""
    join = torch.stack if stack else torch.cat
    counter = COUNTERS[-1] if COUNTERS else None
    carry, y = step(0, carry)
    ys = [y]
    if counter is None or n <= 2 or _recorded(carry, y):
        for t in range(1, n):
            carry, y = step(t, carry)
            ys.append(y)
        return carry, join(ys, dim)
    mark = counter.mark()
    carry, y = step(1, carry)
    ys.append(y)
    held = counter.repeat(mark, n - 2)
    out = join([ys[0]] + [ys[1]] * (n - 1), dim)
    counter.release(held)
    return carry, out
