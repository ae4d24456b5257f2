"""GPipe pipeline parallelism over a mesh axis, the port of the reference's
``nn/pipeline.py``.

``pipeline_apply`` runs ``stage_fn`` on each rank of the mesh axis, one
stage a rank, and streams the microbatches through the classic GPipe
schedule: S + M − 1 ticks, bubble fraction (S − 1) / (S + M − 1). At tick
t stage 0 takes microbatch t, stage s > 0 the activation stage s − 1
handed it at tick t − 1, and every stage hands its output on along the
ring with ``torch.distributed`` P2P on the axis's group (the reference's
``ppermute``); the last stage's outputs are the pipeline's, all-reduced
over the axis so that every rank holds them (the reference's ``psum``).

A stage skips its bubble ticks (nothing to compute): its output there is
zeros, which the reference's schedule computes and discards. Every
choice between values is a ``torch.where`` on a condition that is
constant on the rank (the reference's ``jnp.where``), never a product
with 0: an inf or NaN in one microbatch stays in that microbatch, in the
output and in the gradient, where ``0 * inf`` would spread NaN to the
others.

Gradients. The ring shift is an autograd function whose backward sends
the cotangent the other way. The final all-reduce's backward is the
identity: the output is replicated and every rank computes the same loss
from it, so all-reducing the cotangents would count it S times and give
every stage S times its gradient; the reference's ``jax.grad`` gives it
once. Gradients reach the stages' parameters; an input that requires
grad is refused at S > 1 (the reference's would be the sum over the axis
of stage 0's; no caller asks for it).

Every rank must run every ring shift's backward, in the same order, or a
P2P call waits forever, whatever inputs a caller asks gradients for
(``torch.autograd.grad`` runs only the nodes on a path to them). So each
rank's whole chain of ticks stays in its graph and on a path to every
parameter: the first buffer is a function of the stage's parameters
with zero gradient (``_Tie``), and a skipped tick, a stage that feeds
from the input and the non-last stages' outputs each select past the
value they do not use with ``torch.where``, whose backward gives that
branch exact zeros. The backwards then run tick T − 2 down to 0 on every
rank.

At S = 1 the ring shift is the identity and no collective runs (a rank
cannot send to itself); the pipeline is then the microbatches run through
``stage_fn`` in order, bitwise.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.train import tree as tr


def _shift(x: torch.Tensor, group, ranks: list[int], pos: int,
           step: int) -> torch.Tensor:
    """Send ``x`` to axis position ``pos + step`` and return what
    position ``pos - step`` sent, around the ring."""
    n = len(ranks)
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[(pos + step) % n],
                      group),
           dist.P2POp(dist.irecv, out, ranks[(pos - step) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Forward: to the next stage; backward: the cotangent to the
    previous one."""

    @staticmethod
    def forward(ctx, x, group, ranks, pos):
        ctx.comm = (group, ranks, pos)
        return _shift(x, group, ranks, pos, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, *ctx.comm, -1), None, None, None


class _Tie(torch.autograd.Function):
    """``x`` as a function of ``*deps`` with zero gradient: the chain of
    ticks that starts at ``x`` lies on a path to every one of them."""

    @staticmethod
    def forward(ctx, x, *deps):
        ctx.deps = [(d.shape, d.dtype, d.device) for d in deps]
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return (None, *(torch.zeros(s, dtype=t, device=d)
                        for s, t, d in ctx.deps))


class _Replicate(torch.autograd.Function):
    """Forward: the sum over the axis; backward: the identity (every rank
    already holds the cotangent of the one replicated output)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def pipeline_apply(mesh, axis: str, stage_fn, stage_params, x_microbatches):
    """Run a pipeline over ``axis`` of the ``DeviceMesh`` ``mesh``.

    stage_fn(params, x) -> x     (one stage's computation, shape-preserving)
    stage_params: this rank's stage's tree, the reference's
        ``stage_params[rank]`` (stage s is the rank at position s of the
        axis)
    x_microbatches: (M, mb, ...) microbatched input, the same on every
        rank of the axis

    Every rank of the axis must ask for the same gradients: its stage's
    parameters require grad on all of them or on none.

    Returns the (M, mb, ...) outputs (each microbatch through every stage,
    in order) on every rank of the axis.
    """
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    xs = x_microbatches
    m = xs.shape[0]
    if n_stages == 1:
        return torch.stack([stage_fn(stage_params, xs[t]) for t in range(m)])
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    sid = mesh.get_local_rank(axis)
    last = sid == n_stages - 1
    if xs.requires_grad:
        raise ValueError("pipeline_apply: the input's gradient over several "
                         "stages is not computed; pass an input that does "
                         "not require grad")
    deps = [a for a in tr.leaves(stage_params) if a.requires_grad]
    buf = torch.zeros_like(xs[0])
    if deps:
        buf = _Tie.apply(buf, *deps)
    yes, no = (torch.tensor(v, device=xs.device) for v in (True, False))
    outs = [None] * m
    for t in range(n_stages + m - 1):
        mb = t - sid                        # this stage's microbatch
        if 0 <= mb < m:
            cur = torch.where(yes, xs[t], buf) if sid == 0 else buf
            y = stage_fn(stage_params, cur)
        else:                               # a bubble tick
            y = torch.where(no, buf, torch.zeros_like(buf))
        if t >= n_stages - 1:               # the last stage's output
            outs[t - (n_stages - 1)] = torch.where(yes if last else no, y,
                                                   torch.zeros_like(y))
        if t < n_stages + m - 2:
            buf = _RingShift.apply(y, group, ranks, sid)
    return _Replicate.apply(torch.stack(outs), group)
