"""xLSTM blocks, mirroring the reference's ``nn/xlstm.py``: mLSTM (matrix
memory, chunkwise-parallel prefill) and sLSTM (scalar memory, a strictly
sequential scan) — arXiv:2405.04517.

mLSTM keeps a matrix memory C (B, H, dk, dv), a normaliser n (B, H, dk)
and a stabiliser m (B, H) with exponential input and forget gates. Its
prefill is the reference's chunkwise form (an attention-like term inside
a chunk, a recurrent carry between chunks, the carry's m starting at 0);
the state it returns for decode is the reference's closed form over the
whole sequence. Its decode, and a one-token prefill (m from -1e30), is the
recurrent update. sLSTM steps through time with per-head recurrent
weights. Decode writes every state into the cache in place (the port's
decode contract) and returns the same dict. The reference has no Pallas
kernel here: both are plain tensor ops in both packages.

On a mesh both cores split over the model axis as the reference's
compiled program splits them (:func:`split_rule`): whole heads a rank,
else rows of each rank's batch shard, else each head's columns over the
model ranks that share it (:class:`HeadPart`), else every model rank runs
its whole batch shard. The states leave at the cache's placement (batch
over the dp axes, whole over the model axis), as the reference's cache
specs place them.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.nn.config import XLSTMConfig
from repro_torch.nn.basic import COL, ROW, f32, f32_dtype
from repro_torch.nn import runtime
from repro_torch.nn.param import ParamSpec
from repro_torch.nn.sharding import (NO_MESH, batch_map, gather_split,
                                     head_group, psum_split, write_states)

# The split each call of a core took, by (block, rule), as
# :func:`split_rule` chose and counted it.
SPLITS: collections.Counter = collections.Counter()


def split_rule(ctx, block: str, n_heads: int, head_dim: int,
               batch: int) -> Optional[str]:
    """How a call of the xLSTM core ``block`` of ``n_heads`` heads of
    ``head_dim`` columns on a batch of ``batch`` rows divides over the
    model axis, from shapes alone, counted in SPLITS: ``"heads"``, whole
    heads a rank, where the model axis divides the heads; else
    ``"rows"``, each rank's batch shard split again over the model axis,
    where that divides it (no collective inside a loop); else
    ``"columns"``, each head's columns over the g model ranks that share
    it, where the model axis is n_heads · g and g divides ``head_dim``;
    else ``"replicated"``, every model rank running its whole batch
    shard. None without a mesh or on a model axis of 1: there is nothing
    to split over it (``batch_map`` over the dp axes)."""
    tp = ctx.tp_size()
    if ctx.mesh is None or tp == 1:
        return None
    if n_heads % tp == 0:
        rule = "heads"
    elif ctx.local_rows(batch) % tp == 0:
        rule = "rows"
    elif tp % n_heads == 0 and head_dim % (tp // n_heads) == 0:
        rule = "columns"
    else:
        rule = "replicated"
    SPLITS[block, rule] += 1
    return rule


@dataclasses.dataclass(frozen=True)
class HeadPart:
    """The columns of each head that a core computes: block ``c`` of
    ``g`` equal blocks, the other blocks on the other ranks of ``group``
    (the model ranks that share the head, ``sharding.head_group``), under
    the ``columns`` rule; every column (:data:`WHOLE`: g 1, no group)
    otherwise, where each method is the identity. A product that
    contracts over a head's columns is a partial sum on each rank
    (:meth:`total`); one that needs a whole head's operand gathers it
    (:meth:`gather`)."""
    g: int = 1
    c: int = 0
    group: Any = None

    def total(self, *parts: torch.Tensor) -> tuple:
        """``parts`` summed over the group, in one all-reduce."""
        if self.group is None:
            return parts
        flat = psum_split(torch.cat([p.reshape(-1) for p in parts]),
                          [self.group])
        return tuple(t.view_as(p) for t, p in zip(
            flat.split([p.numel() for p in parts]), parts))

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The whole head's ``t`` from each rank's columns along ``dim``."""
        return t if self.group is None else gather_split(t, dim, self.group)

    def mine(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's columns of a whole head's ``t`` along ``dim``."""
        if self.g == 1:
            return t
        w = t.shape[dim] // self.g
        return t.narrow(dim, self.c * w, w)


WHOLE = HeadPart()


def _column_part(ctx, n_heads: int) -> tuple[HeadPart, int]:
    """This rank's :class:`HeadPart` under the ``columns`` rule and the
    index of its head."""
    g = ctx.tp_size() // n_heads
    r = ctx.coord(ctx.axes_of("model")[0])
    return HeadPart(g, r % g, head_group(ctx.mesh, n_heads)), r // g


def _column_states(ctx, n_heads: int, new: dict) -> dict:
    """A ``columns`` region's states, each (B, tp, w, ...) sharded over
    the model axis by its (head, column block) pairs, or (B, tp) for one
    value a head that every rank of the head holds, at the cache's shapes
    and placement: gathered whole over the model axis, then (B, H, Dh,
    ...) or (B, H)."""
    out = {}
    for k, t in new.items():
        t = ctx.constrain(t, "dp", *(None,) * (t.ndim - 1))
        b, tp = t.shape[:2]
        if t.ndim == 2:
            out[k] = t.reshape(b, n_heads, tp // n_heads)[..., 0]
        else:
            out[k] = t.reshape(b, n_heads, tp // n_heads * t.shape[2],
                               *t.shape[3:])
    return out


def _head_regions(ctx, batch: int):
    """What a whole-heads region of a core needs: ``(at, model_part, bp,
    dp_part, rep, r)``: ``at(base, dim)`` is ``base`` with ``Shard(dim)``
    over the model axis; ``model_part(base)`` is ``base`` with Partial
    there (the gradient of an input that every model rank reads whole but
    uses only for its heads); ``bp`` places a batch over the dp axes,
    ``dp_part`` is the same with Partial where the batch is split (a
    parameter's gradient); ``r`` is this rank's index on the model
    axis."""
    from torch.distributed.tensor import Partial, Shard

    model = ctx.axes_of("model")
    bp = ctx.placements(("dp",), (batch,))
    dp_part = tuple(Partial() if isinstance(pl, Shard) else pl for pl in bp)

    def at(base, dim):
        return ctx.with_dims(base, model, Shard(dim))

    def model_part(base):
        return ctx.with_dims(base, model, Partial())

    return at, model_part, bp, dp_part, ctx.rep(), ctx.coord(model[0])


def _placed_states(ctx, cache, new: dict) -> dict:
    """The states after a step at the cache's own placement (batch over
    the dp axes, whole over the model axis): a decode's written into
    ``cache``, a prefill's redistributed there."""
    if cache is None:
        new = {k: ctx.constrain(t, "dp", *(None,) * (t.ndim - 1))
               for k, t in new.items()}
    return write_states(ctx, cache, new)


# ================================================================= mLSTM


def _mlstm_dims(cfg: XLSTMConfig, d_model: int):
    d_in = int(cfg.proj_factor * d_model)
    return d_in, d_in // cfg.n_heads


def mlstm_specs(cfg: XLSTMConfig, d_model: int, dtype) -> dict:
    h = cfg.n_heads
    d_in, _ = _mlstm_dims(cfg, d_model)
    fp32 = torch.float32
    return {
        "w_up": ParamSpec((d_model, 2 * d_in), dtype, axes=COL),
        "w_q": ParamSpec((d_in, d_in), dtype, axes=COL),
        "w_k": ParamSpec((d_in, d_in), dtype, axes=COL),
        "w_v": ParamSpec((d_in, d_in), dtype, axes=COL),
        "w_if": ParamSpec((d_in, 2 * h), fp32, scale=0.02, axes=(None, None)),
        "b_if": ParamSpec((2 * h,), fp32, init="zeros", axes=(None,)),
        "gn_scale": ParamSpec((d_in,), fp32, init="ones", axes=("model",)),
        "w_down": ParamSpec((d_in, d_model), dtype, axes=ROW),
    }


def _headwise_norm(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6, part: HeadPart = WHOLE) -> torch.Tensor:
    """GroupNorm per head of x (B, S, H, Dh), in fp32: the population
    variance, as ``jnp.var``. Under the ``columns`` rule x holds this
    rank's columns of each head (``part``) and the mean and the variance
    are sums over the head's ranks."""
    xf = f32(x)
    if part.group is None:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    else:
        dh = x.shape[-1] * part.g
        mu = part.total(torch.sum(xf, dim=-1, keepdim=True))[0] / dh
        var = part.total(torch.sum(torch.square(xf - mu), dim=-1,
                                   keepdim=True))[0] / dh
    out = (xf - mu) * torch.rsqrt(var + eps)
    b, s, h, dh = x.shape
    return (out.reshape(b, s, h * dh) * scale).reshape(b, s, h, dh)


def mlstm_apply(p, cfg: XLSTMConfig, x: torch.Tensor,
                cache: Optional[dict] = None, ctx=NO_MESH):
    """x (B, S, D) -> ``(y, cache)``; cache ``{c (B, H, dk, dv), n (B, H,
    dk), m (B, H)}``, returned new by a prefill, updated in place by a
    decode. On a mesh the cell splits over the model axis by
    :func:`split_rule`: whole heads a rank (:func:`_mlstm_heads`), else
    rows of each rank's batch shard, else each head's columns
    (:func:`_mlstm_columns`), else the whole batch shard on every model
    rank (``batch_map``); y then goes into the row-parallel
    down-projection by its columns."""
    up = ctx.constrain(x @ p["w_up"], "dp", None, "model")
    names = ("w_q", "w_k", "w_v", "w_if", "b_if", "gn_scale")
    states = tuple(cache[k] for k in ("c", "n", "m")) if cache else ()
    args = (up, *(p[k] for k in names), *states)
    rule = split_rule(ctx, "mlstm", cfg.n_heads,
                      _mlstm_dims(cfg, x.shape[-1])[1], x.shape[0])
    if rule == "heads":
        y, c, n, m = _mlstm_heads(ctx, cfg, x.dtype, *args)
    elif rule == "columns":
        y, *new = _mlstm_columns(ctx, cfg, x.dtype, *args)
        c, n, m = _column_states(ctx, cfg.n_heads,
                                 dict(zip("cnm", new))).values()
    else:
        def core(up, *rest):
            return _mlstm_core(cfg, x.dtype, *torch.chunk(up, 2, dim=-1),
                               *rest)

        y, c, n, m = batch_map(
            ctx, core, args, (0,) + (None,) * len(names) + (0,) * len(states),
            (0, 0, 0, 0), rows_over_model=rule == "rows")
    y = ctx.constrain(y, "dp", None, "model")
    out = ctx.constrain(y @ p["w_down"], "dp", None, None)
    return out, _placed_states(ctx, cache, {"c": c, "n": n, "m": m})


def _mlstm_heads(ctx, cfg: XLSTMConfig, dtype, up, w_q, w_k, w_v, w_if,
                 b_if, gn_scale, *states):
    """The cell as a ``local_map`` body on this rank's batch shard and its
    H / tp whole heads: xi gathered whole over the model axis (q, k and v
    contract over all of d_in), the rank's heads the local column blocks
    of w_q, w_k and w_v, the gates of every head from the replicated w_if
    and b_if, of which the rank keeps its own, and z and gn_scale the
    rank's columns (the group norm is per head). No collective inside: y
    leaves sharded by its columns over the model axis, the states by their
    heads."""
    at, model_part, bp, dp_part, rep, r = _head_regions(ctx, up.shape[0])
    d_in = up.shape[-1] // 2
    w = d_in // ctx.tp_size()
    head0 = r * (cfg.n_heads // ctx.tp_size())

    def body(up_l, *rest):
        xi = up_l[..., :d_in]
        z = up_l[..., d_in + r * w:d_in + (r + 1) * w]
        return _mlstm_core(cfg, dtype, xi, z, *rest, head0=head0)

    return _mlstm_region(ctx, body, at(bp, 1), up, w_q, w_k, w_v, w_if,
                         b_if, gn_scale, *states)


def _mlstm_region(ctx, body, state_pl, up, w_q, w_k, w_v, w_if, b_if,
                  gn_scale, *states):
    """``body`` as the cell's ``local_map`` region over this rank's batch
    shard: up whole over the model axis, w_q, w_k, w_v and gn_scale this
    rank's column blocks, w_if and b_if whole, the states at ``state_pl``;
    y out sharded by its columns over the model axis, the states by dim
    1."""
    at, model_part, bp, dp_part, rep, _ = _head_regions(ctx, up.shape[0])
    cols, gates = at(rep, 1), rep
    in_pl = (bp, cols, cols, cols, gates, gates, at(rep, 0))
    grad_pl = (model_part(bp),) + (at(dp_part, 1),) * 3 \
        + (model_part(dp_part),) * 2 + (at(dp_part, 0),)
    st_pl = tuple(state_pl for _ in states)
    return ctx.region(body, (at(bp, 2),) + (at(bp, 1),) * 3,
                      in_pl + st_pl, grad_pl + st_pl, up, w_q, w_k, w_v,
                      w_if, b_if, gn_scale, *states)


def _mlstm_columns(ctx, cfg: XLSTMConfig, dtype, up, w_q, w_k, w_v, w_if,
                   b_if, gn_scale, *states):
    """The cell as a ``local_map`` body on this rank's batch shard and its
    Dh / g columns of one head, as :func:`_mlstm_heads` takes whole heads:
    q, k and v this rank's columns (the local column blocks of w_q, w_k
    and w_v), z and gn_scale too, the head's gates from the replicated
    w_if and b_if. The core sums its partial products over the head's g
    ranks (:class:`HeadPart`) and gathers the head's v whole, and a
    decode's states come in whole and are cut there. y leaves sharded by
    its columns over the model axis; the states (c this rank's rows of
    each dk, n its columns, m the head's) by (head, column block), for
    :func:`_column_states`."""
    _, _, bp, _, _, r = _head_regions(ctx, up.shape[0])
    part, head = _column_part(ctx, cfg.n_heads)
    d_in = up.shape[-1] // 2
    w = d_in // ctx.tp_size()

    def body(up_l, w_q, w_k, w_v, w_if, b_if, gn_scale, *st):
        xi = up_l[..., :d_in]
        z = up_l[..., d_in + r * w:d_in + (r + 1) * w]
        if st:      # the head's states, this rank's rows of dk in c and n
            c, n, m = (t[:, head:head + 1] for t in st)
            st = (part.mine(c, 2), part.mine(n, 2), m)
        return _mlstm_core(cfg, dtype, xi, z, w_q, w_k, w_v, w_if, b_if,
                           gn_scale, *st, head0=head, part=part)

    return _mlstm_region(ctx, body, bp, up, w_q, w_k, w_v, w_if, b_if,
                         gn_scale, *states)


def _mlstm_core(cfg: XLSTMConfig, dtype, xi, z, w_q, w_k, w_v, w_if, b_if,
                gn_scale, c_prev=None, n_prev=None, m_prev=None,
                head0: int = 0, part: HeadPart = WHOLE):
    """The cell between the up- and down-projections on heads ``head0``
    onward, as many as w_q's columns hold (every head when they are
    whole), from the whole xi (B, S, d_in) and those heads' columns of z:
    ``(y (B, S, heads·Dh), c, n, m)``; a decode (states given) writes the
    states in place. Under the ``columns`` rule (``part``) w_q, w_k, w_v,
    z, gn_scale and y hold this rank's columns of head ``head0``, v is
    gathered whole, c and n hold this rank's rows of dk (c every dv), and
    the states given are cut from the cache, which the caller writes."""
    b, s, d_in = xi.shape
    dh = d_in // cfg.n_heads
    dl = dh // part.g                                   # columns a head here
    h = w_q.shape[-1] // dl
    q = (xi @ w_q).reshape(b, s, h, dl)
    k = (xi @ w_k).reshape(b, s, h, dl)
    v = part.gather((xi @ w_v).reshape(b, s, h, dl))    # (B, S, H, Dh)
    k = k / torch.tensor(math.sqrt(dh), dtype=torch.float32).to(k.dtype)
    gates = f32(xi) @ w_if + b_if                       # (B, S, 2H)
    f0 = cfg.n_heads + head0
    i_pre = gates[..., head0:head0 + h]                    # log-space gates
    f_pre = gates[..., f0:f0 + h]
    logf = F.logsigmoid(f_pre)

    if c_prev is None and s > 1:
        y = _mlstm_chunked(cfg, q, k, v, i_pre, logf, part)
        new = _mlstm_final_state(k, v, i_pre, logf)
    else:
        cache = c_prev is not None
        if not cache:
            wide = dict(dtype=f32_dtype(xi.dtype), device=xi.device)
            c_prev = torch.zeros((b, h, dl, dh), **wide)
            n_prev = torch.zeros((b, h, dl), **wide)
            m_prev = torch.full((b, h), -1e30, **wide)
        i1, f1 = i_pre[:, 0], logf[:, 0]                  # (B, H)
        m = torch.maximum(f1 + m_prev, i1)
        fi = torch.exp(f1 + m_prev - m)
        ii = torch.exp(i1 - m)
        kf, vf, qf = f32(k[:, 0]), f32(v[:, 0]), f32(q[:, 0])
        c = fi[..., None, None] * c_prev + ii[..., None, None] * (
            kf[..., :, None] * vf[..., None, :])
        n = fi[..., None] * n_prev + ii[..., None] * kf
        num, den = part.total(torch.einsum("bhd,bhdv->bhv", qf, c),
                              torch.einsum("bhd,bhd->bh", qf, n))
        den = torch.abs(den)
        yt = part.mine(num) / torch.maximum(den, torch.exp(-m))[..., None]
        y = yt[:, None].to(dtype).reshape(b, 1, h, dl)
        new = {"c": c, "n": n, "m": m}
        if cache and part.group is None:
            for old, t in zip((c_prev, n_prev, m_prev), (c, n, m)):
                old.copy_(t)

    y = _headwise_norm(y, gn_scale, part=part).to(dtype).reshape(
        b, s, h * dl)
    y = y * F.silu(f32(z)).to(dtype)
    return y, new["c"], new["n"], new["m"]


def _mlstm_chunked(cfg: XLSTMConfig, q, k, v, i_pre, logf,
                   part: HeadPart = WHOLE) -> torch.Tensor:
    """Chunkwise-parallel mLSTM (the stabilised linear-attention form);
    y (B, S, H, Dh) fp32. Under the ``columns`` rule (``part``) q and k
    hold this rank's columns of its head and v the head's whole: a chunk
    sums its three partial products over the head's ranks in one
    all-reduce, and y is this rank's columns."""
    b, s, h, dk = q.shape
    cs = min(cfg.chunk, s)
    if s % cs:
        raise ValueError(f"seq {s} must divide chunk {cs}")
    wide = dict(dtype=f32_dtype(q.dtype), device=q.device)
    c_prev = torch.zeros((b, h, dk, v.shape[-1]), **wide)
    n_prev = torch.zeros((b, h, dk), **wide)
    m_prev = torch.zeros((b, h), **wide)
    tri = torch.tril(torch.ones((cs, cs), dtype=torch.bool, device=q.device))

    def step(j, carry):
        c_prev, n_prev, m_prev = carry
        sl = slice(j * cs, (j + 1) * cs)
        qf, kf, vf = f32(q[:, sl]), f32(k[:, sl]), f32(v[:, sl])
        ib, fb = i_pre[:, sl], logf[:, sl]
        fcum = torch.cumsum(fb, dim=1)               # (B, cs, H) inclusive
        ftot = fcum[:, -1]                           # (B, H)
        lam = fcum + m_prev[:, None, :]              # carry's log weight at t
        # D[t, t'] = sum_{t' < j <= t} f_j + i_t' for t' <= t, else -inf:
        # exp(-inf - finite) = 0, and the diagonal keeps every row's max
        # finite, so no -inf - (-inf) arises
        dmat = fcum[:, :, None, :] - fcum[:, None, :, :] + ib[:, None, :, :]
        dmat = torch.where(tri[None, :, :, None], dmat, -math.inf)
        m_t = torch.maximum(lam, torch.amax(dmat, dim=2))   # (B, t, H)
        w_carry = torch.exp(lam - m_t)
        num_carry = torch.einsum("bthd,bhdv->bthv", qf, c_prev) \
            * w_carry[..., None]
        den_carry = torch.einsum("bthd,bhd->bth", qf, n_prev) * w_carry
        wmat = torch.exp(dmat - m_t[:, :, None, :])         # (B, t, t', H)
        scores = torch.einsum("bthd,bshd->btsh", qf, kf) * wmat
        num_carry, den_carry, scores = part.total(num_carry, den_carry,
                                                  scores)
        num = part.mine(num_carry) + torch.einsum("btsh,bshv->bthv", scores,
                                                  part.mine(vf))
        den = den_carry + torch.sum(scores, dim=2)
        y = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
        # carry to the chunk's end
        w_log = ib + (ftot[:, None] - fcum)
        m_new = torch.maximum(ftot + m_prev, torch.amax(w_log, dim=1))
        wi = torch.exp(w_log - m_new[:, None])              # (B, t, H)
        decay = torch.exp(ftot + m_prev - m_new)
        c_prev = decay[:, :, None, None] * c_prev + torch.einsum(
            "bthd,bth,bthv->bhdv", kf, wi, vf)
        n_prev = decay[..., None] * n_prev + torch.einsum(
            "bthd,bth->bhd", kf, wi)
        return (c_prev, n_prev, m_new), y

    _, y = runtime.scan(step, (c_prev, n_prev, m_prev), s // cs, stack=False)
    return y


def _mlstm_final_state(k, v, i_pre, logf) -> dict:
    """The final ``{c, n, m}`` after a whole prefill, for decode to
    continue from (the reference's closed form over the sequence)."""
    fcum = torch.cumsum(logf, dim=1)
    ftot = fcum[:, -1]                                      # (B, H)
    w_log = i_pre + (ftot[:, None] - fcum)                  # (B, S, H)
    m = torch.amax(w_log, dim=1)                            # (B, H)
    wi = torch.exp(w_log - m[:, None])
    kf, vf = f32(k), f32(v)
    c = torch.einsum("bshd,bsh,bshv->bhdv", kf, wi, vf)
    n = torch.einsum("bshd,bsh->bhd", kf, wi)
    return {"c": c, "n": n, "m": m}


def mlstm_cache_specs(cfg: XLSTMConfig, d_model: int, batch: int) -> dict:
    h = cfg.n_heads
    _, dh = _mlstm_dims(cfg, d_model)
    fp32 = torch.float32
    dp = lambda n: ("dp",) + (None,) * (n - 1)
    return {"c": ParamSpec((batch, h, dh, dh), fp32, init="zeros",
                           axes=dp(4)),
            "n": ParamSpec((batch, h, dh), fp32, init="zeros", axes=dp(3)),
            "m": ParamSpec((batch, h), fp32, init="zeros", axes=dp(2))}


# ================================================================= sLSTM


def slstm_specs(cfg: XLSTMConfig, d_model: int, dtype) -> dict:
    h = cfg.n_heads
    dh = d_model // h
    fp32 = torch.float32
    # 4 gates (i, f, z, o): input weights, and recurrent weights
    # block-diagonal per head
    return {
        "w_gates": ParamSpec((d_model, 4 * d_model), dtype, axes=COL),
        "r_gates": ParamSpec((h, dh, 4 * dh), fp32, axes=(None, None, None)),
        "b_gates": ParamSpec((4 * d_model,), fp32, init="zeros",
                             axes=("model",)),
        "gn_scale": ParamSpec((d_model,), fp32, init="ones", axes=("model",)),
        "w_down": ParamSpec((d_model, d_model), dtype, axes=ROW),
    }


def slstm_apply(p, cfg: XLSTMConfig, x: torch.Tensor,
                cache: Optional[dict] = None, ctx=NO_MESH):
    """x (B, S, D) -> ``(y, cache)``; cache ``{h, c, n, m}``, each (B, H,
    Dh) fp32: a sequential scan over S from the cache's states (a
    prefill's from h = c = m = 0, n = 1). On a mesh the scan splits over
    the model axis as :func:`mlstm_apply`'s cell does (whole heads a rank:
    :func:`_slstm_heads`; each head's columns: :func:`_slstm_columns`)."""
    names = ("w_gates", "b_gates", "r_gates", "gn_scale")
    states = tuple(cache[k] for k in ("h", "c", "n", "m")) if cache else ()
    args = (x, *(p[k] for k in names), *states)
    rule = split_rule(ctx, "slstm", cfg.n_heads, x.shape[-1] // cfg.n_heads,
                      x.shape[0])
    if rule == "heads":
        y, hs, c, n, m = _slstm_heads(ctx, x.dtype, *args)
    elif rule == "columns":
        y, *new = _slstm_columns(ctx, cfg.n_heads, x.dtype, *args)
        hs, c, n, m = _column_states(ctx, cfg.n_heads,
                                     dict(zip("hcnm", new))).values()
    else:
        y, hs, c, n, m = batch_map(
            ctx, functools.partial(_slstm_core, x.dtype), args,
            (0,) + (None,) * len(names) + (0,) * len(states), (0,) * 5,
            rows_over_model=rule == "rows")
    y = ctx.constrain(y, "dp", None, "model")
    out = ctx.constrain(y @ p["w_down"], "dp", None, None)
    return out, _placed_states(ctx, cache,
                               {"h": hs, "c": c, "n": n, "m": m})


def _slstm_heads(ctx, dtype, x, w_gates, b_gates, r_gates, gn_scale,
                 *states):
    """The scan as a ``local_map`` body on this rank's batch shard and its
    H / tp whole heads: x whole, the column blocks of w_gates, b_gates and
    gn_scale (each head's four gates lie together) and the rank's heads
    of r_gates, so a step needs no collective. y leaves sharded by its
    columns over the model axis, the states by their heads."""
    at, model_part, bp, dp_part, rep, _ = _head_regions(ctx, x.shape[0])
    in_pl = (bp, at(rep, 1), at(rep, 0), at(rep, 0), at(rep, 0))
    grad_pl = (model_part(bp), at(dp_part, 1)) + (at(dp_part, 0),) * 3
    st_pl = tuple(at(bp, 1) for _ in states)
    return ctx.region(functools.partial(_slstm_core, dtype),
                      (at(bp, 2),) + (at(bp, 1),) * 4, in_pl + st_pl,
                      grad_pl + st_pl, x, w_gates, b_gates, r_gates,
                      gn_scale, *states)


def _slstm_columns(ctx, n_heads: int, dtype, x, w_gates, b_gates, r_gates,
                   gn_scale, *states):
    """The scan as a ``local_map`` body on this rank's batch shard and its
    Dh / g columns of one head: x whole; the local column blocks of
    w_gates and b_gates (this rank's block of its head's four gates,
    whose products the core gathers over the head's ranks and cuts to
    this rank's columns of each gate), gn_scale this rank's columns, and
    r_gates whole (the core takes its head's rows and this rank's gate
    columns). A step gathers the head's h over its ranks. y leaves
    sharded by its columns over the model axis, the states by (head,
    column block), for :func:`_column_states`."""
    at, model_part, bp, dp_part, rep, _ = _head_regions(ctx, x.shape[0])
    part, head = _column_part(ctx, n_heads)

    def body(x, w_gates, b_gates, r_gates, gn_scale, *st):
        st = [part.mine(t[:, head:head + 1]) for t in st]
        return _slstm_core(dtype, x, w_gates, b_gates,
                           r_gates[head:head + 1], gn_scale, *st, part=part)

    in_pl = (bp, at(rep, 1), at(rep, 0), rep, at(rep, 0))
    grad_pl = (model_part(bp), at(dp_part, 1), at(dp_part, 0),
               model_part(dp_part), at(dp_part, 0))
    st_pl = tuple(bp for _ in states)
    return ctx.region(body, (at(bp, 2),) + (at(bp, 1),) * 4, in_pl + st_pl,
                      grad_pl + st_pl, x, w_gates, b_gates, r_gates,
                      gn_scale, *states)


def _slstm_core(dtype, x, w_gates, b_gates, r, gn_scale, h0=None, c0=None,
                n0=None, m0=None, part: HeadPart = WHOLE):
    """The scan before the down-projection on the heads of ``r`` (H, Dh,
    4·Dh) (some heads: their columns of w_gates and b_gates): ``(y (B, S,
    heads·Dh), h, c, n, m)``; a decode (states given) writes the states in
    place. Under the ``columns`` rule (``part``) w_gates and b_gates hold
    this rank's block of its head's four gates: their product is gathered
    over the head's ranks and cut to this rank's columns of each gate, as
    r is; a step gathers the head's h; y, gn_scale and the states (given
    cut from the cache, which the caller writes) hold this rank's
    columns."""
    b, s, _ = x.shape
    nh, dh = r.shape[0], r.shape[1]
    dl = dh // part.g                                   # columns a head here

    def own(t):
        # this rank's columns of each of the four gates of its head
        if part.g == 1:
            return t
        t = t.reshape(*t.shape[:-1], 4, dh)
        return part.mine(t).reshape(*t.shape[:-2], 4 * dl)

    wx = f32(x) @ f32(w_gates) + b_gates
    wx = own(part.gather(wx)).reshape(b, s, nh, 4 * dl)
    r = own(r)
    if h0 is not None:
        hs, c, n, m = h0, c0, n0, m0
    else:
        wide = dict(dtype=f32_dtype(x.dtype), device=x.device)
        hs, c, m = (torch.zeros((b, nh, dl), **wide) for _ in range(3))
        n = torch.ones((b, nh, dl), **wide)

    def step(t, carry):
        hs, c, n, m = carry
        g = wx[:, t] + torch.einsum("bhd,hdg->bhg", part.gather(hs), r)
        i_pre, f_pre, z_pre, o_pre = torch.chunk(g, 4, dim=-1)
        m_t = torch.maximum(f_pre + m, i_pre)
        i_g = torch.exp(i_pre - m_t)
        f_g = torch.exp(f_pre + m - m_t)
        c = f_g * c + i_g * torch.tanh(z_pre)
        n = f_g * n + i_g
        hs = torch.sigmoid(o_pre) * c / torch.clamp(n, min=1e-6)
        return (hs, c, n, m_t), hs

    (hs, c, n, m), y = runtime.scan(step, (hs, c, n, m), s)  # (B,S,H,Dh)
    y = _headwise_norm(y, gn_scale, part=part).to(dtype).reshape(
        b, s, nh * dl)
    if h0 is not None and part.group is None:
        for old, t in zip((h0, c0, n0, m0), (hs, c, n, m)):
            old.copy_(t)
    return y, hs, c, n, m


def slstm_cache_specs(cfg: XLSTMConfig, d_model: int, batch: int) -> dict:
    nh = cfg.n_heads
    shape = (batch, nh, d_model // nh)
    fp32 = torch.float32
    axes = ("dp", None, None)
    return {"h": ParamSpec(shape, fp32, init="zeros", axes=axes),
            "c": ParamSpec(shape, fp32, init="zeros", axes=axes),
            "n": ParamSpec(shape, fp32, init="ones", axes=axes),
            "m": ParamSpec(shape, fp32, init="zeros", axes=axes)}
