"""Chunked-vocab fused cross-entropy, the port of the reference's
``nn/xent.py`` (there a ``jax.custom_vjp``, here a
``torch.autograd.Function``).

Unembedding, log-softmax and NLL fused over vocab chunks with an online
logsumexp, so that only a (tokens x chunk) tile of fp32 logits is live;
the backward recomputes each chunk's logits and emits its
``(softmax - onehot) * scale`` gradient (times ``1 - (lg / c)^2`` under a
logit softcap ``c``). Products are torch matmuls, as the reference
computes them outside Pallas: fp32 logits from the inputs' values (the
reference's ``preferred_element_type=float32``), the gradient rounded to
the weights' (inputs') dtype before ``g @ W`` (``g^T @ x``), as the
reference rounds it.
"""
from __future__ import annotations

import torch


def _nchunks(v: int, chunk_req: int) -> int:
    """Smallest chunk count k >= v / chunk_req with v % k == 0 (chunks
    tile the vocab exactly, so the backward's dW rows stay disjoint)."""
    k = max(1, -(-v // chunk_req))
    while v % k:
        k += 1
    return k


def _logits_chunk(xf: torch.Tensor, w_c: torch.Tensor, softcap: float):
    lg = xf @ w_c.float().T
    if softcap:
        lg = torch.tanh(lg / softcap) * softcap
    return lg


class _ChunkedXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, table, labels, chunk, softcap):
        t = x.shape[0]
        v = table.shape[0]
        chunk = v // _nchunks(v, chunk)
        m = torch.full((t,), -1e30, dtype=torch.float32, device=x.device)
        l = torch.zeros((t,), dtype=torch.float32, device=x.device)
        picked = torch.zeros_like(l)
        xf = x.float()
        for c0 in range(0, v, chunk):
            lg = _logits_chunk(xf, table[c0:c0 + chunk], softcap)  # (T, C)
            m_new = torch.maximum(m, lg.amax(dim=1))
            l = l * torch.exp(m - m_new) + torch.exp(
                lg - m_new[:, None]).sum(dim=1)
            m = m_new
            loc = labels - c0
            ok = (loc >= 0) & (loc < chunk)
            got = torch.gather(lg, 1, loc.clamp(0, chunk - 1)[:, None])[:, 0]
            picked = torch.where(ok, got, picked)
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        ctx.save_for_backward(x, table, labels, lse)
        ctx.args = (chunk, softcap)
        return torch.mean(lse - picked)

    @staticmethod
    def backward(ctx, ct):
        x, table, labels, lse = ctx.saved_tensors
        chunk, softcap = ctx.args
        t = x.shape[0]
        v = table.shape[0]
        scale = ct / t
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty(table.shape, dtype=table.dtype, device=x.device)
        xf = x.float()
        for c0 in range(0, v, chunk):
            w_c = table[c0:c0 + chunk]
            lg = _logits_chunk(xf, w_c, softcap)
            vid = torch.arange(c0, c0 + chunk, device=x.device)
            g = torch.exp(lg - lse[:, None])            # the softmax chunk
            g = (g - (labels[:, None] == vid[None]).float()) * scale
            if softcap:
                # d tanh(z/c) * c = sech^2 = 1 - (lg/c)^2 on the capped value
                g = g * (1.0 - (lg / softcap) ** 2)
            dx += g.to(w_c.dtype).float() @ w_c.float()
            dw[c0:c0 + chunk] = (g.to(x.dtype).float().T @ xf).to(
                table.dtype)
        return dx.to(x.dtype), dw, None, None, None


def chunked_xent(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 16384, softcap: float = 0.0) -> torch.Tensor:
    """Mean cross-entropy of ``x @ table.T`` (x (T, D), table (V, D)) at
    ``labels`` (T,), over vocab chunks of about ``chunk`` rows."""
    return _ChunkedXent.apply(x, table, labels.long(), chunk, softcap)
