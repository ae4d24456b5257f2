"""Flash attention with its backward, the port of the reference's
``nn/flash.py``: ``flash_attention`` (there a ``jax.custom_vjp``, here a
``torch.autograd.Function``) and its (B, S, H, Dh) wrapper ``sdpa_flash``.

* forward: kernel 6 (``kernels/flash_attention.flash_attention_fwd`` with
  ``return_lse=True``): the CUDA kernel for CUDA tensors, its plain
  version on the CPU. It keeps the reference's residuals ``(q, k, v, o,
  lse)``; ``lse`` (B, KV, G, Sq) fp32 is ``m + log(max(l, 1e-30))``.
* backward: the reference's ``_flash_bwd``, the FlashAttention-2
  recomputation, in torch matmuls (the reference computes it in einsums
  outside Pallas, and no Pallas backward kernel exists): ``delta =
  rowsum(dO * O)`` in fp32; key chunks of ``flash_chunk(Sq)`` rows, each
  over every query chunk, with fp32 ``dk``/``dv`` accumulators and ``dq``
  summed over the key chunks; scores, p, dp and ds in fp32, ds rounded to
  q's dtype before ``ds @ K`` as the reference rounds it. GQA runs in the
  (B, Sq, KV, G, Dh) layout: a key chunk's K/V serve its G query heads,
  and dk/dv sum over them. The masks are the forward's (causal ``kj <=
  qi``, window ``kj > qi - window``, masked scores -1e30). A (query chunk,
  key chunk) pair that the masks cover wholly is skipped when Sq <= Sk:
  then every row has a valid key, so its lse is finite and the pair's p,
  and all it adds, is exactly 0.

Without grad mode, or on inputs that require none (serving), the call is
``flash_attention_fwd`` itself, with no ``lse``: serving launches what it
launched before. Training reaches kernel 6 only through this module; the
kernel wrappers refuse inputs that require grad.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import NEG, flash_attention_fwd


def flash_chunk(sq: int) -> int:
    """The backward's chunk edge (reference ``nn/attention.flash_chunk``):
    1024 rows up to 8192 tokens, 2048 above."""
    return 1024 if sq <= 8192 else 2048


def flash_bwd(q, k, v, o, lse, dout, scale: float, causal: bool,
              window, chunk: int | None = None):
    """(dq, dk, dv) of the reference's ``_flash_bwd`` from the forward's
    residuals: q (B, Sq, KV, G, Dh), k/v (B, Sk, KV, Dh), o like q, lse
    (B, KV, G, Sq) fp32, dout like o."""
    delta = (dout.float() * o.float()).sum(-1).permute(0, 2, 3, 1)
    return bwd_chunks(q, k, v, lse, delta, dout, scale, causal, window,
                      chunk)


def _masked(sq: int, sk: int, q0: int, q1: int, k0: int, k1: int,
            causal: bool, window) -> bool:
    """Every (row, key) of rows q0..q1-1 and keys k0..k1-1 is masked, and
    every row has a valid key elsewhere (Sq <= Sk): the pair adds 0."""
    if sq > sk:
        return False
    above = causal and k0 > q1 - 1
    before = window is not None and k1 - 1 <= q0 - window
    return above or before


def bwd_chunks(q, k, v, lse, delta, dout, scale: float, causal: bool,
               window, chunk: int | None = None):
    """The chunked recomputation given ``lse`` and ``delta`` (B, KV, G,
    Sq) fp32: the body of :func:`flash_bwd`."""
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    chunk = chunk or flash_chunk(sq)
    cq, ck = min(chunk, sq), min(chunk, sk)
    dev = q.device
    qf = q.permute(0, 2, 3, 1, 4)            # (B, KV, G, Sq, Dh) views
    dof = dout.permute(0, 2, 3, 1, 4)
    kf = k.permute(0, 2, 1, 3)               # (B, KV, Sk, Dh)
    vf = v.permute(0, 2, 1, 3)
    dq = torch.zeros((b, kvh, g, sq, dh), dtype=torch.float32, device=dev)
    dk = torch.zeros((b, kvh, sk, dh), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for k0 in range(0, sk, ck):
        k1 = min(sk, k0 + ck)
        kc, vc = kf[:, :, k0:k1].float(), vf[:, :, k0:k1].float()
        kpos = torch.arange(k0, k1, device=dev)
        for q0 in range(0, sq, cq):
            q1 = min(sq, q0 + cq)
            if _masked(sq, sk, q0, q1, k0, k1, causal, window):
                continue
            m = q1 - q0
            qc = qf[:, :, :, q0:q1].float().reshape(b, kvh, g * m, dh)
            doc = dof[:, :, :, q0:q1].float().reshape(b, kvh, g * m, dh)
            s = (qc @ kc.transpose(-1, -2)).view(b, kvh, g, m, k1 - k0)
            s = s * scale
            qpos = torch.arange(q0, q1, device=dev)[:, None]
            msk = torch.ones((m, k1 - k0), dtype=torch.bool, device=dev)
            if causal:
                msk = kpos[None] <= qpos
            if window is not None:
                msk = msk & (kpos[None] > qpos - window)
            s = torch.where(msk, s, NEG)
            p = torch.exp(s - lse[..., q0:q1, None])
            dp = (doc @ vc.transpose(-1, -2)).view_as(p)
            ds = p * (dp - delta[..., q0:q1, None]) * scale
            p = p.reshape(b, kvh, g * m, k1 - k0)
            ds = ds.reshape(b, kvh, g * m, k1 - k0)
            dv[:, :, k0:k1] += p.transpose(-1, -2) @ doc
            dk[:, :, k0:k1] += ds.transpose(-1, -2) @ qc
            dq[:, :, :, q0:q1] += (ds.to(q.dtype).float() @ kc).view(
                b, kvh, g, m, dh)
    return (dq.permute(0, 3, 1, 2, 4).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, chunk):
        out, lse = flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                                       window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, window, chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = True, window=None,
                    chunk: int | None = None) -> torch.Tensor:
    """GQA attention q (B, Sq, KV, G, Dh) over k/v (B, Sk, KV, Dh) ->
    (B, Sq, KV, G, Dh), differentiable in q, k and v; ``chunk`` is the
    backward's chunk edge (default :func:`flash_chunk`)."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale, causal, window, chunk)
    return flash_attention_fwd(q, k, v, scale=scale, causal=causal,
                               window=window)


def sdpa_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float, causal: bool = True, window=None,
               chunk: int | None = None) -> torch.Tensor:
    """(B, Sq, H, Dh) x (B, Sk, KV, Dh) GQA wrapper of
    :func:`flash_attention`."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    out = flash_attention(q.reshape(b, sq, kvh, h // kvh, dh), k, v, scale,
                          causal, window, chunk)
    return out.reshape(b, sq, h, dh)
