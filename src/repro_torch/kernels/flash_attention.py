"""GQA attention forward with an online softmax (the prefill of the judge,
the embedder and the agent), as a CUDA kernel for Hopper
(``csrc/flash_attention.cu``) beside its plain PyTorch version.

Replaces ``repro/kernels/flash_attention.py::_flash_kernel``, the Pallas
TPU kernel, with the reference's public layout and contract: ``q``
(B, Sq, KV, G, Dh), ``k``/``v`` (B, Sk, KV, Dh), fp32 or bf16 ->
(B, Sq, KV, G, Dh) in q's dtype. Scores, max, denominator and accumulator
in fp32; masked scores are -1e30 (causal ``kj <= qi``, sliding window
``kj > qi - window``); the output is ``acc / max(l, 1e-30)``.

What bounds it on an H100: the bytes are q, k, v read once and o written
once; the operations 4·Dh per (query row, key) pair that the masks keep,
on the tensor cores in bf16 (989 TFLOP/s) or on the CUDA cores in fp32
(67 TFLOP/s). At the judge's micro-batch (8 pairs × 128 tokens, KV 8,
G 2, Dh 128, bf16) the bytes bound it (about 3.8 µs); an agent prefill of
4096 tokens is bound by the operations.

The simple design (``csrc/flash_attention.cu`` has the details): one CTA
per (batch, KV head, group member, block of 32 query rows) reads its KV
head through strides, so neither the reference's ``moveaxis`` copies nor
its G-fold ``repeat`` of K/V exist; the TPU's sequential k-block grid axis
is a loop inside the CTA over 64-key tiles staged in shared memory as
fp32; products on the CUDA cores in fp32 (no TF32, no tensor cores yet);
key tiles wholly above the diagonal or before the window are skipped when
every query row has a key of its own (Sq <= Sk), which leaves the output
as it is: a masked prefix is washed out by a zero rescale.

:func:`flash_attention_fwd` launches the kernel for CUDA tensors and
raises if it cannot; it takes :func:`flash_attention_plain` only for CPU
tensors. ``flash_attention_fwd.launches`` and ``.plain_calls`` count the
two.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG = -1.0e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, causal: bool = True,
                          window: int | None = None) -> torch.Tensor:
    """Plain PyTorch version (the reference's ``flash_attention_ref``):
    the fp32 softmax over the whole (Sq, Sk) score matrix."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q.float(), k.float()) * scale
    qi = torch.arange(sq, device=q.device)[:, None]
    kj = torch.arange(sk, device=q.device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    s = torch.where(m, s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", p, v.float()).to(q.dtype)


def _check(q, k, v, window) -> None:
    if q.ndim != 5 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, KV, G, Dh), k and v (B, Sk, KV, "
                         f"Dh); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, kvh, g, dh = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, kvh, dh) or \
            min(q.shape) < 1 or k.shape[1] < 1:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on B, KV or Dh")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


def _lib():
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_launch.argtypes = [
            i, i, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll,
            ctypes.c_float, i, i, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _inner_dense(x: torch.Tensor, n: int) -> bool:
    """The last ``n`` dims are laid out densely (head dims, then Dh)."""
    want = 1
    for dim in range(x.ndim - 1, x.ndim - 1 - n, -1):
        if x.shape[dim] != 1 and x.stride(dim) != want:
            return False
        want *= x.shape[dim]
    return True


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """Causal (or full) GQA attention with an optional sliding window.
    Batch and sequence strides are free; the head and Dh dims must be
    dense (as a reshape of a projection gives them)."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        flash_attention_fwd.plain_calls += 1
        return flash_attention_plain(q, k, v, scale, causal, window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd runs on cuda or cpu, not "
                         f"{q.device}")
    b, sq, kvh, g, dh = q.shape
    sk = k.shape[1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if not (_inner_dense(q, 3) and _inner_dense(k, 2) and _inner_dense(v, 2)):
        raise ValueError("flash_attention_fwd needs dense head and Dh dims")
    out = torch.empty((b, sq, kvh, g, dh), dtype=q.dtype, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            _DTYPE_CODE[q.dtype], dh, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), b, sq, sk, kvh, g,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), float(scale), int(bool(causal)),
            0 if window is None else int(window), stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(
            f"flash_attention launch failed (cuda error {err}: {msg}) at "
            f"q {tuple(q.shape)} k {tuple(k.shape)} dtype={q.dtype}")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0
flash_attention_fwd.plain_calls = 0
