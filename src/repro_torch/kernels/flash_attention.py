"""GQA attention forward with an online softmax (the prefill of the judge,
the embedder and the agent), as CUDA kernels for Hopper
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

Two designs (``csrc/flash_attention.cu`` has the details), chosen by
:func:`pick_design` from the dtype and the rows' alignment:

* ``"tc"``: bf16 inputs whose rows start on 16-byte boundaries, which is
  every call of the LM path. One CTA of 4 warps per (batch, KV head, group
  member, 64 query rows); K/V tiles of 64 keys (32 at Dh 192 and 256,
  whose Q fragments are then read from shared memory at each k-step) stay
  bf16 in a 2-stage shared-memory ring filled by ``cp.async``; Q·Kᵀ and
  P·V on ``mma.sync`` bf16 tensor cores with fp32 accumulation; scores
  and probabilities in registers, P rounded to bf16 before P·V as the
  Pallas kernel rounds it.
* ``"simt"``: fp32 (its 3e-5 check rules out TF32 and bf16 products) and
  rows off a 16-byte boundary (no 16-byte copies). One CTA per (batch, KV
  head, group member, 32 query rows), 64-key tiles staged in shared memory
  as fp32, products as fp32 FMAs on the CUDA cores.

Both read the KV head through strides, so neither the reference's
``moveaxis`` copies nor its G-fold ``repeat`` of K/V exist; the TPU's
sequential k-block grid axis is a loop inside the CTA; key tiles wholly
above the diagonal or before the window are skipped when every query row
has a key of its own (Sq <= Sk), which leaves the output as it is: a
masked prefix is washed out by a zero rescale.

:func:`flash_attention_fwd` launches a kernel for CUDA tensors and raises
if it cannot; it takes :func:`flash_attention_plain` only for CPU tensors.
With ``return_lse=True`` it also returns each query row's log-sum-exp
(B, KV, G, Sq) in fp32, the reference's ``m + log(max(l, 1e-30))`` of
``nn/flash.py::_flash_fwd``, which the training backward consumes (both
designs write it; without it nothing changes). The kernels' output has no
``grad_fn``, so the wrapper refuses inputs that require grad while grad
mode is on: training reaches it through ``nn/flash.flash_attention``.
The wrapper's body is the op ``torch.ops.repro_torch.flash_attention_fwd``,
so that the device picks the version (CPU: plain, CUDA: the kernels), a
``meta`` or fake tensor gets the outputs' shapes alone (the dry run), and
``torch.utils.flop_counter`` counts its products over the (query, key)
pairs the masks keep (:func:`kept_pairs`).
``flash_attention_fwd.launches`` counts every launch,
``.launches_tc`` and ``.launches_simt`` each design's, and
``.plain_calls`` the plain version's calls.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build

NEG = -1.0e30
HEAD_DIMS = (16, 32, 64, 128, 192, 256)   # 192: MLA's folded prefill
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in fp32 for the plain versions' softmax, or float64 as it
    is (the CPU's plain versions also take float64, for exact checks of
    a float64 model)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def dtype_ok(x: torch.Tensor) -> bool:
    """A dtype the kernels take, or float64 on the CPU (plain)."""
    return x.dtype in _DTYPE_CODE or (x.dtype == torch.float64
                                      and x.device.type == "cpu")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float, causal: bool = True,
                          window: int | None = None,
                          return_lse: bool = False):
    """Plain PyTorch version (the reference's ``flash_attention_ref``):
    the fp32 softmax over the whole (Sq, Sk) score matrix; with
    ``return_lse`` also its rows' log-sum-exp (B, KV, G, Sq)."""
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqkgd,bskd->bkgqs", wide(q), wide(k)) * scale
    qi = torch.arange(sq, device=q.device)[:, None]
    kj = torch.arange(sk, device=q.device)[None, :]
    m = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    s = torch.where(m, s, NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, wide(v)).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


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
    if not dtype_ok(q) or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be float32 or bfloat16 (or "
                        f"float64 on the CPU); got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{k.device}, {v.device}")


def dtype_design(dtype: torch.dtype, aligned: bool) -> str:
    """The kernel design of a CUDA call to kernel 6 or 7: ``"tc"`` (bf16
    tensor cores) for bf16 inputs whose rows start on 16-byte boundaries,
    else ``"simt"`` (fp32 FMAs on the CUDA cores)."""
    return "tc" if dtype == torch.bfloat16 and aligned else "simt"


def pick_design(dtype: torch.dtype, aligned: bool, dh: int) -> str:
    """:func:`dtype_design` for this kernel's head dims."""
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    return dtype_design(dtype, aligned)


def _row_strides(x: torch.Tensor) -> tuple[int, int]:
    """Batch and sequence strides in elements, 0 for a dim of size 1 (its
    stride is never used, so it cannot misalign a row)."""
    return tuple(x.stride(d) if x.shape[d] > 1 else 0 for d in (0, 1))


def rows_aligned(*xs: torch.Tensor) -> bool:
    """Every row (batch, sequence position) of each tensor starts on a
    16-byte boundary: its base pointer and its row strides in bytes are
    multiples of 16 (the head and Dh dims are dense, Dh * 2 bytes >= 32)."""
    return all(x.data_ptr() % 16 == 0 and
               all(st * x.element_size() % 16 == 0 for st in _row_strides(x))
               for x in xs)


def _lib():
    lib = build.load("flash_attention")
    if not getattr(lib, "_typed", False):
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        # q, k, v, o, then lse (None: a null pointer, no lse written)
        lib.flash_attention_launch.argtypes = [
            i, i, p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll,
            ctypes.c_float, i, i, p]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_tc_launch.argtypes = [
            i, p, p, p, p, p, i, i, i, i, i, ll, ll, ll, ll, ll, ll,
            ctypes.c_float, i, i, p]
        lib.flash_attention_tc_launch.restype = i
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


def refuse_grad(name: str, *xs: torch.Tensor) -> None:
    """Raise if autograd would record a call to a kernel wrapper: its
    CUDA output has no ``grad_fn``, so the gradient would be lost on the
    card where the CPU's plain version keeps it."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            f"{name} takes no inputs that require grad (the kernel's output "
            f"has no grad_fn); a training step reaches kernel 6 through "
            f"nn/flash.flash_attention, whose backward ports the "
            f"reference's _flash_bwd")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, scale: float, causal: bool = True,
                        window: int | None = None, return_lse: bool = False):
    """Causal (or full) GQA attention with an optional sliding window.
    Batch and sequence strides are free; the head and Dh dims must be
    dense (as a reshape of a projection gives them). CUDA tensors take
    :func:`pick_design`'s kernel. Returns ``out``, or ``(out, lse)`` with
    ``return_lse``."""
    _check(q, k, v, window)
    refuse_grad("flash_attention_fwd", q, k, v)
    out, lse = torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, float(scale), bool(causal), window, return_lse)
    return (out, lse) if return_lse else out


def _lse_or_none(got, return_lse: bool):
    """The op's two outputs from ``out`` or ``(out, lse)``: an op
    returns tensors, so no lse is an empty one."""
    if return_lse:
        return got
    return got, got.new_empty((0,), dtype=torch.float32)


def _on_cpu(q, k, v, scale: float, causal: bool, window, return_lse: bool):
    flash_attention_fwd.plain_calls += 1
    return _lse_or_none(flash_attention_plain(q, k, v, scale, causal, window,
                                              return_lse), return_lse)


def _on_cuda(q, k, v, scale: float, causal: bool, window, return_lse: bool):
    if not (_inner_dense(q, 3) and _inner_dense(k, 2) and _inner_dense(v, 2)):
        raise ValueError("flash_attention_fwd needs dense head and Dh dims")
    design = pick_design(q.dtype, rows_aligned(q, k, v), q.shape[-1])
    return _lse_or_none(_launch(design, q, k, v, scale, causal, window,
                                return_lse), return_lse)


def _shapes_only(q, k, v, scale: float, causal: bool, window,
                 return_lse: bool):
    """The outputs of a call on ``meta`` or fake tensors, nothing run."""
    b, sq, kvh, g, _ = q.shape
    shape = (b, kvh, g, sq) if return_lse else (0,)
    return torch.empty_like(q), q.new_empty(shape, dtype=torch.float32)


_OPS = torch.library.Library("repro_torch", "FRAGMENT")
_OPS.define("flash_attention_fwd(Tensor q, Tensor k, Tensor v, float scale, "
            "bool causal, int? window, bool return_lse) -> (Tensor, Tensor)")
_OPS.impl("flash_attention_fwd", _on_cpu, "CPU")
_OPS.impl("flash_attention_fwd", _on_cuda, "CUDA")
torch.library.register_fake("repro_torch::flash_attention_fwd", _shapes_only,
                            lib=_OPS)


def kept_pairs(sq: int, sk: int, causal: bool, window) -> int:
    """(query, key) pairs the masks keep: query i over keys ``j <= i``
    (causal) and ``j > i - window``."""
    if not causal and window is None:
        return sq * sk
    total = 0
    for i in range(sq):
        hi = min(i, sk - 1) if causal else sk - 1
        lo = max(0, i - window + 1) if window is not None else 0
        total += max(0, hi - lo + 1)
    return total


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flops(q_shape, k_shape, v_shape, scale, causal, window, *args,
           **kwargs) -> int:
    """Its two products over the kept pairs: 4 Dh per pair and query
    head."""
    b, sq, kvh, g, dh = q_shape
    return 4 * b * kvh * g * kept_pairs(sq, k_shape[1], causal, window) * dh


def _launch(design: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            scale: float, causal: bool, window: int | None,
            return_lse: bool = False):
    """Launch ``design``'s kernel on checked CUDA inputs and count it
    (chip_smoke.py also calls it to time the CUDA-core design on inputs
    the dispatch sends to the tensor cores)."""
    b, sq, kvh, g, dh = q.shape
    out = torch.empty((b, sq, kvh, g, dh), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, kvh, g, sq), dtype=torch.float32,
                      device=q.device) if return_lse else None
    lib = _lib()
    strides = (*_row_strides(q), *_row_strides(k), *_row_strides(v))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr())
        rest = (b, sq, k.shape[1], kvh, g, *strides, float(scale),
                int(bool(causal)), 0 if window is None else int(window),
                stream)
        if design == "tc":
            err = lib.flash_attention_tc_launch(dh, *ptrs, *rest)
        else:
            err = lib.flash_attention_launch(_DTYPE_CODE[q.dtype], dh, *ptrs,
                                             *rest)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(
            f"flash_attention launch failed (cuda error {err}: {msg}) at "
            f"q {tuple(q.shape)} k {tuple(k.shape)} dtype={q.dtype} "
            f"design={design}")
    flash_attention_fwd.launches += 1
    if design == "tc":
        flash_attention_fwd.launches_tc += 1
    else:
        flash_attention_fwd.launches_simt += 1
    return (out, lse) if return_lse else out


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_tc = 0
flash_attention_fwd.launches_simt = 0
flash_attention_fwd.plain_calls = 0
