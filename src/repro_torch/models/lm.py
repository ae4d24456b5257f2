"""Language-model assembly, mirroring the reference's ``models/lm.py``:
layers of attention (GQA, full or sliding-window, M-RoPE, QKV bias; or
MLA), Mamba, mLSTM or sLSTM, each with a dense FFN or an MoE channel
mixer (or none); dense prefix layers; an encoder stack for
encoder-decoder models, whose decoder layers add cross-attention; the
vision and audio frontend stubs and the MTP block's parameters.

Parameters are a dict ``{"embed": {"table"}, "final_norm": {"scale"},
["head": {"table"}], ["frontend_proj": {"w"}], ["mtp": {...}], "layers":
[per-layer dict, ...], ["enc_layers": [...], "enc_norm": {"scale"}]}``:
the layers are a Python list in ``cfg.layer_iter()`` order (the prefix
layers first), the encoder's in ``enc_blocks`` order repeated
``enc_repeat`` times, where the reference keeps ``prefix`` apart and
stacks each superblock position over ``n_repeat`` (``enc_repeat``) for
``lax.scan`` (``convert.lm_params_from_numpy`` maps one onto the other).
The stack is a Python loop; a decode step updates each layer's cache
(K/V rows, or a recurrent layer's states) in place.

Steps: :meth:`LM.loss_and_aux` (the training loss: the chunked-vocab
cross-entropy of ``nn/xent``, MTP's loss for DeepSeek-V3 and the MoE
load-balance loss, each layer optionally recomputed in the backward),
:meth:`LM.prefill` (logits of the last position and the caches),
:meth:`LM.decode` (one token against the caches).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.nn import attention as att
from repro_torch.nn import basic
from repro_torch.nn import moe as moe_mod
from repro_torch.nn import ssm
from repro_torch.nn import xlstm as xl
from repro_torch.nn.config import LayerSpec, ModelConfig
from repro_torch.nn.flash import flash_attention
from repro_torch.nn.param import ParamSpec
from repro_torch.nn.xent import chunked_xent

REMAT = ("none", "dots", "save_outs")
# what remat="dots" keeps for the backward, as the reference's
# dots_with_no_batch_dims_saveable policy: products without a batch dim
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _cross_cfg(spec: LayerSpec):
    """A decoder layer's cross-attention: its attention config, no rope."""
    return dataclasses.replace(spec.attn, rope_kind="none")


def layer_specs(spec: LayerSpec, d_model: int, dtype) -> dict:
    p: dict[str, Any] = {"norm1": basic.rmsnorm_specs(d_model)}
    if spec.kind == "attn":
        if spec.attn.kind == "mla":
            p["mixer"] = att.mla_specs(spec.attn, d_model, dtype)
        else:
            p["mixer"] = att.gqa_specs(spec.attn, d_model, dtype)
    elif spec.kind == "mamba":
        p["mixer"] = ssm.mamba_specs(spec.mamba, d_model, dtype)
    elif spec.kind == "mlstm":
        p["mixer"] = xl.mlstm_specs(spec.xlstm, d_model, dtype)
    elif spec.kind == "slstm":
        p["mixer"] = xl.slstm_specs(spec.xlstm, d_model, dtype)
    else:
        raise ValueError(spec.kind)
    if spec.cross_attn:
        p["cross_norm"] = basic.rmsnorm_specs(d_model)
        p["cross"] = att.gqa_specs(_cross_cfg(spec), d_model, dtype)
    if spec.moe is not None:
        p["norm2"] = basic.rmsnorm_specs(d_model)
        p["moe"] = moe_mod.moe_specs(spec.moe, d_model, dtype)
    elif spec.d_ff:
        p["norm2"] = basic.rmsnorm_specs(d_model)
        p["ffn"] = basic.ffn_specs(d_model, spec.d_ff, dtype, spec.ffn_act)
    return p


def layer_cache_specs(spec: LayerSpec, d_model: int, batch: int,
                      s_cache: int, dtype, enc_len: int = 0,
                      kv_quant: bool = False) -> dict:
    out: dict[str, Any] = {}
    if spec.kind == "attn":
        if spec.attn.kind == "mla":
            out["mixer"] = att.mla_cache_specs(spec.attn, batch, s_cache,
                                               dtype)
        else:
            out["mixer"] = att.gqa_cache_specs(spec.attn, batch, s_cache,
                                               dtype, quant=kv_quant)
    elif spec.kind == "mamba":
        out["mixer"] = ssm.mamba_cache_specs(spec.mamba, d_model, batch,
                                             dtype)
    elif spec.kind == "mlstm":
        out["mixer"] = xl.mlstm_cache_specs(spec.xlstm, d_model, batch)
    elif spec.kind == "slstm":
        out["mixer"] = xl.slstm_cache_specs(spec.xlstm, d_model, batch)
    else:
        raise ValueError(spec.kind)
    if spec.cross_attn:
        shp = (batch, enc_len, spec.attn.n_kv_heads, spec.attn.head_dim)
        out["cross_kv"] = {"k": ParamSpec(shp, dtype, init="zeros"),
                           "v": ParamSpec(shp, dtype, init="zeros")}
    return out


def apply_layer(spec: LayerSpec, p, x: torch.Tensor, positions: torch.Tensor,
                *, cache=None, cache_pos=None, causal: bool = True,
                enc_out: Optional[torch.Tensor] = None,
                norm_eps: float = 1e-6):
    """Returns ``(x, cache, aux)``: the layer's output, its (new or
    updated) cache ``{"mixer": {...}, ["cross_kv": {"k", "v"}]}`` (no
    ``mixer`` for an encoder layer) and an MoE layer's load-balance loss
    (0 elsewhere; serving ignores it, as the reference's prefill and
    decode do). ``causal=False`` without a cache is an encoder layer's
    bidirectional self-attention. A cross-attention layer takes its K/V
    from the cache where it has them (decode), else from ``enc_out``."""
    x, new_cache = _mix(spec, p, x, positions, cache=cache,
                        cache_pos=cache_pos, causal=causal, enc_out=enc_out,
                        norm_eps=norm_eps)
    x, aux = _channel(spec, p, x, norm_eps)
    return x, new_cache, aux


def _mix(spec: LayerSpec, p, x: torch.Tensor, positions: torch.Tensor, *,
         cache=None, cache_pos=None, causal: bool = True, enc_out=None,
         norm_eps: float = 1e-6):
    """The token mixer and cross-attention of :func:`apply_layer`:
    ``(x, cache)``."""
    h = basic.rmsnorm(p["norm1"], x, norm_eps)
    mix_cache = cache.get("mixer") if cache else None
    if spec.kind == "attn":
        if spec.attn.kind == "mla":
            y, mix = att.mla_apply(p["mixer"], spec.attn, h, positions,
                                   cache=mix_cache, cache_pos=cache_pos,
                                   eps=norm_eps)
        elif not causal and mix_cache is None:
            y, mix = _bidir_attn(p["mixer"], spec.attn, h, positions), None
        else:
            y, mix = att.gqa_apply(p["mixer"], spec.attn, h, positions,
                                   cache=mix_cache, cache_pos=cache_pos)
    elif spec.kind == "mamba":
        y, mix = ssm.mamba_apply(p["mixer"], spec.mamba, h, cache=mix_cache)
    elif spec.kind == "mlstm":
        y, mix = xl.mlstm_apply(p["mixer"], spec.xlstm, h, cache=mix_cache)
    elif spec.kind == "slstm":
        y, mix = xl.slstm_apply(p["mixer"], spec.xlstm, h, cache=mix_cache)
    else:
        raise ValueError(spec.kind)
    x = x + y
    new_cache: dict[str, Any] = {"mixer": mix} if mix is not None else {}
    if spec.cross_attn:
        hc = basic.rmsnorm(p["cross_norm"], x, norm_eps)
        if cache is not None and "cross_kv" in cache:
            kvp = (cache["cross_kv"]["k"], cache["cross_kv"]["v"])
        else:
            kvp = att.cross_kv(p["cross"], spec.attn, enc_out)
        yc, _ = att.gqa_apply(p["cross"], _cross_cfg(spec), hc, positions,
                              cache_pos=cache_pos, kv_override=kvp)
        x = x + yc
        new_cache["cross_kv"] = {"k": kvp[0], "v": kvp[1]}
    return x, new_cache


def _channel(spec: LayerSpec, p, x: torch.Tensor, norm_eps: float = 1e-6):
    """The channel mixer of :func:`apply_layer` (MoE, dense FFN or
    none): ``(x, aux)``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.moe is not None:
        h2 = basic.rmsnorm(p["norm2"], x, norm_eps)
        y2, aux = moe_mod.moe_apply(p["moe"], spec.moe, h2)
        x = x + y2
    elif spec.d_ff:
        h2 = basic.rmsnorm(p["norm2"], x, norm_eps)
        x = x + basic.ffn(p["ffn"], h2, spec.ffn_act)
    return x, aux


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_layer(remat: str, spec: LayerSpec, p, x: torch.Tensor,
                 positions: torch.Tensor, enc_out, norm_eps: float):
    """A cache-less layer whose activations the backward recomputes
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of
    the scan body: ``"dots"`` keeps the products without a batch dim
    (``dots_with_no_batch_dims_saveable``), ``"save_outs"`` the outputs of
    the two halves (the reference saves its ``mixer_out`` and ``ffn_out``
    names). Returns ``(x, aux)``; the values are ``apply_layer``'s."""
    mix = functools.partial(_mix, spec, p, positions=positions,
                            enc_out=enc_out, norm_eps=norm_eps)
    if remat == "dots":
        def layer(x):
            x, _, aux = apply_layer(spec, p, x, positions, enc_out=enc_out,
                                    norm_eps=norm_eps)
            return x, aux
        return ckpt.checkpoint(
            layer, x, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    x = ckpt.checkpoint(lambda x: mix(x)[0], x, use_reentrant=False)
    return ckpt.checkpoint(functools.partial(_channel, spec, p,
                                             norm_eps=norm_eps),
                           x, use_reentrant=False)


def _bidir_attn(p, cfg, x: torch.Tensor, positions: torch.Tensor):
    """An encoder layer's self-attention: q and k roped, no mask (kernel 6
    without the causal mask, where the reference takes ``_sdpa`` or
    ``sdpa_flash``). Like the reference's, it adds no QKV bias."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = att._split_heads(x @ p["wq"], h, dh)
    k = att._split_heads(x @ p["wk"], kv, dh)
    v = att._split_heads(x @ p["wv"], kv, dh)
    if cfg.rope_kind != "none":
        q = basic.apply_rope(cfg, q, positions)
        k = basic.apply_rope(cfg, k, positions)
    out = flash_attention(q.view(b, s, kv, h // kv, dh), k, v,
                          1.0 / math.sqrt(dh), causal=False)
    return out.reshape(b, s, h * dh) @ p["wo"]


class LM:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.layers = cfg.layer_iter()
        self.enc_layers = list(cfg.enc_blocks) * cfg.enc_repeat \
            if cfg.enc_dec else []

    # ---------------- parameter tree

    def param_specs(self) -> dict:
        cfg = self.cfg
        dt = cfg.pdt
        tree: dict[str, Any] = {
            "embed": basic.embedding_specs(cfg.vocab_size, cfg.d_model, dt),
            "final_norm": basic.rmsnorm_specs(cfg.d_model),
        }
        if not cfg.tie_embeddings:
            tree["head"] = {"table": ParamSpec((cfg.vocab_size, cfg.d_model),
                                               dt, scale=0.02)}
        tree["layers"] = [layer_specs(sp, cfg.d_model, dt)
                          for sp in self.layers]
        if cfg.enc_dec:
            tree["enc_layers"] = [layer_specs(sp, cfg.d_model, dt)
                                  for sp in self.enc_layers]
            tree["enc_norm"] = basic.rmsnorm_specs(cfg.d_model)
        if cfg.frontend:
            # the vision stub projects its embeddings (_inputs); the audio
            # stub's projection is made but, as in the reference, unused:
            # the encoder takes enc_emb as it is
            tree["frontend_proj"] = {
                "w": ParamSpec((cfg.d_model, cfg.d_model), dt)}
        if cfg.mtp:
            # DeepSeek-V3's multi-token-prediction block: carried with the
            # parameters, used only by the training loss
            tree["mtp"] = {
                "norm_h": basic.rmsnorm_specs(cfg.d_model),
                "norm_e": basic.rmsnorm_specs(cfg.d_model),
                "proj": ParamSpec((2 * cfg.d_model, cfg.d_model), dt),
                "block": layer_specs(cfg.blocks[-1], cfg.d_model, dt),
            }
        return tree

    # ---------------- forward pieces

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return basic.embed(params["embed"], tokens)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = basic.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        table = (params["embed"]["table"] if cfg.tie_embeddings
                 else params["head"]["table"])
        logits = basic.unembed({"table": table}, x)
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = torch.tanh(logits.float() / c) * c
        return logits

    def _positions(self, tokens: torch.Tensor, offset: int = 0):
        b, s = tokens.shape[:2]
        pos = offset + torch.arange(s, dtype=torch.int32,
                                    device=tokens.device)
        return pos[None, :].expand(b, s)

    def _inputs(self, params, tokens: torch.Tensor, frontend_emb=None,
                frontend_mask=None, positions=None):
        """The stack's input embeddings and rope positions: the vision
        frontend's projected embeddings where ``frontend_mask`` is set
        (reference ``prefill``), and ``positions`` (B, S), or (3, B, S)
        for M-RoPE, defaulting to 0..S-1."""
        x = self._embed(params, tokens)
        if self.cfg.frontend == "vision" and frontend_emb is not None:
            fe = frontend_emb @ params["frontend_proj"]["w"]
            x = torch.where(frontend_mask[..., None], fe, x)
        if positions is None:
            positions = self._positions(tokens)
        return x, positions

    def _run_stack(self, params, x: torch.Tensor, positions: torch.Tensor, *,
                   caches: Optional[dict] = None, cache_pos=None,
                   want_cache: bool = False,
                   enc_out: Optional[torch.Tensor] = None,
                   remat: str = "none"):
        """The decoder's layers in order. With ``caches`` (decode) each
        layer's cache is updated in place; otherwise ``want_cache``
        collects the prefill's K/V (latent and rope key for MLA), final
        recurrent states and cross K/V. ``enc_out`` is the encoder's
        output, for cross-attention without cached K/V. ``remat`` (one of
        :data:`REMAT`) recomputes each layer in the backward, on the
        cache-less training pass. Returns ``(x, caches or None, aux)``,
        ``aux`` the sum of the MoE layers' load-balance losses."""
        if remat not in REMAT:
            raise ValueError(f"remat must be one of {REMAT}, got {remat!r}")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        new_layers = []
        for i, spec in enumerate(self.layers):
            p_i = params["layers"][i]
            if remat != "none" and caches is None and not want_cache:
                x, a = _remat_layer(remat, spec, p_i, x, positions, enc_out,
                                    self.cfg.norm_eps)
            else:
                c_i = caches["layers"][i] if caches is not None else None
                x, nc, a = apply_layer(spec, p_i, x, positions, cache=c_i,
                                       cache_pos=cache_pos, enc_out=enc_out,
                                       norm_eps=self.cfg.norm_eps)
                new_layers.append(nc)
            aux = aux + a
        if caches is None and not want_cache:
            return x, None, aux
        return x, {"layers": new_layers}, aux

    def _encode(self, params, enc_emb: torch.Tensor) -> torch.Tensor:
        """The encoder stack over precomputed frontend embeddings (B,
        S_enc, D) at positions 0..S_enc-1, then ``enc_norm``."""
        x = enc_emb
        positions = self._positions(enc_emb[..., 0])
        for spec, p in zip(self.enc_layers, params["enc_layers"]):
            x, _, _ = apply_layer(spec, p, x, positions, causal=False,
                                  norm_eps=self.cfg.norm_eps)
        return basic.rmsnorm(params["enc_norm"], x, self.cfg.norm_eps)

    # ---------------- public steps

    def loss_and_aux(self, params, batch: dict, remat: str = "none"):
        """The training loss of ``batch``: ``tokens`` and ``labels`` (B,
        S), and as the config needs them ``frontend_emb``,
        ``frontend_mask``, ``positions`` ((B, S), or (3, B, S) for
        M-RoPE) and ``enc_emb``. Returns ``(loss + aux, {"aux": aux})``
        as the reference does: the mean cross-entropy, plus 0.3 x MTP's
        for DeepSeek-V3, plus the MoE load-balance losses."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x, positions = self._inputs(params, tokens,
                                    batch.get("frontend_emb"),
                                    batch.get("frontend_mask"),
                                    batch.get("positions"))
        enc_out = None
        if cfg.enc_dec:
            enc_out = self._encode(params, batch["enc_emb"])
        x, _, aux = self._run_stack(params, x, positions, enc_out=enc_out,
                                    remat=remat)
        loss = self._loss_from_hidden(params, x, batch["labels"])
        if cfg.mtp:
            loss = loss + 0.3 * self._mtp_loss(params, x, tokens, batch)
        return loss + aux, {"aux": aux}

    def _loss_from_hidden(self, params, x: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
        """Cross-entropy of the final hidden states through the fused
        chunked-vocab loss (the reference's path without tensor
        parallelism): no (tokens x vocab) logits are kept."""
        cfg = self.cfg
        table = (params["embed"]["table"] if cfg.tie_embeddings
                 else params["head"]["table"])
        xn = basic.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        t = xn.shape[0] * xn.shape[1]
        return chunked_xent(xn.reshape(t, cfg.d_model), table,
                            labels.reshape(t), 16384, cfg.logit_softcap)

    def _mtp_loss(self, params, h: torch.Tensor, tokens: torch.Tensor,
                  batch: dict) -> torch.Tensor:
        """DeepSeek-V3's multi-token prediction: token t+2 from (h_t,
        the embedding of token t+1) through the MTP block."""
        cfg = self.cfg
        p = params["mtp"]
        emb_next = self._embed(params, torch.roll(tokens, -1, dims=1))
        z = torch.cat([basic.rmsnorm(p["norm_h"], h, cfg.norm_eps),
                       basic.rmsnorm(p["norm_e"], emb_next, cfg.norm_eps)],
                      dim=-1) @ p["proj"]
        z, _, _ = apply_layer(cfg.blocks[-1], p["block"], z,
                              self._positions(tokens), norm_eps=cfg.norm_eps)
        labels2 = torch.roll(batch["labels"], -1, dims=1)
        return self._loss_from_hidden(params, z, labels2)

    def prefill(self, params, tokens: torch.Tensor, *,
                frontend_emb: Optional[torch.Tensor] = None,
                frontend_mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None,
                enc_emb: Optional[torch.Tensor] = None):
        """tokens (B, S) -> logits of the last position (B, 1, V) and the
        caches ``{"layers": [{"mixer": {...}, ["cross_kv": {...}]}, ...]}``:
        K/V of length S, a recurrent layer's final states, and for an
        encoder-decoder model the cross K/V of the encoder's output over
        ``enc_emb`` (B, S_enc, D). A vision config takes ``frontend_emb``
        (B, S, D) and ``frontend_mask`` (B, S) bool; ``positions`` (B, S),
        or (3, B, S) for M-RoPE, replaces 0..S-1."""
        x, positions = self._inputs(params, tokens, frontend_emb,
                                    frontend_mask, positions)
        enc_out = None
        if self.cfg.enc_dec:
            if enc_emb is None:
                raise ValueError(f"{self.cfg.name} is an encoder-decoder "
                                 f"model: prefill needs enc_emb")
            enc_out = self._encode(params, enc_emb)
        x, caches, _ = self._run_stack(params, x, positions,
                                       want_cache=True, enc_out=enc_out)
        return self._logits(params, x[:, -1:, :]), caches

    def prefill_flops(self, tokens: int) -> float:
        """Forward prefill FLOPs over ``tokens`` tokens (2·N_active·T, the
        roofline model), as the judge pipeline prices the judge."""
        from repro_torch.launch.roofline import model_flops

        return model_flops(self.cfg, "prefill", tokens)

    def decode(self, params, tokens: torch.Tensor, caches: dict, pos: int,
               positions: Optional[torch.Tensor] = None):
        """tokens (B, 1); ``caches`` from :meth:`cache_specs` (or a
        prefill), updated in place; ``pos`` the host-int write index;
        ``positions`` (B, 1) per-row rope positions (default ``pos``).
        Cross-attention reads the cross K/V in the caches, as the
        reference's decode does."""
        x = self._embed(params, tokens)
        if positions is None:
            positions = torch.full((tokens.shape[0], 1), int(pos),
                                   dtype=torch.int32, device=tokens.device)
        x, caches, _ = self._run_stack(params, x, positions, caches=caches,
                                       cache_pos=pos)
        return self._logits(params, x), caches

    # ---------------- cache tree

    def cache_specs(self, batch: int, s_cache: int, enc_len: int = 0,
                    kv_quant: bool = False) -> dict:
        """Zeroed decode caches for ``batch`` rows: ``s_cache`` K/V rows a
        layer, ``enc_len`` cross K/V rows a cross-attention layer."""
        cfg = self.cfg
        return {"layers": [
            layer_cache_specs(sp, cfg.d_model, batch, s_cache, cfg.pdt,
                              enc_len, kv_quant) for sp in self.layers]}
