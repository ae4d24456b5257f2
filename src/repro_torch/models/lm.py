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
:meth:`LM.decode` (one token against the caches). With a
``nn.sharding.ShardCtx`` (``LM(cfg, ctx)``) the same code is a DTensor
program over the context's mesh, the reference's constraints and manual
regions in place (the shard helpers at the end of this module).
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
from repro_torch.nn.param import ParamSpec
from repro_torch.nn.sharding import NO_MESH, batch_map, psum, pmax
from repro_torch.nn.xent import chunked_xent

REMAT = ("none", "dots", "save_outs", "full")
# what remat="dots" keeps for the backward, as the reference's
# dots_with_no_batch_dims_saveable policy: products without a batch dim
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


# a layer's parameters by half: each half gathers its own (ZeRO-3)
MIX_KEYS = ("norm1", "mixer", "cross_norm", "cross")
CHANNEL_KEYS = ("norm2", "moe", "ffn")


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
        axes = att.cache_axes(batch, 4)
        out["cross_kv"] = {"k": ParamSpec(shp, dtype, init="zeros",
                                          axes=axes),
                           "v": ParamSpec(shp, dtype, init="zeros",
                                          axes=axes)}
    return out


def apply_layer(spec: LayerSpec, p, x: torch.Tensor, positions: torch.Tensor,
                *, cache=None, cache_pos=None, causal: bool = True,
                enc_out: Optional[torch.Tensor] = None,
                norm_eps: float = 1e-6, ctx=NO_MESH):
    """Returns ``(x, cache, aux)``: the layer's output, its (new or
    updated) cache ``{"mixer": {...}, ["cross_kv": {"k", "v"}]}`` (no
    ``mixer`` for an encoder layer) and an MoE layer's load-balance loss
    (0 elsewhere; serving ignores it, as the reference's prefill and
    decode do). ``causal=False`` without a cache is an encoder layer's
    bidirectional self-attention. A cross-attention layer takes its K/V
    from the cache where it has them (decode), else from ``enc_out``."""
    x, new_cache = _mix(spec, p, x, positions, cache=cache,
                        cache_pos=cache_pos, causal=causal, enc_out=enc_out,
                        norm_eps=norm_eps, ctx=ctx)
    x, aux = _channel(spec, p, x, norm_eps, ctx)
    return x, new_cache, aux


def _mix(spec: LayerSpec, p, x: torch.Tensor, positions: torch.Tensor, *,
         cache=None, cache_pos=None, causal: bool = True, enc_out=None,
         norm_eps: float = 1e-6, ctx=NO_MESH):
    """The token mixer and cross-attention of :func:`apply_layer`:
    ``(x, cache)``."""
    p = ctx.fsdp_gather({k: p[k] for k in MIX_KEYS if k in p})
    h = basic.rmsnorm(p["norm1"], x, norm_eps)
    mix_cache = cache.get("mixer") if cache else None
    if spec.kind == "attn":
        if spec.attn.kind == "mla":
            y, mix = att.mla_apply(p["mixer"], spec.attn, h, positions,
                                   cache=mix_cache, cache_pos=cache_pos,
                                   eps=norm_eps, ctx=ctx)
        elif not causal and mix_cache is None:
            y = _bidir_attn(p["mixer"], spec.attn, h, positions, ctx)
            mix = None
        else:
            y, mix = att.gqa_apply(p["mixer"], spec.attn, h, positions,
                                   cache=mix_cache, cache_pos=cache_pos,
                                   ctx=ctx)
    elif spec.kind == "mamba":
        y, mix = ssm.mamba_apply(p["mixer"], spec.mamba, h, cache=mix_cache,
                                 ctx=ctx)
    elif spec.kind == "mlstm":
        y, mix = xl.mlstm_apply(p["mixer"], spec.xlstm, h, cache=mix_cache,
                                ctx=ctx)
    elif spec.kind == "slstm":
        y, mix = xl.slstm_apply(p["mixer"], spec.xlstm, h, cache=mix_cache,
                                ctx=ctx)
    else:
        raise ValueError(spec.kind)
    x = x + y
    new_cache: dict[str, Any] = {"mixer": mix} if mix is not None else {}
    if spec.cross_attn:
        hc = basic.rmsnorm(p["cross_norm"], x, norm_eps)
        if cache is not None and "cross_kv" in cache:
            kvp = (cache["cross_kv"]["k"], cache["cross_kv"]["v"])
        else:
            kvp = att.cross_kv(p["cross"], spec.attn, enc_out, ctx)
        yc, _ = att.gqa_apply(p["cross"], _cross_cfg(spec), hc, positions,
                              cache_pos=cache_pos, kv_override=kvp, ctx=ctx)
        x = x + yc
        new_cache["cross_kv"] = {"k": kvp[0], "v": kvp[1]}
    return x, new_cache


def _channel(spec: LayerSpec, p, x: torch.Tensor, norm_eps: float = 1e-6,
             ctx=NO_MESH):
    """The channel mixer of :func:`apply_layer` (MoE, dense FFN or
    none): ``(x, aux)``."""
    p = ctx.fsdp_gather({k: p[k] for k in CHANNEL_KEYS if k in p})
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.moe is not None:
        h2 = basic.rmsnorm(p["norm2"], x, norm_eps)
        y2, aux = moe_mod.moe_apply(p["moe"], spec.moe, h2, ctx)
        x = x + y2
    elif spec.d_ff:
        h2 = basic.rmsnorm(p["norm2"], x, norm_eps)
        x = x + basic.ffn(p["ffn"], h2, spec.ffn_act, ctx)
    return x, aux


def _dots_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_layer(remat: str, spec: LayerSpec, p, x: torch.Tensor,
                 positions: torch.Tensor, enc_out, norm_eps: float,
                 ctx=NO_MESH):
    """A cache-less layer whose activations the backward recomputes
    (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint`` of
    the scan body: ``"dots"`` keeps the products without a batch dim
    (``dots_with_no_batch_dims_saveable``), ``"save_outs"`` the outputs of
    the two halves (the reference saves its ``mixer_out`` and ``ffn_out``
    names), ``"full"`` nothing (the reference's policy None). Returns
    ``(x, aux)``; the values are ``apply_layer``'s."""
    mix = functools.partial(_mix, spec, p, positions=positions,
                            enc_out=enc_out, norm_eps=norm_eps, ctx=ctx)

    def layer(x):
        x, _, aux = apply_layer(spec, p, x, positions, enc_out=enc_out,
                                norm_eps=norm_eps, ctx=ctx)
        return x, aux

    if remat == "full":
        return ckpt.checkpoint(layer, x, use_reentrant=False)
    if remat == "dots":
        return ckpt.checkpoint(
            layer, x, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    x = ckpt.checkpoint(lambda x: mix(x)[0], x, use_reentrant=False)
    return ckpt.checkpoint(functools.partial(_channel, spec, p,
                                             norm_eps=norm_eps, ctx=ctx),
                           x, use_reentrant=False)


def _bidir_attn(p, cfg, x: torch.Tensor, positions: torch.Tensor,
                ctx=NO_MESH):
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
    out = att.attend(ctx, q, k, v, 1.0 / math.sqrt(dh), causal=False)
    y = out.reshape(b, s, h * dh) @ p["wo"]
    return ctx.constrain(y, "dp", None, None)


class LM:
    """``ctx`` (a ``nn.sharding.ShardCtx``) runs the model as a DTensor
    program over its mesh: parameters and inputs DTensors placed by
    ``param_pspec`` and ``configs.input_specs``, the reference's
    constraints and manual regions at the same points. None (the default)
    is the one-device model."""

    def __init__(self, cfg: ModelConfig, ctx=None):
        self.cfg = cfg
        self.ctx = ctx or NO_MESH
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
            tree["head"] = {"table": ParamSpec(
                (cfg.vocab_size, cfg.d_model), dt, scale=0.02,
                axes=("model", "fsdp"))}
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
                "w": ParamSpec((cfg.d_model, cfg.d_model), dt,
                               axes=("fsdp", "model"))}
        if cfg.mtp:
            # DeepSeek-V3's multi-token-prediction block: carried with the
            # parameters, used only by the training loss
            tree["mtp"] = {
                "norm_h": basic.rmsnorm_specs(cfg.d_model),
                "norm_e": basic.rmsnorm_specs(cfg.d_model),
                "proj": ParamSpec((2 * cfg.d_model, cfg.d_model), dt,
                                  axes=("fsdp", "model")),
                "block": layer_specs(cfg.blocks[-1], cfg.d_model, dt),
            }
        return tree

    # ---------------- forward pieces

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        if self.ctx.mesh is None:
            return basic.embed(params["embed"], tokens)
        return _sharded_embed(self.ctx, params["embed"]["table"], tokens)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = basic.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        table = (params["embed"]["table"] if cfg.tie_embeddings
                 else params["head"]["table"])
        logits = basic.unembed({"table": table}, x, self.ctx)
        if cfg.logit_softcap:
            c = cfg.logit_softcap
            logits = torch.tanh(basic.f32(logits) / c) * c
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
            # the stack's input as the embedding's: batch over dp, whole rows
            x = self.ctx.constrain(x, "dp", None, None)
        if positions is None:
            positions = self._positions(tokens)
        # on a mesh whole on every rank (a small gather), so that the rope
        # tables are replicated DTensors
        return x, self.ctx.replicated(positions)

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
                                    self.cfg.norm_eps, self.ctx)
            else:
                c_i = caches["layers"][i] if caches is not None else None
                x, nc, a = apply_layer(spec, p_i, x, positions, cache=c_i,
                                       cache_pos=cache_pos, enc_out=enc_out,
                                       norm_eps=self.cfg.norm_eps,
                                       ctx=self.ctx)
                new_layers.append(nc)
            aux = aux + a
        if caches is None and not want_cache:
            return x, None, aux
        return x, {"layers": new_layers}, aux

    def _encode(self, params, enc_emb: torch.Tensor) -> torch.Tensor:
        """The encoder stack over precomputed frontend embeddings (B,
        S_enc, D) at positions 0..S_enc-1, then ``enc_norm``."""
        x = enc_emb
        positions = self.ctx.replicated(self._positions(enc_emb[..., 0]))
        for spec, p in zip(self.enc_layers, params["enc_layers"]):
            x, _, _ = apply_layer(spec, p, x, positions, causal=False,
                                  norm_eps=self.cfg.norm_eps, ctx=self.ctx)
        return basic.rmsnorm(params["enc_norm"], x, self.cfg.norm_eps)

    # ---------------- public steps

    def loss_and_aux(self, params, batch: dict, remat: str = "none"):
        """The training loss of ``batch``: ``tokens`` and ``labels`` (B,
        S), and as the config needs them ``frontend_emb``,
        ``frontend_mask``, ``positions`` ((B, S), or (3, B, S) for
        M-RoPE) and ``enc_emb``. Returns ``(loss + aux, {"aux": aux})``
        as the reference does: the mean cross-entropy, plus 0.3 x MTP's
        for DeepSeek-V3, plus the MoE load-balance losses."""
        with self.ctx.scope():
            return self._loss_and_aux(self._gathered(params), batch, remat)

    def _gathered(self, params):
        """``params`` with the weights outside the layer stacks (tables,
        projections, norms, MTP) gathered over the fsdp axes (each layer
        gathers its own as it runs)."""
        if self.ctx.mesh is None:
            return params
        stacks = ("layers", "enc_layers")
        top = self.ctx.fsdp_gather({k: v for k, v in params.items()
                                    if k not in stacks})
        return {**top, **{k: params[k] for k in stacks if k in params}}

    def _loss_and_aux(self, params, batch: dict, remat: str):
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
        """Cross-entropy of the final hidden states. Without tensor
        parallelism the fused chunked-vocab loss (no (tokens x vocab)
        logits are kept); with it the vocab-sharded path
        (:func:`_sharded_xent`), as the reference."""
        cfg = self.cfg
        ctx = self.ctx
        table = (params["embed"]["table"] if cfg.tie_embeddings
                 else params["head"]["table"])
        if ctx.mesh is not None and ctx.tp_size() > 1:
            return _sharded_xent(ctx, self._logits(params, x), labels)
        xn = basic.rmsnorm(params["final_norm"], x, cfg.norm_eps)
        if ctx.mesh is None:
            t = xn.shape[0] * xn.shape[1]
            return chunked_xent(xn.reshape(t, cfg.d_model), table,
                                labels.reshape(t), 16384, cfg.logit_softcap)
        return _dp_xent(ctx, xn, table, labels, cfg.logit_softcap)

    def _mtp_loss(self, params, h: torch.Tensor, tokens: torch.Tensor,
                  batch: dict) -> torch.Tensor:
        """DeepSeek-V3's multi-token prediction: token t+2 from (h_t,
        the embedding of token t+1) through the MTP block."""
        cfg = self.cfg
        p = params["mtp"]
        emb_next = self._embed(params, _roll_left(self.ctx, tokens))
        z = torch.cat([basic.rmsnorm(p["norm_h"], h, cfg.norm_eps),
                       basic.rmsnorm(p["norm_e"], emb_next, cfg.norm_eps)],
                      dim=-1) @ p["proj"]
        # the block's input as every layer's: batch over dp, whole rows
        z = self.ctx.constrain(z, "dp", None, None)
        z, _, _ = apply_layer(cfg.blocks[-1], p["block"], z,
                              self.ctx.replicated(self._positions(tokens)),
                              norm_eps=cfg.norm_eps, ctx=self.ctx)
        labels2 = _roll_left(self.ctx, batch["labels"])
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
        with self.ctx.scope():
            params = self._gathered(params)
            x, positions = self._inputs(params, tokens, frontend_emb,
                                        frontend_mask, positions)
            enc_out = None
            if self.cfg.enc_dec:
                if enc_emb is None:
                    raise ValueError(f"{self.cfg.name} is an "
                                     f"encoder-decoder model: prefill "
                                     f"needs enc_emb")
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
        with self.ctx.scope():
            params = self._gathered(params)
            x = self._embed(params, tokens)
            if positions is None:
                positions = torch.full((tokens.shape[0], 1), int(pos),
                                       dtype=torch.int32,
                                       device=tokens.device)
            positions = self.ctx.replicated(positions)
            x, caches, _ = self._run_stack(params, x, positions,
                                           caches=caches, cache_pos=pos)
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


# ----------------------------------------------------------- shard helpers


def _batch_split(ctx, b: int):
    """(placements of a tensor whose dim 0 is a batch of ``b`` split over
    the dp axes that divide it, the same with Partial there, the process
    groups of those axes)."""
    from torch.distributed.tensor import Partial, Shard

    bp = ctx.placements(("dp",), (b,))
    split = [i for i, pl in enumerate(bp) if isinstance(pl, Shard)]
    part = tuple(Partial() if i in split else pl
                 for i, pl in enumerate(ctx.rep()))
    names = list(ctx.mesh.mesh_dim_names)
    return bp, part, ctx.groups([names[i] for i in split])


def _sharded_embed(ctx, table: torch.Tensor, tokens: torch.Tensor):
    """Megatron vocab-parallel embedding as a ``local_map`` body (the
    reference's fully-manual ``shard_map``): each rank gathers the rows of
    its vocab shard, zero elsewhere, and the model axis sums them. Without
    tensor parallelism (or a vocab the model axis does not divide) the
    table is gathered whole and each rank embeds its batch shard."""
    from torch.distributed.tensor import Shard

    bp, part, _ = _batch_split(ctx, tokens.shape[0])
    tp = ctx.tp_size()
    model = ctx.axes_of("model")
    if tp > 1 and table.shape[0] % tp == 0:
        v_local = table.shape[0] // tp
        lo = ctx.coord(model[0]) * v_local
        groups = ctx.groups(model)

        def body(tbl, tok):
            loc = tok.long() - lo
            ok = (loc >= 0) & (loc < v_local)
            loc = torch.clamp(loc, 0, v_local - 1)
            out = torch.nn.functional.embedding(loc, tbl) \
                * ok[..., None].to(tbl.dtype)
            return psum(out, groups)

        tbl_pl = ctx.with_dims(ctx.rep(), model, Shard(0))
        tbl_grad = ctx.with_dims(part, model, Shard(0))
    else:
        def body(tbl, tok):
            return torch.nn.functional.embedding(tok.long(), tbl)

        tbl_pl, tbl_grad = ctx.rep(), part
    out = ctx.region(body, bp, (tbl_pl, bp), (tbl_grad, None), table,
                     tokens)
    return ctx.constrain(out, "dp", None, None)


def _sharded_xent(ctx, logits: torch.Tensor, labels: torch.Tensor):
    """Cross-entropy over vocab-sharded logits without gathering the vocab
    axis (Megatron: local max / sum-exp / label pick, then max and sums
    over the model axis and the sum over dp), a ``local_map`` body. A
    vocab the model axis does not divide is taken whole on each rank."""
    from torch.distributed.tensor import Shard

    b, s, v = logits.shape
    bp, _, dp_groups = _batch_split(ctx, b)
    tp = ctx.tp_size()
    model = ctx.axes_of("model")
    n_tokens = b * s
    if v % tp == 0:
        v_local = v // tp
        lo = ctx.coord(model[0]) * v_local
        groups = ctx.groups(model)
        lg_pl = ctx.with_dims(bp, model, Shard(2))
    else:
        v_local, lo, groups, lg_pl = v, 0, [], bp

    def body(lg, lb):
        lgf = basic.f32(lg)
        # the stabiliser max carries no gradient (it cancels in softmax)
        gmax = pmax(torch.amax(lgf, dim=-1), groups)
        se = torch.sum(torch.exp(lgf - gmax[..., None]), dim=-1)
        lse = torch.log(psum(se, groups)) + gmax
        loc = lb.long() - lo
        ok = (loc >= 0) & (loc < v_local)
        loc = torch.clamp(loc, 0, v_local - 1)
        picked = torch.gather(lgf, -1, loc[..., None])[..., 0]
        picked = psum(picked * ok.to(lgf.dtype), groups)
        total = psum(torch.sum(lse - picked), dp_groups)
        return total / n_tokens

    return ctx.region(body, ctx.rep(), (lg_pl, bp), (lg_pl, None), logits,
                      labels)


def _dp_xent(ctx, xn: torch.Tensor, table: torch.Tensor,
             labels: torch.Tensor, softcap: float):
    """The chunked-vocab loss (``nn/xent``) on each rank's batch shard
    with the whole table (a ``local_map`` body), the mean over the batch
    taken as the sum over dp of each shard's mean times its share."""
    b, s, d = xn.shape
    bp, part, dp_groups = _batch_split(ctx, b)

    def body(x_l, tbl, lb):
        t = x_l.shape[0] * x_l.shape[1]
        loss = chunked_xent(x_l.reshape(t, d), tbl, lb.reshape(t), 16384,
                            softcap)
        if not dp_groups:
            return loss
        return psum(loss * (t / (b * s)), dp_groups)

    return ctx.region(body, ctx.rep(), (bp, ctx.rep(), bp),
                      (bp, part, None), xn, table, labels)


def _roll_left(ctx, t: torch.Tensor) -> torch.Tensor:
    """``torch.roll(t, -1, dims=1)``: on a mesh on each rank's batch
    shard, the sequence being whole on every rank."""
    return batch_map(ctx, lambda x: torch.roll(x, -1, dims=1), (t,), (0,),
                     0)
