"""Decoder-only language model, mirroring the reference's ``models/lm.py``
for attention layers: GQA (full or sliding-window, M-RoPE, QKV bias) or
MLA, each with a dense FFN or an MoE channel mixer, dense prefix layers,
the vision-frontend stub and the MTP block's parameters.

Parameters are a dict ``{"embed": {"table"}, "final_norm": {"scale"},
["head": {"table"}], ["frontend_proj": {"w"}], ["mtp": {...}], "layers":
[per-layer dict, ...]}``: the layers are a Python list in
``cfg.layer_iter()`` order (the prefix layers first) where the reference
keeps ``prefix`` apart and stacks each superblock position over
``n_repeat`` for ``lax.scan`` (``convert.lm_params_from_numpy`` maps one
onto the other). The stack is a Python loop; a decode step updates each
layer's cache in place.

Steps: :meth:`LM.prefill` (logits of the last position and the caches),
:meth:`LM.decode` (one token against the caches). Mamba, mLSTM and sLSTM
layers, encoder-decoder models with their cross-attention and
bidirectional encoder, and the audio frontend come with a later slice;
the training loss (MTP's included) with the training slice: an
:class:`LM` of such a config, or ``loss_and_aux``, raises
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.nn import attention as att
from repro_torch.nn import basic
from repro_torch.nn import moe as moe_mod
from repro_torch.nn.config import LayerSpec, ModelConfig
from repro_torch.nn.param import ParamSpec

MODEL_STACK = "ROADMAP slice 11a′: Mamba, xLSTM and encoder-decoder models"
TRAINING = "ROADMAP slice 11b 'Training'"


def _unported(what: str, slice_: str = MODEL_STACK) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({slice_})")


def _check_layer(spec: LayerSpec) -> None:
    if spec.kind != "attn":
        raise _unported(f"layer kind {spec.kind!r} (Mamba / xLSTM)")
    if spec.cross_attn:
        raise _unported("cross-attention")


def layer_specs(spec: LayerSpec, d_model: int, dtype) -> dict:
    _check_layer(spec)
    p: dict[str, Any] = {"norm1": basic.rmsnorm_specs(d_model)}
    if spec.attn.kind == "mla":
        p["mixer"] = att.mla_specs(spec.attn, d_model, dtype)
    else:
        p["mixer"] = att.gqa_specs(spec.attn, d_model, dtype)
    if spec.moe is not None:
        p["norm2"] = basic.rmsnorm_specs(d_model)
        p["moe"] = moe_mod.moe_specs(spec.moe, d_model, dtype)
    elif spec.d_ff:
        p["norm2"] = basic.rmsnorm_specs(d_model)
        p["ffn"] = basic.ffn_specs(d_model, spec.d_ff, dtype, spec.ffn_act)
    return p


def layer_cache_specs(spec: LayerSpec, batch: int, s_cache: int, dtype,
                      kv_quant: bool = False) -> dict:
    _check_layer(spec)
    if spec.attn.kind == "mla":
        return {"mixer": att.mla_cache_specs(spec.attn, batch, s_cache,
                                             dtype)}
    return {"mixer": att.gqa_cache_specs(spec.attn, batch, s_cache, dtype,
                                         quant=kv_quant)}


def apply_layer(spec: LayerSpec, p, x: torch.Tensor, positions: torch.Tensor,
                *, cache=None, cache_pos=None, norm_eps: float = 1e-6):
    """Returns ``(x, cache)``: the layer's output and its (new or updated)
    cache ``{"mixer": {...}}``. An MoE layer's load-balance loss is not
    returned: serving ignores it, as the reference's prefill and decode
    do."""
    h = basic.rmsnorm(p["norm1"], x, norm_eps)
    mix_cache = cache["mixer"] if cache else None
    if spec.attn.kind == "mla":
        y, mix = att.mla_apply(p["mixer"], spec.attn, h, positions,
                               cache=mix_cache, cache_pos=cache_pos,
                               eps=norm_eps)
    else:
        y, mix = att.gqa_apply(p["mixer"], spec.attn, h, positions,
                               cache=mix_cache, cache_pos=cache_pos)
    x = x + y
    if spec.moe is not None:
        h2 = basic.rmsnorm(p["norm2"], x, norm_eps)
        x = x + moe_mod.moe_apply(p["moe"], spec.moe, h2)[0]
    elif spec.d_ff:
        h2 = basic.rmsnorm(p["norm2"], x, norm_eps)
        x = x + basic.ffn(p["ffn"], h2, spec.ffn_act)
    return x, {"mixer": mix}


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.enc_dec:
            raise _unported("encoder-decoder models")
        if cfg.frontend not in (None, "vision"):
            raise _unported(f"the {cfg.frontend!r} frontend")
        for spec in cfg.layer_iter():
            _check_layer(spec)
        self.cfg = cfg
        self.layers = cfg.layer_iter()

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
        if cfg.frontend:
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
                   want_cache: bool = False):
        """The layers in order. With ``caches`` (decode) each layer's cache
        is updated in place; otherwise ``want_cache`` collects the
        prefill's K/V (latent and rope key for MLA). Returns ``(x, caches
        or None)``."""
        new_layers = []
        for i, spec in enumerate(self.layers):
            c_i = caches["layers"][i] if caches is not None else None
            x, nc = apply_layer(spec, params["layers"][i], x, positions,
                                cache=c_i, cache_pos=cache_pos,
                                norm_eps=self.cfg.norm_eps)
            new_layers.append(nc)
        if caches is None and not want_cache:
            return x, None
        return x, {"layers": new_layers}

    # ---------------- public steps

    def loss_and_aux(self, params, batch):
        raise _unported("the training loss", TRAINING)

    def prefill(self, params, tokens: torch.Tensor, *,
                frontend_emb: Optional[torch.Tensor] = None,
                frontend_mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None):
        """tokens (B, S) -> logits of the last position (B, 1, V) and the
        caches ``{"layers": [{"mixer": {...}}, ...]}`` of length S. A
        vision config takes ``frontend_emb`` (B, S, D) and
        ``frontend_mask`` (B, S) bool; ``positions`` (B, S), or (3, B, S)
        for M-RoPE, replaces 0..S-1."""
        x, positions = self._inputs(params, tokens, frontend_emb,
                                    frontend_mask, positions)
        x, caches = self._run_stack(params, x, positions, want_cache=True)
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
        ``positions`` (B, 1) per-row rope positions (default ``pos``)."""
        x = self._embed(params, tokens)
        if positions is None:
            positions = torch.full((tokens.shape[0], 1), int(pos),
                                   dtype=torch.int32, device=tokens.device)
        x, caches = self._run_stack(params, x, positions, caches=caches,
                                    cache_pos=pos)
        return self._logits(params, x), caches

    # ---------------- cache tree

    def cache_specs(self, batch: int, s_cache: int,
                    kv_quant: bool = False) -> dict:
        dt = self.cfg.pdt
        return {"layers": [layer_cache_specs(sp, batch, s_cache, dt, kv_quant)
                           for sp in self.layers]}
