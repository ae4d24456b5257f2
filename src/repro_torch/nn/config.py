"""Model/layer configuration dataclasses shared by nn layers and configs/."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype named ``name`` ("bfloat16", "float32", ...)."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    kind: str = "gqa"  # gqa | mla
    rope_kind: str = "rope"  # rope | mrope | none
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    window: Optional[int] = None  # sliding-window size; None = full attention
    qkv_bias: bool = False
    # MLA (deepseek) dims
    q_lora_rank: Optional[int] = None
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    @property
    def q_out_dim(self) -> int:
        if self.kind == "mla":
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    d_ff_shared: int = 0  # defaults to d_ff_expert * n_shared when 0
    capacity_factor: float = 1.25
    router_scale: bool = True  # normalise top-k weights to sum to 1
    router_fn: str = "softmax"  # softmax | sigmoid (deepseek-v3)
    aux_loss_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    chunk: int = 256  # time-chunk for the train-time scan


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    kind: str = "mlstm"  # mlstm | slstm
    n_heads: int = 4
    proj_factor: float = 2.0
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One layer of a (super)block: sequence-mixer + channel-mixer."""

    kind: str  # attn | mamba | mlstm | slstm
    attn: Optional[AttnConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    d_ff: int = 0  # dense FFN width; 0 = no dense FFN
    moe: Optional[MoEConfig] = None  # if set, channel mixer is MoE
    ffn_act: str = "swiglu"  # swiglu | gelu
    cross_attn: bool = False  # decoder cross-attention (enc-dec models)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    vocab_size: int
    # decoder structure: prefix layers (unrolled) + superblock * n_repeat (scan)
    blocks: tuple[LayerSpec, ...] = ()
    n_repeat: int = 1
    prefix: tuple[LayerSpec, ...] = ()
    # encoder-decoder
    enc_dec: bool = False
    enc_blocks: tuple[LayerSpec, ...] = ()
    enc_repeat: int = 0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    logit_softcap: float = 0.0
    mtp: bool = False  # deepseek-v3 multi-token prediction head
    frontend: Optional[str] = None  # vision | audio (stub embeddings)
    sub_quadratic: bool = False  # eligible for the long_500k shape
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def pdt(self):
        return _torch_dtype(self.param_dtype)

    @property
    def cdt(self):
        return _torch_dtype(self.compute_dtype)

    @property
    def n_layers(self) -> int:
        n = len(self.prefix) + len(self.blocks) * self.n_repeat
        if self.enc_dec:
            n += len(self.enc_blocks) * self.enc_repeat
        return n

    def layer_iter(self):
        """Logical (decoder-side) layer sequence (prefix, then repeats)."""
        out = list(self.prefix)
        for _ in range(self.n_repeat):
            out.extend(self.blocks)
        return out


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (workload) input shape."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def step(self) -> str:
        return "train_step" if self.kind == "train" else "serve_step"


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}
