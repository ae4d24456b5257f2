"""deepseek-v2-236b [moe] — arXiv:2405.04434.

60L d_model=5120 128H, MLA (kv_lora=512, q_lora=1536, qk_nope=128,
qk_rope=64, v_head=128), d_ff_expert=1536, MoE 160 routed top-6 + 2 shared,
first layer dense (d_ff=12288), vocab=102400.

EP note: 160 experts do not divide the 16-way model axis evenly per shard
group of 10 — 160 % 16 == 0, so 10 experts/device. Softmax router with
top-k scaling, aux load-balance loss.
"""
from repro_torch.configs.common import register
from repro_torch.nn.config import AttnConfig, LayerSpec, ModelConfig, MoEConfig

NAME = "deepseek-v2-236b"


def _mla() -> AttnConfig:
    return AttnConfig(
        n_heads=128, n_kv_heads=128, head_dim=128, kind="mla",
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    )


@register(NAME)
def config() -> ModelConfig:
    moe = MoEConfig(
        n_experts=160, top_k=6, d_ff_expert=1536,
        n_shared=2, d_ff_shared=3072,
    )
    dense = LayerSpec(kind="attn", attn=_mla(), d_ff=12288)
    moel = LayerSpec(kind="attn", attn=_mla(), moe=moe)
    return ModelConfig(
        name=NAME,
        family="moe",
        d_model=5120,
        vocab_size=102400,
        prefix=(dense,),
        blocks=(moel,),
        n_repeat=59,  # 1 dense + 59 MoE = 60 layers
        tie_embeddings=False,
    )
