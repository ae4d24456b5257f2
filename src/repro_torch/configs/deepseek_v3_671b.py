"""deepseek-v3-671b [moe] — arXiv:2412.19437.

61L d_model=7168 128H, MLA (kv_lora=512, q_lora=1536, qk_nope=128,
qk_rope=64, v_head=128), d_ff_expert=2048, MoE 256 routed top-8 (sigmoid
router, aux-loss-free bias balancing) + 1 shared expert, first 3 layers
dense (d_ff=18432), vocab=129280, MTP (multi-token prediction) head.
"""
from repro_torch.configs.common import register
from repro_torch.nn.config import AttnConfig, LayerSpec, ModelConfig, MoEConfig

NAME = "deepseek-v3-671b"


def _mla() -> AttnConfig:
    return AttnConfig(
        n_heads=128, n_kv_heads=128, head_dim=128, kind="mla",
        q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    )


@register(NAME)
def config() -> ModelConfig:
    moe = MoEConfig(
        n_experts=256, top_k=8, d_ff_expert=2048,
        n_shared=1, d_ff_shared=2048, router_fn="sigmoid",
    )
    dense = LayerSpec(kind="attn", attn=_mla(), d_ff=18432)
    moel = LayerSpec(kind="attn", attn=_mla(), moe=moe)
    return ModelConfig(
        name=NAME,
        family="moe",
        d_model=7168,
        vocab_size=129280,
        prefix=(dense,) * 3,
        blocks=(moel,),
        n_repeat=58,  # 3 dense + 58 MoE = 61 layers
        tie_embeddings=False,
        mtp=True,
    )
