"""gemma3-12b [dense] — hf:google/gemma-3 family (pattern per tech report).

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144.
5:1 local(sliding-window 1024):global interleave, 128k context:
superblock = 5 sliding + 1 global, repeated 8x. head_dim=256 (gemma3 uses
wide heads, d_model/n_heads != head_dim).
"""
from repro_torch.configs.common import register
from repro_torch.nn.config import AttnConfig, LayerSpec, ModelConfig

NAME = "gemma3-12b"


@register(NAME)
def config() -> ModelConfig:
    local = AttnConfig(
        n_heads=16, n_kv_heads=8, head_dim=256,
        window=1024, rope_theta=10_000.0,
    )
    glob = AttnConfig(
        n_heads=16, n_kv_heads=8, head_dim=256, rope_theta=1_000_000.0
    )
    mk = lambda a: LayerSpec(kind="attn", attn=a, d_ff=15360)
    return ModelConfig(
        name=NAME,
        family="dense",
        d_model=3840,
        vocab_size=262144,
        blocks=(mk(local),) * 5 + (mk(glob),),
        n_repeat=8,  # 8 x 6 = 48 layers
        tie_embeddings=True,
        # 5/6 sliding-window layers -> long-context decode is dominated by
        # the ring buffers; global layers keep full KV. Treated as
        # sub-quadratic for the long_500k cell (see DESIGN.md §4).
        sub_quadratic=True,
    )
