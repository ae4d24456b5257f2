"""Architecture registry: the 10 assigned architectures + the paper's own
models. ``get_config(name)`` / ``list_archs()`` are the public API;
``ASSIGNED`` lists the assigned rows; each builds a ``models.lm.LM``."""
from repro_torch.configs import (  # noqa: F401  (import for registration)
    deepseek_v2_236b,
    deepseek_v3_671b,
    gemma3_12b,
    granite_3_8b,
    jamba_1_5_large_398b,
    paper_models,
    qwen1_5_110b,
    qwen2_vl_7b,
    seamless_m4t_large_v2,
    xlstm_350m,
    yi_34b,
)
from repro_torch.configs.common import get_config, list_archs, shrink

ASSIGNED = [
    "jamba-1.5-large-398b",
    "gemma3-12b",
    "yi-34b",
    "granite-3-8b",
    "qwen1.5-110b",
    "qwen2-vl-7b",
    "seamless-m4t-large-v2",
    "deepseek-v2-236b",
    "deepseek-v3-671b",
    "xlstm-350m",
]

PAPER_MODELS = ["search-r1-7b", "qwen3-8b-code", "qwen3-0.6b"]

__all__ = ["ASSIGNED", "PAPER_MODELS", "get_config", "list_archs", "shrink"]
