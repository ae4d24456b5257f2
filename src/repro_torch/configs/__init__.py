"""Architecture registry: the paper's own models. ``get_config(name)`` /
``list_archs()`` are the public API. The ten assigned dry-run
architectures join with the rest of the model stack (ROADMAP)."""
from repro_torch.configs import paper_models  # noqa: F401  (registration)
from repro_torch.configs.common import get_config, list_archs, shrink

PAPER_MODELS = ["search-r1-7b", "qwen3-8b-code", "qwen3-0.6b"]

__all__ = ["PAPER_MODELS", "get_config", "list_archs", "shrink"]
