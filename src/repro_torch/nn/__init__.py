"""Model configuration dataclasses."""
