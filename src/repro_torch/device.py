"""Explicit device selection for the port's entry points.

Entry points default to ``"cuda"``. Asking for CUDA on a machine without
it is an error, never a silent fall back to the CPU: a caller that wants
the host path passes ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` (a string or ``torch.device``) as a ``torch.device``.

    Raises ``RuntimeError`` for a CUDA device when CUDA is unavailable and
    ``ValueError`` for a device type other than ``cpu`` or ``cuda``."""
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the host")
    return dev
