"""The device every entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device); a CUDA device without a card raises (there is
    no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    return dev
