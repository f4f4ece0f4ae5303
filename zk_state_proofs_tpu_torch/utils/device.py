"""The device every entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device, mesh=None) -> torch.device:
    """torch.device(device); a CUDA device without a card raises (there is
    no silent CPU fallback). With a mesh (parallel.make_mesh), the mesh's
    device, whose type `device` must name."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    if mesh is None:
        return dev
    if dev.type != mesh.device.type:
        raise ValueError(f"device {dev} is not of the mesh's device {mesh.device}")
    return mesh.device
