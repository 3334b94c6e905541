"""Device choice for the port's entry points.

Every entry point takes ``device``. Left unset it means the CUDA card;
with no card that is an error, never a silent CPU run. ``device="cpu"``
is the explicit request the CPU tests make.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` → ``cuda`` (raises when no card is visible); anything else
    is taken as given, and a CUDA device is checked to exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev


def device_name(device: torch.device) -> str:
    """The name the cost model's hardware table is keyed by: "cpu" for the
    CPU, ``torch.cuda.get_device_name`` for a card."""
    if device.type == "cpu":
        return "cpu"
    return torch.cuda.get_device_name(device)
