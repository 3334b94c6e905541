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


def lasting_empty(shape, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """An empty tensor meant to outlive the temporaries made after it (a
    weight filled from f32 draws or from a quantizer's f32 work). On the
    card the caching allocator first returns its cached blocks, so the
    tensor takes a segment of its own: one that later holds the
    temporaries' freed blocks beside it can never be given back, and the
    KV pool, sized from free memory, would lose it."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return torch.empty(shape, dtype=dtype, device=device)
