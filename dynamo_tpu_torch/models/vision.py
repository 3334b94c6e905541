"""Vision encoder: images → a fixed number of LM-space embedding tokens.

Copy of ``dynamo_tpu/models/vision.py`` in PyTorch: a small ViT (patchify
→ linear → pre-norm transformer blocks → learned-query pooling to
``num_image_tokens`` vectors of the LM's hidden size), in float32, on an
explicit device. Its products and softmax are plain torch ops, as they
are plain ``jnp`` in JAX: no kernel of its own.

What follows the JAX module exactly:

* ``_ln`` has no bias and uses eps 1e-5 and ``rsqrt``;
* the MLP's GELU is the tanh approximation (``jax.nn.gelu``'s default);
* the pooling attends with layer 0's attention weights.

The weights are the port's own seeded draw (``torch.Generator`` seeded
with ``cfg.seed``, on the CPU, so the CPU and the card hold the same
bits): JAX draws its weights from ``jax.random``, which the port cannot
reproduce. ``vision_params_from_jax`` carries JAX's weights across.
Images decode through ``models/image.py`` (PNG and Pillow's resize,
without PIL). Matmuls run in full float32 on the card (TF32 off).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dynamo_tpu_torch.models.image import decode_image
from dynamo_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 64           # input resized to image_size x image_size
    patch_size: int = 16
    hidden_size: int = 128         # ViT width
    num_layers: int = 2
    num_heads: int = 4
    num_image_tokens: int = 8      # pooled output tokens
    lm_hidden_size: int = 64       # target LM hidden (tiny-llama default)
    seed: int = 7

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * 3


def init_vision_params(cfg: VisionConfig, device: str | torch.device | None = None) -> dict:
    """Seeded random weights (the JAX module's shapes and scales, drawn in
    its order), float32 on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(cfg.seed)
    h = cfg.hidden_size

    def dense(shape, fan_in):
        return (torch.randn(shape, generator=gen, dtype=torch.float32) * (fan_in ** -0.5)).to(dev)

    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "wq": dense((h, h), h), "wk": dense((h, h), h),
            "wv": dense((h, h), h), "wo": dense((h, h), h),
            "w1": dense((h, 4 * h), h), "w2": dense((4 * h, h), 4 * h),
            "ln1": torch.ones(h, device=dev), "ln2": torch.ones(h, device=dev),
        })
    return {
        "patch_proj": dense((cfg.patch_dim, h), cfg.patch_dim),
        "pos": dense((cfg.num_patches, h), h),
        "queries": dense((cfg.num_image_tokens, h), h),
        "out_proj": dense((h, cfg.lm_hidden_size), h),
        "final_ln": torch.ones(h, device=dev),
        "layers": layers,
    }


def vision_params_from_jax(np_tree: dict, device: str | torch.device | None = None) -> dict:
    """The JAX module's params (``jax.tree.map(np.asarray, params)``) → the
    port's, bit for bit, on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)

    def conv(x: Any):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return torch.from_numpy(np.array(x, dtype=np.float32, copy=True)).to(dev)

    return conv(np_tree)


def _ln(x: torch.Tensor, g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g


def _attn(x, q_in, wq, wk, wv, wo, num_heads: int) -> torch.Tensor:
    """Cross (or self) attention: queries ``q_in`` attend over ``x``."""
    B, N, H = x.shape
    M = q_in.shape[1]
    d = H // num_heads
    q = (q_in @ wq).reshape(B, M, num_heads, d).transpose(1, 2)
    kk = (x @ wk).reshape(B, N, num_heads, d).transpose(1, 2)
    v = (x @ wv).reshape(B, N, num_heads, d).transpose(1, 2)
    a = torch.softmax((q @ kk.transpose(2, 3)) * (d ** -0.5), dim=-1)
    o = (a @ v).transpose(1, 2).reshape(B, M, H)
    return o @ wo


def encode_patches(params: dict, cfg: VisionConfig, patches: torch.Tensor) -> torch.Tensor:
    """[B, num_patches, patch_dim] float32 → [B, num_image_tokens, lm_H]."""
    x = patches @ params["patch_proj"] + params["pos"][None]
    for lp in params["layers"]:
        xn = _ln(x, lp["ln1"])
        x = x + _attn(xn, xn, lp["wq"], lp["wk"], lp["wv"], lp["wo"], cfg.num_heads)
        xn = _ln(x, lp["ln2"])
        x = x + F.gelu(xn @ lp["w1"], approximate="tanh") @ lp["w2"]
    x = _ln(x, params["final_ln"])
    # learned-query pooling to a fixed token count
    q = params["queries"][None].expand(x.shape[0], cfg.num_image_tokens, cfg.hidden_size)
    lp0 = params["layers"][0]
    pooled = _attn(x, q, lp0["wq"], lp0["wk"], lp0["wv"], lp0["wo"], cfg.num_heads)
    return pooled @ params["out_proj"]


class VisionEncoder(nn.Module):
    """Host-facing encoder: decodes and resizes images on the host, runs
    the ViT on ``device`` (default: the CUDA card). ``last_timing`` holds
    the last ``encode``'s host milliseconds (decode and resize) and device
    milliseconds (the ViT, by CUDA events on a card, else wall time)."""

    def __init__(self, cfg: VisionConfig | None = None,
                 device: str | torch.device | None = None, params: dict | None = None):
        super().__init__()
        self.cfg = cfg or VisionConfig()
        self.device = resolve_device(device)
        p = params if params is not None else init_vision_params(self.cfg, self.device)
        self.top = nn.ParameterDict({k: nn.Parameter(v.to(self.device), requires_grad=False)
                                     for k, v in p.items() if k != "layers"})
        self.blocks = nn.ModuleList(
            nn.ParameterDict({k: nn.Parameter(v.to(self.device), requires_grad=False)
                              for k, v in lp.items()}) for lp in p["layers"])
        self.last_timing: dict[str, float] = {}
        if self.device.type == "cuda":
            # the f32 ViT's matmuls stay f32 (TF32 would round their inputs)
            torch.backends.cuda.matmul.allow_tf32 = False

    @property
    def params(self) -> dict:
        return {**self.top, "layers": list(self.blocks)}

    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        return encode_patches(self.params, self.cfg, patches)

    def _to_patches(self, img: np.ndarray) -> np.ndarray:
        c = self.cfg
        P, G = c.patch_size, c.image_size // c.patch_size
        x = img.astype(np.float32) / 255.0
        x = x.reshape(G, P, G, P, 3).transpose(0, 2, 1, 3, 4)
        return x.reshape(c.num_patches, c.patch_dim)

    def decode_image(self, data: bytes) -> np.ndarray:
        """Image bytes → [image_size, image_size, 3] uint8 (PNG; others are
        refused by name, models/image.py)."""
        return decode_image(data, self.cfg.image_size)

    @torch.no_grad()
    def encode(self, images: list[bytes]) -> np.ndarray:
        """Image bytes → [N, num_image_tokens, lm_hidden] float32."""
        t0 = time.perf_counter()
        patches = np.stack([self._to_patches(self.decode_image(b)) for b in images])
        t1 = time.perf_counter()
        x = torch.from_numpy(patches).to(self.device)
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = self(x)
            end.record()
            end.synchronize()
            device_ms = start.elapsed_time(end)
        else:
            t2 = time.perf_counter()
            out = self(x)
            device_ms = (time.perf_counter() - t2) * 1e3
        self.last_timing = {"decode_ms": (t1 - t0) * 1e3, "device_ms": device_ms}
        return out.cpu().numpy()
