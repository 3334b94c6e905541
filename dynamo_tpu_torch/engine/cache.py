"""Paged KV cache storage and block allocator — port of
``dynamo_tpu/engine/cache.py`` for a model-precision (bf16/f32) cache.

Cache tensors are ``[layers, num_blocks, block_size, kv_heads, head_dim]``
on the engine's device. Block 0 is reserved as the trash block for padding
writes (models/llama.py). The int8/int4 quantized layouts are still to be
ported (ROADMAP); ``bytes_per_block`` already prices them exactly as the
JAX spec does, since it sizes the pool.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from dynamo_tpu_torch.engine.errors import NoFreeBlocks
from dynamo_tpu_torch.models.config import ModelConfig

#: scales are float32 — 4 bytes per (layer, block, kv_head), k and v each
_SCALE_ITEMSIZE = 4


@dataclass
class KVCacheSpec:
    num_blocks: int
    block_size: int
    num_layers: int
    num_kv_heads: int
    head_dim: int
    dtype: str = "bfloat16"
    #: "int8" / "int4" mean quantized storage (not ported yet); any other
    #: value means the cache is stored at ``dtype`` (model precision).
    kv_dtype: str = "bfloat16"

    @classmethod
    def for_model(cls, cfg: ModelConfig, num_blocks: int, block_size: int,
                  kv_dtype: str = "bfloat16") -> "KVCacheSpec":
        return cls(
            num_blocks=num_blocks,
            block_size=block_size,
            num_layers=cfg.num_layers,
            num_kv_heads=cfg.num_kv_heads,
            head_dim=cfg.head_dim,
            dtype=cfg.dtype,
            kv_dtype=kv_dtype,
        )

    @property
    def quantized(self) -> bool:
        return self.kv_dtype in ("int8", "int4")

    @property
    def shape(self) -> tuple[int, int, int, int, int]:
        return (self.num_layers, self.num_blocks, self.block_size, self.num_kv_heads, self.head_dim)

    def bytes_per_block(self) -> int:
        if self.quantized:
            d = self.head_dim // 2 if self.kv_dtype == "int4" else self.head_dim
            payload = 2 * self.num_layers * self.block_size * self.num_kv_heads * d
            scales = 2 * self.num_layers * self.num_kv_heads * _SCALE_ITEMSIZE
            return payload + scales
        itemsize = torch.empty((), dtype=getattr(torch, self.dtype)).element_size()
        # k + v, all layers
        return 2 * self.num_layers * self.block_size * self.num_kv_heads * self.head_dim * itemsize


def allocate_cache(spec: KVCacheSpec, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Zeroed K and V caches on ``device`` (model-precision storage)."""
    if spec.quantized:
        raise NotImplementedError(
            f"kv_dtype={spec.kv_dtype!r}: the quantized KV cache is not "
            "ported yet (ROADMAP: int8/int4 cache slice)")
    dt = getattr(torch, spec.dtype)
    return (torch.zeros(spec.shape, dtype=dt, device=device),
            torch.zeros(spec.shape, dtype=dt, device=device))


@dataclass
class BlockAllocator:
    """Free-list allocator over device block ids. Block 0 (trash) is never
    handed out."""

    num_blocks: int
    _free: list[int] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._free = list(range(self.num_blocks - 1, 0, -1))  # pop() yields 1,2,3..

    @property
    def num_free(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> list[int]:
        if n > len(self._free):
            raise NoFreeBlocks(f"need {n} blocks, {len(self._free)} free")
        return [self._free.pop() for _ in range(n)]

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if not 0 < b < self.num_blocks:
                raise ValueError(f"bad block id {b}")
        self._free.extend(blocks)
