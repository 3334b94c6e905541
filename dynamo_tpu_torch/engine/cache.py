"""Paged KV cache storage and block allocator — port of
``dynamo_tpu/engine/cache.py`` for one device.

Cache tensors are ``[layers, num_blocks, block_size, kv_heads, head_dim]``
on the engine's device. Block 0 is reserved as the trash block for padding
writes (models/llama.py).

With ``kv_dtype="int8"`` each cache is a dict ``{"q": int8 payload
[L, NB, BS, KH, D], "s": float32 scales [L, NB, KH]}`` — symmetric
per-(layer, block, kv head) quantization at scatter time. ``kv_dtype=
"int4"`` keeps the dict but packs two signed nibbles a byte along head_dim:
``{"q": uint8 [L, NB, BS, KH, D//2], "s": f32}``; the uint8 payload dtype
is the packed-int4 marker everywhere downstream (scatter, gather, kernel).
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
    #: "int8" / "int4" enable quantized storage; any other value means the
    #: cache is stored at ``dtype`` (model precision).
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
    def packed_int4(self) -> bool:
        return self.kv_dtype == "int4"

    @property
    def payload_dtype(self) -> torch.dtype:
        """Storage dtype of the quantized payload: uint8 is the packed-int4
        marker (two nibbles a byte), int8 one byte an element."""
        return torch.uint8 if self.packed_int4 else torch.int8

    @property
    def payload_head_dim(self) -> int:
        """Trailing payload dim: head_dim, halved when int4-packed."""
        if self.packed_int4:
            if self.head_dim % 2:
                raise ValueError(
                    f"kv_dtype=int4 needs an even head_dim, got {self.head_dim}")
            return self.head_dim // 2
        return self.head_dim

    @property
    def shape(self) -> tuple[int, int, int, int, int]:
        return (self.num_layers, self.num_blocks, self.block_size, self.num_kv_heads, self.head_dim)

    @property
    def payload_shape(self) -> tuple[int, int, int, int, int]:
        """Stored payload shape: ``shape`` with head_dim/2 when int4-packed."""
        return (self.num_layers, self.num_blocks, self.block_size,
                self.num_kv_heads, self.payload_head_dim)

    @property
    def scale_shape(self) -> tuple[int, int, int]:
        """Quantization scales [layers, blocks, kv_heads] (int8/int4)."""
        return (self.num_layers, self.num_blocks, self.num_kv_heads)

    def bytes_per_block(self) -> int:
        if self.quantized:
            payload = (2 * self.num_layers * self.block_size
                       * self.num_kv_heads * self.payload_head_dim)
            scales = 2 * self.num_layers * self.num_kv_heads * _SCALE_ITEMSIZE
            return payload + scales
        itemsize = torch.empty((), dtype=getattr(torch, self.dtype)).element_size()
        # k + v, all layers
        return 2 * self.num_layers * self.block_size * self.num_kv_heads * self.head_dim * itemsize


def register_device_tier(pool, spec: KVCacheSpec, *, name: str = "device") -> None:
    """Register the device block pool as a tier row in the memory ledger
    (obs/mem_ledger.py). ``pool`` is a PrefixPool; resident means
    referenced-or-cached — everything not on the raw free list (block 0,
    never handed out, is excluded). Byte math comes from
    :meth:`KVCacheSpec.bytes_per_block`, so quantized specs report their
    packed footprint. Pulled only at snapshot/audit time, never per step."""
    from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger

    bytes_per_block = spec.bytes_per_block()

    def _occupancy() -> tuple[int, int]:
        resident = pool.num_blocks - 1 - pool.num_free_raw
        return resident, resident * bytes_per_block

    get_mem_ledger().register_tier(name, _occupancy)


def allocate_cache(spec: KVCacheSpec, device: torch.device):
    """Zeroed K and V caches on ``device``: tensors at model precision, or
    ``{"q", "s"}`` dicts when ``spec.quantized``."""
    if spec.quantized:
        def qzeros() -> dict[str, torch.Tensor]:
            return {"q": torch.zeros(spec.payload_shape, dtype=spec.payload_dtype,
                                     device=device),
                    "s": torch.zeros(spec.scale_shape, dtype=torch.float32, device=device)}
        return qzeros(), qzeros()
    dt = getattr(torch, spec.dtype)
    return (torch.zeros(spec.shape, dtype=dt, device=device),
            torch.zeros(spec.shape, dtype=dt, device=device))


def cache_payload(cache) -> torch.Tensor:
    """The payload of a quantized cache, or the tensor itself: wherever the
    [L, NB, BS, KH, Dp] geometry is needed regardless of quantization."""
    return cache["q"] if isinstance(cache, dict) else cache


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
