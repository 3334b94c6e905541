"""Model architecture configs — copy of ``dynamo_tpu/models/config.py``.

One dataclass covers the dense Llama family, MoE shapes and the tiny
CPU-testable presets; a ``.gguf`` file's config is read from its metadata
(models/gguf.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class ModelConfig:
    name: str = "tiny-llama"
    vocab_size: int = 512
    hidden_size: int = 64
    intermediate_size: int = 128
    num_layers: int = 2
    num_heads: int = 4
    num_kv_heads: int = 2
    head_dim: int = 16
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = True
    dtype: str = "bfloat16"
    # MoE (0 experts = dense)
    num_experts: int = 0
    num_experts_per_tok: int = 0
    moe_intermediate_size: int = 0
    num_shared_experts: int = 0

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @classmethod
    def from_hf_config(cls, path: str) -> "ModelConfig":
        """Read a local HF config.json (llama-family keys)."""
        cfg = json.loads((Path(path) / "config.json").read_text())
        n_heads = cfg["num_attention_heads"]
        # MoE keys across HF families: mixtral (num_local_experts),
        # deepseek/qwen-moe (n_routed_experts, num_experts).
        n_experts = (cfg.get("num_local_experts") or cfg.get("n_routed_experts")
                     or cfg.get("num_experts") or 0)
        return cls(
            num_experts=n_experts,
            num_experts_per_tok=cfg.get("num_experts_per_tok", 2 if n_experts else 0),
            moe_intermediate_size=cfg.get(
                "moe_intermediate_size",
                cfg["intermediate_size"] if n_experts else 0),
            num_shared_experts=cfg.get("n_shared_experts", 0) or 0,
            name=cfg.get("_name_or_path", Path(path).name),
            vocab_size=cfg["vocab_size"],
            hidden_size=cfg["hidden_size"],
            intermediate_size=cfg["intermediate_size"],
            num_layers=cfg["num_hidden_layers"],
            num_heads=n_heads,
            num_kv_heads=cfg.get("num_key_value_heads", n_heads),
            head_dim=cfg.get("head_dim", cfg["hidden_size"] // n_heads),
            rope_theta=cfg.get("rope_theta", 10000.0),
            rms_norm_eps=cfg.get("rms_norm_eps", 1e-5),
            max_position_embeddings=cfg.get("max_position_embeddings", 8192),
            tie_word_embeddings=cfg.get("tie_word_embeddings", False),
        )


MODEL_PRESETS: dict[str, ModelConfig] = {
    # CPU-testable tiny models.
    "tiny-llama": ModelConfig(),
    "tiny-llama-big-vocab": ModelConfig(name="tiny-llama-big-vocab", vocab_size=32000),
    "tiny-moe": ModelConfig(
        name="tiny-moe",
        num_experts=8,
        num_experts_per_tok=2,
        moe_intermediate_size=64,
        num_shared_experts=1,
    ),
    # Real targets (shapes only; weights load from local checkpoints).
    "llama-3-8b": ModelConfig(
        name="llama-3-8b",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=32,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=500000.0,
        max_position_embeddings=8192,
        tie_word_embeddings=False,
    ),
    # 8-layer cut of llama-3-8b: real layer shapes at full width, random
    # weights — the port's chip smoke serves it on one H100.
    "llama-3-8b-lite": ModelConfig(
        name="llama-3-8b-lite",
        vocab_size=128256,
        hidden_size=4096,
        intermediate_size=14336,
        num_layers=8,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=500000.0,
        max_position_embeddings=8192,
        tie_word_embeddings=True,
    ),
    "llama-3-70b": ModelConfig(
        name="llama-3-70b",
        vocab_size=128256,
        hidden_size=8192,
        intermediate_size=28672,
        num_layers=80,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        rope_theta=500000.0,
        max_position_embeddings=8192,
        tie_word_embeddings=False,
    ),
    "deepseek-moe": ModelConfig(
        name="deepseek-moe",
        vocab_size=129280,
        hidden_size=7168,
        intermediate_size=18432,
        num_layers=61,
        num_heads=128,
        num_kv_heads=8,
        head_dim=128,
        num_experts=256,
        num_experts_per_tok=8,
        moe_intermediate_size=2048,
        num_shared_experts=1,
    ),
    "gpt-oss-120b": ModelConfig(
        name="gpt-oss-120b",
        vocab_size=201088,
        hidden_size=2880,
        intermediate_size=2880,
        num_layers=36,
        num_heads=64,
        num_kv_heads=8,
        head_dim=64,
        num_experts=128,
        num_experts_per_tok=4,
        moe_intermediate_size=2880,
    ),
}


def resolve_model_config(name_or_path: str) -> ModelConfig:
    if name_or_path in MODEL_PRESETS:
        return MODEL_PRESETS[name_or_path]
    p = Path(name_or_path)
    if p.is_file() and p.suffix == ".gguf":
        from dynamo_tpu_torch.models.gguf import GGUFReader

        return GGUFReader(p).config()
    if p.is_dir() and (p / "config.json").exists():
        return ModelConfig.from_hf_config(name_or_path)
    raise ValueError(f"unknown model: {name_or_path!r} (presets: {sorted(MODEL_PRESETS)})")
