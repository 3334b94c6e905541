"""Checkpoint loading: HF safetensors → the port's params dict, and the
weight bridge from the JAX package's params.

Port of ``dynamo_tpu/models/loader.py`` without ``ml_dtypes`` (absent on
the card's machine): the safetensors container is parsed directly (8-byte
header length + JSON header + raw little-endian data) over ``mmap``, and
bf16 tensors are read as ``uint16`` and viewed as ``torch.bfloat16``.

HF llama-family names map onto the same stacked-layer layout as the JAX
package (``{"embed", "final_norm", ["lm_head"], "layers": {name: [L, ...]}}``),
with projections transposed from HF's ``[out, in]`` to ``[in, out]``.
MoE checkpoints are not ported yet.
"""

from __future__ import annotations

import json
import mmap
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.utils.device import resolve_device
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("loader")

Params = dict[str, Any]

# Safetensors dtype code → (numpy storage dtype, torch dtype). BF16 is
# stored as uint16 in numpy and viewed as bfloat16 once it is a tensor.
_ST_DTYPES: dict[str, tuple[np.dtype, torch.dtype]] = {
    "F64": (np.dtype(np.float64), torch.float64),
    "F32": (np.dtype(np.float32), torch.float32),
    "F16": (np.dtype(np.float16), torch.float16),
    "BF16": (np.dtype(np.uint16), torch.bfloat16),
    "I64": (np.dtype(np.int64), torch.int64),
    "I32": (np.dtype(np.int32), torch.int32),
    "I16": (np.dtype(np.int16), torch.int16),
    "I8": (np.dtype(np.int8), torch.int8),
    "U8": (np.dtype(np.uint8), torch.uint8),
    "BOOL": (np.dtype(np.bool_), torch.bool),
}


def _to_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """numpy array → CPU tensor of ``dtype`` (a copy: mmap'd and JAX-owned
    arrays are read-only); uint16 storage is viewed as bfloat16 bits
    (``torch.from_numpy`` has no bfloat16)."""
    t = torch.from_numpy(np.array(arr, copy=True, order="C"))
    return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


class SafetensorsFile:
    """Reader for one .safetensors file (mmap-backed)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        header_len = int.from_bytes(self._mm[:8], "little")
        self.header: dict[str, Any] = json.loads(self._mm[8 : 8 + header_len])
        self.header.pop("__metadata__", None)
        self._base = 8 + header_len

    def names(self) -> list[str]:
        return list(self.header)

    def tensor(self, name: str) -> torch.Tensor:
        meta = self.header[name]
        np_dt, dt = _ST_DTYPES[meta["dtype"]]
        shape = meta["shape"]
        start, _end = meta["data_offsets"]
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(self._mm, dtype=np_dt, count=count,
                            offset=self._base + start).reshape(shape)
        return _to_tensor(arr, dt)


class CheckpointReader:
    """Name→tensor access across a sharded checkpoint directory.

    Resolves ``model.safetensors.index.json`` (weight_map) when present,
    else unions all ``*.safetensors`` files in the directory."""

    def __init__(self, model_dir: str | Path):
        self.dir = Path(model_dir)
        self._files: dict[str, SafetensorsFile] = {}
        self._where: dict[str, str] = {}
        index = self.dir / "model.safetensors.index.json"
        if index.exists():
            weight_map = json.loads(index.read_text())["weight_map"]
            for name, fname in weight_map.items():
                self._where[name] = fname
        else:
            for p in sorted(self.dir.glob("*.safetensors")):
                for name in self._file(p.name).names():
                    self._where[name] = p.name
        if not self._where:
            raise FileNotFoundError(f"no safetensors weights under {self.dir}")

    def _file(self, fname: str) -> SafetensorsFile:
        if fname not in self._files:
            self._files[fname] = SafetensorsFile(self.dir / fname)
        return self._files[fname]

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def names(self) -> list[str]:
        return list(self._where)

    def get(self, name: str) -> torch.Tensor:
        return self._file(self._where[name]).tensor(name)


def has_weights(model_dir: str | Path) -> bool:
    p = Path(model_dir)
    return p.is_dir() and (
        (p / "model.safetensors.index.json").exists()
        or any(p.glob("*.safetensors"))
    )


# ---------------------------------------------------------------------------
# HF llama-family name mapping
# ---------------------------------------------------------------------------

#: our layer param name → (HF suffix under model.layers.{i}., transpose).
#: Transpose: HF stores linear weights as [out, in]; the port computes
#: ``x @ W`` with W as [in, out].
_LAYER_SPECS: dict[str, tuple[str, bool]] = {
    "wq": ("self_attn.q_proj.weight", True),
    "wk": ("self_attn.k_proj.weight", True),
    "wv": ("self_attn.v_proj.weight", True),
    "wo": ("self_attn.o_proj.weight", True),
    "attn_norm": ("input_layernorm.weight", False),
    "mlp_norm": ("post_attention_layernorm.weight", False),
    "w_gate": ("mlp.gate_proj.weight", True),
    "w_up": ("mlp.up_proj.weight", True),
    "w_down": ("mlp.down_proj.weight", True),
}


def iter_param_leaves(cfg: ModelConfig, reader: CheckpointReader,
                      dtype: torch.dtype) -> Iterator[tuple[tuple[str, ...], torch.Tensor]]:
    """Yield ((path), stacked CPU tensor) for every model parameter; layer
    params are stacked into [L, ...] one layer at a time."""
    if cfg.is_moe:
        raise NotImplementedError(
            "MoE checkpoints are not ported yet (ROADMAP: MoE slice)")

    def grab(name: str, transpose: bool) -> torch.Tensor:
        if name not in reader:
            raise KeyError(f"checkpoint is missing tensor {name!r}; "
                           "config/checkpoint mismatch?")
        t = reader.get(name)
        return (t.T if transpose else t).to(dtype).contiguous()

    yield ("embed",), grab("model.embed_tokens.weight", False)
    yield ("final_norm",), grab("model.norm.weight", False)
    if not cfg.tie_word_embeddings:
        yield ("lm_head",), grab("lm_head.weight", True)
    for our, (suffix, transpose) in _LAYER_SPECS.items():
        first = grab(f"model.layers.0.{suffix}", transpose)
        out = torch.empty((cfg.num_layers, *first.shape), dtype=dtype)
        out[0] = first
        for i in range(1, cfg.num_layers):
            out[i] = grab(f"model.layers.{i}.{suffix}", transpose)
        yield ("layers", our), out


def load_params(cfg: ModelConfig, model_dir: str | Path,
                device: str | torch.device | None = None) -> Params:
    """Load an HF llama-family checkpoint into the port's params dict, at
    ``cfg.dtype``, on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    reader = CheckpointReader(model_dir)
    params: Params = {}
    n_bytes = 0
    for path, t in iter_param_leaves(cfg, reader, getattr(torch, cfg.dtype)):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.to(dev)
        n_bytes += t.numel() * t.element_size()
    log.info("loaded %s: %.2f GiB of weights from %s",
             cfg.name, n_bytes / 2**30, model_dir)
    return params


# ---------------------------------------------------------------------------
# Weight bridge from the JAX package
# ---------------------------------------------------------------------------

def from_jax_params(params_np: Params, device: str | torch.device | None = None) -> Params:
    """The JAX package's params pytree, as numpy arrays (``jax.tree.map(
    np.asarray, params)``), → the port's dict of tensors, bit for bit.

    ml_dtypes bfloat16 arrays travel as their ``uint16`` bits, because
    ``torch.from_numpy`` rejects them; the bits are viewed back as
    ``torch.bfloat16``."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return _to_tensor(a.view(np.uint16), torch.bfloat16).to(dev)
        return _to_tensor(a, None).to(dev)

    return conv(params_np)
