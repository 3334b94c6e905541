"""Checkpoint loading: HF safetensors → the port's params dict, and the
weight bridge from the JAX package's params.

Port of ``dynamo_tpu/models/loader.py`` without ``ml_dtypes`` (absent on
the card's machine): the safetensors container is parsed directly (8-byte
header length + JSON header + raw little-endian data) over ``mmap``, and
bf16 tensors are read as ``uint16`` and viewed as ``torch.bfloat16``.

HF llama-family names map onto the same stacked-layer layout as the JAX
package (``{"embed", "final_norm", ["lm_head"], "layers": {name: [L, ...]}}``),
with projections transposed from HF's ``[out, in]`` to ``[in, out]``.
MoE checkpoints of both families the JAX loader reads (mixtral's
``block_sparse_moe``, deepseek/qwen-moe's ``mlp.experts`` and
``shared_experts``) stack their routed experts into ``[L, E, in, out]``.
"""

from __future__ import annotations

import json
import mmap
from pathlib import Path
from typing import Any, Iterator

import numpy as np
import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.parallel.mesh import pad_dim, rank_logical_axes, shard_bounds
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

    def tensor(self, name: str, index: tuple[slice, ...] = ()) -> torch.Tensor:
        """The tensor ``name``, or only its ``index`` slice of the stored
        layout (only those bytes are copied out of the mapped file)."""
        meta = self.header[name]
        np_dt, dt = _ST_DTYPES[meta["dtype"]]
        shape = meta["shape"]
        start, _end = meta["data_offsets"]
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(self._mm, dtype=np_dt, count=count,
                            offset=self._base + start).reshape(shape)
        return _to_tensor(arr[index], dt)


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

    def shape(self, name: str) -> list[int]:
        return self._file(self._where[name]).header[name]["shape"]

    def get(self, name: str, index: tuple[slice, ...] = ()) -> torch.Tensor:
        return self._file(self._where[name]).tensor(name, index)


def has_weights(model_dir: str | Path) -> bool:
    p = Path(model_dir)
    return p.is_dir() and (
        (p / "model.safetensors.index.json").exists()
        or any(p.glob("*.safetensors"))
    )


# ---------------------------------------------------------------------------
# HF llama-family name mapping
# ---------------------------------------------------------------------------

def _layer_specs(cfg: ModelConfig, family: str) -> dict[str, tuple[str, bool]]:
    """Our layer param name → (HF suffix under ``model.layers.{i}.``,
    transpose). Transpose: HF stores linear weights as [out, in]; the port
    computes ``x @ W`` with W as [in, out]."""
    specs = {
        "wq": ("self_attn.q_proj.weight", True),
        "wk": ("self_attn.k_proj.weight", True),
        "wv": ("self_attn.v_proj.weight", True),
        "wo": ("self_attn.o_proj.weight", True),
        "attn_norm": ("input_layernorm.weight", False),
        "mlp_norm": ("post_attention_layernorm.weight", False),
    }
    if cfg.is_moe:
        router = ("block_sparse_moe.gate.weight" if family == "mixtral"
                  else "mlp.gate.weight")
        specs["router"] = (router, True)
        if cfg.num_shared_experts:
            specs.update(
                shared_gate=("mlp.shared_experts.gate_proj.weight", True),
                shared_up=("mlp.shared_experts.up_proj.weight", True),
                shared_down=("mlp.shared_experts.down_proj.weight", True),
            )
    else:
        specs.update(
            w_gate=("mlp.gate_proj.weight", True),
            w_up=("mlp.up_proj.weight", True),
            w_down=("mlp.down_proj.weight", True),
        )
    return specs


def _moe_family(reader: CheckpointReader, cfg: ModelConfig) -> str:
    """The MoE naming family of the checkpoint's tensors: mixtral
    (``block_sparse_moe.experts.N.w1/w2/w3``, no shared experts) or
    deepseek/qwen-moe (``mlp.experts.N.gate_proj/up_proj/down_proj``, and
    ``mlp.shared_experts`` where the config has them)."""
    if "model.layers.0.block_sparse_moe.gate.weight" in reader:
        if cfg.num_shared_experts:
            raise ValueError(
                "config declares shared experts but checkpoint uses "
                "mixtral-style names, which have none")
        return "mixtral"
    if "model.layers.0.mlp.gate.weight" in reader:
        return "deepseek"
    raise ValueError(
        "MoE config but no recognized MoE router tensor in checkpoint "
        "(looked for block_sparse_moe.gate / mlp.gate)")


def _expert_specs(family: str) -> dict[str, str]:
    """Routed-expert weights: our name → HF suffix pattern (mixtral: w1 =
    gate, w3 = up, w2 = down)."""
    if family == "mixtral":
        return {
            "w_gate": "block_sparse_moe.experts.{e}.w1.weight",
            "w_up": "block_sparse_moe.experts.{e}.w3.weight",
            "w_down": "block_sparse_moe.experts.{e}.w2.weight",
        }
    return {
        "w_gate": "mlp.experts.{e}.gate_proj.weight",
        "w_up": "mlp.experts.{e}.up_proj.weight",
        "w_down": "mlp.experts.{e}.down_proj.weight",
    }


def iter_param_leaves(cfg: ModelConfig, reader: CheckpointReader, dtype: torch.dtype,
                      rank: int = 0, tp: int = 1, expert: int = 0, ep: int = 1
                      ) -> Iterator[tuple[tuple[str, ...], torch.Tensor]]:
    """Yield ((path), stacked CPU tensor) for every model parameter; layer
    params are stacked into [L, ...] one layer at a time, an MoE model's
    routed experts into [L, E, ...] one expert at a time. With ``tp`` or
    ``ep`` > 1 each leaf is the shard of the rank at (model ``rank``,
    expert ``expert``) (parallel/mesh.py): only that rank's experts are
    read, and only its slice of each checkpoint tensor."""
    axes = rank_logical_axes(cfg)
    family = _moe_family(reader, cfg) if cfg.is_moe else "llama"

    def grab(name: str, transpose: bool, leaf_axes: tuple) -> torch.Tensor:
        if name not in reader:
            raise KeyError(f"checkpoint is missing tensor {name!r} (family={family}); "
                           "config/checkpoint mismatch?")
        # the shard's bounds on our [in, out] layout, read from HF's [out, in]
        stored = reader.shape(name)
        ours = stored[::-1] if transpose else stored
        bounds = [shard_bounds(n, ax, rank, tp, expert, ep) for n, ax in zip(ours, leaf_axes)]
        index = tuple(slice(lo, hi) for lo, hi, _ in bounds)
        t = reader.get(name, index[::-1] if transpose else index)
        t = t.T if transpose else t
        for dim, (_lo, _hi, per) in enumerate(bounds):
            t = pad_dim(t, dim, per)
        return t.to(dtype).contiguous()

    def stack(names: list[str], lead: tuple[int, ...], transpose: bool,
              leaf_axes: tuple) -> torch.Tensor:
        """The tensors ``names`` stacked into a ``[*lead, ...]`` tensor
        allocated up front and filled a tensor at a time."""
        first = grab(names[0], transpose, leaf_axes)
        out = torch.empty((len(names), *first.shape), dtype=dtype)
        out[0] = first
        for i, name in enumerate(names[1:], 1):
            out[i] = grab(name, transpose, leaf_axes)
        return out.view(*lead, *first.shape)

    yield ("embed",), grab("model.embed_tokens.weight", False, axes["embed"])
    yield ("final_norm",), grab("model.norm.weight", False, axes["final_norm"])
    if not cfg.tie_word_embeddings:
        yield ("lm_head",), grab("lm_head.weight", True, axes["lm_head"])
    L, E = cfg.num_layers, cfg.num_experts
    for our, (suffix, transpose) in _layer_specs(cfg, family).items():
        names = [f"model.layers.{i}.{suffix}" for i in range(L)]
        yield ("layers", our), stack(names, (L,), transpose, axes["layers"][our][1:])
    if cfg.is_moe:
        lo, hi, per = shard_bounds(E, "expert", rank, tp, expert, ep)
        for our, pattern in _expert_specs(family).items():
            names = [f"model.layers.{i}.{pattern.format(e=e)}"
                     for i in range(L) for e in range(lo, hi)]
            yield ("layers", our), stack(names, (L, per), True, axes["layers"][our][2:])


def load_params(cfg: ModelConfig, model_dir: str | Path,
                device: str | torch.device | None = None, rank: int = 0,
                tp: int = 1, expert: int = 0, ep: int = 1) -> Params:
    """Load an HF llama-family checkpoint into the port's params dict, at
    ``cfg.dtype``, on ``device`` (default: the CUDA card): with ``tp`` or
    ``ep`` > 1 the shard of the rank at (``rank``, ``expert``), reading
    only its slice of each tensor."""
    dev = resolve_device(device)
    reader = CheckpointReader(model_dir)
    params: Params = {}
    n_bytes = 0
    for path, t in iter_param_leaves(cfg, reader, getattr(torch, cfg.dtype), rank, tp,
                                     expert, ep):
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
    np.asarray, params)``), → the port's dict of tensors, bit for bit (a
    full tree: ``parallel.mesh.shard_params`` cuts a rank's shard of it).
    MoE leaves and int8 leaves (``{"q", "so"|"sr"}``, models/quant.py)
    carry over as they are: nested dicts, int8 and f32 arrays.

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
