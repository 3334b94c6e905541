"""GGUF checkpoint support: parse the container, map llama tensors.

Copy of ``dynamo_tpu/models/gguf.py`` without ``ml_dtypes``, which the
card's machine lacks: tensors are read straight from the ``mmap`` with
``torch.frombuffer`` (F32, F16 and BF16 zero-copy, BF16 as
``torch.bfloat16``), and Q8_0 / Q4_0 GGML blocks dequantize to float32
with the JAX reader's arithmetic (one f32 product of the block's value and
its f16 scale).

Container layout (GGUF v2/v3): magic ``GGUF`` + version, tensor count,
metadata KV section (typed values incl. nested arrays), tensor info table
(name, dims, ggml type, offset), alignment padding, then raw tensor data.
GGML stores dims innermost-first, so an HF ``[out, in]`` matrix appears as
``ne=[in, out]`` with identical row-major bytes.

``load_params_gguf`` gives the port's params dict: leaves rounded to
bfloat16 (round to nearest even, the rounding of JAX's ``ml_dtypes``
cast) whatever the checkpoint stores, then cast to the config's dtype when
that is another (float32: exact); under ``tp > 1`` a rank's shard.
``--quantization int8`` requantizes those leaves afterwards
(models/quant.py), as in the JAX engine. ``save_gguf`` writes the same
subset, byte for byte as the JAX writer.
"""

from __future__ import annotations

import mmap
import struct
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np
import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("gguf")

MAGIC = b"GGUF"

# metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 = range(13)
_SCALAR_FMT = {_U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I",
               _I32: "<i", _F32: "<f", _BOOL: "<?", _U64: "<Q", _I64: "<q",
               _F64: "<d"}

# ggml tensor types we can read losslessly
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q8_0 = 2, 8
GGML_BF16 = 30
_TENSOR_DTYPES: dict[int, torch.dtype] = {
    GGML_F32: torch.float32,
    GGML_F16: torch.float16,
    GGML_BF16: torch.bfloat16,
}
#: bytes of one 32-value block: an f16 scale and 32 int8 / 16 nibble bytes
_BLOCK_BYTES = {GGML_Q8_0: 34, GGML_Q4_0: 18}

ALIGNMENT_KEY = "general.alignment"
DEFAULT_ALIGNMENT = 32


class GGUFReader:
    """mmap-backed reader: metadata dict + zero-copy tensor views."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        with open(self.path, "rb") as f:
            # copy-on-write: tensors view the pages without a copy, and no
            # write through a view can reach the file
            self._mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self._pos = 0
        if self._read(4) != MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (bad magic)")
        self.version = self._scalar("<I")
        if self.version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = self._scalar("<Q")
        n_kv = self._scalar("<Q")
        self.metadata: dict[str, Any] = {}
        for _ in range(n_kv):
            key = self._string()
            self.metadata[key] = self._value(self._scalar("<I"))
        self._tensors: dict[str, tuple[tuple[int, ...], int, int]] = {}
        for _ in range(n_tensors):
            name = self._string()
            n_dims = self._scalar("<I")
            dims = tuple(self._scalar("<Q") for _ in range(n_dims))
            ggml_type = self._scalar("<I")
            offset = self._scalar("<Q")
            self._tensors[name] = (dims, ggml_type, offset)
        align = int(self.metadata.get(ALIGNMENT_KEY, DEFAULT_ALIGNMENT))
        self._data_base = -(-self._pos // align) * align

    # -- low-level parsing --------------------------------------------------
    def _read(self, n: int) -> bytes:
        out = self._mm[self._pos : self._pos + n]
        self._pos += n
        return out

    def _scalar(self, fmt: str):
        (v,) = struct.unpack(fmt, self._read(struct.calcsize(fmt)))
        return v

    def _string(self) -> str:
        n = self._scalar("<Q")
        return self._read(n).decode("utf-8", errors="replace")

    def _value(self, vtype: int):
        if vtype == _STR:
            return self._string()
        if vtype == _ARR:
            etype = self._scalar("<I")
            n = self._scalar("<Q")
            return [self._value(etype) for _ in range(n)]
        fmt = _SCALAR_FMT.get(vtype)
        if fmt is None:
            raise ValueError(f"unknown GGUF metadata value type {vtype}")
        return self._scalar(fmt)

    # -- public surface -----------------------------------------------------
    def names(self) -> list[str]:
        return list(self._tensors)

    def __contains__(self, name: str) -> bool:
        return name in self._tensors

    def tensor(self, name: str) -> torch.Tensor:
        """CPU tensor in numpy convention (outermost dim first). F32/F16/BF16
        are zero-copy views of the file; Q8_0/Q4_0 blocks (32-value groups
        with an f16 scale) dequantize to float32."""
        dims, ggml_type, offset = self._tensors[name]
        count = int(np.prod(dims)) if dims else 1
        shape = tuple(reversed(dims))  # GGML dims are innermost-first
        if ggml_type in _BLOCK_BYTES:
            nblocks = count // 32
            bb = _BLOCK_BYTES[ggml_type]
            raw = torch.frombuffer(self._mm, dtype=torch.uint8, count=nblocks * bb,
                                   offset=self._data_base + offset).view(nblocks, bb)
            scale = raw[:, :2].contiguous().view(torch.float16).float()
            if ggml_type == GGML_Q8_0:
                vals = raw[:, 2:].contiguous().view(torch.int8).float()
            else:  # Q4_0: 16 bytes of nibbles, value = nibble - 8
                nib = raw[:, 2:]
                vals = torch.cat([nib & 0x0F, nib >> 4], dim=1).float() - 8.0
            return (vals * scale).reshape(shape)
        dtype = _TENSOR_DTYPES.get(ggml_type)
        if dtype is None:
            raise ValueError(
                f"tensor {name!r} uses ggml type {ggml_type}; only "
                "F32/F16/BF16/Q8_0/Q4_0 GGUF tensors are supported — "
                "requantize or convert the checkpoint")
        return torch.frombuffer(self._mm, dtype=dtype, count=count,
                                offset=self._data_base + offset).view(shape)

    def architecture(self) -> str:
        return str(self.metadata.get("general.architecture", ""))

    def config(self) -> ModelConfig:
        """llama-family metadata → engine ModelConfig."""
        arch = self.architecture()
        if arch != "llama":
            raise ValueError(f"unsupported GGUF architecture {arch!r}")
        md = self.metadata

        def req(key: str):
            if f"{arch}.{key}" not in md:
                raise ValueError(f"GGUF missing {arch}.{key}")
            return md[f"{arch}.{key}"]

        n_heads = int(req("attention.head_count"))
        emb = int(req("embedding_length"))
        vocab = int(md.get(f"{arch}.vocab_size")
                    or len(md.get("tokenizer.ggml.tokens", []) or [])
                    or self._tensors["token_embd.weight"][0][1])
        return ModelConfig(
            name=self.path.stem,
            vocab_size=vocab,
            hidden_size=emb,
            intermediate_size=int(req("feed_forward_length")),
            num_layers=int(req("block_count")),
            num_heads=n_heads,
            num_kv_heads=int(md.get(f"{arch}.attention.head_count_kv", n_heads)),
            head_dim=int(md.get(f"{arch}.attention.key_length", emb // n_heads)),
            rope_theta=float(md.get(f"{arch}.rope.freq_base", 10000.0)),
            rms_norm_eps=float(md.get(
                f"{arch}.attention.layer_norm_rms_epsilon", 1e-5)),
            max_position_embeddings=int(md.get(f"{arch}.context_length", 8192)),
            tie_word_embeddings="output.weight" not in self._tensors,
        )


def permute_qk(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """HF half-rotate layout → GGUF interleaved-rope layout for attn_q/attn_k
    rows (llama.cpp convert_hf_to_gguf permute): per head, rows reorder from
    [evens, odds] halves to interleaved pairs. ``w`` is [out, in]."""
    out, inn = w.shape
    return (w.reshape(n_heads, 2, out // n_heads // 2, inn)
             .transpose(1, 2).reshape(out, inn))


def unpermute_qk(w: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Inverse of :func:`permute_qk`: GGUF checkpoints store Q/K in the
    interleaved-rope layout; the engine applies HF half-rotate rope, so
    loads restore the HF row order."""
    out, inn = w.shape
    return (w.reshape(n_heads, out // n_heads // 2, 2, inn)
             .transpose(1, 2).reshape(out, inn))


# llama.cpp tensor names → (our layer param, transpose-to-[in,out])
_LAYER_SPECS = {
    "wq": ("attn_q.weight", True),
    "wk": ("attn_k.weight", True),
    "wv": ("attn_v.weight", True),
    "wo": ("attn_output.weight", True),
    "attn_norm": ("attn_norm.weight", False),
    "mlp_norm": ("ffn_norm.weight", False),
    "w_gate": ("ffn_gate.weight", True),
    "w_up": ("ffn_up.weight", True),
    "w_down": ("ffn_down.weight", True),
}


def load_params_gguf(path: str | Path, device: str | torch.device | None = None,
                     rank: int = 0, tp: int = 1, dtype: str | None = None,
                     stage: int = 0, pp: int = 1) -> tuple[ModelConfig, dict]:
    """Read a llama-family GGUF into (config, the port's params dict) on
    ``device`` (default: the CUDA card): leaves rounded to bfloat16, then
    cast to ``dtype`` (default: the config's); with ``tp > 1`` rank
    ``rank``'s shard, with ``pp > 1`` stage ``stage``'s layers only (and
    no ``embed``, ``final_norm`` or ``lm_head`` past the first stage)."""
    from dynamo_tpu_torch.parallel.mesh import shard_params, stage_layers
    from dynamo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    reader = GGUFReader(path)
    cfg = reader.config()
    out_dtype = getattr(torch, dtype or cfg.dtype)

    def leaf(t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).to(out_dtype).contiguous()

    params: dict = {"layers": {}}
    if stage == 0:
        params["embed"] = leaf(reader.tensor("token_embd.weight"))
        params["final_norm"] = leaf(reader.tensor("output_norm.weight"))
        if not cfg.tie_word_embeddings:
            params["lm_head"] = leaf(reader.tensor("output.weight").T)
    l_lo, l_hi = stage_layers(cfg, stage, pp)
    unperm = {"wq": cfg.num_heads, "wk": cfg.num_kv_heads}
    for our, (suffix, transpose) in _LAYER_SPECS.items():
        def grab(i: int) -> torch.Tensor:
            t = reader.tensor(f"blk.{i}.{suffix}")
            if our in unperm:
                t = unpermute_qk(t, unperm[our])
            return leaf(t.T if transpose else t)

        first = grab(l_lo)
        out = torch.empty((l_hi - l_lo, *first.shape), dtype=out_dtype)
        out[0] = first
        for i in range(l_lo + 1, l_hi):
            out[i - l_lo] = grab(i)
        params["layers"][our] = out
    params = shard_params(params, cfg, rank, tp)

    def place(p):
        return {k: place(v) for k, v in p.items()} if isinstance(p, dict) else p.to(dev)

    params = place(params)
    log.info("loaded GGUF %s: %s (%d layers, vocab %d)",
             path, cfg.name, cfg.num_layers, cfg.vocab_size)
    return cfg, params


# ---------------------------------------------------------------------------
# Writer (tests, chip_smoke and re-export tooling)
# ---------------------------------------------------------------------------

def _w_string(f: BinaryIO, s: str) -> None:
    b = s.encode()
    f.write(struct.pack("<Q", len(b)) + b)


def _w_value(f: BinaryIO, v: Any) -> None:
    if isinstance(v, bool):
        f.write(struct.pack("<I", _BOOL) + struct.pack("<?", v))
    elif isinstance(v, int):
        f.write(struct.pack("<I", _U64) + struct.pack("<Q", v))
    elif isinstance(v, float):
        f.write(struct.pack("<I", _F32) + struct.pack("<f", v))
    elif isinstance(v, str):
        f.write(struct.pack("<I", _STR))
        _w_string(f, v)
    elif isinstance(v, list):
        f.write(struct.pack("<I", _ARR))
        f.write(struct.pack("<I", _STR) + struct.pack("<Q", len(v)))
        for item in v:
            _w_string(f, str(item))
    else:
        raise TypeError(f"unsupported metadata value {type(v)}")


def _encoded(arr: Any) -> tuple[tuple[int, ...], int, memoryview]:
    """(numpy-convention shape, ggml type, raw bytes) of a tensor value."""
    if isinstance(arr, tuple):
        shape, gtype, blob = arr
        return tuple(shape), gtype, memoryview(blob).cast("B")
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        gtype = {v: k for k, v in _TENSOR_DTYPES.items()}.get(t.dtype)
        if gtype is None:
            raise TypeError(f"unsupported tensor dtype {t.dtype}")
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return tuple(t.shape), gtype, memoryview(bits.numpy()).cast("B")
    a = np.ascontiguousarray(arr)
    if a.dtype.name == "bfloat16":   # an ml_dtypes array: its bits
        return a.shape, GGML_BF16, memoryview(a.view(np.uint16)).cast("B")
    gtype = {np.dtype(np.float32): GGML_F32, np.dtype(np.float16): GGML_F16}.get(a.dtype)
    if gtype is None:
        raise TypeError(f"unsupported array dtype {a.dtype}")
    return a.shape, gtype, memoryview(a).cast("B")


def save_gguf(path: str | Path, metadata: dict[str, Any],
              tensors: dict[str, Any]) -> None:
    """Write a GGUF v3 file. Values are torch tensors or numpy arrays
    (F32/F16/BF16) or pre-encoded quantized tensors as ``(numpy_shape,
    ggml_type, raw_bytes)`` tuples (e.g. Q8_0 blocks). The bytes equal the
    JAX writer's for the same inputs; each blob is written from its own
    buffer, never gathered into one."""
    encoded = {name: _encoded(arr) for name, arr in tensors.items()}
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<Q", len(tensors)))
        f.write(struct.pack("<Q", len(metadata)))
        for k, v in metadata.items():
            _w_string(f, k)
            _w_value(f, v)
        offset = 0
        for name, (shape, gtype, blob) in encoded.items():
            _w_string(f, name)
            dims = tuple(reversed(shape))  # ggml: innermost first
            f.write(struct.pack("<I", len(dims)))
            for d in dims:
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<I", gtype))
            f.write(struct.pack("<Q", offset))
            offset += blob.nbytes + (-blob.nbytes) % DEFAULT_ALIGNMENT
        f.write(b"\0" * ((-f.tell()) % DEFAULT_ALIGNMENT))
        for _shape, _gtype, blob in encoded.values():
            f.write(blob)
            f.write(b"\0" * ((-blob.nbytes) % DEFAULT_ALIGNMENT))
