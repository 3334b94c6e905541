"""Device↔host KV block movement — port of ``dynamo_tpu/kvbm/transfer.py``.

Host-side block formats, the JAX package's byte for byte:

* float caches: one ``np.ndarray`` of shape
  ``[2, layers, block_size, kv_heads, head_dim]`` (index 0 = K, 1 = V).
  A bf16 block is kept as its uint16 bit patterns (numpy has no bfloat16):
  the same bytes as the JAX package's ``ml_dtypes.bfloat16`` block, which
  :func:`host_bits` reads as such. f32 → bf16 on the host rounds to
  nearest even, NaN to the quiet NaN of its sign, as ``ml_dtypes`` does.
* quantized caches: one FLAT ``uint8`` array of ``spec.bytes_per_block()``
  bytes — the payload ``[2, L, BS, KH, Dp]`` followed by the float32 scales
  ``[2, L, KH]`` (``pack_kv_block``/``unpack_kv_block``). Dp is head_dim
  for int8 and head_dim/2 for packed int4 (ops/paged_attention's
  split-half nibbles); the two kinds are told apart by byte length alone.

:class:`BlockTransferEngine` moves blocks between those host formats and
the engine's cache tensors; :class:`TPTransferEngine` does the same for
the leader of a tensor-parallel engine, whose ranks each hold some kv
heads. ``extract`` gathers the blocks on the device into one contiguous
tensor in the host layout and copies it off in one transfer. ``inject``
writes IN PLACE (``index_copy_`` on the block axis, scales included): the
engine's step programs (CUDA graphs on the card) read the cache tensors as
static inputs, so the cache is never rebound.
Format conversion happens at the inject boundary as in the JAX package:
float blocks into a quantized cache are quantized on the device
(:func:`quantize_lnh`: true division by the scale, round half to even, the
bytes of :func:`quantize_block`), a packed block of the other quantized
kind or into a float cache is dequantized on the host first.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dynamo_tpu_torch.engine.cache import cache_payload
from dynamo_tpu_torch.ops.paged_attention import INT4_QMAX, pack_int4, unpack_int4

#: divide-guard for quantization scales (matches models/llama._KV_SCALE_EPS)
_EPS = 1e-8

#: host element type of a float block, by the spec's dtype name (bf16 as bits)
HOST_FLOAT = {"float32": np.float32, "bfloat16": np.uint16, "float16": np.float16}


def f32_to_bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 → bfloat16 bit patterns (uint16), round to nearest even; a
    NaN becomes the quiet NaN of its sign (``ml_dtypes``' conversion)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = ((bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & np.uint32(1)))
               >> np.uint32(16)).astype(np.uint16)
    nan = np.isnan(x)
    if nan.any():
        sign = ((bits >> np.uint32(16)) & np.uint32(0x8000)).astype(np.uint16)
        rounded = np.where(nan, sign | np.uint16(0x7FC0), rounded)
    return rounded


def bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) → float32, exact."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << np.uint32(16)).view(np.float32)


def host_bits(block: np.ndarray) -> np.ndarray:
    """A host block in the port's representation: a numpy dtype named
    bfloat16 (the JAX package's ``ml_dtypes`` blocks) reads as its uint16
    bits; anything else is returned as is."""
    if block.dtype.name == "bfloat16":
        return block.view(np.uint16)
    return block


def block_to_f32(block: np.ndarray) -> np.ndarray:
    """A float host block's values as float32 (uint16 = bf16 bits)."""
    block = host_bits(block)
    if block.dtype == np.uint16:
        return bf16_bits_to_f32(block)
    return block.astype(np.float32)


def f32_to_host(x: np.ndarray, dtype: str) -> np.ndarray:
    """float32 values → the host format of a ``dtype`` ("float32",
    "bfloat16", "float16") cache."""
    if dtype == "bfloat16":
        return f32_to_bf16_bits(x)
    return np.asarray(x, np.float32).astype(HOST_FLOAT[dtype])


def _np_pack_int4(vals: np.ndarray) -> np.ndarray:
    """Host-side mirror of ops.paged_attention.pack_int4 (same split-half
    nibble convention): int values in [-8, 7], even trailing dim → uint8
    with trailing dim halved."""
    d = vals.shape[-1]
    if d % 2:
        raise ValueError(f"int4 packing needs an even trailing dim, got {d}")
    w = vals.astype(np.int32)
    lo = w[..., : d // 2] & 0xF
    hi = w[..., d // 2:] & 0xF
    return (lo | (hi << 4)).astype(np.uint8)


def _np_unpack_int4(packed: np.ndarray) -> np.ndarray:
    """Host-side mirror of ops.paged_attention.unpack_int4: uint8 nibble
    pairs → int32 values in [-8, 7] with trailing dim doubled."""
    w = packed.astype(np.int32)
    lo = w & 0xF
    hi = (w >> 4) & 0xF
    lo = lo - ((lo & 0x8) << 1)
    hi = hi - ((hi & 0x8) << 1)
    return np.concatenate([lo, hi], axis=-1)


# -- host-side block (de)packing ---------------------------------------------

def pack_kv_block(kq: np.ndarray, ks: np.ndarray,
                  vq: np.ndarray, vs: np.ndarray) -> np.ndarray:
    """(payload [L,BS,KH,Dp] int8|uint8 + scales [L,KH] f32) × k,v → flat
    uint8. A uint8 payload (packed int4 nibbles) is kept byte for byte, so
    the flat block's length encodes its kind."""
    payload = np.stack([kq, vq])
    if payload.dtype != np.uint8:
        payload = payload.astype(np.int8)
    payload = np.ascontiguousarray(payload)
    scales = np.ascontiguousarray(np.stack([ks, vs]).astype(np.float32))
    return np.concatenate([payload.reshape(-1).view(np.uint8),
                           scales.reshape(-1).view(np.uint8)])


def unpack_kv_block(flat: np.ndarray, shape: tuple[int, int, int, int],
                    payload_dtype=np.int8) -> tuple[np.ndarray, np.ndarray]:
    """flat uint8 → (payload [2,L,BS,KH,Dp], scales [2,L,KH] f32). ``shape``
    is the PAYLOAD shape (trailing dim head_dim/2 for packed int4)."""
    L, BS, KH, Dp = shape
    split = 2 * L * BS * KH * Dp
    payload = flat[:split].view(payload_dtype).reshape(2, L, BS, KH, Dp)
    scales = flat[split:].view(np.float32).reshape(2, L, KH)
    return payload, scales


def _packed_kind(flat: np.ndarray, shape: tuple[int, int, int, int]) -> str:
    """Which quantization a flat block holds, from its byte length alone.
    ``shape`` is the LOGICAL [L, BS, KH, D] block shape (full head_dim)."""
    L, BS, KH, D = shape
    scales = 2 * L * KH * 4
    if flat.size == 2 * L * BS * KH * D + scales:
        return "int8"
    if flat.size == L * BS * KH * D + scales:
        return "int4"
    raise ValueError(
        f"packed block of {flat.size} bytes matches neither int8 nor int4 "
        f"for logical shape {shape}")


def quantize_block(block: np.ndarray, kv_dtype: str = "int8") -> np.ndarray:
    """Float host block [2, L, BS, KH, D] → packed flat uint8 (int8 bytes
    or int4 nibble pairs per ``kv_dtype``)."""
    qmax = INT4_QMAX if kv_dtype == "int4" else 127.0
    x = block_to_f32(block)
    amax = np.abs(x).max(axis=(2, 4))                       # [2, L, KH]
    s = np.maximum(amax / qmax, _EPS).astype(np.float32)
    q = np.clip(np.round(x / s[:, :, None, :, None]), -qmax, qmax)
    q = _np_pack_int4(q) if kv_dtype == "int4" else q.astype(np.int8)
    return pack_kv_block(q[0], s[0], q[1], s[1])


def dequantize_block(flat: np.ndarray, shape: tuple[int, int, int, int],
                     dtype: str) -> np.ndarray:
    """Packed flat uint8 (either kind) → float host block [2, L, BS, KH, D]
    in the host format of ``dtype`` (a cache dtype name). ``shape`` is the
    logical block shape (full head_dim)."""
    L, BS, KH, D = shape
    if _packed_kind(flat, shape) == "int4":
        packed, scales = unpack_kv_block(flat, (L, BS, KH, D // 2), np.uint8)
        payload = _np_unpack_int4(packed)
    else:
        payload, scales = unpack_kv_block(flat, shape)
    out = payload.astype(np.float32) * scales[:, :, None, :, None]
    return np.ascontiguousarray(f32_to_host(out, dtype))


def _is_packed(block: np.ndarray) -> bool:
    return block.ndim == 1 and block.dtype == np.uint8


def ensure_block_format(block: np.ndarray, spec) -> np.ndarray:
    """Convert a host block to ``spec``'s native format (mixed-precision
    import boundary): packed uint8 of ``spec.kv_dtype``'s kind for
    quantized specs, a float block in the host format of ``spec.dtype``
    otherwise. No-op when it already matches; a packed block of the OTHER
    quantized kind round-trips through float on the host."""
    block = host_bits(block)
    shape = (spec.num_layers, spec.block_size, spec.num_kv_heads, spec.head_dim)
    if spec.quantized:
        if not _is_packed(block):
            return quantize_block(block, spec.kv_dtype)
        want = "int4" if spec.packed_int4 else "int8"
        if _packed_kind(block, shape) == want:
            return block
        return quantize_block(dequantize_block(block, shape, "float32"), spec.kv_dtype)
    if _is_packed(block):
        return dequantize_block(block, shape, spec.dtype)
    if block.dtype != HOST_FLOAT[spec.dtype]:
        return f32_to_host(block_to_f32(block), spec.dtype)
    return block


# -- device side ---------------------------------------------------------------

def quantize_lnh(x: torch.Tensor, int4: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """[L, n, BS, KH, D] float → (payload, [L, n, KH] f32 scales): symmetric
    per-(layer, block, kv head) abs-max, :func:`quantize_block`'s arithmetic
    on the device. Both divisions are by tensors: a CUDA division by a
    Python scalar is a multiply by its reciprocal, another rounding.
    ``int4`` packs two signed nibbles a byte (uint8, trailing dim halved)."""
    qmax = INT4_QMAX if int4 else 127.0
    x = x.float()
    amax = x.abs().amax(dim=(2, 4))
    s = torch.maximum(amax / torch.full_like(amax, qmax), torch.full_like(amax, _EPS))
    q = torch.clamp(torch.round(x / s[:, :, None, :, None]), -qmax, qmax)
    if int4:
        return pack_int4(q.to(torch.int32)), s
    return q.to(torch.int8), s


#: torch element type of a host block's numpy dtype (uint16 bf16 bits via int16)
_TORCH_OF = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.int16,
             np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16}


def _stacked(blocks: list[np.ndarray], pinned: bool) -> torch.Tensor:
    """Host blocks of one format stacked into one tensor [n, *block] (in
    pinned memory with ``pinned``, written there by the one stacking copy);
    bf16 bits come out as bfloat16."""
    dt = blocks[0].dtype
    out = torch.empty((len(blocks), *blocks[0].shape), dtype=_TORCH_OF[dt], pin_memory=pinned)
    np.stack(blocks, out=out.numpy().view(dt))
    return out.view(torch.bfloat16) if dt == np.uint16 else out


def _host_float(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy (bf16 as uint16 bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


@dataclass
class TransferStats:
    """Blocks and bytes moved, and the time they took: for each inject on
    the card, the host time that staged its blocks in pinned memory and the
    device time of its copy and scatter (CUDA events, read lazily: an
    inject never waits for the card; on the CPU its whole wall); the host
    wall time of each extract's gather and copy (an extract waits for its
    copy anyway); and the extracts that first waited for work already on
    the stream (a step in flight), with that wait. Over a sharded cache
    (:class:`TPTransferEngine`) also the bytes and host seconds of the
    ranks' head gathers (extract) and block broadcasts (inject)."""

    extracts: int = 0
    extract_blocks: int = 0
    extract_bytes: int = 0
    extract_s: float = 0.0
    waits: int = 0
    wait_s: float = 0.0
    injects: int = 0
    inject_blocks: int = 0
    inject_bytes: int = 0
    inject_s: float = 0.0
    stage_s: float = 0.0
    gather_bytes: int = 0
    gather_s: float = 0.0
    scatter_bytes: int = 0
    scatter_s: float = 0.0
    _open: list = field(default_factory=list)
    #: guards ``_open``: a worker reads its stats off the engine-core thread
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def note_inject(self, start, end) -> None:
        with self._lock:
            self._open.append((start, end))

    def snapshot(self) -> dict:
        with self._lock:
            opened, self._open = self._open, []
        for start, end in opened:
            end.synchronize()
            self.inject_s += start.elapsed_time(end) / 1e3
        return {
            "extracts": self.extracts, "extract_blocks": self.extract_blocks,
            "extract_bytes": self.extract_bytes, "extract_s": self.extract_s,
            "d2h_bytes_per_s": self.extract_bytes / self.extract_s if self.extract_s else None,
            "waits": self.waits, "wait_s": self.wait_s,
            "injects": self.injects, "inject_blocks": self.inject_blocks,
            "inject_bytes": self.inject_bytes, "inject_s": self.inject_s,
            "stage_s": self.stage_s,
            "h2d_bytes_per_s": self.inject_bytes / self.inject_s if self.inject_s else None,
            "gather_bytes": self.gather_bytes, "gather_s": self.gather_s,
            "gather_bytes_per_s": self.gather_bytes / self.gather_s if self.gather_s else None,
            "scatter_bytes": self.scatter_bytes, "scatter_s": self.scatter_s,
            "scatter_bytes_per_s": (self.scatter_bytes / self.scatter_s
                                    if self.scatter_s else None),
        }


def _device(cache_k) -> torch.device:
    return (cache_k["q"] if isinstance(cache_k, dict) else cache_k).device


def _place(x: torch.Tensor, dim: int, lo: int, total: int) -> torch.Tensor:
    """``x`` at offset ``lo`` of a zeroed tensor whose ``dim`` is ``total``
    long (``x`` itself when it already spans it)."""
    if x.shape[dim] == total:
        return x
    shape = list(x.shape)
    shape[dim] = total
    out = x.new_zeros(shape)
    out.narrow(dim, lo, x.shape[dim]).copy_(x)
    return out


def gather_blocks(cache_k, cache_v, idx: torch.Tensor, dequant: bool = False,
                  heads: tuple[int, int] | None = None,
                  layers: tuple[int, int] | None = None) -> torch.Tensor:
    """Blocks ``idx`` of a cache in the host layout, block-major, on the
    cache's device: flat uint8 ``[n, payload + scales]`` for a quantized
    cache (``pack_kv_block``'s bytes), else ``[n, 2, L, BS, KH, D]``
    (float32 for a dequantized one). ``heads=(lo, total)``: the cache holds
    kv heads ``[lo, lo + KH)`` of ``total``, and the others are zeros (a
    rank's share of a whole block); ``layers=(lo, total)`` likewise for
    layers ``[lo, lo + L)`` (a pipeline stage's share)."""
    n = idx.numel()
    lo, total = heads if heads is not None else (0, None)
    l_lo, l_total = layers if layers is not None else (0, None)

    def wide(x, dim):
        x = x if total is None else _place(x, dim, lo, total)
        return x if l_total is None else _place(x, 0, l_lo, l_total)

    if isinstance(cache_k, dict) and not dequant:
        def rows(c):
            return wide(c["q"].index_select(1, idx), 3), wide(c["s"].index_select(1, idx), 2)

        (kq, ks), (vq, vs) = rows(cache_k), rows(cache_v)
        payload = torch.stack([kq, vq]).permute(2, 0, 1, 3, 4, 5).contiguous()
        scales = torch.stack([ks, vs]).permute(2, 0, 1, 3).contiguous()
        return torch.cat([payload.view(torch.uint8).reshape(n, -1),
                          scales.view(torch.uint8).reshape(n, -1)], dim=1)
    if isinstance(cache_k, dict):
        k, v = _dequant_rows(cache_k, idx), _dequant_rows(cache_v, idx)
    else:
        k, v = cache_k.index_select(1, idx), cache_v.index_select(1, idx)
    return torch.stack([wide(k, 3), wide(v, 3)]).permute(2, 0, 1, 3, 4, 5).contiguous()


def prepare_inject(blocks: list[np.ndarray], cache_k, kv_heads: int | None = None,
                   num_layers: int | None = None) -> tuple[str, list[np.ndarray]]:
    """The host half of an inject: convert host blocks for ``cache_k``'s
    kind and pick how they are written: ``"packed"`` (blocks of the cache's
    own quantized kind, copied as bytes), ``"quantize"`` (float blocks
    quantized on the device) or ``"float"`` (cast into a float cache). A
    packed block of the other quantized kind, or one into a float cache, is
    dequantized on the host. ``kv_heads``, ``num_layers``: the blocks' head
    and layer counts when the cache holds a share of them (else the
    cache's own)."""
    blocks = [host_bits(b) for b in blocks]
    packed = _is_packed(blocks[0])
    if isinstance(cache_k, dict):
        cq = cache_k["q"]
        int4 = cq.dtype == torch.uint8
        L, _, BS, KH, Dp = cq.shape
        logical = (num_layers or L, BS, kv_heads or KH, Dp * 2 if int4 else Dp)
        if packed and _packed_kind(blocks[0], logical) == ("int4" if int4 else "int8"):
            return "packed", blocks
        if packed:   # the other quantized kind: dequantize on the host
            blocks = [dequantize_block(b, logical, "float32") for b in blocks]
        return "quantize", blocks
    if packed:
        L, _, BS, KH, D = cache_k.shape
        name = str(cache_k.dtype).removeprefix("torch.")
        blocks = [dequantize_block(b, (num_layers or L, BS, kv_heads or KH, D), name)
                  for b in blocks]
    return "float", blocks


def write_blocks(cache_k, cache_v, idx: torch.Tensor, data: torch.Tensor, mode: str,
                 lo: int = 0, layers: tuple[int, int] | None = None) -> None:
    """The device half of an inject: write ``data`` (stacked host blocks on
    the cache's device, :func:`prepare_inject`'s mode) into the cache at
    ``idx``, in place; the cache holds the blocks' kv heads ``[lo, lo +
    KH)`` (all of them at ``lo=0`` when the counts agree), and with
    ``layers=(l_lo, total)`` their layers ``[l_lo, l_lo + L)`` of
    ``total`` (a pipeline stage's; else all of them)."""
    n = idx.numel()
    L = cache_payload(cache_k).shape[0]
    l_lo, l_total = layers if layers is not None else (0, L)
    if mode == "packed":
        cq = cache_k["q"]
        _, _, BS, kh, Dp = cq.shape
        # the blocks' head count, from their byte length
        total = data.shape[1] // (2 * l_total * (BS * Dp + 4))
        split = 2 * l_total * BS * total * Dp               # data: [n, P + S] uint8
        payload = data[:, :split].view(cq.dtype).reshape(n, 2, l_total, BS, total, Dp)
        scales = data[:, split:].contiguous().view(torch.float32).reshape(n, 2, l_total, total)
        for j, c in enumerate((cache_k, cache_v)):
            c["q"].index_copy_(1, idx, payload[:, j, l_lo: l_lo + L, :, lo: lo + kh]
                               .transpose(0, 1))
            c["s"].index_copy_(1, idx, scales[:, j, l_lo: l_lo + L, lo: lo + kh].transpose(0, 1))
        return
    kh = (cache_k["q"] if mode == "quantize" else cache_k).shape[3]
    x = data[:, :, l_lo: l_lo + L, :, lo: lo + kh, :]       # [n, 2, L, BS, kh, D]
    if mode == "quantize":
        x = x.float()
        int4 = cache_k["q"].dtype == torch.uint8
        for j, c in enumerate((cache_k, cache_v)):
            q, s = quantize_lnh(x[:, j].transpose(0, 1), int4)
            c["q"].index_copy_(1, idx, q)
            c["s"].index_copy_(1, idx, s)
        return
    x = x.to(cache_k.dtype)
    cache_k.index_copy_(1, idx, x[:, 0].transpose(0, 1))
    cache_v.index_copy_(1, idx, x[:, 1].transpose(0, 1))


class BlockTransferEngine:
    """Block gather (extract) / in-place scatter (inject) over a cache."""

    #: the kv heads and layers of a whole block (None: the cache's own)
    kv_heads: int | None = None
    num_layers: int | None = None

    def __init__(self) -> None:
        self.stats = TransferStats()

    def _wait_for_stream(self, dev: torch.device) -> None:
        """Before a gather on the card: wait for the steps already queued
        on the stream, counting the wait when there was one."""
        if dev.type != "cuda":
            return
        stream = torch.cuda.current_stream(dev)
        if not stream.query():
            t_wait = time.perf_counter()
            stream.synchronize()
            self.stats.waits += 1
            self.stats.wait_s += time.perf_counter() - t_wait

    def _gather(self, cache_k, cache_v, ids: list[int], dequant: bool) -> torch.Tensor:
        """The blocks ``ids`` in the host layout, in host memory."""
        dev = _device(cache_k)
        idx = torch.tensor(ids, dtype=torch.long).to(dev)
        gathered = gather_blocks(cache_k, cache_v, idx, dequant)
        if dev.type == "cuda":  # one copy into pinned memory (a pageable one runs at a fraction)
            pinned = torch.empty(gathered.shape, dtype=gathered.dtype, pin_memory=True)
            pinned.copy_(gathered, non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            gathered = pinned
        return gathered

    def extract(self, cache_k, cache_v, ids: list[int], dequant: bool = False,
                span_attrs: dict | None = None) -> list[np.ndarray]:
        """Gather blocks off the device; returns one host block per id.
        Quantized caches yield packed flat-uint8 blocks unless ``dequant``
        (then: float32 blocks). The gather runs on the stream the engine's
        steps run on, after whatever is on it."""
        from dynamo_tpu_torch.obs.tracer import get_tracer

        n = len(ids)
        st = self.stats
        with get_tracer().span("kv.transfer", direction="extract",
                               blocks=n, **(span_attrs or {})) as sp:
            self._wait_for_stream(_device(cache_k))
            t0 = time.perf_counter()
            host = _host_float(self._gather(cache_k, cache_v, ids, dequant))
            out = [host[i] for i in range(n)]
            nbytes = int(host.nbytes)
            st.extracts += 1
            st.extract_blocks += n
            st.extract_bytes += nbytes
            st.extract_s += time.perf_counter() - t0
            sp.attrs["bytes"] = nbytes
            return out

    def _write(self, cache_k, cache_v, ids: list[int], mode: str,
               data: torch.Tensor) -> None:
        """Copy the stacked host blocks to the card and write them."""
        dev = _device(cache_k)
        idx = torch.tensor(ids, dtype=torch.long)
        if dev.type == "cuda":
            idx = idx.pin_memory()
        write_blocks(cache_k, cache_v, idx.to(dev, non_blocking=True),
                     data.to(dev, non_blocking=True), mode)

    def inject(self, cache_k, cache_v, ids: list[int], blocks: list[np.ndarray],
               span_attrs: dict | None = None) -> None:
        """Write host blocks into the cache at ``ids``, in place. Accepts
        packed or float blocks against either cache kind; format conversion
        happens here. On the card the host data is staged in pinned memory,
        and the copy and scatter are queued on the current stream without
        waiting."""
        from dynamo_tpu_torch.obs.tracer import get_tracer

        assert len(ids) == len(blocks) and ids
        blocks = [host_bits(b) for b in blocks]
        nbytes = sum(int(b.nbytes) for b in blocks)
        cuda = _device(cache_k).type == "cuda"
        st = self.stats
        with get_tracer().span("kv.transfer", direction="inject",
                               blocks=len(ids), bytes=nbytes, **(span_attrs or {})):
            t0 = time.perf_counter()
            mode, blocks = prepare_inject(blocks, cache_k, self.kv_heads, self.num_layers)
            data = _stacked(blocks, pinned=cuda)
            start = None
            if cuda:
                st.stage_s += time.perf_counter() - t0
                start = torch.cuda.Event(enable_timing=True)
                start.record()
            self._write(cache_k, cache_v, ids, mode, data)
            st.injects += 1
            st.inject_blocks += len(ids)
            st.inject_bytes += nbytes
            if cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                st.note_inject(start, end)
            else:
                st.inject_s += time.perf_counter() - t0


class TPTransferEngine(BlockTransferEngine):
    """The leader's block mover over a cache sharded by kv head across the
    ranks of a tensor-parallel engine, or by layer across the stages of a
    pipeline-parallel one (JAX's engine at one process, whose
    ``export_blocks`` returns whole blocks): host blocks are always WHOLE
    blocks, every kv head and every layer, in the layout, packing and
    bytes that :class:`BlockTransferEngine` gives over one unsharded cache
    of the same content, so blocks move freely between engines of any tp
    and pp.

    ``extract`` posts ``("extract", ids, dequant)`` to the followers (in
    step order, on the control pipe), and every rank of the leader's block
    group (data replica 0, expert shard 0: the cache is replicated over
    both; every stage and model shard) gathers its heads of its layers
    into a zeroed whole-block buffer that is summed into the leader's
    (:func:`tp_gather`). ``inject`` converts the host blocks as
    ``BlockTransferEngine`` does, posts ``("inject", ids, mode, shape,
    dtype)`` and broadcasts them to every rank as bytes; each writes its
    own heads of its own layers (:func:`tp_scatter`), every data replica
    and expert shard its copy."""

    def __init__(self, group, kv_heads: int, num_layers: int | None = None) -> None:
        super().__init__()
        self.group = group
        self.kv_heads = kv_heads
        self.num_layers = num_layers

    def _gather(self, cache_k, cache_v, ids: list[int], dequant: bool) -> torch.Tensor:
        g = self.group
        g.post("extract", list(ids), dequant)
        bytes0, s0 = g.block_bytes, g.block_s
        out = tp_gather(g, cache_k, cache_v, ids, dequant, self.kv_heads)
        self.stats.gather_bytes += g.block_bytes - bytes0
        self.stats.gather_s += g.block_s - s0
        return out

    def _write(self, cache_k, cache_v, ids: list[int], mode: str,
               data: torch.Tensor) -> None:
        g = self.group
        g.post("inject", list(ids), mode, tuple(data.shape), str(data.dtype))
        bytes0, s0 = g.block_bytes, g.block_s
        tp_scatter(g, cache_k, cache_v, ids, mode, data.shape, data.dtype, data)
        self.stats.scatter_bytes += g.block_bytes - bytes0
        self.stats.scatter_s += g.block_s - s0


def tp_gather(group, cache_k, cache_v, ids: list[int], dequant: bool,
              kv_heads: int) -> torch.Tensor | None:
    """One rank's part of a sharded extract (every rank of the leader's
    block group runs it, the leader last to post): the rank's heads of its
    stage's layers of blocks ``ids`` in a zeroed whole-block buffer,
    summed over the block group into the leader's. Returns the leader's
    whole blocks in the host layout, in host memory (None on the other
    ranks)."""
    dev = _device(cache_k)
    idx = torch.tensor(ids, dtype=torch.long).to(dev)
    L, _, _, kh, _ = cache_payload(cache_k).shape
    gathered = gather_blocks(cache_k, cache_v, idx, dequant, (group.rank * kh, kv_heads),
                             (group.stage * L, group.pp * L))
    shape, dtype = gathered.shape, gathered.dtype
    buf = gathered.view(torch.uint8)
    if buf.device != group.block_device:
        buf = buf.to(group.block_device)
    buf = group.gather_parts(buf)
    if not group.leader:
        return None
    if buf.device.type == "cuda":
        pinned = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        pinned.copy_(buf)
        buf = pinned
    return buf.view(dtype).reshape(shape)


def tp_scatter(group, cache_k, cache_v, ids: list[int], mode: str, shape: tuple,
               dtype: torch.dtype, data: torch.Tensor | None = None) -> None:
    """One rank's part of a sharded inject (every rank runs it): the
    leader's stacked host blocks ``data`` ([n, ...] of ``dtype``) arrive
    as bytes, and the rank writes its own kv heads of its stage's layers
    of them into its cache."""
    if data is not None:
        buf = data.contiguous().view(torch.uint8)
        if buf.device != group.block_device:
            buf = buf.to(group.block_device)
    else:
        nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        buf = torch.empty(nbytes, dtype=torch.uint8, device=group.block_device)
    buf = group.broadcast_bytes(buf.reshape(-1))
    dev = _device(cache_k)
    data = buf.view(dtype).reshape(shape).to(dev)
    L, _, _, kh, _ = cache_payload(cache_k).shape
    write_blocks(cache_k, cache_v, torch.tensor(ids, dtype=torch.long).to(dev), data, mode,
                 lo=group.rank * kh, layers=(group.stage * L, group.pp * L))


def _dequant_rows(c: dict, idx: torch.Tensor) -> torch.Tensor:
    """A quantized cache's blocks ``idx`` as float32 [L, n, BS, KH, D]."""
    g = c["q"].index_select(1, idx)
    if g.dtype == torch.uint8:
        g = unpack_int4(g)
    return g.float() * c["s"].index_select(1, idx)[:, :, None, :, None]
