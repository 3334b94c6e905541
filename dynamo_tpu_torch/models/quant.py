"""Weight-only int8 quantization: per-channel scales, compute at the model
dtype — port of ``dynamo_tpu/models/quant.py``.

Scheme (the JAX package's): symmetric per-output-channel scales. For a
matrix W[in, out], ``scale[o] = max_i |W[i, o]| / 127`` and
``q = round(W / scale)``; ``llama.mm`` applies the scale after the
contraction, ``(x @ q) * scale``. The embedding quantizes per vocab row,
which serves both the gather and the tied logits (a scale per logit
column). A quantized leaf is the dict ``{"q": int8, "so"|"sr": float32}``;
the key names the scheme ("so" out-channel, "sr" row).

The scale is ``amax * (1/127)``, not ``amax / 127``: JAX's quantizer runs
under ``jax.jit``, where XLA turns the division by a constant into a
multiply by its f32 reciprocal, and the two differ in the last bit for a
share of the channels. ``q`` divides by the scale tensor in both packages.
So the port's ``q`` and scales equal JAX's byte for byte.

Tensor parallelism: JAX quantizes after placement, under GSPMD, so each
scale is over the whole matrix. The port quantizes each rank's shard;
where the shard cuts the contracted axis (``wo``, ``w_down``: their rows
are split over the "model" axis) the per-channel abs-max is taken over
the ranks (``TPGroup.all_reduce_max``) before the scale is formed, which
gives every rank JAX's scales and its slice of JAX's ``q``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import torch

from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.utils.device import lasting_empty
from dynamo_tpu_torch.utils.logging import get_logger

if TYPE_CHECKING:
    from dynamo_tpu_torch.parallel.collectives import TPGroup

log = get_logger("quant")

Params = dict[str, Any]

# Matrices consumed through llama.mm (contraction along the second-to-last
# axis, scale on the last). MoE expert stacks ride the einsum path and stay
# at the model dtype, as in the JAX package.
_MM_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
            "shared_gate", "shared_up", "shared_down")
#: the MoE expert stacks the quantizer leaves alone
_EXPERT_KEYS = ("w_gate", "w_up", "w_down")
#: the reciprocal JAX's jitted ``amax / 127.0`` multiplies by
_INV_QMAX = 1.0 / 127.0
#: the floor of a scale (an all-zero channel)
_SCALE_EPS = 1e-12
QUANTIZATIONS = ("none", "", "int8")


def is_quantized(leaf) -> bool:
    """A ``{"q", "so"|"sr"}`` leaf."""
    return isinstance(leaf, dict) and "q" in leaf and ("so" in leaf or "sr" in leaf)


def leaf_shape(leaf) -> torch.Size:
    """The shape of a plain or quantized leaf's matrix (its ``q``)."""
    return leaf["q"].shape if is_quantized(leaf) else leaf.shape


def layer_leaf(leaf, li: int):
    """Layer ``li``'s slice of a stacked ``[L, ...]`` leaf, plain or
    quantized (both tensors of a quantized leaf are stacked)."""
    if isinstance(leaf, dict):
        return {k: v[li] for k, v in leaf.items()}
    return leaf[li]


def _quantize(w: torch.Tensor, scale: torch.Tensor, scale_dim: int) -> torch.Tensor:
    q = torch.round(w.float() / scale.unsqueeze(scale_dim)).clamp_(-127, 127)
    return q.to(torch.int8)


def _quant_mm(w: torch.Tensor, tp: "TPGroup | None" = None) -> dict[str, torch.Tensor]:
    """[..., in, out] → q int8 + per-out-channel scale [..., out]; with
    ``tp`` the abs-max is over every rank's rows of ``in``. The outputs
    are allocated first (``lasting_empty``) and filled one matrix at a
    time, so the f32 temporaries are one matrix's."""
    mats = w.reshape(-1, *w.shape[-2:])
    q = lasting_empty(mats.shape, torch.int8, w.device)
    amax = lasting_empty((mats.shape[0], mats.shape[-1]), torch.float32, w.device)
    for i, m in enumerate(mats):
        amax[i] = m.float().abs().amax(dim=-2)
    if tp is not None:
        amax = tp.all_reduce_max(amax)
    scale = amax.mul_(_INV_QMAX).clamp_min_(_SCALE_EPS)
    for i, m in enumerate(mats):
        q[i] = _quantize(m, scale[i], -2)
    return {"q": q.reshape(w.shape), "so": scale.reshape(*w.shape[:-2], w.shape[-1])}


def _quant_rows(w: torch.Tensor, chunk: int = 1 << 16) -> dict[str, torch.Tensor]:
    """[rows, h] → q int8 + per-row scale [rows] (embedding), ``chunk``
    rows at a time into outputs allocated first (as :func:`_quant_mm`)."""
    q = lasting_empty(w.shape, torch.int8, w.device)
    sr = lasting_empty(w.shape[0], torch.float32, w.device)
    for lo in range(0, w.shape[0], chunk):
        rows = w[lo: lo + chunk]
        s = sr[lo: lo + chunk]
        torch.clamp_min(rows.float().abs().amax(dim=-1) * _INV_QMAX, _SCALE_EPS, out=s)
        q[lo: lo + chunk] = _quantize(rows, s, -1)
    return {"q": q, "sr": sr}


def quantize_params_int8(params: Params, cfg: ModelConfig,
                         tp: "TPGroup | None" = None) -> Params:
    """The params with their big matrices quantized in place of their
    float leaves. Norms and the MoE router stay at the model dtype, and so
    do MoE expert stacks (the einsum path; a warning names them).
    Idempotent: a quantized leaf passes through. Under ``tp`` the params
    are this rank's shard and the row-parallel matrices' scales are taken
    over the group."""
    from dynamo_tpu_torch.parallel.mesh import PARAM_RULES, param_logical_axes

    axes = param_logical_axes(cfg)["layers"]
    out = dict(params)
    layers = dict(params["layers"])
    skipped = []
    for key in _MM_KEYS:
        if key not in layers or is_quantized(layers[key]):
            continue
        if cfg.is_moe and key in _EXPERT_KEYS:
            skipped.append(key)
            continue
        row_parallel = tp is not None and PARAM_RULES.get(axes[key][-2]) == "model"
        layers[key] = _quant_mm(layers[key], tp if row_parallel else None)
    out["layers"] = layers
    if not is_quantized(params["embed"]):
        out["embed"] = _quant_rows(params["embed"])
        if "lm_head" in params and not is_quantized(params["lm_head"]):
            # [h, vocab]: a scale per vocab column, the mm geometry
            out["lm_head"] = _quant_mm(params["lm_head"])
    if skipped:
        log.warning("int8 quantization skipped MoE expert tensors %s "
                    "(einsum/ragged dispatch paths are bf16-only for now)", skipped)
    return out


def dequantize_params(params: Params) -> Params:
    """Inverse (testing): every quantized leaf expanded back to f32."""
    if is_quantized(params):
        q = params["q"].float()
        if "sr" in params:
            return q * params["sr"][..., None]
        return q * params["so"][..., None, :]
    if isinstance(params, dict):
        return {k: dequantize_params(v) for k, v in params.items()}
    return params


def param_bytes(params: Params) -> int:
    """Bytes of a params tree (int8 leaves count 1 a value, scales
    included)."""
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
