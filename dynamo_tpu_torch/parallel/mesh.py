"""Mesh axes and the parameter layout of tensor, expert and pipeline
parallelism — port of ``dynamo_tpu/parallel/mesh.py`` (and of
``param_logical_axes`` from ``dynamo_tpu/models/llama.py``) for the
"model", "expert" and "pipe" axes.

The JAX package places a params pytree on a device mesh and lets GSPMD
insert the collectives. Here each rank is a process of its own: it holds
its own slice of every sharded leaf (:func:`shard_params`), computes on
it, and the model code calls the collectives itself
(``parallel/collectives.py``). The slices are JAX's: the rank at
coordinates ``(m, e, s)`` in ("model", "expert", "pipe") holds the m-th
of tp equal contiguous pieces of each dim whose logical axis
:data:`PARAM_RULES` maps to "model", the e-th of ep pieces of each dim it
maps to "expert", and the s-th of pp pieces of the stacked layer dim
("layers" on "pipe": pipeline stage s holds layers ``[s L/pp, (s+1)
L/pp)``):

- ``wq``, ``wk``, ``wv``: output columns (the rank's q and kv heads);
  ``wo``: input rows (the same heads);
- ``w_gate``, ``w_up``: columns; ``w_down``: rows (the FFN width);
- ``embed``: vocab rows; ``lm_head``: vocab columns;
- norms replicated;
- an int8 leaf (``{"q", "so"|"sr"}``, models/quant.py): ``q`` as its
  matrix, the scales on the matrix's output (or vocab) axis.

- MoE: the expert stacks ``w_gate``/``w_up`` [E, H, M] by columns and
  ``w_down`` [E, M, H] by rows of the per-expert width M ("moe_mlp" on
  "model": TEP), and by experts ("expert" on "expert": EP); the shared
  expert's width as the dense FFN's ("mlp"); the router [H, E] whole on
  every rank (:func:`rank_logical_axes`). JAX stores the router split on
  "expert" but its dropless ``shard_fn`` gathers it before the top-k
  (``dynamo_tpu/models/moe.py``), so every rank routes with the whole
  matrix in both packages.

- Pipeline stages: ``"layers"`` on "pipe" (JAX's ``PARAM_RULES``), so
  stage ``s`` of ``pp`` holds layers ``[s L/pp, (s+1) L/pp)`` of every
  stacked leaf (both tensors of an int8 leaf); only stage 0 holds
  ``embed``, ``final_norm`` and ``lm_head``: it embeds, and the last
  stage's hidden comes back to it for the final norm and the logits
  (JAX replicates them over "pipe"; the port's later stages never read
  them).

An expert count that does not divide over ep is refused by name, as
JAX's placement refuses it (``device_put`` needs a divisible dim), and a
layer count that does not divide over pp in JAX's words.

The vocab is the one axis that need not divide: each rank's piece is
``ceil(V / tp)`` rows, the last one padded with zero rows that the model
masks (``models/llama.embed_lookup``, ``logits_from_hidden``). JAX refuses
that placement (``device_put`` needs a divisible dim); the port serves
it.

Kv heads whose count does not divide tp are refused, as JAX's engine
refuses them: its dense gather fallback (``dynamo_tpu/models/llama.py``,
``forward``) serves a bare ``forward`` only, while its engine cannot place
such a cache (``kv_cache_spec`` puts the kv heads on "model", and the
placement needs a divisible dim), so ``EngineCore`` raises at
construction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from dynamo_tpu_torch.models.config import ModelConfig

AXES = ("data", "pipe", "seq", "model", "expert")


@dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.sp * self.tp * self.ep


# Logical→mesh axis rules for model parameters (a copy of JAX's). Keys are
# the logical axis names of :func:`param_logical_axes`; values are mesh
# axes (None = replicate). Params shard over "model", "expert" and
# "pipe": the port's "data" ranks (engine/tp.py) each hold a copy of them.
PARAM_RULES: dict[str, str | None] = {
    "vocab": "model",          # embedding/lm_head vocab-sharded
    "hidden": None,            # activations' hidden axis replicated in params
    "heads": "model",          # attention heads sharded (TP)
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",            # MLP intermediate sharded (TP)
    "expert": "expert",        # MoE experts sharded (EP)
    "layers": "pipe",          # stacked layer dim sharded over pipeline stages
    "moe_mlp": "model",        # per-expert intermediate (TEP)
}

Params = dict[str, Any]


def param_logical_axes(cfg: ModelConfig) -> Params:
    """Logical axis names per parameter leaf (copy of the JAX function)."""
    layer = {
        "wq": ("layers", None, "heads"),
        "wk": ("layers", None, "kv_heads"),
        "wv": ("layers", None, "kv_heads"),
        "wo": ("layers", "heads", None),
        "attn_norm": ("layers", None),
        "mlp_norm": ("layers", None),
    }
    if cfg.is_moe:
        layer.update(
            router=("layers", None, "expert"),
            w_gate=("layers", "expert", None, "moe_mlp"),
            w_up=("layers", "expert", None, "moe_mlp"),
            w_down=("layers", "expert", "moe_mlp", None),
        )
        if cfg.num_shared_experts:
            layer.update(
                shared_gate=("layers", None, "mlp"),
                shared_up=("layers", None, "mlp"),
                shared_down=("layers", "mlp", None),
            )
    else:
        layer.update(
            w_gate=("layers", None, "mlp"),
            w_up=("layers", None, "mlp"),
            w_down=("layers", "mlp", None),
        )
    axes: Params = {"embed": ("vocab", None), "final_norm": (None,), "layers": layer}
    if not cfg.tie_word_embeddings:
        axes["lm_head"] = (None, "vocab")
    return axes


def rank_logical_axes(cfg: ModelConfig) -> Params:
    """The logical axes a rank's shard is cut by: :func:`param_logical_axes`
    with the MoE router whole (its expert axis replicated)."""
    axes = param_logical_axes(cfg)
    if cfg.is_moe:
        axes["layers"]["router"] = ("layers", None, None)
    return axes


def check_tp(cfg: ModelConfig, tp: int, ep: int = 1) -> None:
    """Raise unless ``cfg``'s query heads, kv heads and FFN width (a MoE
    model's per-expert width M; its shared experts' width is a multiple
    of M) divide over ``tp`` ranks, and a MoE model's experts over
    ``ep``."""
    for name, n in (("tp", tp), ("ep", ep)):
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")
    if cfg.num_kv_heads % tp:
        raise ValueError(
            f"num_kv_heads={cfg.num_kv_heads} does not divide over tp={tp}: the KV "
            "cache shards its kv heads over the ranks (the JAX engine cannot place "
            "such a cache either: ROADMAP, gaps in the reference)")
    dims = [("num_heads", cfg.num_heads, "tp", tp)]
    if cfg.is_moe:
        dims += [("moe_intermediate_size", cfg.moe_intermediate_size, "tp", tp),
                 ("num_experts", cfg.num_experts, "ep", ep)]
    else:
        dims.append(("intermediate_size", cfg.intermediate_size, "tp", tp))
    for name, n, axis, size in dims:
        if n % size:
            why = " (JAX's placement refuses it too)" if axis == "ep" else ""
            raise ValueError(f"{name}={n} does not divide over {axis}={size}{why}")


def check_pp(cfg: ModelConfig, pp: int) -> None:
    """Raise unless ``cfg``'s layers divide over ``pp`` pipeline stages, in
    the words of JAX's ``forward_pp``."""
    if pp < 1:
        raise ValueError(f"pp must be >= 1, got {pp}")
    if cfg.num_layers % pp:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by pp={pp}")


def stage_layers(cfg: ModelConfig, stage: int, pp: int) -> tuple[int, int]:
    """The layers ``[lo, hi)`` pipeline stage ``stage`` of ``pp`` holds."""
    check_pp(cfg, pp)
    per = cfg.num_layers // pp
    return stage * per, (stage + 1) * per


def local_heads(cfg: ModelConfig, tp: int) -> tuple[int, int]:
    """(query heads, kv heads) of one rank."""
    check_tp(cfg, tp)
    return cfg.num_heads // tp, cfg.num_kv_heads // tp


def shard_bounds(n: int, axis: str | None, rank: int, tp: int, expert: int = 0,
                 ep: int = 1, stage: int = 0, pp: int = 1) -> tuple[int, int, int]:
    """The piece ``[lo, hi)`` of a dim of size ``n`` on logical ``axis``
    held by the rank at (model ``rank`` of ``tp``, expert ``expert`` of
    ``ep``, stage ``stage`` of ``pp``), and the piece's size ``per`` once
    padded (``hi - lo`` but on the vocab axis, whose last piece is padded
    to ``ceil(n / tp)``). A dim on none of the axes is whole: ``(0, n,
    n)``."""
    mesh_axis = PARAM_RULES.get(axis)
    if mesh_axis == "expert":
        rank, tp, name = expert, ep, "ep"
    elif mesh_axis == "pipe":
        rank, tp, name = stage, pp, "pp"
    elif mesh_axis == "model":
        name = "tp"
    else:
        return 0, n, n
    if tp == 1:
        return 0, n, n
    if axis == "vocab":
        per = -(-n // tp)
    elif n % tp:
        raise ValueError(f"a {axis} dim of {n} does not divide over {name}={tp}")
    else:
        per = n // tp
    lo = min(rank * per, n)
    return lo, min(lo + per, n), per


def pad_dim(x: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """``x`` with zeros appended along ``dim`` up to ``size``."""
    short = size - x.shape[dim]
    if short <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = short
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def shard_leaf(x: torch.Tensor, axes: tuple, rank: int, tp: int, expert: int = 0,
               ep: int = 1, stage: int = 0, pp: int = 1) -> torch.Tensor:
    """One leaf's slice for the rank at (``rank``, ``expert``, ``stage``),
    in memory of its own (the full leaf can be freed)."""
    for dim, axis in enumerate(axes):
        lo, hi, per = shard_bounds(x.shape[dim], axis, rank, tp, expert, ep, stage, pp)
        if (lo, hi) != (0, x.shape[dim]):
            x = pad_dim(x.narrow(dim, lo, hi - lo), dim, per)
    return x.clone(memory_format=torch.contiguous_format)


def quantized_axes(axes: tuple, key: str) -> tuple:
    """The logical axes of a quantized leaf's tensor ``key`` for a matrix
    on ``axes``: ``q`` keeps them, a per-out-channel scale ``so`` drops the
    contracted (second-to-last) axis, a per-row scale ``sr`` the last."""
    if key == "so":
        return axes[:-2] + axes[-1:]
    if key == "sr":
        return axes[:-1]
    return axes


def shard_params(params: Params, cfg: ModelConfig, rank: int, tp: int, expert: int = 0,
                 ep: int = 1, stage: int = 0, pp: int = 1) -> Params:
    """The shard of a full params tree held by the rank at (model ``rank``
    of ``tp``, expert ``expert`` of ``ep``, pipeline stage ``stage`` of
    ``pp``): the counterpart of JAX's ``shard_params`` on a (tp, ep, pp)
    mesh followed by taking that rank's addressable shards (the router
    whole). A quantized leaf (models/quant.py) is cut as its matrix is:
    ``q`` on the matrix's axes, its scales on theirs (a padded vocab
    piece's scales are zeros, as its rows are). A stage past the first
    holds its layers only."""
    if tp == 1 and ep == 1 and pp == 1:
        return params
    check_tp(cfg, tp, ep)
    check_pp(cfg, pp)
    cut = (rank, tp, expert, ep, stage, pp)

    def walk(p, axes):
        if isinstance(axes, dict):
            return {k: walk(p[k], axes[k]) for k in axes}
        if isinstance(p, dict):
            return {k: shard_leaf(v, quantized_axes(axes, k), *cut) for k, v in p.items()}
        return shard_leaf(p, axes, *cut)

    axes = rank_logical_axes(cfg)
    if stage > 0:
        axes = {"layers": axes["layers"]}
    return walk(params, axes)
