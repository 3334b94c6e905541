"""Expert-parallel MoE dispatch: the dropless ragged groups and the
capacity variant — port of ``dynamo_tpu/models/moe.py``.

- :func:`moe_mlp_dropless` (the engine's ``moe_impl="ep"``, at ep > 1):
  exact under any routing. The (token, choice) rows are sorted by local
  expert, stably, so each of this rank's experts takes one contiguous
  group; rows routed to another rank's experts sort into a trailing void
  group that is never computed. One product runs per non-empty local
  group (torch matmuls over each group stand in for ``lax.ragged_dot``),
  the rows are weighted and ``index_add``-ed into an f32 [N, H] partial.
  Under a group the partial is a sum over BOTH the expert and the model
  axis: a rank holds its experts' slabs and its slice of their width
  (TEP), so one f32 all-reduce over the MoE group (tp x ep ranks,
  parallel/collectives.py) completes the expert combine and the width's
  contraction, as JAX's one ``psum(y, ("expert", "model"))``. The shared
  expert's partial rides the same sum, divided by ep (every expert rank
  of a model shard computes the same one). The result is cast once.

  The group sizes are read on the host (one ``tolist`` a layer and
  forward step: the per-group products need their row counts), which
  synchronises the host with the card once a MoE layer. Multi-rank steps
  run eagerly, so the sync costs no graph; a grouped Hopper product that
  takes the sizes on the card is later speed work (ROADMAP).

- :func:`moe_mlp_ep` (``moe_impl="ep_capacity"``): the Switch/GShard
  capacity formulation on one device, with JAX's choice-major priority:
  a token's first choice wins a slot over any token's second choice, and
  a choice past its expert's capacity is dropped.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.models.config import ModelConfig

if TYPE_CHECKING:
    from dynamo_tpu_torch.parallel.collectives import TPGroup

Params = dict[str, Any]


def _router_topk(xt: torch.Tensor, lp: Params, cfg: ModelConfig
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """([N, k] expert ids, [N, k] softmax weights): f32 logits, the top k
    in ``lax.top_k``'s tie order, a softmax over the top values — the
    dense dispatch's routing (models/llama.moe_mlp)."""
    from dynamo_tpu_torch.models.llama import top_k

    logits = xt.float() @ lp["router"].float()                    # [N, E]
    topv, topi = top_k(logits, cfg.num_experts_per_tok)
    return topi, torch.softmax(topv, dim=-1)


def _dropless_rows(xt: torch.Tensor, topi: torch.Tensor, weights: torch.Tensor,
                   w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor,
                   e_lo: int, e_local: int) -> torch.Tensor:
    """This rank's expert rows. xt [N, H]; topi/weights [N, k]; w_*
    [e_local, H|M, M|H], the slabs of experts ``[e_lo, e_lo + e_local)``.
    Returns the f32 [N, H] partial (zeros where a row's experts are
    another rank's)."""
    n, h = xt.shape
    k = topi.shape[1]
    flat_e = topi.reshape(-1)                                     # [Nk] token-major
    flat_t = torch.arange(n, device=xt.device).repeat_interleave(k)
    local_e = flat_e - e_lo
    is_local = (local_e >= 0) & (local_e < e_local)
    key = torch.where(is_local, local_e, torch.full_like(local_e, e_local))
    perm = torch.sort(key, stable=True).indices
    sizes = torch.bincount(key, minlength=e_local + 1).tolist()   # host sync
    rows = flat_t[perm]
    xs = xt[rows]                                                 # [Nk, H]
    n_local = n * k - sizes[e_local]                              # the void group trails
    outs = []
    lo = 0
    for g in range(e_local):
        size = sizes[g]
        if size:
            a = xs[lo: lo + size]
            act = F.silu(a @ w_gate[g]) * (a @ w_up[g])
            outs.append(act @ w_down[g])
        lo += size
    y = torch.zeros((n, h), dtype=torch.float32, device=xt.device)
    if n_local:
        contrib = torch.cat(outs).float() * weights.reshape(-1)[perm[:n_local], None]
        y.index_add_(0, rows[:n_local], contrib)
    return y


def dropless_partial(x: torch.Tensor, lp: Params, cfg: ModelConfig, expert: int = 0,
                     ep: int = 1) -> torch.Tensor:
    """One rank's f32 [N, H] partial of the dropless FFN of x [B, T, H]:
    its experts' rows (``lp``'s expert stacks are expert shard ``expert``
    of ``ep``, and may be a slice of the width) plus the shared expert's
    output over ``ep``. The sum of every rank's partial is the layer's
    output before its one cast."""
    from dynamo_tpu_torch.models.llama import swiglu

    xt = x.reshape(-1, x.shape[-1])
    topi, weights = _router_topk(xt, lp, cfg)
    e_local = lp["w_gate"].shape[0]
    y = _dropless_rows(xt, topi, weights, lp["w_gate"], lp["w_up"], lp["w_down"],
                       expert * e_local, e_local)
    if cfg.num_shared_experts:
        sh = swiglu(xt, lp["shared_gate"], lp["shared_up"], lp["shared_down"]).float()
        y = y + (sh / ep if ep > 1 else sh)
    return y


def moe_mlp_dropless(x: torch.Tensor, lp: Params, cfg: ModelConfig,
                     group: "TPGroup | None" = None) -> torch.Tensor:
    """Dropless MoE FFN. x: [B, T, H] → [B, T, H], exact against the dense
    dispatch under any routing skew. Under ``group`` (tp x ep > 1) ``lp``
    is the rank's shard and the partials are summed over the MoE group in
    f32 before the one cast."""
    ep, expert = (group.ep, group.expert_rank) if group is not None else (1, 0)
    y = dropless_partial(x, lp, cfg, expert, ep)
    if group is not None:
        y = group.all_reduce_moe(y)
    return y.to(x.dtype).reshape(x.shape)


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Per-expert token slots, padded to a multiple of 8 (at least 8)."""
    cap = int(num_tokens * top_k / num_experts * capacity_factor) + 1
    return max(-(-cap // 8) * 8, 8)


def moe_mlp_ep(x: torch.Tensor, lp: Params, cfg: ModelConfig,
               capacity_factor: float = 2.0) -> torch.Tensor:
    """Capacity-bounded MoE FFN on one device. x: [B, T, H] → [B, T, H].

    Each token's top-k choices go to per-expert buffers of C slots; the
    choices are ranked choice-major (every token's 1st choice before any
    2nd choice, tokens in order within a choice), and a choice past C is
    dropped. The dispatch and combine tensors are JAX's one-hot einsums,
    the expert buffers cast to the model dtype as in JAX."""
    from dynamo_tpu_torch.models.llama import swiglu

    b, t, h = x.shape
    n = b * t
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    xt = x.reshape(n, h)
    topi, weights = _router_topk(xt, lp, cfg)                     # [N, k]
    cap = expert_capacity(n, e, k, capacity_factor)
    oh = F.one_hot(topi.T.reshape(k * n), e)                      # [kN, E] choice-major
    pos = torch.cumsum(oh, dim=0) * oh - 1
    pos_in_e = pos.max(dim=1).values                              # [kN]
    keep = (pos_in_e >= 0) & (pos_in_e < cap)
    pos_in_e = torch.where(keep, pos_in_e, torch.zeros_like(pos_in_e))
    keep = keep.reshape(k, n).T                                   # [N, k]
    pos_nk = pos_in_e.reshape(k, n).T
    slot_oh = F.one_hot(pos_nk, cap).float()                      # [N, k, C]
    exp_oh = F.one_hot(topi, e).float()                           # [N, k, E]
    dispatch = torch.einsum("nke,nkc->nec", exp_oh, slot_oh * keep.float()[..., None])
    combine = torch.einsum("nke,nkc->nec", exp_oh * (weights * keep)[..., None], slot_oh)
    expert_in = torch.einsum("nec,nh->ech", dispatch, xt.float()).to(x.dtype)
    gate = torch.einsum("ech,ehm->ecm", expert_in, lp["w_gate"])
    up = torch.einsum("ech,ehm->ecm", expert_in, lp["w_up"])
    out_e = torch.einsum("ecm,emh->ech", F.silu(gate) * up, lp["w_down"])
    y = torch.einsum("nec,ech->nh", combine, out_e.float()).to(x.dtype)
    if cfg.num_shared_experts:
        y = y + swiglu(xt, lp["shared_gate"], lp["shared_up"], lp["shared_down"])
    return y.reshape(b, t, h)
