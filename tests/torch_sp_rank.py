"""Seq ranks of the sequence-parallel twins (``tests/test_torch_ring_attention.py``),
each in a process of its own (torch and the port only), spawned by
``tests/torch_tp_rank.run_ranks``.

``ring_rank`` joins a gloo group of ``sp`` seq ranks through ``file://``
and runs the port's ``forward`` on the full params and a zeroed cache of
each kv dtype: a ring prefill step of fresh prompts (``sp_prefill``), then
a decode step on the cache it wrote (no ring). It sends, per kv dtype and
step, the hidden states, the calls of the attention kernel and the cache
after the step, and the ring's hops and bytes; then what one
``ring_pass`` of a tensor naming its sender brought.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.engine.cache import KVCacheSpec, allocate_cache
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.parallel.collectives import init_tp_group
from tests.torch_tp_rank import _bits


def ring_rank(rank: int, init_method: str, sp: int, cfg, params: dict, steps: list,
              kv_dtypes: tuple, num_blocks: int, block_size: int, conn) -> None:
    """``steps``: [(token_ids, q_start, q_len, block_tables, sp_prefill)] as
    numpy arrays (and a bool), run in order on one cache a kv dtype."""
    group = init_tp_group(rank, 1, "gloo", init_method, torch.device("cpu"), timeout=60.0,
                          sp=sp)
    calls = [0]
    plain = llama.paged_attention_kernel

    def counted(*a, **kw):
        calls[0] += 1
        return plain(*a, **kw)

    llama.paged_attention_kernel = counted
    try:
        out = {}
        for kv in kv_dtypes:
            spec = KVCacheSpec.for_model(cfg, num_blocks, block_size, kv_dtype=kv)
            ck, cv = allocate_cache(spec, torch.device("cpu"))
            group.reset_stats()
            res = []
            for toks, qs, ql, bt, ring in steps:
                calls[0] = 0
                hidden = llama.forward(params, cfg, torch.from_numpy(toks), torch.from_numpy(qs),
                                       torch.from_numpy(ql), torch.from_numpy(bt), ck, cv,
                                       tp=group, sp_prefill=ring)
                caches = [{k: x.numpy().copy() for k, x in c.items()} if isinstance(c, dict)
                          else _bits(c).copy() for c in (ck, cv)]
                res.append((hidden.numpy(), calls[0], caches))
            out[kv] = (res, (group.ring_hops, group.ring_bytes))
        mark = torch.full((2, 3), float(group.seq_rank))
        out["pass"] = group.ring_pass(mark).numpy()
        conn.send(out)
    finally:
        llama.paged_attention_kernel = plain
        group.close()
        conn.close()
