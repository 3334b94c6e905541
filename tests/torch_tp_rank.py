"""One rank of ``tests/test_torch_tp.py``'s forward twin, in a process of
its own (torch and the port only: it starts fast).

``forward_rank`` joins a gloo group of two through ``file://``, runs the
port's ``forward`` at tp=2 over this rank's shard of the params and of a
zeroed cache — a prefill chunk, then one decode step on the cache it
wrote — and returns the replicated hidden states and the gathered logits
of both steps on the pipe as numpy arrays.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.engine.cache import KVCacheSpec, allocate_cache
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.parallel.collectives import init_tp_group
from dynamo_tpu_torch.parallel.mesh import shard_params


def forward_rank(rank: int, init_method: str, cfg, params: dict, steps: list,
                 num_blocks: int, block_size: int, conn) -> None:
    """``steps``: [(token_ids, q_start, q_len, block_tables)] as numpy arrays,
    run in order on one cache."""
    group = init_tp_group(rank, 2, "gloo", init_method, torch.device("cpu"), timeout=60.0)
    try:
        shard = shard_params(params, cfg, rank, 2)
        spec = KVCacheSpec.for_model(cfg, num_blocks, block_size, kv_dtype="", tp=2)
        ck, cv = allocate_cache(spec, torch.device("cpu"))
        out = []
        for toks, qs, ql, bt in steps:
            hidden = llama.forward(shard, cfg, torch.from_numpy(toks), torch.from_numpy(qs),
                                   torch.from_numpy(ql), torch.from_numpy(bt), ck, cv,
                                   tp=group)
            logits = llama.logits_from_hidden(shard, cfg, hidden, group)
            out.append((hidden.numpy(), logits.numpy()))
        conn.send(out)
    finally:
        group.close()
        conn.close()
