"""Ranks of the pipeline-parallel twins (``tests/test_torch_pp.py``,
``tests/test_torch_pp_kvbm.py``), each in a process of its own (torch and
the port only), spawned by ``tests/torch_tp_rank.run_ranks``.

``forward_pp_rank`` joins a gloo group of two pipeline stages, runs the
port's ``forward`` at pp=2 over this stage's shard of the params and of a
zeroed cache for each case (a ragged prefill chunk, then a decode step on
the cache it wrote), counting the attention kernel's calls on this stage;
it returns stage 0's final hidden states and logits, each stage's calls
and microbatches a step, and its cache. ``transfer_pp_rank`` runs the
block mover over a cache split by layers.
"""

from __future__ import annotations

import torch

from dynamo_tpu_torch.engine.cache import KVCacheSpec, allocate_cache
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.parallel.collectives import init_tp_group
from dynamo_tpu_torch.parallel.mesh import shard_params
from tests.torch_tp_rank import _bits, _numpy_tree


def forward_pp_rank(rank: int, init_method: str, cases: dict, num_blocks: int,
                    block_size: int, conn) -> None:
    """``cases``: {name: (cfg, full params, microbatches, [(token_ids,
    q_start, q_len, block_tables)...])}, each run in order on a cache of
    its own. Sends {name: ([(hidden, logits) or None a step], [(kernel
    calls, microbatches) a step], (cache_k, cache_v))}."""
    group = init_tp_group(rank, 1, "gloo", init_method, torch.device("cpu"), timeout=60.0,
                          pp=2)
    calls = [0]
    kernel = llama.paged_attention_kernel

    def counted(*args, **kw):
        calls[0] += 1
        return kernel(*args, **kw)

    llama.paged_attention_kernel = counted
    try:
        out = {}
        for name, (cfg, params, mb, steps) in cases.items():
            shard = shard_params(params, cfg, 0, 1, stage=rank, pp=2)
            spec = KVCacheSpec.for_model(cfg, num_blocks, block_size, kv_dtype="", pp=2)
            ck, cv = allocate_cache(spec, torch.device("cpu"))
            results, counts = [], []
            for toks, qs, ql, bt in steps:
                calls0, mb0 = calls[0], group.microbatches
                hidden = llama.forward(shard, cfg, torch.from_numpy(toks), torch.from_numpy(qs),
                                       torch.from_numpy(ql), torch.from_numpy(bt), ck, cv,
                                       tp=group, pp_microbatches=mb)
                counts.append((calls[0] - calls0, group.microbatches - mb0))
                if rank == 0:
                    logits = llama.logits_from_hidden(shard, cfg, hidden)
                    results.append((hidden.numpy(), logits.numpy()))
                else:
                    assert hidden is None
                    results.append(None)
            out[name] = (results, counts, (_bits(ck), _bits(cv)))
        conn.send(out)
    finally:
        group.close()
        conn.close()


def _layers(cache, rank: int, size: int):
    """Stage ``rank``'s layers of a cache [L, NB, BS, KH, D] (and of a
    quantized one's scales [L, NB, KH])."""
    if isinstance(cache, dict):
        return {k: _layers(v, rank, size) for k, v in cache.items()}
    return cache.chunk(size, dim=0)[rank].clone()


def transfer_pp_rank(rank: int, init_method: str, cases: dict, conn) -> None:
    """The block mover on stage ``rank`` of two: for each case
    (``{kind: (cache_k, cache_v, ids, [host block lists])}``, whole
    caches) this stage holds its layers; the leader extracts ``ids``
    through ``TPTransferEngine`` (packed, and dequantized for a quantized
    cache) while stage 1 serves the gathers, then every host block list
    is injected at ``ids``. Sends {kind: (extracts, the stage's caches
    after the injects)}."""
    from dynamo_tpu_torch.kvbm.transfer import (
        TPTransferEngine,
        _stacked,
        prepare_inject,
        tp_gather,
        tp_scatter,
    )

    group = init_tp_group(rank, 1, "gloo", init_method, torch.device("cpu"), timeout=60.0,
                          pp=2)
    try:
        out = {}
        for kind, (ck, cv, ids, injects) in cases.items():
            ck, cv = _layers(ck, rank, 2), _layers(cv, rank, 2)
            quant = isinstance(ck, dict)
            L, _, _, kh, _ = (ck["q"] if quant else ck).shape
            eng = TPTransferEngine(group, kh, 2 * L)
            extracts = []
            for dequant in ((False, True) if quant else (False,)):
                if group.leader:
                    extracts.append([b.tobytes() for b in eng.extract(ck, cv, ids, dequant)])
                else:
                    tp_gather(group, ck, cv, ids, dequant, kh)
            for blocks in injects:
                if group.leader:
                    eng.inject(ck, cv, ids, blocks)
                else:   # what the leader's post names: the mode, shape and dtype
                    mode, host = prepare_inject(blocks, ck, kh, 2 * L)
                    data = _stacked(host, pinned=False)
                    tp_scatter(group, ck, cv, ids, mode, tuple(data.shape), data.dtype)
            out[kind] = (extracts, *(_numpy_tree(c) if quant else _bits(c) for c in (ck, cv)))
        conn.send(out)
    finally:
        group.close()
        conn.close()
