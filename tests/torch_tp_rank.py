"""Ranks of the tensor-parallel twins (``tests/test_torch_tp.py``,
``tests/test_torch_quant.py``), each in a process of its own (torch and
the port only: it starts fast), and ``run_ranks``, which spawns them.

``forward_rank`` joins a gloo group of two through ``file://``, runs the
port's ``forward`` at tp=2 over this rank's shard of the params and of a
zeroed cache — a prefill chunk, then one decode step on the cache it
wrote — and returns the replicated hidden states and the gathered logits
of both steps on the pipe as numpy arrays. ``quantize_rank`` returns the
rank's int8 shard.
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


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.numpy()


def quantize_rank(rank: int, init_method: str, cfg, params: dict, conn) -> None:
    """Quantize this rank's shard of the float ``params`` to int8 over a
    gloo group of two (the row-parallel scales over the group) and send
    the quantized shard on the pipe as numpy arrays."""
    from dynamo_tpu_torch.models.quant import quantize_params_int8

    group = init_tp_group(rank, 2, "gloo", init_method, torch.device("cpu"), timeout=60.0)
    try:
        shard = quantize_params_int8(shard_params(params, cfg, rank, 2), cfg, tp=group)
        conn.send(_numpy_tree(shard))
    finally:
        group.close()
        conn.close()


def run_ranks(target, size: int, tmp_path, *args, timeout: float = 120.0) -> list:
    """Run ``target(rank, init_method, *args, conn)`` in ``size`` spawned
    processes over a ``file://`` rendezvous in ``tmp_path``; returns what
    each rank sent, in rank order, after every process exited with 0."""
    init = f"file://{tmp_path / 'rendezvous'}"
    ctx = torch.multiprocessing.get_context("spawn")
    procs, conns = [], []
    for rank in range(size):
        ours, theirs = ctx.Pipe()
        proc = ctx.Process(target=target, daemon=True, args=(rank, init, *args, theirs))
        proc.start()
        theirs.close()
        procs.append(proc)
        conns.append(ours)
    try:
        got = []
        for rank, conn in enumerate(conns):
            if not conn.poll(timeout):
                raise AssertionError(f"rank {rank} sent nothing within {timeout} s")
            got.append(conn.recv())
    finally:
        for proc in procs:
            proc.join(timeout=60)
            if proc.is_alive():
                proc.kill()
    codes = [p.exitcode for p in procs]
    if codes != [0] * size:
        raise AssertionError(f"rank exit codes {codes}")
    return got


def _bits(x: torch.Tensor):
    """A tensor as numpy (bf16 as its int16 bits)."""
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()


def _heads(cache, rank: int, size: int):
    """Rank ``rank``'s kv heads of a cache [L, NB, BS, KH, D] (and of a
    quantized one's scales [L, NB, KH])."""
    if isinstance(cache, dict):
        return {"q": _heads(cache["q"], rank, size),
                "s": cache["s"].chunk(size, dim=2)[rank].contiguous()}
    return cache.chunk(size, dim=3)[rank].contiguous()


def transfer_rank(rank: int, init_method: str, cases: dict, conn) -> None:
    """The sharded block mover on rank ``rank`` of two: for each case
    (``{kind: (cache_k, cache_v, ids, [(mode-named blocks)...])}``, whole
    caches) this rank holds its kv heads; the leader extracts ``ids``
    through ``TPTransferEngine`` (packed, and dequantized for a quantized
    cache) while the follower serves the gathers, then every host block
    list is injected at ``ids`` the same way. Sends {kind: (extracts, the
    rank's shard after the injects)}."""
    from dynamo_tpu_torch.kvbm.transfer import (
        TPTransferEngine,
        _stacked,
        prepare_inject,
        tp_gather,
        tp_scatter,
    )

    group = init_tp_group(rank, 2, "gloo", init_method, torch.device("cpu"), timeout=60.0)
    try:
        out = {}
        for kind, (ck, cv, ids, injects) in cases.items():
            ck, cv = _heads(ck, rank, 2), _heads(cv, rank, 2)
            kh = (ck["q"] if isinstance(ck, dict) else ck).shape[3] * 2
            eng = TPTransferEngine(group, kh)
            quant = isinstance(ck, dict)
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
                    mode, host = prepare_inject(blocks, ck, kh)
                    data = _stacked(host, pinned=False)
                    tp_scatter(group, ck, cv, ids, mode, tuple(data.shape), data.dtype)
            out[kind] = (extracts, *(_numpy_tree(c) if quant else _bits(c) for c in (ck, cv)))
            if group.leader:
                out[kind] += (eng.stats.snapshot(),)
        conn.send(out)
    finally:
        group.close()
        conn.close()
