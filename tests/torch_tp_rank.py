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
