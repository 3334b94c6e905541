"""The port's multi-host pieces against the JAX package's, with no engine
spread over processes: the hello (JAX's ``test_hello_carries_kvbm_tier_fields``
and the field list), a rank's box and tier geometry against JAX's
``local_block_spec`` on a stub cache with ``addressable_shards`` (tp, pp
and dp up to 2), the refusals by name (ranks the nodes do not divide,
``run_in_core`` on a multi-host leader), a lost node failing the streams,
the rank placement, the framed channel's pipe contract, the leader's
discovery record, and the multi-node recipe's worker argv."""

from __future__ import annotations

import dataclasses
import socket
import types

import pytest

from dynamo_tpu.engine.cache import KVCacheSpec as JKVCacheSpec
from dynamo_tpu.kvbm import distributed as jdist
from dynamo_tpu.parallel import multihost as jmh
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine.cache import KVCacheSpec
from dynamo_tpu_torch.kvbm import distributed as tdist
from dynamo_tpu_torch.models.config import MODEL_PRESETS
from dynamo_tpu_torch.parallel import multihost as tmh
from dynamo_tpu_torch.parallel.collectives import rank_coords
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig


def box_stub(tp: int = 1, model_rank: int = 0, pp: int = 1, stage: int = 0,
             jax_spec: JKVCacheSpec | None = None):
    """A rank's group as ``local_box`` reads it (model shard, stage); with
    ``jax_spec``, a JAX cache array stub whose one addressable shard is the
    same rank's box of a [L, NB, BS, KH, D] payload."""
    if jax_spec is None:
        return types.SimpleNamespace(size=tp, rank=model_rank, pp=pp, stage=stage)
    L, KH = jax_spec.num_layers, jax_spec.num_kv_heads
    shape = (L, jax_spec.num_blocks, jax_spec.block_size, KH, jax_spec.head_dim)
    idx = (slice(stage * L // pp, (stage + 1) * L // pp), slice(None), slice(None),
           slice(model_rank * KH // tp, (model_rank + 1) * KH // tp), slice(None))
    return types.SimpleNamespace(addressable_shards=[types.SimpleNamespace(index=idx)],
                                 ndim=5, shape=shape)


# ---------------------------------------------------------------------------
# the hello
# ---------------------------------------------------------------------------

def test_hello_carries_kvbm_tier_fields():
    """JAX's case (tests/test_multihost.py): tier config shapes scheduling
    (onboarded blocks change prefill shapes), so it rides the hello."""
    cfg = TEngineConfig(model="tiny-llama", host_kv_blocks=7,
                        disk_kv_path="/tmp/x", disk_kv_bytes=123)
    out = tmh.engine_config_from_hello(tmh.leader_hello(cfg))
    assert out.host_kv_blocks == 7
    assert out.disk_kv_path == "/tmp/x"
    assert out.disk_kv_bytes == 123


def test_hello_fields_hold_jaxs_and_the_groups():
    """Every field of JAX's hello is in the port's, which adds the ones that
    shape the port's group and programs; a hello round-trips an
    EngineConfig and the model's config (dtype overrides included), and
    JAX's hello of the same settings carries the same values."""
    assert set(jmh._HELLO_FIELDS) <= set(tmh._HELLO_FIELDS)
    assert {"num_nodes", "dist_backend", "ring_prefill_threshold"} <= set(tmh._HELLO_FIELDS)
    kw = dict(model="tiny-llama", num_blocks=13, block_size=4, decode_bucket=(4, 8), tp=2,
              dp=2, decode_window=2, host_kv_blocks=64, remote_kv_addr="h:1")
    tcfg = TEngineConfig(**kw, num_nodes=2, dist_backend="gloo", warmup_mode="off")
    model = MODEL_PRESETS["tiny-llama"]
    model32 = dataclasses.replace(model, dtype="float32")
    hello = tmh.leader_hello(tcfg, model32)
    jhello = jmh.leader_hello(JEngineConfig(**kw, dtype="float32"))
    for f in jmh._HELLO_FIELDS:
        if f != "attn_impl":
            assert hello[f] == jhello[f], f
    assert hello["attn_impl"] == tmh.ATTN_IMPL
    assert tmh.engine_config_from_hello(hello) == tcfg
    assert tmh.model_config_from_hello(hello) == model32
    with pytest.raises(ValueError, match="attention implementation"):
        tmh.engine_config_from_hello({**hello, "attn_impl": "pallas"})


# ---------------------------------------------------------------------------
# the box
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tp,pp,dp", [(1, 1, 2), (2, 1, 1), (2, 1, 2), (1, 2, 1), (1, 2, 2)])
def test_local_block_spec_matches_jax(tp, pp, dp):
    """Each world rank's box: the same local layers and kv heads, and the
    same fingerprint, as JAX's ``local_block_spec`` gives a process whose
    addressable shard is that rank's (replicas over data share a box)."""
    spec = KVCacheSpec.for_model(MODEL_PRESETS["tiny-llama"], 16, 4, kv_dtype="int8")
    jspec = JKVCacheSpec(num_blocks=16, block_size=4, num_layers=spec.num_layers,
                         num_kv_heads=spec.num_kv_heads, head_dim=spec.head_dim,
                         kv_dtype="int8")
    boxes = set()
    for world in range(dp * pp * tp):
        _, s, _, _, m = rank_coords(world, tp, 1, pp, 1)
        box = tdist.local_box(box_stub(tp, m, pp, s), spec.num_layers, spec.num_kv_heads)
        local, fp = tdist.local_block_spec(spec, box)
        jlocal, jfp = jdist.local_block_spec(jspec, box_stub(tp, m, pp, s, jax_spec=jspec))
        assert fp == jfp
        assert (local.num_layers, local.num_kv_heads, local.kv_dtype) == (
            jlocal.num_layers, jlocal.num_kv_heads, jlocal.kv_dtype)
        assert local.bytes_per_block() * tp * pp == spec.bytes_per_block()
        boxes.add(box)
    assert len(boxes) == tp * pp


# ---------------------------------------------------------------------------
# refusals by name, placement
# ---------------------------------------------------------------------------

def test_ranks_the_nodes_do_not_divide_are_refused():
    with pytest.raises(ValueError, match="cannot be spread over 3 nodes"):
        tmh.node_ranks(4, 3, 0)
    with pytest.raises(ValueError, match="cannot be spread over 3 nodes"):
        teng.check_supported(TEngineConfig(tp=2, dp=2, num_nodes=3, warmup_mode="off",
                                           dist_backend="gloo"),
                             MODEL_PRESETS["tiny-llama"])
    assert [list(tmh.node_ranks(8, 2, k)) for k in range(2)] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="its op channel"):
        teng.EngineCore(TEngineConfig(tp=2, num_nodes=2, warmup_mode="off",
                                      dist_backend="gloo"), device="cpu")


async def test_run_in_core_is_refused_on_a_multi_host_leader():
    """JAX's words; named core ops still run, broadcast first."""
    core = teng.EngineCore(TEngineConfig(model="tiny-llama", block_size=4, num_blocks=32,
                                         max_model_len=64, warmup_mode="off"), device="cpu")
    sent = []
    engine = teng.AsyncTorchEngine(core, op_sink=sent.append)
    try:
        with pytest.raises(RuntimeError, match="run_in_core is not supported on a "
                                               "multi-host leader; use run_op"):
            await engine.run_in_core(lambda c: 1)
        assert await engine.abort_class(None) == 0
        assert sent[-1] == {"op": "exec", "name": "qos_abort_class",
                            "args": {"priority": None}}
    finally:
        await engine.shutdown()


async def test_a_lost_node_fails_every_stream_and_later_requests():
    """A broadcast that raises stops the engine with OpChannelDown: the
    request in hand fails with its error, and so do later ones."""
    from dynamo_tpu_torch.protocols import common as tproto
    from tests.torch_mh import _req

    core = teng.EngineCore(TEngineConfig(model="tiny-llama", block_size=4, num_blocks=32,
                                         max_model_len=64, warmup_mode="off"), device="cpu")

    def sink(op):
        raise RuntimeError("lost 1 follower node connection(s)")

    engine = teng.AsyncTorchEngine(core, op_sink=sink)
    try:
        outs = [o async for o in engine.generate(_req(tproto, [1, 2, 3], "x", 4))]
        assert outs[-1].finish_reason.value == "error" and "lost 1 follower" in outs[-1].error
        later = [o async for o in engine.generate(_req(tproto, [1, 2, 3], "y", 4))]
        assert "op channel down" in later[-1].error
        with pytest.raises(teng.OpChannelDown):
            await engine.run_op("qos_abort_class", {})
    finally:
        await engine.shutdown()


def test_frame_conn_keeps_the_pipe_contract():
    """A remote rank's channel: send/recv/poll as a pipe's, tuples back as
    tuples, EOFError once the peer is gone."""
    a, b = socket.socketpair()
    ca, cb = tmh.FrameConn(a), tmh.FrameConn(b)
    assert not cb.poll()
    ca.send(("step", (4, 1, 8, 2, True, False, False, False)))
    assert cb.poll(1.0)
    assert cb.recv() == ("step", (4, 1, 8, 2, True, False, False, False))
    cb.send(("stats", {"rank": 1, "programs": [[[4, 1], 3]]}))
    assert ca.recv() == ("stats", {"rank": 1, "programs": [[[4, 1], 3]]})
    ca.close()
    with pytest.raises(EOFError):
        cb.recv()
    cb.close()
    assert ca.frames_sent == 1 and cb.frames_recv == 1


async def test_leader_address_is_published_under_the_lease():
    from dynamo_tpu_torch.transports.client import CoordinatorClient
    from dynamo_tpu_torch.transports.coordinator import CoordinatorServer

    server = CoordinatorServer()
    await server.start()
    client = await CoordinatorClient.connect(server.url)
    try:
        with pytest.raises(TimeoutError, match="no leader address"):
            await tmh.resolve_leader_addr(client, "g", timeout=0.3)
        lease = await client.lease_grant(5.0)
        await tmh.publish_leader_addr(client, "g", "10.0.0.1:7000", 7001, lease.id)
        assert await tmh.resolve_leader_addr(client, "g") == ("10.0.0.1:7000", 7001)
        # JAX's reader of the same record
        assert await jmh.resolve_leader_addr(client, "g") == ("10.0.0.1:7000", 7001)
    finally:
        await client.close()
        await server.stop()


def test_vote_min_is_the_identity_at_one_rank():
    assert tmh.vote_min(5) == 5
    assert tmh.vote_min(5, types.SimpleNamespace(world_size=1)) == 5
    assert tmh.vote_min(5, types.SimpleNamespace(world_size=4, agree_min=lambda n: 2)) == 2


def test_recipe_of_multi_node_workers_parses_and_passes_the_checks():
    """recipes/llama-3-70b/disagg-v5e-64.yaml renders one worker process a
    node (2 prefill replicas x 4 nodes, 1 decode x 8): every rendered argv
    parses and passes ``check_worker_args`` (the engine's own checks come
    at its build)."""
    from pathlib import Path

    from dynamo_tpu_torch.components import worker
    from dynamo_tpu_torch.launch import recipe

    path = Path(__file__).resolve().parent.parent / "recipes/llama-3-70b/disagg-v5e-64.yaml"
    procs = [p for p in recipe.build_plan(recipe.load_spec(path), device="cpu").processes
             if p.module.endswith("components.worker")]
    assert len(procs) == 2 * 4 + 8
    nodes = {}
    for p in procs:
        ns = worker.parse_args(p.args)
        worker.check_worker_args(ns)
        ec = worker.engine_config(ns, None)
        nodes.setdefault(ns.multihost_group, set()).add((ns.node_rank, ec.num_nodes, ec.tp))
    assert len(nodes) == 3
    for group, seen in nodes.items():
        n = len(seen)
        assert seen == {(k, n, 16 if n == 4 else 32) for k in range(n)}, group
    # each node of them holds R / N ranks
    assert list(tmh.node_ranks(32, 8, 7)) == [28, 29, 30, 31]
