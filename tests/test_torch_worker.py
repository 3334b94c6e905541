"""The port's worker side against the JAX package's, in process: the health
canaries and the drain protocol (the in-process cases of
tests/test_health.py and tests/test_drain.py, re-bound to the port's
classes, then run against the port's engine), ``abort_class`` against JAX's
``EngineCore.abort_class`` on the same batch, the published stats through
the port's codec, and the worker's and frontend's refusals by name.
"""

from __future__ import annotations

import asyncio
import dataclasses
from pathlib import Path

import msgpack
import pytest

import dynamo_tpu_torch.runtime.drain as tdrain
import dynamo_tpu_torch.runtime.health as thealth
from dynamo_tpu_torch.components import frontend as tfrontend
from dynamo_tpu_torch.components import worker as tworker
from dynamo_tpu_torch.engine.cache import KVCacheSpec as TSpec
from dynamo_tpu_torch.kvbm.remote import RemoteBlockPool as TRemotePool
from dynamo_tpu_torch.utils import msgpack as tmsgpack
from tests import test_drain as jax_drain_tests
from tests import test_health as jax_health_tests
from tests.test_torch_runtime import rebind

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "tests" / "data" / "tiny-real-llama"
REAL32 = "tiny-real-llama-f32-worker"


HEALTH_CASES = ["test_canary_flips_not_ready_and_recovers",
                "test_real_traffic_suppresses_canaries"]


@pytest.mark.parametrize("case", HEALTH_CASES)
async def test_health_twin(case):
    await rebind(getattr(jax_health_tests, case),
                 EndpointHealthMonitor=thealth.EndpointHealthMonitor,
                 HealthCheckConfig=thealth.HealthCheckConfig)()


def test_router_health_gating_twin():
    """tests/test_health.py's gating case on the port's KvRouter."""
    from dynamo_tpu_torch.router.kv_router import KvRouter

    r = KvRouter()
    r.update_metrics({"worker_id": 1, "ready": False, "kv_total_blocks": 64})
    r.update_metrics({"worker_id": 2, "ready": True, "kv_total_blocks": 64})
    for i in range(6):
        wid, _ = r.find_best_match(f"r{i}", list(range(32)), [1, 2])
        assert wid == 2, "routed to a NotReady worker"
        r.complete(f"r{i}")
    r.update_metrics({"worker_id": 2, "ready": False, "kv_total_blocks": 64})
    wid, _ = r.find_best_match("rz", list(range(32)), [1, 2])
    assert wid in (1, 2)


DRAIN_CASES = ["test_drain_request_roundtrip_and_keys",
               "test_drainer_runs_streams_down_then_evacuates",
               "test_drainer_batch_grace_early_stops_batch_class",
               "test_drainer_deadline_overrun_is_done_not_aborted",
               "test_drainer_operator_abort_skips_wait_and_evacuation",
               "test_drainer_survives_deregister_failure",
               "test_drainer_async_callbacks",
               "test_session_record_roundtrip"]


@pytest.mark.parametrize("case", DRAIN_CASES)
async def test_drain_twin(case):
    """The transport-free drain cases on the port's drainer; the session
    record case with the port's client against the JAX package's store."""
    fn = rebind(getattr(jax_drain_tests, case),
                DrainRequest=tdrain.DrainRequest, WorkerDrainer=tdrain.WorkerDrainer,
                drain_key=tdrain.drain_key, drain_status_key=tdrain.drain_status_key,
                get_drain_metrics=tdrain.get_drain_metrics,
                RemoteBlockPool=TRemotePool,
                SPEC=TSpec(**{f.name: getattr(jax_drain_tests.SPEC, f.name)
                              for f in dataclasses.fields(TSpec)}))
    if case == "test_session_record_roundtrip":
        store = jax_drain_tests.StoreFixture()
        try:
            fn(store)
        finally:
            store.close()
    elif asyncio.iscoroutinefunction(fn):
        await fn()
    else:
        fn()


# ---------------------------------------------------------------------------
# against the port's engine (tiny-real-llama, f32, CPU)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def real32():
    from dynamo_tpu.models import loader as jloader
    from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
    from dynamo_tpu.models.config import ModelConfig as JModelConfig
    from dynamo_tpu_torch.models import loader as tloader
    from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
    from tests.test_torch_engine import _tcfg

    jcfg = dataclasses.replace(JModelConfig.from_hf_config(str(CKPT)),
                               dtype="float32", name=REAL32)
    JAX_PRESETS[REAL32] = jcfg
    TORCH_PRESETS[REAL32] = _tcfg(jcfg)
    yield (jloader.load_params(jcfg, CKPT),
           tloader.load_params(TORCH_PRESETS[REAL32], CKPT, device="cpu"))
    del JAX_PRESETS[REAL32], TORCH_PRESETS[REAL32]


KW = dict(model=REAL32, block_size=4, num_blocks=128, max_batch_size=8,
          max_model_len=256, prefill_chunk=32, decode_bucket=(4, 8))
PRIORITIES = ["batch", "interactive", "batch", "standard", "batch", "interactive"]


def _qos_req(proto, i: int, priority: str, max_tokens: int = 40):
    return proto.PreprocessedRequest(
        token_ids=[5 + i, 9, 17, 33, 2 + i, 8, 40, 11 * i % 290 + 3], request_id=f"q{i}",
        annotations={"qos.priority": priority},
        stop_conditions=proto.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=proto.SamplingOptions(temperature=0.0))


def _abort_run(pkg: str, params, priority):
    """Six streams of mixed QoS classes, three steps, then
    ``abort_class(priority)``; returns (aborted ids, still-live ids, every
    stream to its end)."""
    if pkg == "jax":
        from dynamo_tpu.engine import engine as eng
        from dynamo_tpu.protocols import common as proto
        from dynamo_tpu.utils.config import EngineConfig
        core = eng.EngineCore(EngineConfig(**KW), params=params)
    else:
        from dynamo_tpu_torch.engine import engine as eng
        from dynamo_tpu_torch.protocols import common as proto
        from dynamo_tpu_torch.utils.config import EngineConfig
        core = eng.EngineCore(EngineConfig(**KW), params=params, device="cpu")
    got = {f"q{i}": [] for i in range(len(PRIORITIES))}
    for i, p in enumerate(PRIORITIES):
        assert core.add_request(_qos_req(proto, i, p)) is None
    for _ in range(3):
        for rid, out in core.step().items():
            got[rid].extend(out.token_ids)
    aborted = core.abort_class(priority)
    live = sorted(rid for rid, s in core._seqs.items() if s.phase.name != "FINISHED")
    for _ in range(500):
        if not core.has_work():
            break
        for rid, out in core.step().items():
            got[rid].extend(out.token_ids)
    return sorted(aborted), live, got


@pytest.mark.parametrize("priority", ["batch", "interactive", None])
def test_abort_class_equal_jax(real32, priority):
    got = _abort_run("torch", real32[1], priority)
    ref = _abort_run("jax", real32[0], priority)
    assert got == ref
    want = [f"q{i}" for i, p in enumerate(PRIORITIES) if priority in (None, p)]
    assert got[0] == want


def _engine(params):
    from dynamo_tpu_torch.engine import engine as teng
    from dynamo_tpu_torch.utils.config import EngineConfig

    return teng.build_engine(EngineConfig(**KW), params=params, device="cpu")


async def test_async_abort_class_is_qos_scoped(real32):
    """tests/test_drain.py's mocker case on the port's AsyncTorchEngine:
    abort_class("batch") stops only batch-class streams with CANCELLED,
    abort_class() the rest."""
    from dynamo_tpu_torch.protocols import common as proto

    eng = _engine(real32[1])

    async def consume(i, priority):
        fr = None
        async for d in eng.generate(_qos_req(proto, i, priority, max_tokens=200)):
            if d.finish_reason is not None:
                fr = d.finish_reason
        return fr

    try:
        t_batch = asyncio.create_task(consume(0, "batch"))
        t_inter = asyncio.create_task(consume(1, "interactive"))
        while eng.inflight < 2 or not eng.core.has_work():
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.05)
        assert await eng.abort_class("batch") == 1
        assert await asyncio.wait_for(t_batch, 10) == proto.FinishReason.CANCELLED
        assert not t_inter.done()
        assert await eng.abort_class() == 1
        assert await asyncio.wait_for(t_inter, 10) == proto.FinishReason.CANCELLED
    finally:
        await eng.shutdown()


async def test_canary_and_drain_through_the_engine(real32):
    """The worker's wiring on the port's engine: a health canary replayed
    through the handler completes (Ready), and a drain whose run-down
    early-stops the live batch stream reports it aborted."""
    from dynamo_tpu_torch.protocols import common as proto

    eng = _engine(real32[1])

    async def handler(payload, ctx):
        async for out in eng.generate(proto.PreprocessedRequest.from_dict(payload)):
            yield out.to_dict()

    mon = thealth.EndpointHealthMonitor(handler, thealth.HealthCheckConfig(
        payload=thealth.default_canary_payload(), idle_interval_s=0.1, timeout_s=5.0))
    mon.start()
    try:
        await asyncio.sleep(0.5)
        assert mon.ready
        stream = asyncio.create_task(_drain_stream(eng, proto))
        while eng.inflight < 1:
            await asyncio.sleep(0.01)
        dereg = []
        d = tdrain.WorkerDrainer(
            inflight=lambda: eng.inflight, deregister=lambda: dereg.append(1),
            evacuate=eng.evacuate_sessions, abort_batch=lambda: eng.abort_class("batch"),
            abort_all=lambda: eng.abort_class(None), deadline_s=10.0, batch_grace_s=0.1)
        rep = await d.drain(reason="test")
        assert rep.state == "done" and dereg == [1]
        assert rep.streams_aborted == 1
        assert await asyncio.wait_for(stream, 10) == proto.FinishReason.CANCELLED
    finally:
        await mon.stop()
        await eng.shutdown()


async def _drain_stream(eng, proto):
    fr = None
    async for d in eng.generate(_qos_req(proto, 3, "batch", max_tokens=200)):
        if d.finish_reason is not None:
            fr = d.finish_reason
    return fr


async def test_published_stats_pack_with_the_port_codec(real32):
    """What the worker publishes (engine stats and its ``attention``
    section) packs with the port's codec to msgpack's bytes, after a
    request ran."""
    from dynamo_tpu_torch.protocols import common as proto

    eng = _engine(real32[1])
    try:
        async for _ in eng.generate(_qos_req(proto, 0, "standard", max_tokens=4)):
            pass
        stats = {**eng.stats(), "attention": tworker.attention_stats(eng.core),
                 "worker_id": 2 ** 60 + 5, "ready": True}
        assert tmsgpack.packb(stats) == msgpack.packb(stats, use_bin_type=True)
        att = stats["attention"]
        assert att["layers"] == 2 and att["forward_steps"] > 0
        assert att["max_memory_allocated"] == 0  # no card: no kernel launches
        assert set(att["launches"]) == {"mma_bf16", "mma_int8", "mma_int4", "mma_f32",
                                        "mma_int8_f32q", "mma_int4_f32q"}
    finally:
        await eng.shutdown()


# ---------------------------------------------------------------------------
# refusals by name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,needle", [
    (["--engine", "mocker", "--disagg", "prefill"], "--disagg requires --engine torch"),
    (["--engine", "mocker", "--num-nodes", "2"], "--num-nodes > 1 requires --engine torch"),
    (["--num-nodes", "2", "--node-rank", "2"], "--node-rank 2 is not a node of --num-nodes 2"),
    (["--num-nodes", "0"], "is not a node of --num-nodes 0"),
])
def test_worker_refuses_by_name(argv, needle):
    with pytest.raises(SystemExit, match=needle):
        tworker.check_worker_args(tworker.parse_args(argv))


@pytest.mark.parametrize("role", ["prefill", "decode"])
def test_worker_takes_disagg_at_tp1(role):
    """``--disagg prefill|decode`` runs on one rank (tests/test_torch_disagg_cluster.py
    serves through both), and on two (the leader hands off whole blocks)."""
    tworker.check_worker_args(tworker.parse_args(["--disagg", role]))
    ns = tworker.parse_args(["--disagg", role, "--tp", "2", "--dp", "2",
                             "--dist-backend", "gloo", "--tp-devices", "0,0,0,0"])
    tworker.check_worker_args(ns)
    ec = tworker.engine_config(ns, None)
    assert (ec.tp, ec.dp, ec.dist_backend, ec.tp_devices) == (2, 2, "gloo", (0, 0, 0, 0))


def test_worker_keeps_jax_flags_and_defaults():
    """Every flag of the JAX worker parses on the port's, with JAX's
    default (``--engine`` aside: the port serves ``torch``); the port's own
    are the card and dtype, and its ranks' backend and cards."""
    from dynamo_tpu.components import worker as jworker

    j, t = vars(jworker.parse_args([])), vars(tworker.parse_args([]))
    assert t.pop("engine") == "torch" and j.pop("engine") == "jax"
    assert t["health_interval"] == 5.0
    for k, v in j.items():
        assert t[k] == v, k
    assert set(t) - set(j) == {"device", "dtype", "dist_backend", "tp_devices"}
    tworker.check_worker_args(tworker.parse_args([]))


def test_engine_refusals_reach_the_worker(real32):
    """The worker's engine build is the engine's (check_supported).
    ``--sp 2`` with the default ``--warmup-mode lazy``, refused until
    warmup came to every mesh (ROADMAP item 14f), builds over gloo on the
    CPU (eager programs, the reason given) and serves; nccl on the CPU is
    refused by name."""
    from dynamo_tpu_torch.engine import engine as teng
    from dynamo_tpu_torch.protocols import common as tproto
    from tests.test_torch_engine import _req, _run

    ns = tworker.parse_args(["--model", REAL32, "--sp", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="dist_backend='gloo'"):
        teng.EngineCore(tworker.engine_config(ns, None), params=real32[1], device="cpu")
    ns = tworker.parse_args(["--model", REAL32, "--sp", "2", "--device", "cpu",
                             "--dist-backend", "gloo", "--num-blocks", "64",
                             "--max-model-len", "128"])
    assert ns.warmup_mode == "lazy"
    core = teng.EngineCore(tworker.engine_config(ns, None), params=real32[1], device="cpu")
    try:
        assert "CUDA graphs" in core.warmup()["graph_reason"]
        got, fin = _run(core, [_req(tproto, [10, 11, 12, 13], "r0", 4)])
        assert fin == {"r0"} and len(got["r0"]) == 4
    finally:
        core.close()


@pytest.mark.parametrize("argv,needle", [
    (["--grpc-port", "0"], "KServe gRPC"),
    (["--grpc-port", "0", "--encoder-endpoint", "dyn://ns.encoder.encode"], "KServe gRPC"),
])
def test_frontend_refuses_by_name(argv, needle):
    with pytest.raises(SystemExit, match=needle):
        tfrontend.check_frontend_args(tfrontend.parse_args(argv))


def test_frontend_accepts_the_encoder_endpoint():
    """The remote ViT encoder is ported: ``--encoder-endpoint`` passes."""
    tfrontend.check_frontend_args(tfrontend.parse_args(
        ["--encoder-endpoint", "dyn://ns.encoder.encode"]))


def test_frontend_keeps_jax_flags_and_defaults():
    from dynamo_tpu.components import frontend as jfrontend

    assert vars(tfrontend.parse_args([])) == vars(jfrontend.parse_args([]))
    j = jfrontend.qos_config_from_args(jfrontend.parse_args([]))
    t = tfrontend.qos_config_from_args(tfrontend.parse_args([]))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_yaml_refused_by_name(tmp_path):
    """YAML plans and configs read through the port's ``yaml_lite``; what
    that reader does not read (an anchor, a tag) is refused by name."""
    from dynamo_tpu_torch.chaos.plan import ChaosPlan
    from dynamo_tpu_torch.utils.config import RuntimeConfig
    from dynamo_tpu_torch.utils.yaml_lite import YamlError

    plan = tmp_path / "plan.yaml"
    plan.write_text("seed: 1\nrules: []\n")
    assert ChaosPlan.load(str(plan)).seed == 1
    plan.write_text("seed: &s 1\nrules: []\n")
    with pytest.raises(YamlError, match="anchors are not read"):
        ChaosPlan.load(str(plan))
    (tmp_path / "plan.json").write_text('{"seed": 3, "rules": [{"point": "worker.*", '
                                        '"kind": "delay", "delay_s": 0.0}]}')
    assert ChaosPlan.load(str(tmp_path / "plan.json")).seed == 3
    cfg = tmp_path / "rt.yaml"
    cfg.write_text("namespace: x\nlease_ttl_s: 2.5  # seconds\n")
    rc = RuntimeConfig.from_settings(str(cfg))
    assert (rc.namespace, rc.lease_ttl_s) == ("x", 2.5)
    cfg.write_text("namespace: !!str x\n")
    with pytest.raises(ValueError, match="could not parse") as err:
        RuntimeConfig.from_settings(str(cfg))
    assert "tags are not read" in str(err.value.__cause__)
    (tmp_path / "rt.json").write_text('{"namespace": "x", "lease_ttl_s": 3.5}')
    rc = RuntimeConfig.from_settings(str(tmp_path / "rt.json"))
    assert (rc.namespace, rc.lease_ttl_s) == ("x", 3.5)
