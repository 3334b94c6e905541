"""The port's disaggregated prefill/decode against the JAX package's, on the
CPU (tiny-llama with JAX's random weights bridged to the port: at f32, and
at bf16 for the bf16 cache).

- The cases of tests/test_disagg.py run on the port's classes (re-bound;
  their deferred imports of ``dynamo_tpu.disagg.*`` resolve to the port's
  modules), with ``baseline_tokens`` the JAX package's aggregated engine on
  the same weights: the port's handoffs give JAX's f32 greedy streams. The
  slow process-level case has its twin here, slow too; so has
  tests/test_chaos.py's injected shard disconnect.
- Handoffs across packages, staged and streamed, at f32, bf16 and int8: a
  JAX ``KvTransferSource`` on an ``AsyncJaxEngine`` feeding the port's
  decode handler (``StreamedKvConsumer`` / ``pull_and_import``), and the
  port's source feeding JAX's. The decode stream equals the decoding
  package's own handoff from the same prefill package (exact tokens) and,
  at f32, JAX's aggregated stream; at f32 and bf16 the decode engine holds
  the prefill engine's blocks byte for byte.
- Staged bytes: the same blocks in both packages' caches stage the same
  bytes (bf16 as its bits, int8 dequantized to f32 as JAX's
  ``_extract_deq``), the same dtype name and box, in one shot and streamed.
- The shard wire across packages (a bf16 reply names "bfloat16"), a block
  frame in the port's codec (msgpack's bin32 bytes), and the memory
  ledger's ``staging`` pins of an unpulled transfer until its release or
  its TTL.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import sys
import threading
import time
import types

import jax
import ml_dtypes
import numpy as np
import pytest

from dynamo_tpu.disagg import handlers as jhandlers
from dynamo_tpu.disagg import sharded as jsharded
from dynamo_tpu.disagg import source as jsource
from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.kvbm import transfer as jtr
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch import chaos as tchaos
from dynamo_tpu_torch.disagg import handlers as thandlers
from dynamo_tpu_torch.disagg import metrics as tmetrics
from dynamo_tpu_torch.disagg import sharded as tsharded
from dynamo_tpu_torch.disagg import source as tsource
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.kvbm import transfer as ttr
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.models.loader import from_jax_params
from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger
from dynamo_tpu_torch.obs.tracer import get_tracer
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.tokens import compute_block_hashes_for_tokens
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests import test_chaos as jax_chaos_tests
from tests import test_disagg as jax_disagg_tests
from tests.test_torch_kvbm import MODEL, _tcfg, engine_kw, req, tiny32  # noqa: F401
from tests.test_torch_runtime import rebind

MODEL16 = "tiny-llama-disagg-bf16"
PROMPT = jax_disagg_tests.PROMPT          # 24 tokens = 6 blocks of 4
LONG = jax_disagg_tests.LONG_PROMPT       # 40 tokens = 10 blocks; 5 chunks of 8
DEADLINE_S = 20.0


@pytest.fixture(scope="module")
def tiny16():
    """tiny-llama at bf16 as a preset of both packages, with JAX's random
    weights bridged to the port."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="bfloat16", name=MODEL16)
    JAX_PRESETS[MODEL16] = jcfg
    TORCH_PRESETS[MODEL16] = _tcfg(jcfg)
    jp = jllama.init_params(jcfg, jax.random.key(0))
    yield jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    del JAX_PRESETS[MODEL16], TORCH_PRESETS[MODEL16]


class _Ctx:
    def is_cancelled(self):
        return False


async def until(cond, what: str, timeout: float = DEADLINE_S):
    """Await ``cond()`` (a coroutine function) until it returns something
    true; fail after ``timeout`` seconds naming ``what``."""
    deadline = time.monotonic() + timeout
    while True:
        got = await cond()
        if got:
            return got
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        await asyncio.sleep(0.02)


# ---------------------------------------------------------------------------
# tests/test_disagg.py, re-bound to the port
# ---------------------------------------------------------------------------

def port_names(params) -> dict:
    """The names tests/test_disagg.py's cases use, bound to the port (the
    engine on the CPU with the bridged weights), with the JAX package's
    aggregated engine on the same weights as ``baseline_tokens``."""
    jp, tp = params

    def tiny_config(**kw):
        return TEngineConfig(**engine_kw(**kw))

    def EngineCore(cfg):  # noqa: N802 — the JAX tests' name
        return teng.EngineCore(cfg, params=tp, device="cpu")

    def make_req(prompt=None, max_tokens=8, temperature=0.0, rid=None, **kw):
        r = tproto.PreprocessedRequest(
            token_ids=prompt or [10, 11, 12, 13, 14],
            stop_conditions=tproto.StopConditions(max_tokens=max_tokens, ignore_eos=True),
            sampling_options=tproto.SamplingOptions(temperature=temperature, **kw))
        if rid:
            r.request_id = rid
        return r

    def baseline_tokens(prompt, max_tokens=6):
        core = jeng.EngineCore(JEngineConfig(**engine_kw()), params=jp)
        out, _ = jax_disagg_tests.run_to_completion(
            core, [jax_disagg_tests.make_req(prompt=prompt, max_tokens=max_tokens, rid="b")])
        return out["b"]

    names = {"tiny_config": tiny_config, "EngineCore": EngineCore, "make_req": make_req,
             "baseline_tokens": baseline_tokens, "AsyncJaxEngine": teng.AsyncTorchEngine,
             "KvTransferSource": tsource.KvTransferSource,
             "PrefillHandler": thandlers.PrefillHandler,
             "DisaggDecodeHandler": thandlers.DisaggDecodeHandler,
             "compute_block_hashes_for_tokens": compute_block_hashes_for_tokens,
             # (a context manager: re-bind the generator it wraps)
             "capture_spans": contextlib.contextmanager(rebind(
                 jax_disagg_tests.capture_spans.__wrapped__, get_tracer=get_tracer))}
    names["_handoff_tokens"] = rebind(jax_disagg_tests._handoff_tokens, **names)
    return names


DISAGG_CASES = sorted(n for n in dir(jax_disagg_tests) if n.startswith("test_")
                      and n != "test_disagg_e2e_over_network")


@pytest.mark.parametrize("case", DISAGG_CASES)
async def test_disagg_twin(tiny32, monkeypatch, case):  # noqa: F811
    fn = rebind(getattr(jax_disagg_tests, case), **port_names(tiny32))
    monkeypatch.setitem(sys.modules, "dynamo_tpu.disagg.metrics", tmetrics)
    monkeypatch.setitem(sys.modules, "dynamo_tpu.disagg.sharded", tsharded)
    out = fn()
    if asyncio.iscoroutine(out):
        await out


def test_shard_client_survives_injected_disconnect_twin(monkeypatch):
    """tests/test_chaos.py's case on the port's chaos engine and sharded
    module: the first pull dies on an injected disconnect, the client
    reconnects and the fetch completes."""
    fn = rebind(jax_chaos_tests.test_shard_client_survives_injected_disconnect,
                chaos=tchaos)
    monkeypatch.setitem(sys.modules, "dynamo_tpu.disagg.sharded", tsharded)
    try:
        fn(42)
    finally:
        tchaos.reset()


@pytest.mark.slow
def test_disagg_e2e_over_network():
    """tests/test_disagg.py's slow case on the port: a prefill and a decode
    worker process with the KV pull riding the shard server; the decode
    worker's greedy output equals an aggregated port engine's."""
    from dynamo_tpu_torch.engine.engine import EngineCore
    from dynamo_tpu_torch.runtime.client import EndpointClient, PushRouter
    from dynamo_tpu_torch.runtime.protocols import EndpointId
    from dynamo_tpu_torch.runtime.runtime import DistributedRuntime
    from dynamo_tpu_torch.utils.config import RuntimeConfig
    from tests.test_torch_kvbm import run
    from tests.utils_process import ManagedProcess, free_port

    prompt = list(("measure twice cut once " * 2).encode())   # 46 bytes → 11 blocks of 4
    base = EngineCore(TEngineConfig(model="tiny-llama", block_size=4, num_blocks=64,
                                    max_model_len=256, max_batch_size=8), device="cpu")
    expected = run(base, [req(tproto, prompt, "b", 8)])["b"]
    coord_port = free_port()
    url = f"tcp://127.0.0.1:{coord_port}"
    coordinator = ManagedProcess(
        ["-m", "dynamo_tpu_torch.transports.coordinator", "--host", "127.0.0.1",
         "--port", str(coord_port)], name="coordinator").start()
    coordinator.wait_for_line("COORDINATOR_READY", 30)
    common = ["--coordinator", url, "--device", "cpu", "--model", "tiny-llama",
              "--block-size", "4", "--num-blocks", "64", "--max-model-len", "256",
              "--max-batch-size", "8"]
    prefill_w = ManagedProcess(["-m", "dynamo_tpu_torch.components.worker", *common,
                                "--component", "prefill", "--disagg", "prefill"],
                               name="prefill").start()
    decode_w = ManagedProcess(["-m", "dynamo_tpu_torch.components.worker", *common,
                               "--disagg", "decode",
                               "--prefill-endpoint", "dyn://dynamo.prefill.generate"],
                              name="decode").start()
    try:
        prefill_w.wait_for_line("WORKER_READY", 90)
        decode_w.wait_for_line("WORKER_READY", 90)

        async def drive():
            rt = await DistributedRuntime.create(RuntimeConfig(coordinator_url=url))
            client = await EndpointClient.create(
                rt, EndpointId.parse("dyn://dynamo.backend.generate"))
            await client.wait_for_instances(30)
            router = PushRouter(client)
            r = req(tproto, prompt, "e2e", 8)
            tokens = []
            async for out in router.generate(r.to_dict(), r.request_id):
                tokens.extend(out.get("token_ids", []))
            await client.close()
            await rt.shutdown()
            return tokens

        tokens = asyncio.run(drive())
        assert tokens == expected, f"disagg output diverged: {tokens} != {expected}"
        assert "pulled" in decode_w.logs()  # KV actually moved over TCP
    finally:
        decode_w.stop()
        prefill_w.stop()
        coordinator.stop()


# ---------------------------------------------------------------------------
# handoffs across packages
# ---------------------------------------------------------------------------

PKGS = {"jax": types.SimpleNamespace(source=jsource, handlers=jhandlers, proto=jproto),
        "torch": types.SimpleNamespace(source=tsource, handlers=thandlers, proto=tproto)}
#: cache kinds: (model preset, kv_dtype); "f32" and "bf16" hold the cache at
#: the model's dtype
KINDS = {"f32": (MODEL, "bfloat16"), "bf16": (MODEL16, "bfloat16"), "int8": (MODEL, "int8")}
LONG_HASHES = compute_block_hashes_for_tokens(LONG, 4)


def async_engine(pkg: str, params, **kw):
    jp, tp = params
    if pkg == "jax":
        return jeng.AsyncJaxEngine(jeng.EngineCore(JEngineConfig(**engine_kw(**kw)), params=jp))
    return teng.AsyncTorchEngine(teng.EngineCore(TEngineConfig(**engine_kw(**kw)), params=tp,
                                                 device="cpu"))


async def export(engine, hashes: list[int]) -> list[bytes]:
    """The engine's blocks of the chain, as their host bytes."""
    plan = await engine.run_in_core(lambda c: c.export_blocks(hashes))
    return [ttr.host_bits(np.ascontiguousarray(b)).tobytes() for _, _, b in plan]


async def handoff(params, src: str, dst: str, kind: str, stream: bool) -> dict:
    """LONG through a ``src`` prefill engine (chunks of 8) and its source
    into a ``dst`` decode engine's DisaggDecodeHandler, 6 greedy tokens:
    the decode stream, its prefill tokens, the blocks the handoff pulled,
    and both engines' blocks of the handed-off chain."""
    model, kv = KINDS[kind]
    p = async_engine(src, params, model=model, kv_dtype=kv, prefill_chunk=8)
    d = async_engine(dst, params, model=model, kv_dtype=kv)
    source = PKGS[src].source.KvTransferSource(p)
    prefill = PKGS[src].handlers.PrefillHandler(p, source, block_size=4, stream=stream)

    async def prefill_call(payload, request_id):
        async for item in prefill.generate(payload, _Ctx()):
            yield item

    decode = PKGS[dst].handlers.DisaggDecodeHandler(d, prefill_call, block_size=4)
    try:
        outs = [o async for o in decode.generate(
            req(PKGS[dst].proto, LONG, "h", 6).to_dict(), _Ctx())]
        assert decode.remote_prefills == 1 and decode.local_fallbacks == 0

        async def released():
            return not source._transfers

        await until(released, "the decode side's release ack")
        pins = await p.run_in_core(lambda c: sum(len(v) for v in c._staged_pins.values()))
        cap = (len(LONG) - 1) // 4
        return {"tokens": [t for o in outs for t in o.get("token_ids", [])],
                "decode_prefill": d.core.metrics.num_prefill_tokens, "pins_left": pins,
                "src_blocks": await export(p, LONG_HASHES[:cap]),
                "dst_blocks": await export(d, LONG_HASHES[:cap])}
    finally:
        await source.stop()
        await p.shutdown()
        await d.shutdown()


_handoffs: dict = {}


async def cached_handoff(params, src, dst, kind, stream) -> dict:
    key = (src, dst, kind, stream)
    if key not in _handoffs:
        _handoffs[key] = await handoff(params, src, dst, kind, stream)
    return _handoffs[key]


@pytest.mark.parametrize("stream", [False, True], ids=["staged", "streamed"])
@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("src,dst", [("jax", "torch"), ("torch", "jax")])
async def test_handoff_across_packages(tiny32, tiny16, src, dst, kind, stream):  # noqa: F811
    """A handoff from one package's prefill side into the other's decode
    side gives the decode stream of the decoding package's own handoff from
    the same prefill package (exact tokens), prefilling only the prompt's
    last block; at f32 it is JAX's aggregated stream. At f32 and bf16 the
    decode engine then holds the prefill engine's 9 blocks byte for byte
    (int8 stages dequantized blocks the decode side requantizes)."""
    params = tiny16 if kind == "bf16" else tiny32
    got = await cached_handoff(params, src, dst, kind, stream)
    ref = await cached_handoff(params, src, src, kind, stream)
    assert got["tokens"] == ref["tokens"] and len(got["tokens"]) == 6
    # 9 of the 10 prompt blocks handed off: the decode side computes 4 tokens
    assert got["decode_prefill"] == 4
    assert got["pins_left"] == 0
    if kind != "int8":
        assert got["dst_blocks"] == got["src_blocks"] and len(got["src_blocks"]) == 9
    if kind == "f32":
        assert got["tokens"] == port_names(tiny32)["baseline_tokens"](LONG)


# ---------------------------------------------------------------------------
# staged bytes, the wire, the memory ledger
# ---------------------------------------------------------------------------

def chain_plan(kind: str, pkg: str, prompt: list[int]) -> list:
    """Seeded blocks for ``prompt``'s chain in ``pkg``'s host format (the
    same bytes in both packages): f32, bf16 bits, packed int8."""
    rng = np.random.default_rng(7)
    hashes = compute_block_hashes_for_tokens(prompt, 4)
    plan, parent = [], None
    for h in hashes:
        x = rng.standard_normal((2, 2, 4, 2, 16)).astype(np.float32)
        if kind == "bf16":
            b = x.astype(ml_dtypes.bfloat16)
            block = b if pkg == "jax" else b.view(np.uint16)
        elif kind == "int8":
            block = (jtr if pkg == "jax" else ttr).quantize_block(x, "int8")
        else:
            block = x
        plan.append((h, parent, block))
        parent = h
    return plan


async def staged(pkg: str, params, kind: str, stream: bool) -> tuple:
    """PROMPT's chain injected into a ``pkg`` engine, then staged by its
    source (one shot, or streamed through a one-token prefill that matches
    it): the staged entry's hashes, parents, box, dtype name, shape and
    bytes."""
    model, kv = KINDS[kind]
    engine = async_engine(pkg, params, model=model, kv_dtype=kv)
    plan = chain_plan(kind, pkg, PROMPT)
    source = PKGS[pkg].source.KvTransferSource(engine)
    hashes = [h for h, _, _ in plan][:(len(PROMPT) - 1) // 4]
    try:
        assert await engine.run_in_core(lambda c: c.import_blocks(plan)) == len(plan)
        if stream:
            events: asyncio.Queue = asyncio.Queue()
            reg = await source.register_streaming("s", hashes, events)
            async for _ in engine.generate(req(PKGS[pkg].proto, PROMPT, "s", 1)):
                pass
            assert await source.finish_streaming(reg["xfer_id"]) == len(hashes)
        else:
            reg = await source.register(hashes)
        h, par, data, box, dtype = await engine.run_in_core(
            lambda c: c.staging.snapshot(reg["xfer_id"]))
        data = ttr.host_bits(np.ascontiguousarray(data))
        return list(h), list(par), tuple(box), dtype, data.shape, data.tobytes()
    finally:
        await source.stop()
        await engine.shutdown()


@pytest.mark.parametrize("stream", [False, True], ids=["staged", "streamed"])
@pytest.mark.parametrize("kind", list(KINDS))
async def test_staged_bytes_equal_jax(tiny32, tiny16, kind, stream):  # noqa: F811
    """The same 6 blocks in a JAX and a port engine of one cache kind stage
    the same 5 blocks (the last is never shipped): equal hashes, parents,
    box, dtype name ("float32", "bfloat16"; int8 stages f32) and bytes."""
    params = tiny16 if kind == "bf16" else tiny32
    got = await staged("torch", params, kind, stream)
    ref = await staged("jax", params, kind, stream)
    assert got == ref
    assert got[3] == ("bfloat16" if kind == "bf16" else "float32")
    assert got[4] == (5, 2, 2, 4, 2, 16)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("server,client", [("jax", "torch"), ("torch", "jax")])
def test_shard_wire_across_packages(server, client, kind):
    """One package's ShardServer serves a staged transfer to the other's
    fetch_slice, wave by wave and whole: the same hashes, box and bytes; a
    bf16 reply says "bfloat16" and reads back as the client's bf16 (JAX's
    ml_dtypes, the port's uint16 bits)."""
    mods = {"jax": jsharded, "torch": tsharded}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 2, 2, 4, 2, 16)).astype(np.float32)
    if kind == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    data = x.view(np.uint16) if (kind == "bf16" and server == "torch") else x
    store = mods[server].StagingStore()
    hashes, parents, box = [5, 6, 7, 8], [None, 5, 6, 7], (0, 2, 0, 2)
    store.begin("x", hashes, parents, box, "bfloat16" if kind == "bf16" else "float32")
    assert store.append("x", 0, data[:2]) and store.append("x", 2, data[2:])
    store.finalize("x", 4)
    srv = mods[server].ShardServer(store, host="127.0.0.1")
    try:
        addr = f"127.0.0.1:{srv.port}"
        for start, stop in ((0, 2), (2, 4), (None, None)):
            h, _, flat, got_box = mods[client].fetch_slice(addr, "x", box, start=start, stop=stop)
            want = x[slice(start, stop)]
            assert list(h) == hashes[slice(start, stop)] and tuple(got_box) == box
            assert flat.dtype == (np.uint16 if client == "torch" and kind == "bf16" else want.dtype)
            assert flat.tobytes() == np.ascontiguousarray(want).tobytes()
    finally:
        srv.close()


async def test_staging_pins_in_the_memory_ledger(tiny32):  # noqa: F811
    """An unpulled transfer's pins show under the memory ledger's
    ``staging`` class, and its id is live (no orphan), until
    ``release_export``; one left to the source's TTL goes the same way."""
    led = get_mem_ledger()
    led.reset()
    engine = async_engine("torch", tiny32)
    source = tsource.KvTransferSource(engine, ttl_s=0.4)
    hashes = compute_block_hashes_for_tokens(PROMPT, 4)[:5]
    try:
        async for _ in engine.generate(req(tproto, PROMPT, "p", 1)):
            pass
        params = await source.register(hashes)
        assert led.owner_blocks()["staging"] == 5
        audit = led.audit()
        assert audit["orphan_pins"] == 0 and "staging" in audit["classes_covered"]
        await source.release(params["xfer_id"])
        assert led.owner_blocks()["staging"] == 0
        # the TTL: an unpulled transfer expires and unpins
        await source.register(hashes)
        assert led.owner_blocks()["staging"] == 5
        source.start()

        async def expired():
            return not source._transfers and led.owner_blocks()["staging"] == 0

        await until(expired, "the transfer's TTL")
        assert led.audit()["orphan_pins"] == 0
        free = await engine.run_in_core(lambda c: (c.pool.num_free, len(c._staged_pins)))
        assert free[1] == 0
    finally:
        await source.stop()
        await engine.shutdown()



def test_block_frame_codec_equals_msgpack():
    """A pulled block's frame (a bin32 payload of 1 MiB, and of 512 KiB:
    bin32 too) in the port's codec is msgpack's bytes, and reads back; the
    blocking-socket framing carries it whole."""
    import socket

    import msgpack

    from dynamo_tpu_torch.transports.wire import recv_frame, send_frame
    from dynamo_tpu_torch.utils import msgpack as tmsgpack

    rng = np.random.default_rng(11)
    for n in (2**19, 2**20):
        frame = {"i": 5, "d": rng.integers(0, 256, n, dtype=np.uint8).tobytes()}
        packed = tmsgpack.packb(frame)
        assert packed == msgpack.packb(frame, use_bin_type=True)
        assert packed[packed.index(b"\xc6"):][:5] == b"\xc6" + n.to_bytes(4, "big")
        assert tmsgpack.unpackb(packed) == frame
        a, b = socket.socketpair()
        try:
            t = threading.Thread(target=send_frame, args=(a, frame))
            t.start()
            assert recv_frame(b) == frame
            t.join(10)
            a.close()
            assert recv_frame(b) is None  # clean EOF
        finally:
            a.close()
            b.close()
