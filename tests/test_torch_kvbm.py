"""The port's KVBM tiers and block transfer against the JAX package's, on
the CPU: host and disk pools (LRU, the host → disk cascade, a disk
directory written by one package and served by the other, the purge on a
MANIFEST mismatch, a truncated file), the host block formats
(``quantize_block``, ``dequantize_block``, ``ensure_block_format`` and the
bf16 rounding, byte for byte with JAX's under hypothesis), extract/inject
against JAX's programs at every kv dtype with the cache written in place,
and the engine's offload → onboard round trip against the JAX engine's
(tiny-llama at f32 with bridged weights: greedy streams, offloaded and
onboarded block counts, prefill tokens).
"""

from __future__ import annotations

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.engine.cache import KVCacheSpec as JSpec
from dynamo_tpu.kvbm import pools as jpools
from dynamo_tpu.kvbm import transfer as jtr
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine.cache import KVCacheSpec as TSpec
from dynamo_tpu_torch.kvbm import pools as tpools
from dynamo_tpu_torch.kvbm import transfer as ttr
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.models.config import ModelConfig as TModelConfig
from dynamo_tpu_torch.models.loader import from_jax_params
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig

GEOM = dict(num_blocks=8, block_size=4, num_layers=2, num_kv_heads=2, head_dim=8)
#: the cache kinds: (model dtype, kv_dtype)
KINDS = {"float32": ("float32", "bfloat16"), "bfloat16": ("bfloat16", "bfloat16"),
         "int8": ("float32", "int8"), "int4": ("float32", "int4")}


def specs(kind: str) -> tuple[JSpec, TSpec]:
    dtype, kv = KINDS[kind]
    return JSpec(**GEOM, dtype=dtype, kv_dtype=kv), TSpec(**GEOM, dtype=dtype, kv_dtype=kv)


def float_block(rng, dtype: str = "float32") -> tuple[np.ndarray, np.ndarray]:
    """A float block as (JAX host array, port host array) of one value."""
    x = rng.standard_normal((2, GEOM["num_layers"], GEOM["block_size"],
                             GEOM["num_kv_heads"], GEOM["head_dim"])).astype(np.float32)
    if dtype == "bfloat16":
        j = x.astype(ml_dtypes.bfloat16)
        return j, j.view(np.uint16)
    return x, x


def as_bytes(block: np.ndarray) -> bytes:
    return np.ascontiguousarray(block).tobytes()


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

def test_host_pool_lru_copy_and_cascade(tmp_path):
    """LRU order, copies out of the arena, and the host → disk spill, with
    the JAX pools beside as the reference for every observable."""
    jspec, tspec = specs("bfloat16")
    rng = np.random.default_rng(0)
    blocks = [float_block(rng, "bfloat16") for _ in range(4)]
    seen = []
    for mod, spec, side, path in ((jpools, jspec, 0, tmp_path / "j"),
                                  (tpools, tspec, 1, tmp_path / "t")):
        disk = mod.DiskBlockPool(spec, path, capacity_bytes=1 << 20)
        pool = mod.HostBlockPool(spec, capacity_blocks=2, overflow=disk)
        pool.put(1, blocks[0][side])
        pool.put(2, blocks[1][side])
        got1 = pool.get(1)                      # 1 is MRU → 2 is the victim
        pool.put(3, blocks[2][side])            # evicts 2 to disk
        pool.put(4, blocks[3][side])            # evicts 1 to disk
        seen.append(([h in pool for h in (1, 2, 3, 4)], [h in disk for h in (1, 2, 3, 4)],
                     pool.stats.to_dict(), as_bytes(got1), as_bytes(disk.get(2)),
                     pool.occupancy(), disk.occupancy()))
    assert seen[0] == seen[1]
    assert seen[1][0] == [False, False, True, True] and seen[1][1] == [True, True, False, False]
    assert seen[1][3] == as_bytes(blocks[0][0])


@pytest.mark.parametrize("kind", list(KINDS))
def test_disk_directory_shared_across_packages(tmp_path, kind):
    """A disk tier written by JAX is served by the port with the same bytes
    and the same MANIFEST, and the other way round; the byte budget evicts
    the oldest file in both."""
    jspec, tspec = specs(kind)
    dtype = KINDS[kind][0]
    rng = np.random.default_rng(1)
    blocks = {h: float_block(rng, dtype) for h in (21, 22, 23)}
    if jspec.quantized:
        blocks = {h: (jtr.quantize_block(j, kind),) * 2 for h, (j, _) in blocks.items()}
    nbytes = int(np.prod(jpools.block_shape(jspec))) * jpools.block_dtype(jspec).itemsize
    assert tpools.block_shape(tspec) == jpools.block_shape(jspec)
    assert tpools.block_dtype(tspec).itemsize == jpools.block_dtype(jspec).itemsize
    jdisk = jpools.DiskBlockPool(jspec, tmp_path / "a", capacity_bytes=2 * nbytes,
                                 fingerprint="m")
    for h, (j, _) in blocks.items():
        jdisk.put(h, j)
    tdisk = tpools.DiskBlockPool(tspec, tmp_path / "a", capacity_bytes=2 * nbytes,
                                 fingerprint="m")
    assert 21 not in tdisk and len(tdisk) == 2
    for h in (22, 23):
        assert as_bytes(tdisk.get(h)) == as_bytes(blocks[h][0])
    # the port writes; JAX reads
    tdisk2 = tpools.DiskBlockPool(tspec, tmp_path / "b", fingerprint="m")
    for h, (_, t) in blocks.items():
        tdisk2.put(h, t)
    jdisk2 = jpools.DiskBlockPool(jspec, tmp_path / "b", fingerprint="m")
    assert (tmp_path / "a" / "MANIFEST").read_text() == (tmp_path / "b" / "MANIFEST").read_text()
    for h, (j, _) in blocks.items():
        assert as_bytes(jdisk2.get(h)) == as_bytes(j)


def test_disk_manifest_mismatch_purges_and_truncated_file(tmp_path):
    """Another model's (or another kv dtype's) directory is purged by the
    port as by JAX; a truncated file reads as a miss and is dropped."""
    jspec, tspec = specs("float32")
    rng = np.random.default_rng(2)
    j, t = float_block(rng)
    jpools.DiskBlockPool(jspec, tmp_path, fingerprint="model-a").put(41, j)
    assert 41 in tpools.DiskBlockPool(tspec, tmp_path, fingerprint="model-a")
    other = tpools.DiskBlockPool(tspec, tmp_path, fingerprint="model-b")
    assert 41 not in other and len(other) == 0
    tpools.DiskBlockPool(tspec, tmp_path, fingerprint="model-b").put(42, t)
    _, tq = specs("int8")
    assert len(tpools.DiskBlockPool(tq, tmp_path, fingerprint="model-b")) == 0
    disk = tpools.DiskBlockPool(tspec, tmp_path)
    disk.put(51, t)
    with open(disk._file(51), "wb") as f:
        f.write(b"short")
    assert disk.get(51) is None  # dropped, not raised
    assert 51 not in disk
    assert 51 not in tpools.DiskBlockPool(tspec, tmp_path)


# ---------------------------------------------------------------------------
# host block formats
# ---------------------------------------------------------------------------

@settings(max_examples=200, deadline=None)
@given(st.lists(st.integers(0, 2**32 - 1), min_size=1, max_size=64))
def test_bf16_rounding_matches_ml_dtypes(words):
    """f32 → bf16 bits on the host: round to nearest even, ±inf kept, every
    NaN to the quiet NaN of its sign — ``ml_dtypes``' bits, the bytes the
    JAX package's bf16 host blocks hold."""
    x = np.array(words, np.uint32).view(np.float32)
    x = np.concatenate([x, np.array([np.inf, -np.inf, np.nan, -np.nan, 0.0, -0.0],
                                    np.float32)])
    with np.errstate(invalid="ignore"):  # NaN casts warn in ml_dtypes
        want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(ttr.f32_to_bf16_bits(x), want)
    back = ttr.bf16_bits_to_f32(want)
    np.testing.assert_array_equal(back.view(np.uint32),
                                  want.view(ml_dtypes.bfloat16).astype(np.float32)
                                  .view(np.uint32))


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), scale=st.sampled_from([1e-3, 1.0, 300.0]),
       zero_head=st.booleans())
def test_block_formats_match_jax(seed, scale, zero_head):
    """quantize_block / dequantize_block / ensure_block_format: the port's
    bytes equal JAX's for int8 and int4 from f32 and bf16 blocks, back to
    f32 and bf16, and across the two quantized kinds."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, 2, 4, 2, 8)) * scale).astype(np.float32)
    if zero_head:
        x[:, :, :, 0] = 0.0  # an all-zero head: the scale's divide guard
    shape = (2, 4, 2, 8)
    for src in (x, x.astype(ml_dtypes.bfloat16)):
        tsrc = src.view(np.uint16) if src.dtype == ml_dtypes.bfloat16 else src
        for kind in ("int8", "int4"):
            jq = jtr.quantize_block(src, kind)
            assert as_bytes(ttr.quantize_block(tsrc, kind)) == as_bytes(jq)
            for out in ("float32", "bfloat16"):
                jd = jtr.dequantize_block(jq, shape, jnp.dtype(out))
                assert as_bytes(ttr.dequantize_block(jq, shape, out)) == as_bytes(jd)
            for dtype, kv in (("float32", "int8"), ("float32", "int4"),
                              ("bfloat16", "bfloat16"), ("float32", "bfloat16")):
                js = JSpec(**GEOM, dtype=dtype, kv_dtype=kv)
                ts = TSpec(**GEOM, dtype=dtype, kv_dtype=kv)
                for blk, tblk in ((jq, jq), (src, tsrc)):
                    want = jtr.ensure_block_format(blk, js)
                    if not js.quantized and want.dtype != np.dtype(jnp.dtype(dtype)):
                        continue  # JAX leaves a float block of another dtype to its caller
                    assert as_bytes(ttr.ensure_block_format(tblk, ts)) == as_bytes(want)


# ---------------------------------------------------------------------------
# extract / inject
# ---------------------------------------------------------------------------

def make_caches(kind: str, rng) -> tuple[tuple, tuple]:
    """(JAX caches, torch caches) of one content: [L, NB, BS, KH, D]."""
    L, NB, BS, KH, D = (GEOM[k] for k in ("num_layers", "num_blocks", "block_size",
                                          "num_kv_heads", "head_dim"))
    out_j, out_t = [], []
    for _ in range(2):
        if kind in ("int8", "int4"):
            dp = D // 2 if kind == "int4" else D
            q = (rng.integers(0, 256, (L, NB, BS, KH, dp)).astype(np.uint8) if kind == "int4"
                 else rng.integers(-127, 128, (L, NB, BS, KH, dp)).astype(np.int8))
            s = rng.uniform(0.01, 1.0, (L, NB, KH)).astype(np.float32)
            out_j.append({"q": jnp.asarray(q), "s": jnp.asarray(s)})
            out_t.append({"q": torch.from_numpy(q.copy()), "s": torch.from_numpy(s.copy())})
        else:
            x = rng.standard_normal((L, NB, BS, KH, D)).astype(np.float32)
            out_j.append(jnp.asarray(x, jnp.dtype(kind)))
            out_t.append(torch.from_numpy(x).to(getattr(torch, kind)))
    return tuple(out_j), tuple(out_t)


def cache_bytes(c) -> list[bytes]:
    if isinstance(c, dict):
        return [as_bytes(np.asarray(c["q"]).view(np.uint8)), as_bytes(np.asarray(c["s"]))]
    if isinstance(c, torch.Tensor):
        if c.dtype == torch.bfloat16:
            return [as_bytes(c.view(torch.int16).numpy())]
        return [as_bytes(c.numpy())]
    return [as_bytes(np.asarray(c))]


def ptrs(caches) -> list[int]:
    return [t.data_ptr() for c in caches
            for t in (c.values() if isinstance(c, dict) else [c])]


@pytest.mark.parametrize("kind", list(KINDS))
def test_extract_matches_jax_and_roundtrips_in_place(kind):
    """extract gives JAX's host blocks byte for byte; inject of them into a
    zeroed cache writes the same blocks back, in place (every cache
    tensor's ``data_ptr()`` unchanged), and leaves the others alone."""
    rng = np.random.default_rng(3)
    (jk, jv), (tk, tv) = make_caches(kind, rng)
    ids = [3, 5, 6]
    jblocks = jtr.BlockTransferEngine().extract(jk, jv, ids)
    eng = ttr.BlockTransferEngine()
    tblocks = eng.extract(tk, tv, ids)
    assert [as_bytes(b) for b in tblocks] == [as_bytes(b) for b in jblocks]
    _, (zk, zv) = make_caches(kind, np.random.default_rng(4))
    before = ptrs((zk, zv))
    untouched = [b[:, 1].clone() if not isinstance(b, dict) else b["q"][:, 1].clone()
                 for b in (zk, zv)]
    eng.inject(zk, zv, ids, tblocks)
    assert ptrs((zk, zv)) == before
    assert [as_bytes(b) for b in eng.extract(zk, zv, ids)] == [as_bytes(b) for b in tblocks]
    for c, u in zip((zk, zv), untouched):
        assert torch.equal(c[:, 1] if not isinstance(c, dict) else c["q"][:, 1], u)
    snap = eng.stats.snapshot()
    assert snap["extracts"] == 2 and snap["injects"] == 1 and snap["inject_blocks"] == 3
    assert snap["extract_bytes"] == 2 * sum(b.nbytes for b in tblocks)
    if kind in ("int8", "int4"):
        # dequant=True: float32 blocks of a quantized cache, as JAX's
        jdeq = jtr.BlockTransferEngine().extract(jk, jv, ids, dequant=True)
        tdeq = eng.extract(tk, tv, ids, dequant=True)
        assert [as_bytes(b) for b in tdeq] == [as_bytes(b) for b in jdeq]


CROSS = [("float32", "int8"), ("float32", "int4"), ("bfloat16", "int8"),
         ("int8", "int4"), ("int4", "int8"), ("int8", "float32"), ("int4", "bfloat16"),
         ("bfloat16", "float32"), ("float32", "bfloat16")]


@pytest.mark.parametrize("src,dst", CROSS)
def test_inject_across_kinds_matches_jax(src, dst):
    """Blocks of one cache kind injected into a cache of another convert at
    the boundary as in JAX. Into a float cache: packed blocks dequantized
    on the host, float blocks rounded to the cache's dtype; the whole cache
    equals JAX's after its inject. Into a quantized cache: float blocks are
    quantized on the device with ``quantize_block``'s arithmetic, so the
    injected blocks extract as the JAX host conversion
    (``ensure_block_format``: ``quantize_block``, after a host dequantize
    for the other packed kind) byte for byte and scale for scale. (JAX's
    own device quantizer is not that oracle: XLA turns its division by
    qmax into a multiply by the reciprocal, so a scale can differ from
    ``quantize_block``'s in the last bit.) Either way, the other blocks
    are untouched and the cache tensors stay where they were."""
    rng = np.random.default_rng(5)
    (jsk, jsv), _ = make_caches(src, rng)
    ids, dst_ids = [2, 4, 7], [1, 3, 5]
    jblocks = jtr.BlockTransferEngine().extract(jsk, jsv, ids)
    tblocks = [b.view(np.uint16) if b.dtype == ml_dtypes.bfloat16 else b for b in jblocks]
    (jdk, jdv), (tdk, tdv) = make_caches(dst, np.random.default_rng(6))
    keep = [k for k in range(GEOM["num_blocks"]) if k not in dst_ids]
    before_bytes = ttr.BlockTransferEngine().extract(tdk, tdv, keep)
    before = ptrs((tdk, tdv))
    ttr.BlockTransferEngine().inject(tdk, tdv, dst_ids, tblocks)
    assert ptrs((tdk, tdv)) == before
    after = ttr.BlockTransferEngine().extract(tdk, tdv, keep)
    assert [as_bytes(b) for b in after] == [as_bytes(b) for b in before_bytes]
    if dst in ("int8", "int4"):
        jspec = JSpec(**GEOM, dtype="float32", kv_dtype=dst)
        got = ttr.BlockTransferEngine().extract(tdk, tdv, dst_ids)
        assert ([as_bytes(b) for b in got]
                == [as_bytes(jtr.ensure_block_format(b, jspec)) for b in jblocks])
    else:
        jdk, jdv = jtr.BlockTransferEngine().inject(jdk, jdv, dst_ids, jblocks)
        for jc, tc in ((jdk, tdk), (jdv, tdv)):
            assert cache_bytes(tc) == cache_bytes(jc)


# ---------------------------------------------------------------------------
# engine twins: offload → onboard (tests/test_kvbm.py)
# ---------------------------------------------------------------------------

MODEL = "tiny-llama-kvbm-f32"


def _tcfg(jcfg) -> TModelConfig:
    return TModelConfig(**{f.name: getattr(jcfg, f.name)
                           for f in dataclasses.fields(TModelConfig)})


@pytest.fixture(scope="module")
def tiny32():
    """tiny-llama at f32 as a preset of both packages, with JAX's random
    weights bridged to the port."""
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32", name=MODEL)
    JAX_PRESETS[MODEL] = jcfg
    TORCH_PRESETS[MODEL] = _tcfg(jcfg)
    jp = jllama.init_params(jcfg, jax.random.key(0))
    yield jp, from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    del JAX_PRESETS[MODEL], TORCH_PRESETS[MODEL]


def engine_kw(**kw) -> dict:
    d = dict(model=MODEL, block_size=4, num_blocks=64, max_batch_size=8,
             max_model_len=256, prefill_chunk=32, decode_bucket=(4, 8))
    d.update(kw)
    return d


def cores(params, **kw):
    """(JAX EngineCore, torch EngineCore) of one config and weights."""
    jp, tp = params
    return (jeng.EngineCore(JEngineConfig(**engine_kw(**kw)), params=jp),
            teng.EngineCore(TEngineConfig(**engine_kw(**kw)), params=tp, device="cpu"))


def req(proto, prompt, rid, max_tokens=6, annotations=None, **so):
    return proto.PreprocessedRequest(
        token_ids=list(prompt), request_id=rid, annotations=dict(annotations or {}),
        stop_conditions=proto.StopConditions(max_tokens=max_tokens, ignore_eos=True),
        sampling_options=proto.SamplingOptions(temperature=so.pop("temperature", 0.0), **so))


def run(core, reqs) -> dict[str, list[int]]:
    """Drive ``core.step()`` until idle; the tokens of every request."""
    for r in reqs:
        assert core.add_request(r) is None
    got = {r.request_id: [] for r in reqs}
    for _ in range(2000):
        if not core.has_work():
            break
        for rid, out in core.step().items():
            got[rid].extend(out.token_ids)
    return got


def proto_of(core):
    return tproto if isinstance(core, teng.EngineCore) else jproto


def offload_onboard(core) -> dict:
    """tests/test_kvbm.py's round trip: prompt A, fillers that evict its
    blocks, prompt A again."""
    p = proto_of(core)
    prompt_a = list(range(100, 124))  # 24 tokens = 6 blocks of 4
    first = run(core, [req(p, prompt_a, "a1")])
    run(core, [req(p, [200 + 30 * i + j for j in range(24)], f"f{i}", 4) for i in range(4)])
    offloaded = core.kvbm.stats.offloaded_blocks
    prefill0 = core.metrics.num_prefill_tokens
    second = run(core, [req(p, prompt_a, "a2")])
    return {"first": first["a1"], "second": second["a2"], "offloaded": offloaded,
            "onboarded": core.kvbm.stats.onboarded_blocks,
            "prefill": core.metrics.num_prefill_tokens - prefill0}


@pytest.mark.parametrize("tiers", ["host", "host+disk", "disk"])
@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_engine_offload_onboard_matches_jax(tiny32, tmp_path, tiers, kv):
    """Evict → offload → onboard gives the first run's greedy continuation,
    with JAX's offloaded and onboarded counts and prefill tokens (the
    onboarded blocks are not recomputed). ``host+disk``: a 4-block host
    tier spills to disk, and the onboard reads both. The JAX engine builds
    that cascade as ``overflow=disk or remote``, which drops an empty disk
    tier (its len is 0), so its host tier never spills: the port's is held
    to the JAX engine with a host tier that holds everything, which loses
    no block either."""
    kw = {"num_blocks": 13, "kv_dtype": kv}
    jkw = dict(kw)
    if "host" in tiers:
        kw["host_kv_blocks"] = 4 if "disk" in tiers else 64
        jkw["host_kv_blocks"] = 64
    if tiers == "disk":
        jkw.update(disk_kv_path=str(tmp_path / "jax"), disk_kv_bytes=1 << 20)
    if "disk" in tiers:
        kw.update(disk_kv_path=str(tmp_path / "torch"), disk_kv_bytes=1 << 20)
    jcore, _ = cores(tiny32, **jkw)
    _, tcore = cores(tiny32, **kw)
    jres, tres = offload_onboard(jcore), offload_onboard(tcore)
    if tiers == "host+disk":
        host, disk = tcore.kvbm.tiers
        assert host.stats.evictions > 0 and disk.stats.stores == host.stats.evictions
        assert disk.stats.hits > 0
    assert tres == jres
    assert tres["offloaded"] > 0 and tres["onboarded"] > 0
    assert tres["second"] == tres["first"]
    assert tres["prefill"] < 24


@pytest.mark.parametrize("setting", [
    dict(host_kv_blocks=8), dict(disk_kv_path="DISK", disk_kv_bytes=1 << 20),
    dict(remote_kv_addr="127.0.0.1:1"), dict(session_ttl=5.0, session_tiers=False),
    dict(remote_kv_addr="127.0.0.1:1", global_prefix_cache=True),
    dict(remote_kv_addr="127.0.0.1:1", stream_ckpt_blocks=4),
])
def test_kvbm_and_session_settings_are_accepted(tiny32, tmp_path, setting):
    """The settings an earlier slice refused build an engine now, with the
    tiers, the session store and the queues the JAX engine builds for
    them (an unreachable store address included: it degrades to misses)."""
    setting = {k: (str(tmp_path) if v == "DISK" else v) for k, v in setting.items()}
    jcore, tcore = cores(tiny32, **setting)
    assert (tcore.sessions is None) == (jcore.sessions is None)
    if jcore.kvbm is None:
        assert tcore.kvbm is None
        return
    assert [t.name for t in tcore.kvbm.tiers] == [t.name for t in jcore.kvbm.tiers]
    assert (tcore.kvbm.publish_tier is None) == (jcore.kvbm.publish_tier is None)
    assert (tcore.kvbm.ckpt_tier is None) == (jcore.kvbm.ckpt_tier is None)


def test_memory_ledger_does_not_keep_an_engine_with_tiers_alive(tmp_path):
    """The process-global memory ledger holds the device pool (whose evict
    and commit hooks reach the engine) and the KVBM tiers weakly: an
    engine with a host and a disk tier is collected once dropped, weights
    and KV cache with it, and its rows then report nothing resident."""
    from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger

    core = teng.EngineCore(TEngineConfig(
        model="tiny-llama", block_size=4, num_blocks=32, max_batch_size=2, max_model_len=64,
        host_kv_blocks=8, disk_kv_path=str(tmp_path), disk_kv_bytes=1 << 20,
        allow_random_weights=True), device="cpu")
    assert core.pool.evict_hook is not None
    names = [t.name for t in core.kvbm.tiers]
    ref = weakref.ref(core.runner)
    del core
    gc.collect()
    assert ref() is None
    rows = get_mem_ledger().tier_occupancy()
    for name in ["device", *names]:
        assert rows[name]["blocks"] == 0 and rows[name]["bytes"] == 0
