"""The port's int8 and packed-int4 KV cache against the JAX package's, on
the CPU: nibble packing, the cache spec, the in-place quantized scatter,
the dequantizing gather, the kernel's plain version on quantized content
(against the Pallas kernel in interpret mode), the model forward and the
engine.

Tolerances, with their reasons:
- packing, spec, scatter bytes and scales: exact — the same f32 operations
  (division, not a reciprocal; round half to even; clamp before the cast)
  in the same order on both sides;
- gather: exact (one f32 product per element on both sides);
- kernel, f32: atol = rtol = 2e-5, as the f32 kernel tests of
  tests/test_torch_paged_attention.py (online vs one-pass softmax sums);
  bf16 at the bench geometry: 2e-2 (one bf16 rounding of an O(1) output);
- forward: hidden 1e-4 as tests/test_torch_llama.py; scales 1e-6
  relative; payload elements may differ by one quantum on at most 0.1% of
  them, because XLA and ATen sum a matmul in different orders and can put
  a value on the other side of a .5 rounding tie;
- engine: identical greedy streams (f32 checkpoint). int4 is held against
  JAX int4 only: the JAX int4 engine itself differs from bf16 at the first
  token on tiny-llama (ROADMAP Queue 3).

The CUDA variants run only on the card: ``chip_smoke.py`` holds them
against the plain version there.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.cache import KVCacheSpec as JSpec
from dynamo_tpu.engine.cache import allocate_cache as jalloc
from dynamo_tpu.engine.engine import EngineCore as JEngineCore
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.ops import paged_attention as jpa
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.engine.cache import KVCacheSpec as TSpec
from dynamo_tpu_torch.engine.cache import allocate_cache as talloc
from dynamo_tpu_torch.engine.cache import cache_payload
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.models.loader import from_jax_params
from dynamo_tpu_torch.ops import paged_attention as tpa
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import CKPT, ROOT, _kw, _pair, _req, _tcfg, real32  # noqa: F401

F32 = dict(atol=2e-5, rtol=2e-5)
KINDS = ["int8", "int4"]
PAYLOAD = {"int8": (np.int8, torch.int8), "int4": (np.uint8, torch.uint8)}


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def _caches(kind, nb, bs, kh, d, lead=()):
    """Zeroed JAX and port caches of one kind: ({"q", "s"}, {"q", "s"})."""
    dp = d // 2 if kind == "int4" else d
    npdt, tdt = PAYLOAD[kind]
    j = {"q": jnp.zeros(lead + (nb, bs, kh, dp), npdt),
         "s": jnp.zeros(lead + (nb, kh), jnp.float32)}
    t = {"q": torch.zeros(lead + (nb, bs, kh, dp), dtype=tdt),
         "s": torch.zeros(lead + (nb, kh), dtype=torch.float32)}
    return j, t


# ---------------------------------------------------------------------------
# int4 packing and the cache spec
# ---------------------------------------------------------------------------

def test_int4_packing_matches_jax_bit_exact():
    every_byte = np.arange(256, dtype=np.uint8).reshape(4, 64)
    np.testing.assert_array_equal(tpa.unpack_int4(_t(every_byte)).numpy(),
                                  np.asarray(jpa.unpack_int4(jnp.asarray(every_byte))))
    rng = np.random.default_rng(0)
    vals = rng.integers(-8, 8, size=(3, 5, 2, 16)).astype(np.int32)
    packed = tpa.pack_int4(_t(vals))
    assert packed.dtype == torch.uint8 and packed.shape[-1] == 8
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpa.pack_int4(jnp.asarray(vals))))
    np.testing.assert_array_equal(tpa.unpack_int4(packed).numpy(), vals)
    # split-half, not interleaved: element j + D/2 is the high nibble of byte j
    assert int(packed[0, 0, 0, 0]) == (vals[0, 0, 0, 0] & 0xF) | ((vals[0, 0, 0, 8] & 0xF) << 4)
    with pytest.raises(ValueError, match="even"):
        tpa.pack_int4(torch.zeros((2, 7), dtype=torch.int32))


@pytest.mark.parametrize("kind", KINDS)
def test_cache_spec_and_allocation_match_jax(kind):
    for name in ("tiny-llama", "llama-3-8b-lite", "llama-3-8b"):
        for dtype in ("bfloat16", "float32"):
            jcfg = dataclasses.replace(JAX_PRESETS[name], dtype=dtype)
            js, ts = JSpec.for_model(jcfg, 10, 16, kind), TSpec.for_model(_tcfg(jcfg), 10, 16, kind)
            assert (ts.quantized, ts.packed_int4) == (js.quantized, js.packed_int4) == (
                True, kind == "int4")
            assert str(ts.payload_dtype).removeprefix("torch.") == jnp.dtype(js.payload_dtype).name
            assert ts.payload_head_dim == js.payload_head_dim
            assert ts.payload_shape == js.payload_shape and ts.scale_shape == js.scale_shape
            assert ts.bytes_per_block() == js.bytes_per_block()
    spec = dict(num_blocks=8, block_size=4, num_layers=2, num_kv_heads=2, head_dim=8,
                dtype="float32", kv_dtype=kind)
    jk, jv = jalloc(JSpec(**spec), None)
    tk, tv = talloc(TSpec(**spec), torch.device("cpu"))
    for j, t in ((jk, tk), (jv, tv)):
        assert tuple(t["q"].shape) == j["q"].shape and tuple(t["s"].shape) == j["s"].shape
        assert t["q"].dtype == PAYLOAD[kind][1] and t["s"].dtype == torch.float32
        assert not t["q"].any() and not t["s"].any()
        assert cache_payload(t) is t["q"]
    with pytest.raises(ValueError, match="even head_dim"):
        TSpec(**{**spec, "head_dim": 7, "kv_dtype": "int4"}).payload_head_dim
    assert not TSpec(**{**spec, "kv_dtype": "bfloat16"}).quantized


# ---------------------------------------------------------------------------
# quantized scatter and dequantizing gather
# ---------------------------------------------------------------------------

# (slots [B, T], value scale): block size 4, blocks 1.. are real, 0 is trash
_WRITES = [
    ([[4, 5, 6, 7], [8, 9, 0, 0]], 1.0),      # fresh blocks 1 and 2 at offset 0; padding → 0
    ([[10, 11, 12, 0], [13, 0, 0, 0]], 3.0),  # mid-block append to 2 (max-merge, requant), 3 fresh
    ([[14, 15, 0, 0], [0, 0, 0, 0]], 0.2),    # append to block 3 with smaller values
    ([[4, 5, 6, 0], [16, 17, 0, 0]], 0.05),   # block 1 recycled at offset 0 (scale reset), 4 fresh
    ([[7, 0, 0, 0], [18, 19, 0, 0]], 40.0),   # append after the reset; a large update to 4
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", KINDS)
def test_quant_scatter_matches_jax_bytes_and_scales(kind, dtype):
    rng = np.random.default_rng(3)
    nb, bs, kh, d = 8, 4, 2, 16
    jc, tc = _caches(kind, nb, bs, kh, d)
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    for i, (slots, scale) in enumerate(_WRITES):
        new = (scale * rng.standard_normal((2, 4, kh, d))).astype(np.float32)
        sl = np.asarray(slots, np.int32)
        jc = jl._scatter_kv(jc, jnp.asarray(new, jd), jnp.asarray(sl))
        tl._scatter_kv(tc, _t(new).to(td), _t(sl))
        # block 0 takes the padding writes: any winner; every other block exact
        np.testing.assert_array_equal(tc["q"].numpy()[1:], np.asarray(jc["q"])[1:])
        np.testing.assert_array_equal(tc["s"].numpy()[1:], np.asarray(jc["s"])[1:])
        if i == 3:
            assert tc["s"][1].max() < 0.05, "the recycled block kept its old tenant's scale"


@pytest.mark.parametrize("kind", KINDS)
def test_dequantizing_gather_matches_jax(kind):
    rng = np.random.default_rng(4)
    nb, bs, kh, d = 8, 4, 2, 16
    jc, tc = _caches(kind, nb, bs, kh, d)
    new = rng.standard_normal((2, 8, kh, d)).astype(np.float32)
    sl = np.arange(4, 20, dtype=np.int32).reshape(2, 8)
    jc = jl._scatter_kv(jc, jnp.asarray(new), jnp.asarray(sl))
    tl._scatter_kv(tc, _t(new), _t(sl))
    bt = np.array([[1, 2], [3, 4], [2, 1]], np.int32)
    got = tl._gather_kv(tc, _t(bt))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 2 * bs, kh, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(jl._gather_kv(jc, jnp.asarray(bt))),
                               atol=1e-7, rtol=0)


# ---------------------------------------------------------------------------
# the kernel's plain version on quantized content
# ---------------------------------------------------------------------------

def _quant_case(rng, kind, b, t, h, kh, d, nb, bs, nblk, q_start=None, kv_lens=None):
    """Random q and quantized K/V content (payload + per-(block, head)
    scales), block tables over distinct physical blocks."""
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)

    def cache():
        if kind == "int8":
            payload = rng.integers(-127, 128, size=(nb, bs, kh, d)).astype(np.int8)
        else:
            payload = rng.integers(0, 256, size=(nb, bs, kh, d // 2)).astype(np.uint8)
        return payload, rng.uniform(0.002, 0.03, size=(nb, kh)).astype(np.float32)

    k, v = cache(), cache()
    bt = (rng.permutation(nb - 1)[: b * nblk].reshape(b, nblk) + 1).astype(np.int32)
    if q_start is None:
        q_start = rng.integers(0, nblk * bs - t, size=(b,))
    q_start = np.asarray(q_start, np.int32)
    kv_lens = (q_start + t if kv_lens is None else np.asarray(kv_lens)).astype(np.int32)
    return q, k, v, bt, q_start, kv_lens


def _both(case, num_splits=1, dtype="float32"):
    q, (kq, ks), (vq, vs), bt, qs, kl = case
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = jpa.paged_attention_kernel(
        jnp.asarray(q, jd), {"q": jnp.asarray(kq), "s": jnp.asarray(ks)},
        {"q": jnp.asarray(vq), "s": jnp.asarray(vs)},
        *(jnp.asarray(a) for a in (bt, qs, kl)), num_splits=num_splits, interpret=True)
    out = tpa.paged_attention(
        _t(q).to(getattr(torch, dtype)), {"q": _t(kq), "s": _t(ks)}, {"q": _t(vq), "s": _t(vs)},
        *(_t(a) for a in (bt, qs, kl)), num_splits=num_splits)
    return out.float().numpy(), np.asarray(ref, np.float32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("t,kh,h", [(1, 2, 2), (1, 2, 8), (8, 2, 8)])
def test_plain_matches_pallas_on_quant_cache(kind, t, kh, h):
    rng = np.random.default_rng(10 + t + h)
    out, ref = _both(_quant_case(rng, kind, b=3, t=t, h=h, kh=kh, d=64, nb=32, bs=16, nblk=4))
    np.testing.assert_allclose(out, ref, **F32)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_quant_ragged_with_a_zero_length_row(kind):
    rng = np.random.default_rng(11)
    case = _quant_case(rng, kind, 4, 4, 4, 2, 64, 32, 16, 4,
                       q_start=[0, 5, 17, 40], kv_lens=[4, 9, 0, 44])
    out, ref = _both(case)
    np.testing.assert_allclose(out, ref, **F32)
    assert np.isfinite(out).all() and (out[2] == 0).all()


@pytest.mark.parametrize("ns", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_plain_quant_split_k_matches_pallas(kind, ns):
    rng = np.random.default_rng(12)
    case = _quant_case(rng, kind, 4, 1, 4, 2, 64, 48, 16, 8, q_start=[0, 15, 62, 127],
                       kv_lens=[1, 16, 63, 128])
    out, ref = _both(case, num_splits=ns)
    np.testing.assert_allclose(out, ref, **F32)
    seq, _ = _both(case, num_splits=1)
    np.testing.assert_allclose(out, seq, atol=2e-6, rtol=2e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_quant_bf16_at_bench_shapes(kind):
    """bf16 q at the llama-3-8b-lite attention geometry (kh 8, d 128, bs 16)."""
    rng = np.random.default_rng(7)
    out, ref = _both(_quant_case(rng, kind, 2, 1, 8, 8, 128, 24, 16, 4), num_splits=1,
                     dtype="bfloat16")
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("kind", KINDS)
def test_wrapper_on_cpu_uses_the_plain_version_and_counts_no_launch(kind):
    rng = np.random.default_rng(9)
    q, (kq, ks), (vq, vs), bt, qs, kl = _quant_case(rng, kind, 2, 4, 4, 2, 32, 16, 16, 4)
    args = (_t(q), {"q": _t(kq), "s": _t(ks)}, {"q": _t(vq), "s": _t(vs)}, _t(bt), _t(qs), _t(kl))
    before = dict(tpa.paged_attention.launches_by_kernel)
    out = tpa.paged_attention(*args, num_splits=1)
    assert torch.equal(out, tpa.paged_attention_plain(*args, num_splits=1))
    assert tpa.paged_attention.launches_by_kernel == before
    assert tpa.cache_kind(args[1]) == kind and tpa.cache_kind(args[0]) == "float"


@pytest.mark.parametrize("kind", KINDS)
def test_kernel_input_checks(kind):
    """The checks the CUDA wrapper runs before a launch (device-independent,
    so they run here on CPU tensors): what the kernel cannot take raises."""
    rng = np.random.default_rng(8)
    q, (kq, ks), (vq, vs), bt, qs, kl = _quant_case(rng, kind, 2, 1, 4, 2, 32, 16, 16, 4)
    kc, vc = {"q": _t(kq), "s": _t(ks)}, {"q": _t(vq), "s": _t(vs)}
    rest = (_t(bt), _t(qs), _t(kl))
    tpa._check_cuda_inputs(_t(q), kc, vc, *rest)
    other = "int4" if kind == "int8" else "int8"
    bad = [
        ({"q": kc["q"].view(PAYLOAD[other][1]), "s": kc["s"]}, vc),      # mixed kinds
        ({"q": kc["q"], "s": kc["s"][:, :1].contiguous()}, vc),           # scale shape
        ({"q": kc["q"], "s": kc["s"].double()}, vc),                      # scale dtype
        (kc, _t(vq).float()),                                            # float next to quantized
    ]
    for k_bad, v_bad in bad:
        with pytest.raises((TypeError, ValueError)):
            tpa._check_cuda_inputs(_t(q), k_bad, v_bad, *rest)
    if kind == "int4":
        with pytest.raises(ValueError):  # D/2 payload against a q of another head_dim
            tpa._check_cuda_inputs(_t(q)[..., :30].contiguous(), kc, vc, *rest)


# ---------------------------------------------------------------------------
# model forward
# ---------------------------------------------------------------------------

JCFG = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype="float32")


def _payload_values(payload: np.ndarray) -> np.ndarray:
    if payload.dtype == np.uint8:
        return np.asarray(jpa.unpack_int4(jnp.asarray(payload)))
    return payload.astype(np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_forward_on_quant_cache_matches_jax(kind):
    """Two layers, prefill (ragged, with a padding row) then decode, into
    quantized caches: hidden states, scales and payload."""
    jp = jl.init_params(JCFG, jax.random.key(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp), device="cpu")
    tcfg = _tcfg(JCFG)
    rng = np.random.default_rng(5)
    L, nb, bs = JCFG.num_layers, 24, 4
    jck, tck = _caches(kind, nb, bs, JCFG.num_kv_heads, JCFG.head_dim, lead=(L,))
    jcv, tcv = _caches(kind, nb, bs, JCFG.num_kv_heads, JCFG.head_dim, lead=(L,))
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    steps = [(rng.integers(0, JCFG.vocab_size, size=(3, 8)), [0, 0, 0], [8, 5, 0]),
             (rng.integers(0, JCFG.vocab_size, size=(3, 1)), [8, 5, 0], [1, 1, 1])]
    for toks, q_start, q_len in steps:
        args = [np.asarray(a, np.int32) for a in (toks, q_start, q_len, bt)]
        jh, jck, jcv = jl.forward(jp, JCFG, *(jnp.asarray(a) for a in args), jck, jcv)
        th = tl.forward(tp, tcfg, *(_t(a) for a in args), tck, tcv)
        live = args[2] > 0
        np.testing.assert_allclose(th[live].numpy(), np.asarray(jh)[live], atol=1e-4, rtol=1e-4)
        for jc, tc in ((jck, tck), (jcv, tcv)):
            np.testing.assert_allclose(tc["s"].numpy()[:, 1:], np.asarray(jc["s"])[:, 1:],
                                       rtol=1e-6, atol=0)
            tv = _payload_values(tc["q"].numpy()[:, 1:])
            jv = _payload_values(np.asarray(jc["q"])[:, 1:])
            diff = np.abs(tv - jv)
            assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).sum())


# ---------------------------------------------------------------------------
# engine: twins of tests/test_engine.py and tests/test_kv_quant.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_quant_batch_matches_solo(real32, kind):  # noqa: F811
    probe = [10, 11, 12, 13, 14]
    solo, _, _ = _pair(real32, _kw(kv_dtype=kind), [probe], [8], jax_too=False)
    prompts = [[20 + i, 30 + i, 40 + i] for i in range(4)] + [probe]
    busy, jbusy, core = _pair(real32, _kw(kv_dtype=kind), prompts, [8] * 5)
    assert isinstance(core.runner.cache_k, dict)
    assert busy == jbusy
    assert busy["r4"] == solo["r0"]


@pytest.mark.parametrize("kind", KINDS)
def test_quant_preemption_under_block_pressure(real32, kind):  # noqa: F811
    """Preempted streams free their blocks; the blocks come back to other
    streams at offset 0, which must reset their scales. (A resumed stream
    re-quantizes its context in one prefill, not write by write, so it is
    held against JAX under the same pressure, not against a roomy run.)"""
    prompts = [list(range(10 + 20 * i, 26 + 20 * i)) for i in range(3)]
    tight, jtight, core = _pair(real32, _kw(kv_dtype=kind, num_blocks=16, max_model_len=64),
                                prompts, [30] * 3)
    assert core.sched.preemption_count > 0, "test did not exercise preemption"
    assert tight == jtight


@pytest.mark.parametrize("kind", KINDS)
def test_quant_unified_matches_legacy_greedy(real32, kind):  # noqa: F811
    prompts = [[(3 * i + j) % 100 for j in range(5 + 17 * i)] for i in range(4)]
    lens = [6 + 2 * i for i in range(4)]
    legacy, jlegacy, _ = _pair(real32, _kw(kv_dtype=kind, unified_step=False), prompts, lens)
    unified, junified, _ = _pair(real32, _kw(kv_dtype=kind), prompts, lens)
    assert legacy == jlegacy and unified == junified
    assert [len(unified[f"r{i}"]) for i in range(4)] == lens


def _tiny(**kw) -> TEngineConfig:
    d = dict(model="tiny-llama", block_size=4, num_blocks=64, max_batch_size=8,
             max_model_len=256, prefill_chunk=32, decode_bucket=(4, 8))
    d.update(kw)
    return TEngineConfig(**d)


def test_int8_engine_logprob_tolerance():
    """First-token logprob (prefill-dominated), int8 vs model precision,
    within the port (tiny-llama, bf16, random weights from seed 0)."""

    def first_lp(kv_dtype):
        core = teng.EngineCore(_tiny(kv_dtype=kv_dtype), device="cpu")
        core.add_request(_req(tproto, list(range(30, 54)), "r", 2))
        while core.has_work():
            for out in core.step().values():
                if out.log_probs:
                    return out.log_probs[0]
        raise AssertionError("no logprob emitted")

    assert abs(first_lp("int8") - first_lp("bfloat16")) < 0.05


def test_kv_dtype_validation_and_metrics(monkeypatch):
    with pytest.raises(ValueError, match="kv_dtype"):
        teng.EngineCore(_tiny(kv_dtype="fp8"), device="cpu")
    with pytest.raises(ValueError, match="kv_dtype"):
        JEngineCore(JEngineConfig(model="tiny-llama", kv_dtype="fp8"))
    odd = dataclasses.replace(TORCH_PRESETS["tiny-llama"], name="tiny-llama-odd", head_dim=15)
    monkeypatch.setitem(TORCH_PRESETS, odd.name, odd)
    with pytest.raises(ValueError, match="even"):
        teng.EngineCore(_tiny(model=odd.name, kv_dtype="int4"), device="cpu")
    for kind in KINDS:
        core = teng.EngineCore(_tiny(kv_dtype=kind), device="cpu")
        stats = core.metrics.snapshot(core.sched, core.pool)
        assert stats["kv_quant_enabled"] is True
        assert stats["kv_cache_bytes"] == (
            core.runner.spec.bytes_per_block() * core.runner.spec.num_blocks)
        assert core.runner.cache_k["q"].dtype == PAYLOAD[kind][1]
    plain = teng.EngineCore(_tiny(), device="cpu")
    assert plain.metrics.snapshot(plain.sched, plain.pool)["kv_quant_enabled"] is False


def test_launcher_kv_dtype_int8_on_cpu(tmp_path):
    src = tmp_path / "prompts.jsonl"
    src.write_text('{"prompt": "one two three four", "max_tokens": 8}\n')
    res = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=batch", "out=torch",
         "--model", str(CKPT), "--device", "cpu", "--block-size", "4",
         "--num-blocks", "64", "--max-model-len", "128", "--max-batch-size", "2",
         "--kv-dtype", "int8", "--input-jsonl", str(src)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    line = res.stdout.strip().splitlines()[-1]
    assert '" five six seven eight' in line and '"tokens": 8' in line
