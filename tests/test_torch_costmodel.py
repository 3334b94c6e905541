"""The port's cost model (``dynamo_tpu_torch/obs/costmodel.py``) against the
JAX package's, function by function.

Every public function of both copies runs on the same inputs, drawn by
hypothesis over model shapes (dense and MoE), KV and weight dtypes, QoS
classes and step geometry, each package over its own ``ModelConfig`` with
the same fields and its own ``HardwareSpec`` with the same rates (the JAX
table has no H100 row). Results must agree to 1e-12 relative: both copies
do the same float operations in the same order, so in practice they are
equal. The hardware table is the one place the copies differ: the port
adds the H100 SXM row, keyed so that only the SXM card's name
(``torch.cuda.get_device_name()``) matches it, and raises on a device it
lacks where JAX falls back to the CPU row.
"""

from __future__ import annotations

import dataclasses
import math

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.obs import costmodel as jcm
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.models.config import ModelConfig as TModelConfig
from dynamo_tpu_torch.obs import costmodel as tcm
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig

REL = 1e-12
SETTINGS = settings(max_examples=40, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])


def close(a, b) -> None:
    """Equal structures whose numbers agree to REL relative."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__
        close(dataclasses.asdict(a), dataclasses.asdict(b))
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            close(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            close(x, y)
    elif isinstance(a, float) or isinstance(b, float):
        assert math.isclose(a, b, rel_tol=REL, abs_tol=0.0) or (a == b), (a, b)
    else:
        assert a == b, (a, b)


@st.composite
def models(draw):
    """A pair of equal ModelConfigs, one per package."""
    heads = draw(st.sampled_from([4, 8, 32]))
    kv = draw(st.sampled_from([h for h in (1, 2, 4, 8) if heads % h == 0]))
    moe = draw(st.booleans())
    fields = dict(
        vocab_size=draw(st.sampled_from([512, 32000, 128256])),
        hidden_size=draw(st.sampled_from([64, 1024, 4096])),
        intermediate_size=draw(st.sampled_from([128, 2816, 14336])),
        num_layers=draw(st.integers(1, 32)),
        num_heads=heads, num_kv_heads=kv,
        head_dim=draw(st.sampled_from([16, 64, 128])),
        tie_word_embeddings=draw(st.booleans()),
        num_experts=8 if moe else 0,
        num_experts_per_tok=2 if moe else 0,
        moe_intermediate_size=draw(st.sampled_from([64, 1408])) if moe else 0,
        num_shared_experts=draw(st.integers(0, 2)) if moe else 0,
    )
    return JModelConfig(**fields), TModelConfig(**fields)


@st.composite
def hardware(draw):
    flops = draw(st.floats(1e11, 2e15))
    bw = draw(st.floats(1e10, 5e12))
    return jcm.HardwareSpec("hw", flops, bw), tcm.HardwareSpec("hw", flops, bw)


KV = st.sampled_from(["bfloat16", "int8", "int4"])
QUANT = st.sampled_from(["none", "int8"])
QOS = st.sampled_from(["interactive", "standard", "batch", "other"])
BS = st.sampled_from([4, 16, 32])


def both(name: str, *args_j, kw_j=None, args_t=None, kw_t=None, **kw):
    """Call ``name`` in each package: JAX-side args, then the port's (the
    same unless given)."""
    jr = getattr(jcm, name)(*args_j, **(kw_j or {}), **kw)
    tr = getattr(tcm, name)(*(args_t if args_t is not None else args_j), **(kw_t or {}), **kw)
    return jr, tr


def test_public_surface_is_the_same():
    assert set(tcm.__all__) == set(jcm.__all__)
    assert tcm.KV_DTYPES == jcm.KV_DTYPES
    assert tcm.QOS_ITL_SLO_SCALE == jcm.QOS_ITL_SLO_SCALE
    for const in ("DCN_BYTES_PER_S", "PREFILL_MFU", "ICI_BYTES_PER_S",
                  "RING_PREFILL_OVERHEAD_S"):
        assert getattr(tcm, const) == getattr(jcm, const)
    # every JAX row is in the port's table, unchanged, and prices a ring
    # hop at the JAX copy's link rate (the port's rows carry the hop rate)
    for key, spec in jcm.HW_SPECS.items():
        port = dataclasses.asdict(tcm.HW_SPECS[key])
        assert port.pop("ring_bytes_per_s") == jcm.ICI_BYTES_PER_S
        assert port == dataclasses.asdict(spec)


@pytest.mark.parametrize("name", [
    "NVIDIA H100 80GB HBM3", "nvidia h100 80gb hbm3"])
def test_h100_row_matches_the_sxm_card(name):
    spec = tcm.hw_spec_for(name)
    assert (spec.name, spec.peak_flops, spec.hbm_bw) == ("h100-sxm", 989e12, 3.35e12)
    # a ring hop at one direction of NVLink 4 (900 GB/s both ways), not a TPU link
    assert spec.ring_bytes_per_s == 450e9


@pytest.mark.parametrize("name", [
    "NVIDIA H100 PCIe", "NVIDIA H100 NVL", "NVIDIA A100-SXM4-80GB", "NVIDIA H200"])
def test_a_card_the_table_lacks_raises_naming_it(name):
    with pytest.raises(LookupError, match=name):
        tcm.hw_spec_for(name)
    # where the JAX copy would have priced it at the CPU row
    assert jcm.hw_spec_for(name).name == "cpu"


@pytest.mark.parametrize("kind", ["cpu", "", "TPU v5 lite", "TPU v5p", "TPU v6 lite",
                                  "TPU v4"])
def test_hw_spec_for_agrees_with_jax_on_its_rows(kind):
    jrow, trow = jcm.hw_spec_for(kind), dataclasses.asdict(tcm.hw_spec_for(kind))
    # the JAX copy prices every row's ring hop at its one link rate
    assert trow.pop("ring_bytes_per_s") == jcm.ICI_BYTES_PER_S
    close(dataclasses.asdict(jrow), trow)


def test_chip_smoke_reads_the_cost_model_row():
    """chip_smoke's bounds use the cost model's H100 row, and nothing else."""
    import chip_smoke

    spec = tcm.hw_spec_for("NVIDIA H100 80GB HBM3")
    assert chip_smoke.card_rates("NVIDIA H100 80GB HBM3") == (spec.hbm_bw, spec.peak_flops)
    with pytest.raises(LookupError):
        chip_smoke.card_rates("NVIDIA H100 PCIe")


def test_engine_on_a_card_the_table_lacks(monkeypatch):
    """prefill_chunk=0 on a card without a row raises at construction,
    naming the card; a fixed chunk builds, with the step profiler off."""
    monkeypatch.setattr(teng, "device_name", lambda device: "NVIDIA H100 PCIe")
    kw = dict(model="tiny-llama", block_size=4, num_blocks=32, max_batch_size=2,
              max_model_len=64)
    with pytest.raises(ValueError, match="NVIDIA H100 PCIe"):
        teng.EngineCore(TEngineConfig(prefill_chunk=0, **kw), device="cpu")
    core = teng.EngineCore(TEngineConfig(prefill_chunk=16, **kw), device="cpu")
    assert core._hw is None and not core.perf.enabled


def test_itl_slo_ms_is_the_jax_default():
    from dynamo_tpu.utils.config import EngineConfig as JEngineConfig

    assert TEngineConfig().itl_slo_ms == JEngineConfig().itl_slo_ms == 50.0


@SETTINGS
@given(st.integers(1, 100000), st.integers(1, 64), st.integers(1, 8),
       st.integers(1, 32), st.integers(1, 6), st.integers(1, 32))
def test_auto_num_splits(nb, batch, q_chunks, cores, min_blocks, max_splits):
    close(*both("auto_num_splits", nb, batch=batch, q_chunks=q_chunks, core_count=cores,
                min_blocks_per_split=min_blocks, max_splits=max_splits))


@SETTINGS
@given(st.integers(1, 64), st.integers(1, 512), st.sampled_from([(4, 2), (32, 8), (8, 8)]),
       st.sampled_from([16, 64, 128]), st.integers(0, 9000), BS, KV,
       st.sampled_from([2, 4]), st.integers(1, 8))
def test_paged_attention_cost(batch, t, heads, d, kv_len, bs, kv, act, ns):
    close(*both("paged_attention_cost", batch=batch, q_tokens=t, num_heads=heads[0],
                num_kv_heads=heads[1], head_dim=d, kv_len=kv_len, block_size=bs,
                kv_dtype=kv, act_bytes=act, num_splits=ns))


@SETTINGS
@given(st.integers(1, 8), st.integers(1, 8192), st.sampled_from([(4, 2), (32, 8)]),
       st.sampled_from([64, 128]), st.integers(1, 8))
def test_ring_attention_cost(batch, seq, heads, d, sp):
    close(*both("ring_attention_cost", batch=batch, seq_len=seq, num_heads=heads[0],
                num_kv_heads=heads[1], head_dim=d, sp=sp))


@SETTINGS
@given(st.integers(1, 4096), st.integers(1, 4096), st.integers(1, 4096),
       st.sampled_from([1, 2, 4]), st.sampled_from([1, 2]))
def test_dense_matmul_cost(m, n, k, ab, wb):
    close(jcm.dense_matmul_cost(m, n, k, act_bytes=ab, weight_bytes=wb, name="x"),
          tcm.dense_matmul_cost(m, n, k, act_bytes=ab, weight_bytes=wb, name="x"))


@SETTINGS
@given(models(), st.integers(1, 131072), st.integers(1, 64), st.floats(0, 1e9),
       st.floats(0, 1e6), BS, KV, QUANT, st.integers(1, 8))
def test_model_step_cost_and_total(m, tokens, rows, q_ctx, blocks, bs, kv, quant, ns):
    jm, tm = m
    kw = dict(tokens=tokens, logit_rows=rows, attn_q_ctx=q_ctx, kv_blocks=blocks,
              block_size=bs, kv_dtype=kv, quantization=quant, attn_num_splits=ns)
    jr, tr = both("model_step_cost", jm, args_t=(tm,), **kw)
    close(jr, tr)
    close(jcm.total_cost(jr), tcm.total_cost(tr))


@SETTINGS
@given(models(), hardware(), st.integers(1, 256), st.integers(1, 9000), BS, KV, QUANT,
       st.integers(1, 8))
def test_decode_prefill_and_predicted_perf(m, hw, batch, kv_len, bs, kv, quant, ns):
    jm, tm = m
    jhw, thw = hw
    close(*both("decode_step_cost", jm, args_t=(tm,), batch=batch, kv_len=kv_len,
                block_size=bs, kv_dtype=kv, quantization=quant, attn_num_splits=ns))
    close(*both("prefill_cost", jm, args_t=(tm,), batch=batch, chunk=min(kv_len, 512),
                kv_len=kv_len, block_size=bs, kv_dtype=kv, quantization=quant))
    close(*both("predicted_decode_perf", jm, jhw, args_t=(tm, thw), batch=batch,
                kv_len=kv_len, block_size=bs, kv_dtype=kv, quantization=quant,
                attn_num_splits=ns))
    close(*both("analytic_param_bytes", jm, quant, args_t=(tm, quant)))


@SETTINGS
@given(models(), hardware(), BS, KV, QUANT, st.integers(16, 8192), st.floats(0.05, 0.9),
       st.integers(1, 20000))
def test_prefix_and_session_costs(m, hw, bs, kv, quant, rep, mfu, n):
    jm, tm = m
    jhw, thw = hw
    jp, tp = both("prefix_cache_cost", jm, jhw, args_t=(tm, thw), block_size=bs,
                  kv_dtype=kv, quantization=quant, rep_prefix_tokens=rep, prefill_mfu=mfu)
    close(jp, tp)
    close([jp.seconds_per_token, jp.recompute_seconds(n), jp.pull_seconds(n // bs),
           jp.break_even_blocks()],
          [tp.seconds_per_token, tp.recompute_seconds(n), tp.pull_seconds(n // bs),
           tp.break_even_blocks()])
    js, ts = both("session_retention_cost", jm, jhw, args_t=(tm, thw), block_size=bs,
                  kv_dtype=kv, quantization=quant, rep_context_tokens=rep, prefill_mfu=mfu)
    close(js, ts)
    close([js.retained_bytes(n), js.recompute_seconds(n), js.seconds_per_gb],
          [ts.retained_bytes(n), ts.recompute_seconds(n), ts.seconds_per_gb])
    close(*both("kv_block_wire_bytes", num_layers=jm.num_layers, block_size=bs,
                num_kv_heads=jm.num_kv_heads, head_dim=jm.head_dim, kv_dtype=kv))


@SETTINGS
@given(models(), hardware(), st.integers(0, 128), st.integers(1, 8192), st.integers(0, 4096),
       st.integers(1, 8192), BS, KV, QUANT, QOS, st.floats(1e-4, 0.5))
def test_mixed_step_and_auto_chunk(m, hw, rows, dec_kv, chunk, chunk_kv, bs, kv, quant, qos,
                                   slo):
    jm, tm = m
    jhw, thw = hw
    kw = dict(decode_rows=rows, decode_kv_len=dec_kv, chunk=chunk, chunk_kv_len=chunk_kv,
              block_size=bs, kv_dtype=kv, quantization=quant)
    close(*both("mixed_step_cost", jm, args_t=(tm,), **kw))
    close(*both("mixed_step_seconds", jm, jhw, args_t=(tm, thw), **kw))
    close(*both("auto_prefill_chunk", jm, jhw, args_t=(tm, thw), itl_slo_s=slo,
                decode_rows=max(rows, 1), decode_kv_len=dec_kv, block_size=bs,
                max_chunk=chunk_kv, kv_dtype=kv, quantization=quant, qos_class=qos))


@SETTINGS
@given(models(), hardware(), st.integers(1, 20000), st.integers(1, 8),
       st.sampled_from([256, 512, 2048]), BS, KV)
def test_ring_and_chunked_prefill(m, hw, prompt, sp, chunk, bs, kv):
    jm, tm = m
    jhw, thw = hw
    close(*both("chunked_prefill_seconds", jm, jhw, args_t=(tm, thw), prompt_tokens=prompt,
                chunk=chunk, block_size=bs, kv_dtype=kv))
    close(*both("ring_prefill_seconds", jm, jhw, args_t=(tm, thw), prompt_tokens=prompt,
                sp=sp, block_size=bs, kv_dtype=kv))
    jd, td = both("ring_vs_chunked_prefill", jm, jhw, args_t=(tm, thw), prompt_tokens=prompt,
                  sp=sp, chunk=chunk, block_size=bs, kv_dtype=kv)
    close(jd, td)
    close([jd.use_ring, jd.speedup], [td.use_ring, td.speedup])
    close(*both("ring_prefill_break_even_tokens", jm, jhw, args_t=(tm, thw), sp=sp,
                chunk=chunk, block_size=bs, kv_dtype=kv, max_tokens=1 << 13))


@SETTINGS
@given(hardware(), st.floats(0, 1e16), st.floats(0, 1e12), st.floats(-1.0, 10.0))
def test_rates(hw, flops, nbytes, wall):
    jhw, thw = hw
    close(jcm.mfu(flops, wall, jhw), tcm.mfu(flops, wall, thw))
    close(jcm.bw_util(nbytes, wall, jhw), tcm.bw_util(nbytes, wall, thw))
    jc, tc = jcm.KernelCost("k", flops, nbytes), tcm.KernelCost("k", flops, nbytes)
    close(jcm.roofline_fraction(jc, wall, jhw), tcm.roofline_fraction(tc, wall, thw))
    close([jc.intensity, jc.time_bound(jhw), jc.bound(jhw), (jc + jc.scaled(0.5)).flops],
          [tc.intensity, tc.time_bound(thw), tc.bound(thw), (tc + tc.scaled(0.5)).flops])
    close(jhw.ridge_intensity, thw.ridge_intensity)


@pytest.mark.parametrize("max_model_len, slo_ms, want", [
    (8192, 50.0, {"interactive": 4096, "standard": 8192, "batch": 8192}),
    (2048, 50.0, {"interactive": 2048, "standard": 2048, "batch": 2048}),
    (8192, 10.0, {"interactive": 1024, "standard": 2048, "batch": 2048}),
])
def test_auto_chunks_on_the_h100_row(max_model_len, slo_ms, want):
    """The chunks the engine resolves for llama-3-8b-lite at 32 decode rows
    on the H100 row (the engine's call: decode_kv_len = max_model_len / 2,
    ladder cap = min(max_model_len, max_tokens_per_step=8192)), equal to
    the JAX copy's on the same row."""
    from dynamo_tpu.models.config import MODEL_PRESETS as JP
    from dynamo_tpu_torch.models.config import MODEL_PRESETS as TP

    thw = tcm.hw_spec_for("NVIDIA H100 80GB HBM3")
    jhw = jcm.HardwareSpec(thw.name, thw.peak_flops, thw.hbm_bw)
    got = {}
    for cm, cfg, hw in ((jcm, JP["llama-3-8b-lite"], jhw), (tcm, TP["llama-3-8b-lite"], thw)):
        got[cm.__name__] = {q: cm.auto_prefill_chunk(
            cfg, hw, itl_slo_s=slo_ms / 1e3, decode_rows=32,
            decode_kv_len=max_model_len // 2, block_size=16,
            max_chunk=min(max_model_len, 8192), qos_class=q)
            for q in cm.QOS_ITL_SLO_SCALE}
    assert got[tcm.__name__] == got[jcm.__name__] == want
