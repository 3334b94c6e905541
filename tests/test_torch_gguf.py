"""The port's GGUF support (``dynamo_tpu_torch/models/gguf.py``) against the
JAX package's ``dynamo_tpu/models/gguf.py``.

- ``save_gguf`` writes the JAX writer's bytes for the same F32, F16, BF16,
  Q8_0 and Q4_0 tensors and metadata; each reader reads the other's file
  to the same metadata and tensor bits (Q8_0 / Q4_0 dequantized to f32
  with the JAX reader's arithmetic).
- ``load_params_gguf``'s leaves equal JAX's leaf for leaf (bf16 bits), for
  a tied and an untied tiny-llama with Q/K in llama.cpp's interleaved-rope
  layout, and for a Q8_0 file; at tp=2 each rank's leaves are its shard.
- An engine given the ``.gguf`` path streams the JAX engine's greedy tokens
  at f32 (JAX's loaded bf16 leaves widened to f32 on both sides), and
  ``quantization="int8"`` requantizes the loaded leaves to JAX's bytes.
- ``resolve_model_config`` reads a ``.gguf`` path's config as JAX's does;
  an unknown ggml type is refused by name.
"""

from __future__ import annotations

import dataclasses
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.models import gguf as jg
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import quant as jq
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.models.config import resolve_model_config as jresolve
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.models import gguf as tg
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.models.config import resolve_model_config as tresolve
from dynamo_tpu_torch.parallel.mesh import shard_params
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_gguf import _write_tiny_llama_gguf
from tests.test_torch_engine import _req, _run, _tcfg
from tests.test_torch_quant import _assert_trees_equal, _np


def q8_0(w: np.ndarray) -> tuple[tuple[int, ...], int, bytes]:
    """llama.cpp's Q8_0 blocks of ``w`` (rows of 32-value blocks)."""
    blocks = w.astype(np.float32).reshape(-1, 32)
    d = np.abs(blocks).max(axis=1) / 127.0
    q = np.round(blocks / np.where(d == 0, 1, d)[:, None]).astype(np.int8)
    raw = np.concatenate([d.astype(np.float16)[:, None].view(np.uint8),
                          q.view(np.uint8)], axis=1)
    return w.shape, jg.GGML_Q8_0, raw.tobytes()


def q4_0(w: np.ndarray) -> tuple[tuple[int, ...], int, bytes]:
    blocks = w.astype(np.float32).reshape(-1, 32)
    d = np.abs(blocks).max(axis=1) / 7.0
    q = np.clip(np.round(blocks / np.where(d == 0, 1, d)[:, None]) + 8, 0, 15).astype(np.uint8)
    nib = q[:, :16] | (q[:, 16:] << 4)
    raw = np.concatenate([d.astype(np.float16)[:, None].view(np.uint8), nib], axis=1)
    return w.shape, jg.GGML_Q4_0, raw.tobytes()


METADATA = {"general.architecture": "llama", "general.name": "t", "llama.block_count": 2,
            "llama.rope.freq_base": 500000.0, "flag": True,
            "tokenizer.ggml.tokens": ["a", "b", "c"]}


def _tensors(rng) -> dict:
    w = rng.standard_normal((8, 64)).astype(np.float32)
    return {"f32": w, "f16": w.astype(np.float16), "bf16": w.astype(ml_dtypes.bfloat16),
            "q8": q8_0(w), "q4": q4_0(w), "vec": rng.standard_normal(32).astype(np.float32)}


def test_writer_bytes_and_readers_equal_jaxs(tmp_path):
    rng = np.random.default_rng(0)
    tensors = _tensors(rng)
    jpath, tpath = tmp_path / "j.gguf", tmp_path / "t.gguf"
    jg.save_gguf(jpath, METADATA, tensors)
    tg.save_gguf(tpath, METADATA, tensors)
    assert tpath.read_bytes() == jpath.read_bytes()
    # torch tensors (bf16 as torch.bfloat16) write the same bytes
    as_torch = {k: (v if isinstance(v, tuple) else
                    torch.from_numpy(v.view(np.int16)).view(torch.bfloat16)
                    if v.dtype.name == "bfloat16" else torch.from_numpy(v))
                for k, v in tensors.items()}
    tg.save_gguf(tmp_path / "t2.gguf", METADATA, as_torch)
    assert (tmp_path / "t2.gguf").read_bytes() == jpath.read_bytes()
    jr, tr = jg.GGUFReader(tpath), tg.GGUFReader(jpath)
    assert tr.metadata == jr.metadata and tr.names() == jr.names()
    for name in jr.names():
        want, got = np.asarray(jr.tensor(name)), tr.tensor(name)
        assert tuple(got.shape) == want.shape, name
        if want.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def test_permute_and_unpermute_equal_jaxs():
    w = np.random.default_rng(1).standard_normal((64, 24)).astype(np.float32)
    for n_heads in (2, 4):
        p = tg.permute_qk(torch.from_numpy(w), n_heads)
        np.testing.assert_array_equal(p.numpy(), jg.permute_qk(w, n_heads))
        np.testing.assert_array_equal(tg.unpermute_qk(p, n_heads).numpy(), w)


def _jax_tree(cfg, seed):
    return jl.init_params(cfg, jax.random.key(seed))


@pytest.fixture(scope="module", params=["tied", "untied"])
def gguf_file(request, tmp_path_factory):
    """A tiny-llama GGUF (Q/K permuted as llama.cpp stores them), and, for
    the untied model, its ``output.weight``."""
    tied = request.param == "tied"
    cfg = dataclasses.replace(JAX_PRESETS["tiny-llama"], tie_word_embeddings=tied)
    params = _jax_tree(cfg, 3)
    root = tmp_path_factory.mktemp("gguf")
    path = root / f"tiny-{request.param}.gguf"
    _write_tiny_llama_gguf(root / "tied.gguf" if not tied else path, cfg, params)
    if not tied:
        # the JAX fixture writes no lm_head: add it as llama.cpp names it
        r = jg.GGUFReader(root / "tied.gguf")
        tensors = {n: np.array(r.tensor(n)) for n in r.names()}
        tensors["output.weight"] = np.ascontiguousarray(
            np.asarray(params["lm_head"], np.float32).T)
        jg.save_gguf(path, dict(r.metadata), tensors)
    return str(path)


def test_load_params_leaves_equal_jaxs(gguf_file):
    jcfg, jparams = jg.load_params_gguf(gguf_file)
    tcfg, tparams = tg.load_params_gguf(gguf_file, device="cpu")
    assert dataclasses.asdict(tcfg) == {f.name: getattr(jcfg, f.name)
                                        for f in dataclasses.fields(tcfg)}
    assert dataclasses.asdict(tresolve(gguf_file)) == dataclasses.asdict(tcfg)
    assert jresolve(gguf_file) == jcfg
    _assert_trees_equal(tparams, _np(jparams))
    assert ("lm_head" in tparams) == ("untied" in gguf_file)
    assert tparams["embed"].dtype == torch.bfloat16
    # at tp=2 each rank holds its shard of the same leaves
    for rank in (0, 1):
        _, shard = tg.load_params_gguf(gguf_file, device="cpu", rank=rank, tp=2)
        want = shard_params(tparams, tcfg, rank, 2)
        _assert_trees_equal(shard, jax.tree.map(lambda t: np.asarray(
            t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()), want))


def test_a_q8_0_file_loads_as_jax_loads_it(tmp_path):
    """Every 2-D matrix as Q8_0 blocks, norms as F32: the dequantized,
    bf16-rounded leaves equal JAX's byte for byte."""
    cfg = JAX_PRESETS["tiny-llama"]
    src = tmp_path / "f32.gguf"
    _write_tiny_llama_gguf(src, cfg, _jax_tree(cfg, 5))
    r = jg.GGUFReader(src)
    tensors = {n: (q8_0(np.asarray(r.tensor(n))) if np.asarray(r.tensor(n)).ndim == 2
                   else np.asarray(r.tensor(n))) for n in r.names()}
    path = tmp_path / "q8.gguf"
    tg.save_gguf(path, dict(r.metadata), tensors)
    _, jparams = jg.load_params_gguf(path)
    _, tparams = tg.load_params_gguf(path, device="cpu")
    _assert_trees_equal(tparams, _np(jparams))


def test_unknown_ggml_type_refused(tmp_path):
    path = tmp_path / "bad.gguf"
    with open(path, "wb") as f:
        f.write(jg.MAGIC + struct.pack("<I", 3) + struct.pack("<Q", 1) + struct.pack("<Q", 1))
        jg._w_string(f, "general.architecture")
        jg._w_value(f, "llama")
        jg._w_string(f, "t")
        f.write(struct.pack("<I", 1) + struct.pack("<Q", 32) + struct.pack("<I", 12)
                + struct.pack("<Q", 0))
        f.write(b"\0" * ((-f.tell()) % jg.DEFAULT_ALIGNMENT) + b"\0" * 64)
    with pytest.raises(ValueError, match="only F32/F16/BF16/Q8_0/Q4_0"):
        tg.GGUFReader(path).tensor("t")
    with pytest.raises(ValueError, match="not a GGUF file"):
        (tmp_path / "x.gguf").write_bytes(b"NOPE" + bytes(32))
        tg.GGUFReader(tmp_path / "x.gguf")


KW = dict(block_size=4, num_blocks=64, max_batch_size=4, max_model_len=128)
PROMPTS = [list(range(7, 19)), [3, 1, 4, 1, 5, 9, 2, 6], list(range(40, 61))]


def test_engine_streams_equal_jaxs_at_f32(gguf_file):
    """The port's engine loads the ``.gguf`` path itself (its leaves rounded
    to bf16, then widened to f32); JAX's engine gets its own loader's bf16
    leaves widened to f32."""
    jcfg, jparams = jg.load_params_gguf(gguf_file)
    JAX_PRESETS[gguf_file] = dataclasses.replace(jcfg, dtype="float32")
    TORCH_PRESETS[gguf_file] = dataclasses.replace(_tcfg(jcfg), dtype="float32")
    try:
        jcore = jeng.EngineCore(JEngineConfig(model=gguf_file, **KW),
                                params=jax.tree.map(lambda x: x.astype(jnp.float32), jparams))
        tcore = teng.EngineCore(TEngineConfig(model=gguf_file, **KW), device="cpu")
        assert tcore.runner.params["embed"].dtype == torch.float32
        jreqs = [_req(jproto, p, f"r{i}", max_tokens=10) for i, p in enumerate(PROMPTS)]
        treqs = [_req(tproto, p, f"r{i}", max_tokens=10) for i, p in enumerate(PROMPTS)]
        jgot, _ = _run(jcore, jreqs)
        tgot, _ = _run(tcore, treqs)
        assert tgot == jgot
        assert all(len(v) == 10 for v in tgot.values())
    finally:
        del JAX_PRESETS[gguf_file], TORCH_PRESETS[gguf_file]


def test_int8_requantizes_the_loaded_leaves_as_jax_does(gguf_file):
    _, jparams = jg.load_params_gguf(gguf_file)
    jcfg = jresolve(gguf_file)
    want = _np(jq.quantize_params_int8(jax.tree.map(jnp.copy, jparams), jcfg))
    tcore = teng.EngineCore(TEngineConfig(model=gguf_file, quantization="int8", **KW),
                            device="cpu")
    _assert_trees_equal(tcore.runner.params, want)


def test_an_engine_refuses_a_gguf_it_cannot_read(tmp_path):
    bad = tmp_path / "bad.gguf"
    bad.write_bytes(b"GGUF" + struct.pack("<I", 9) + bytes(16))
    with pytest.raises(ValueError, match="unsupported GGUF version 9"):
        teng.EngineCore(TEngineConfig(model=str(bad), **KW), device="cpu")
