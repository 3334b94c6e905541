"""The port's package boundary: the JAX→torch weight bridge, import
isolation from JAX and the JAX package, and no silent CPU fallback."""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS

ROOT = Path(__file__).resolve().parent.parent


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_from_jax_params_round_trips_bit_exact(dtype):
    from dynamo_tpu_torch.models.loader import from_jax_params

    cfg = dataclasses.replace(JAX_PRESETS["tiny-llama"], dtype=dtype)
    params_np = jax.tree.map(np.asarray, jllama.init_params(cfg, jax.random.key(3)))
    tparams = from_jax_params(params_np, device="cpu")
    jl = dict(_leaves(params_np))
    tl = dict(_leaves(tparams))
    assert jl.keys() == tl.keys()
    for path, a in jl.items():
        t = tl[path]
        assert t.dtype == getattr(torch, dtype), path
        assert tuple(t.shape) == a.shape, path
        if dtype == "bfloat16":
            back = t.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(back, a.view(np.uint16), err_msg=str(path))
        else:
            np.testing.assert_array_equal(t.numpy(), a, err_msg=str(path))


def test_port_imports_neither_jax_nor_the_jax_package():
    """Import every module of the port in a fresh interpreter: neither jax
    nor any dynamo_tpu module may land in sys.modules."""
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "dynamo_tpu_torch").rglob("*.py"))
    assert "dynamo_tpu_torch.ops.paged_attention" in mods
    code = textwrap.dedent(f"""
        import importlib, sys
        for m in {mods!r}:
            importlib.import_module(m)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.") or m == "jaxlib"
                     or m == "dynamo_tpu" or m.startswith("dynamo_tpu."))
        print("BAD", bad)
        sys.exit(1 if bad else 0)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_raise_without_cuda_unless_cpu_is_asked():
    """No silent CPU: with no card, every entry point left without a device
    raises; device='cpu' runs."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    from dynamo_tpu_torch.engine.engine import EngineCore, build_engine
    from dynamo_tpu_torch.models.config import MODEL_PRESETS
    from dynamo_tpu_torch.models.llama import init_params
    from dynamo_tpu_torch.models.loader import from_jax_params, load_params
    from dynamo_tpu_torch.utils.config import EngineConfig
    from dynamo_tpu_torch.utils.device import resolve_device

    cfg = MODEL_PRESETS["tiny-llama"]
    ec = EngineConfig(model="tiny-llama", block_size=4, num_blocks=16,
                      max_batch_size=2, max_model_len=64)
    calls = [
        lambda: resolve_device(None),
        lambda: init_params(cfg),
        lambda: load_params(cfg, ROOT / "tests" / "data" / "tiny-real-llama"),
        lambda: from_jax_params({"w": np.zeros(2, np.float32)}),
        lambda: EngineCore(ec),
        lambda: build_engine(ec),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert resolve_device("cpu").type == "cpu"
    assert EngineCore(ec, device="cpu").runner.device.type == "cpu"
    res = subprocess.run(
        [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=batch", "out=torch",
         "--model", "tiny-llama"], input='{"prompt": "hi"}\n', cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
