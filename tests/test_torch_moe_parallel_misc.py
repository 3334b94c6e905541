"""MoE across ranks in the port, the paths around the engines: block
export at ep = 2 against tp = 1, the refusals (shown in both packages
where JAX refuses too), the launcher's ``--ep`` and a recipe's ep axis.

Tolerance: exported blocks at ep = 2 against tp = 1 within 1e-5 of the
block's largest value, plus 1e-5 (the ranks' MoE sums run in another
order, which moves the later layers' K and V in the last f32 bits).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine import engine as jeng
from dynamo_tpu.models.config import MODEL_PRESETS as JAX_PRESETS
from dynamo_tpu.models.config import ModelConfig as JModelConfig
from dynamo_tpu.protocols import common as jproto
from dynamo_tpu.utils.config import EngineConfig as JEngineConfig
from dynamo_tpu_torch.components import worker as tworker
from dynamo_tpu_torch.engine import engine as teng
from dynamo_tpu_torch.launch import recipe as trecipe
from dynamo_tpu_torch.models.config import MODEL_PRESETS as TORCH_PRESETS
from dynamo_tpu_torch.protocols import common as tproto
from dynamo_tpu_torch.utils.config import EngineConfig as TEngineConfig
from tests.test_torch_engine import ROOT, _run, _tcfg
from tests.test_torch_moe import _moe_checkpoint
from tests.test_torch_moe_parallel_engine import NAMES, _port, moe32  # noqa: F401
from tests.test_torch_tp import PROMPTS, _cfg, _reqs

EXPORT_TOL = (1e-5, 1e-5)


def test_export_blocks_at_ep2_against_tp1(moe32):  # noqa: F811
    """``export_blocks`` of an ep = 2 engine (the leader's model group
    gathers; the cache is replicated over "expert") equals tp = 1's whole
    blocks within EXPORT_TOL."""
    from dynamo_tpu_torch.tokens import TokenBlockSequence

    _, full = moe32[1]
    kw = _cfg(NAMES[1])
    hashes = TokenBlockSequence.from_tokens(PROMPTS[1], 4).sequence_hashes()
    blocks = {}
    for mesh in (dict(), dict(ep=2)):
        core = _port(full, **mesh, **kw)
        try:
            _run(core, _reqs(tproto))
            blocks[bool(mesh)] = core.export_blocks(hashes)
        finally:
            core.close()
    one, two = blocks[False], blocks[True]
    assert len(one) == len(two) == len(hashes) == 9
    rel, abs_ = EXPORT_TOL
    for (h1, p1, b1), (h2, p2, b2) in zip(one, two):
        assert (h1, p1) == (h2, p2) and b1.shape == b2.shape and b1.dtype == b2.dtype
        assert np.abs(b2 - b1).max() <= rel * np.abs(b1).max() + abs_


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

BASE = dict(block_size=4, num_blocks=16, max_batch_size=2, max_model_len=64)


def test_experts_that_do_not_divide_over_ep_are_refused_by_both_packages():
    """8 experts over ep = 3: JAX's placement of the router (on "expert")
    raises at construction; the port refuses by name before any follower
    starts."""
    with pytest.raises(ValueError, match="implies that the global size"):
        jeng.EngineCore(JEngineConfig(model="tiny-moe", **BASE, ep=3))
    with pytest.raises(ValueError, match=r"num_experts=8 does not divide over ep=3 \(JAX"):
        teng.EngineCore(TEngineConfig(model="tiny-moe", **BASE, ep=3, dist_backend="gloo",
                                      warmup_mode="off"), device="cpu")


def test_an_expert_width_that_does_not_divide_over_tp_is_refused_by_both_packages():
    name = "tiny-moe-m63"
    jcfg = dataclasses.replace(JAX_PRESETS["tiny-moe"], moe_intermediate_size=63, name=name)
    JAX_PRESETS[name], TORCH_PRESETS[name] = jcfg, _tcfg(jcfg)
    try:
        with pytest.raises(ValueError, match="implies that the global size"):
            jeng.EngineCore(JEngineConfig(model=name, **BASE, tp=2))
        with pytest.raises(ValueError, match="moe_intermediate_size=63 does not divide over tp=2"):
            teng.EngineCore(TEngineConfig(model=name, **BASE, tp=2, dist_backend="gloo",
                                          warmup_mode="off"), device="cpu")
    finally:
        del JAX_PRESETS[name], TORCH_PRESETS[name]


def test_int8_at_ep2_with_a_shared_expert_is_refused_by_both_packages(moe32):  # noqa: F811
    """JAX builds the engine but its dropless shard_map refuses the
    quantized shared expert at the first step; the port refuses by name
    at construction (ROADMAP, gaps in the reference)."""
    jp, full = moe32[1]
    kw = _cfg(NAMES[1], quantization="int8")
    core = jeng.EngineCore(JEngineConfig(**kw, ep=2), params=jax.tree.map(jnp.copy, jp))
    core.add_request(_reqs(jproto)[0])
    with pytest.raises(ValueError, match="in_specs"):
        core.step()
    with pytest.raises(ValueError, match="int8 weights at ep > 1 for a model with a shared "
                                         "expert"):
        _port(full, ep=2, **kw)


@pytest.mark.parametrize("setting,match", [
    (dict(pp=2, ep=2), "pp>1 currently composes only with dp"),
    (dict(sp=2, pp=2), "pp>1 currently composes only with dp"),
    (dict(ep=2, warmup_mode="lazy"), "CUDA graphs"),
    (dict(ep=0), "ep must be >= 1"),
    (dict(ep=2, tp_devices=(0, 0, 0)), "dp x ep x tp = 1 x 2 x 1 ranks"),
])
def test_moe_parallel_refusals(setting, match):
    kw = dict(model="tiny-moe", **BASE, dist_backend="gloo", warmup_mode="off")
    kw.update(setting)
    if "warmup_mode" in setting:
        # refused until warmup came to every mesh: ep=2 with lazy warmup
        # builds, its programs eager (on the CPU; on the card: ROADMAP 16c)
        core = teng.EngineCore(TEngineConfig(**kw), device="cpu")
        try:
            assert not core.runner.graphs and match in core.warmup()["graph_reason"]
            assert "16c" in teng.step_graphs(dataclasses.replace(
                core.engine_cfg, dist_backend="nccl"), "cuda")[1]
        finally:
            core.close()
        return
    with pytest.raises(ValueError, match=match):
        teng.EngineCore(TEngineConfig(**kw), device="cpu")


# ---------------------------------------------------------------------------
# the launcher and a recipe
# ---------------------------------------------------------------------------

def test_launcher_ep2_on_cpu(tmp_path):
    """``--ep 2`` serves a MoE checkpoint (4 experts, a shared expert) on
    the CPU over gloo; ``--ep 3`` is refused by name before any follower
    starts. (The checkpoint loads at bf16, where streams across meshes are
    no oracle: the engines above hold them at f32.)"""
    cfg = JModelConfig(name="ckpt-moe", vocab_size=64, hidden_size=16, num_layers=2,
                       num_heads=2, num_kv_heads=2, head_dim=8, num_experts=4,
                       num_experts_per_tok=2, moe_intermediate_size=24, num_shared_experts=1)
    _moe_checkpoint(tmp_path, cfg, "deepseek", seed=3)
    src = tmp_path / "prompts.jsonl"
    src.write_text(json.dumps({"prompt": "one two", "max_tokens": 6}) + "\n")
    base = [sys.executable, "-m", "dynamo_tpu_torch.launch.run", "in=batch", "out=torch",
            "--model", str(tmp_path), "--device", "cpu", "--block-size", "4",
            "--num-blocks", "64", "--max-model-len", "64", "--max-batch-size", "2",
            "--dist-backend", "gloo", "--warmup-mode", "off", "--input-jsonl", str(src)]
    res = subprocess.run(base + ["--ep", "2"], cwd=ROOT, capture_output=True, text=True,
                         timeout=180)
    assert res.returncode == 0, res.stderr[-4000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["tokens"] == 6
    res = subprocess.run(base + ["--ep", "3"], cwd=ROOT, capture_output=True, text=True,
                         timeout=180)
    assert res.returncode != 0 and "num_experts=4 does not divide over ep=3" in res.stderr


def test_a_recipe_with_an_ep_axis_plans_a_serving_worker(tmp_path):
    """A recipe whose worker mesh is {tp: 2, ep: 2} plans ``--tp 2 --ep 2``
    for the torch worker, as JAX's plan does, and the worker's CLI makes an
    EngineConfig with that mesh."""
    from dynamo_tpu.launch import recipe as jrecipe

    r = tmp_path / "moe.yaml"
    r.write_text("""
apiVersion: dynamo-tpu/v1
kind: TpuServeDeployment
metadata: {name: moe-ep}
spec:
  model: tiny-moe
  coordinator: {port: 4222}
  frontend: {port: 8080}
  workers:
    - name: w
      mesh: {tp: 2, ep: 2}
      engine: {blockSize: 4, numBlocks: 64, maxModelLen: 64}
""")
    plan = trecipe.build_plan(trecipe.load_spec(r), device="cpu")
    jplan = jrecipe.build_plan(jrecipe.load_spec(r))
    w = next(p for p in plan.processes if p.name == "w")
    jw = next(p for p in jplan.processes if p.name == "w")
    assert w.args[w.args.index("--ep") + 1] == "2" == jw.args[jw.args.index("--ep") + 1]
    ns = tworker.parse_args(w.args)
    tworker.check_worker_args(ns)
    ec = tworker.engine_config(ns, None)
    assert (ec.tp, ec.ep, ec.model) == (2, 2, "tiny-moe")
    teng.check_supported(dataclasses.replace(ec, dist_backend="gloo", warmup_mode="off"),
                         TORCH_PRESETS["tiny-moe"])
