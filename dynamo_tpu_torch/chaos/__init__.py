"""Named fault points with deterministic, seeded fault injection.

Call sites thread a *fault point* through every layer that can fail:

    from dynamo_tpu_torch import chaos
    ...
    await chaos.ainject("transports.request", op=body.get("op"))   # async
    chaos.inject("disagg.pull", addr=addr)                        # sync

With chaos disabled (the default) both calls are a module-level no-op:
one global ``None`` check, no allocation, no locking — safe to leave in
production paths. Chaos turns on when a process is started with
``DYN_CHAOS_PLAN`` (YAML/JSON file path or inline JSON; optionally
``DYN_CHAOS_SEED`` overriding the plan's seed) or when a harness calls
:func:`configure` directly. See docs/CHAOS.md for the fault-point
catalog, the plan DSL, and the seed-replay workflow.

Copy of ``dynamo_tpu/chaos/__init__.py``.
"""

from __future__ import annotations

import os
import time
from typing import Any

from dynamo_tpu_torch.chaos.injector import ChaosEngine, ChaosInjectedError, Injection
from dynamo_tpu_torch.chaos.plan import FAULT_KINDS, ChaosPlan, ChaosRule

__all__ = [
    "FAULT_KINDS", "ChaosEngine", "ChaosInjectedError", "ChaosPlan",
    "ChaosRule", "Injection", "ainject", "configure", "configure_from_env",
    "enabled", "engine", "inject", "injection_log", "reset",
]

SEED_ENV = "DYN_CHAOS_SEED"
PLAN_ENV = "DYN_CHAOS_PLAN"

_engine: ChaosEngine | None = None


def configure(plan: "ChaosPlan | dict | str", seed: int | None = None) -> ChaosEngine:
    """Enable chaos for this process. ``plan`` is a ChaosPlan, a dict, a
    file path, or inline JSON; ``seed`` (if given) overrides the plan's."""
    global _engine
    if not isinstance(plan, ChaosPlan):
        plan = ChaosPlan.load(plan)
    if seed is not None:
        plan = ChaosPlan(seed=seed, rules=plan.rules)
    _engine = ChaosEngine(plan)
    return _engine


def configure_from_env(env: "dict[str, str] | None" = None) -> ChaosEngine | None:
    """Enable chaos iff DYN_CHAOS_PLAN is set (DYN_CHAOS_SEED optional)."""
    e = os.environ if env is None else env
    spec = e.get(PLAN_ENV)
    if not spec:
        return None
    seed_s = e.get(SEED_ENV)
    return configure(spec, seed=int(seed_s) if seed_s else None)


def reset() -> None:
    """Disable chaos (tests)."""
    global _engine
    _engine = None


def enabled() -> bool:
    return _engine is not None


def engine() -> ChaosEngine | None:
    return _engine


def injection_log() -> list[tuple]:
    """Ordered (seq, point, kind, rule, hit) tuples injected so far."""
    return _engine.log_keys() if _engine is not None else []


def _record(inj: Injection) -> None:
    from dynamo_tpu_torch.chaos.metrics import get_chaos_metrics

    get_chaos_metrics().record(inj.point, inj.kind)


def inject(point: str, **ctx: Any) -> None:
    """Synchronous fault point. No-op unless chaos is configured."""
    eng = _engine
    if eng is None:
        return
    inj = eng.decide(point, ctx)
    if inj is None:
        return
    _record(inj)
    rule = eng.rule_for(inj)
    if inj.kind == "delay":
        time.sleep(rule.delay_s)
        return
    if inj.kind == "hang":
        time.sleep(rule.hang_s)
        return
    eng.apply_terminal(inj)


async def ainject(point: str, **ctx: Any) -> None:
    """Async fault point: sleeps cooperatively. No-op unless configured."""
    eng = _engine
    if eng is None:
        return
    inj = eng.decide(point, ctx)
    if inj is None:
        return
    _record(inj)
    rule = eng.rule_for(inj)
    if inj.kind == "delay":
        import asyncio

        await asyncio.sleep(rule.delay_s)
        return
    if inj.kind == "hang":
        import asyncio

        await asyncio.sleep(rule.hang_s)
        return
    eng.apply_terminal(inj)


# Subprocesses (workers, frontends, coordinators spawned by the harness)
# opt in purely through the environment; reading two env vars once at
# import keeps the disabled path a plain module-global None check.
configure_from_env()
