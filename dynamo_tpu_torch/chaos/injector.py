"""Deterministic fault-injection engine behind the named fault points.

FoundationDB-style simulation testing needs one property above all:
**replayability** — the same seed must produce the same fault sequence.
Two design choices buy that here:

* one RNG per fault point, derived from ``sha256(seed, point_name)``.
  A point's fault schedule depends only on its own hit sequence, never on
  how calls at OTHER points interleave (worker threads, shard-server
  threads, and asyncio tasks all hit points concurrently — a shared RNG
  would make the schedule depend on thread scheduling).
* decisions happen under one lock and are appended to an ordered
  ``injection log``; tests replay a plan twice and assert the logs are
  identical.

Fault kinds map onto errors the stack already recovers from, so chaos
exercises the REAL recovery paths rather than synthetic ones:

* ``delay``       sleep ``delay_s`` (sync or async per call site)
* ``error``       raise :class:`ChaosInjectedError` (a ``ConnectionError``
                  subclass — retryable by Migration / ShardClient / kvbm
                  circuit breaker, like any transport fault)
* ``disconnect``  raise ``ConnectionResetError`` (peer-died shape)
* ``hang``        sleep ``hang_s`` (wedge: flushed out by canaries and
                  client timeouts, not by an exception)
* ``kill``        SIGKILL the current process (crash, not clean shutdown)

Copy of ``dynamo_tpu/chaos/injector.py``.
"""

from __future__ import annotations

import fnmatch
import hashlib
import os
import random
import signal
import threading
from dataclasses import dataclass
from typing import Any, Mapping

from dynamo_tpu_torch.chaos.plan import ChaosPlan
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("chaos")


class ChaosInjectedError(ConnectionError):
    """A fault injected by the chaos engine (kind=error).

    Subclasses ``ConnectionError`` so every retry/migration path that
    handles a real transport fault handles an injected one identically.
    """

    def __init__(self, point: str, message: str = ""):
        super().__init__(message or f"chaos: injected error at {point}")
        self.point = point


@dataclass(frozen=True)
class Injection:
    """One injected fault, as recorded in the engine's ordered log."""

    seq: int            # global order of injection within this engine
    point: str
    kind: str
    rule_index: int     # which plan rule fired
    hit: int            # the point-local hit number that drew the fault

    def key(self) -> tuple:
        return (self.seq, self.point, self.kind, self.rule_index, self.hit)


class ChaosEngine:
    """Interprets a :class:`ChaosPlan` deterministically.

    Thread-safe: fault points are hit from asyncio tasks, engine-core
    threads, and shard-server handler threads of the same process.
    """

    def __init__(self, plan: ChaosPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._rngs: dict[str, random.Random] = {}
        self._hits: dict[str, int] = {}          # point -> hits seen
        self._injected: dict[int, int] = {}      # rule index -> times fired
        self._seq = 0
        self.log: list[Injection] = []

    def _rng(self, point: str) -> random.Random:
        rng = self._rngs.get(point)
        if rng is None:
            digest = hashlib.sha256(
                f"{self.plan.seed}:{point}".encode()).digest()
            rng = self._rngs[point] = random.Random(
                int.from_bytes(digest[:8], "big"))
        return rng

    def decide(self, point: str, ctx: Mapping[str, Any]) -> Injection | None:
        """Record a hit at ``point`` and return the fault to apply, if any.

        Exactly one RNG draw per hit (whether or not any rule is eligible)
        keeps a point's schedule a pure function of (seed, hit number) —
        adding a bounded rule can't shift the faults of a later rule.
        """
        with self._lock:
            hit = self._hits[point] = self._hits.get(point, 0) + 1
            draw = self._rng(point).random()
            for idx, rule in enumerate(self.plan.rules):
                if not fnmatch.fnmatchcase(point, rule.point):
                    continue
                if rule.match and any(ctx.get(k) != v
                                      for k, v in rule.match.items()):
                    continue
                if hit <= rule.after:
                    continue
                if (rule.count is not None
                        and self._injected.get(idx, 0) >= rule.count):
                    continue
                if draw >= rule.rate:
                    continue
                self._injected[idx] = self._injected.get(idx, 0) + 1
                inj = Injection(seq=self._seq, point=point, kind=rule.kind,
                                rule_index=idx, hit=hit)
                self._seq += 1
                self.log.append(inj)
                return inj
        return None

    def rule_for(self, inj: Injection):
        return self.plan.rules[inj.rule_index]

    def log_keys(self) -> list[tuple]:
        """The injected-fault sequence as comparable tuples (replay tests
        assert two runs of the same plan+seed produce equal lists)."""
        with self._lock:
            return [inj.key() for inj in self.log]

    def apply_terminal(self, inj: Injection) -> None:
        """Raise/kill for a decided fault. Sleep kinds are applied by the
        caller (sync vs async call sites need different sleeps)."""
        rule = self.rule_for(inj)
        if inj.kind == "error":
            raise ChaosInjectedError(inj.point, rule.message)
        if inj.kind == "disconnect":
            raise ConnectionResetError(
                rule.message or f"chaos: injected disconnect at {inj.point}")
        if inj.kind == "kill":
            log.warning("chaos: killing process at point %s (seq %d)",
                        inj.point, inj.seq)
            # SIGKILL, not sys.exit: a crash leaves no chance for cleanup
            # handlers to mask the failure mode under test.
            os.kill(os.getpid(), signal.SIGKILL)
