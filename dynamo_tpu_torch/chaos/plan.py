"""ChaosPlan: the declarative fault-injection DSL.

A plan is a seed plus an ordered list of rules. Each rule targets one or
more named fault points (glob over the point name), picks a fault kind,
and bounds how often it fires:

```yaml
seed: 1234
rules:
  - point: worker.dispatch        # glob: "disagg.*" matches stage/pull/import
    kind: error                   # delay | error | disconnect | hang | kill
    rate: 0.25                    # per-hit injection probability
    count: 3                      # stop after this many injections (null = ∞)
    after: 2                      # let the first N matching hits through
    delay_s: 0.05                 # sleep length for kind=delay
    match: {endpoint: generate}   # ctx equality predicate (all keys must ==)
```

Interpretation is deterministic: the injector derives one RNG per fault
point from ``sha256(seed, point)``, so the same plan + seed replays the
identical fault sequence regardless of what other points do (see
injector.py). Plans load from JSON files, inline JSON strings, or plain
dicts — the env var ``DYN_CHAOS_PLAN`` accepts any of the three. A plan
file is read as YAML (JSON is YAML's flow form) by the port's own reader,
``utils/yaml_lite.py``.

Copy of ``dynamo_tpu/chaos/plan.py``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping

from dynamo_tpu_torch.utils import yaml_lite

FAULT_KINDS = ("delay", "error", "disconnect", "hang", "kill")


@dataclass
class ChaosRule:
    """One fault-injection rule; see the module docstring for field docs."""

    point: str                      # glob over fault-point names
    kind: str                       # one of FAULT_KINDS
    rate: float = 1.0               # per-hit injection probability
    count: int | None = None        # max injections (None = unbounded)
    after: int = 0                  # skip the first N matching hits
    delay_s: float = 0.05           # sleep for kind=delay
    hang_s: float = 300.0           # sleep for kind=hang
    message: str = ""               # carried on the raised error
    match: dict[str, Any] = field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {FAULT_KINDS})")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"point": self.point, "kind": self.kind,
                             "rate": self.rate}
        if self.count is not None:
            d["count"] = self.count
        if self.after:
            d["after"] = self.after
        if self.kind == "delay":
            d["delay_s"] = self.delay_s
        if self.kind == "hang":
            d["hang_s"] = self.hang_s
        if self.message:
            d["message"] = self.message
        if self.match:
            d["match"] = dict(self.match)
        return d

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ChaosRule":
        known = {"point", "kind", "rate", "count", "after", "delay_s",
                 "hang_s", "message", "match"}
        extra = set(d) - known
        if extra:
            raise ValueError(f"unknown ChaosRule keys: {sorted(extra)}")
        return cls(
            point=str(d["point"]),
            kind=str(d["kind"]),
            rate=float(d.get("rate", 1.0)),
            count=None if d.get("count") is None else int(d["count"]),
            after=int(d.get("after", 0)),
            delay_s=float(d.get("delay_s", 0.05)),
            hang_s=float(d.get("hang_s", 300.0)),
            message=str(d.get("message", "")),
            match=dict(d.get("match") or {}),
        )


@dataclass
class ChaosPlan:
    """A seed + ordered rules. Rules are evaluated in order per hit; the
    first eligible rule injects (one fault per hit, like firewall rules)."""

    seed: int = 0
    rules: list[ChaosRule] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {"seed": self.seed, "rules": [r.to_dict() for r in self.rules]}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "ChaosPlan":
        return cls(seed=int(d.get("seed", 0)),
                   rules=[ChaosRule.from_dict(r) for r in d.get("rules", [])])

    @classmethod
    def load(cls, spec: "str | Path | Mapping[str, Any]") -> "ChaosPlan":
        """Load from a dict, a YAML/JSON file path, or an inline JSON
        string (the shapes ``DYN_CHAOS_PLAN`` accepts)."""
        if isinstance(spec, Mapping):
            return cls.from_dict(spec)
        text = str(spec).strip()
        if text.startswith("{"):
            return cls.from_dict(json.loads(text))
        path = Path(text)
        data = yaml_lite.safe_load(path.read_text())
        if not isinstance(data, Mapping):
            raise ValueError(f"chaos plan {path} is not a mapping")
        return cls.from_dict(data)
