"""Minimal Prometheus-compatible metrics registry — copy of
``dynamo_tpu/utils/metrics.py`` without ``metrics_url`` / ``fetch_metrics``
(an aiohttp scrape client for the planner and fleet tools, which come with
their slice: the card's machine has no aiohttp).

Fills the role of the reference's hierarchical MetricsRegistry
(reference: lib/runtime/src/metrics.rs, name constants in
metrics/prometheus_names.rs): counters/gauges/histograms with labels,
hierarchical auto-labels (namespace/component/endpoint), and text
exposition for a /metrics endpoint. Dependency-free.

Exposition follows the Prometheus text format: one ``# HELP``/``# TYPE``
header per metric family across the whole registry tree (child
registries contribute samples, not duplicate headers), label values
escaped per the spec, and histogram ``le`` bounds rendered via a single
repr-stable formatter.
"""

from __future__ import annotations

import math
import re
import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Iterable, Mapping

DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


def _escape_label_value(v: str) -> str:
    """Prometheus exposition escaping: backslash, double-quote, newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def _fmt_le(ub: float) -> str:
    """Render a bucket upper bound. Shared by observe (bucket identity)
    and expose so the printed ``le`` always names the float actually
    compared against; repr() of a true float is shortest-round-trip."""
    return "+Inf" if ub == math.inf else repr(float(ub))


class Counter:
    kind = "counter"

    def __init__(self, name: str, help_: str, const_labels: dict[str, str]):
        self.name, self.help = name, help_
        self.const = const_labels
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, value: float = 1.0, **labels: str) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] += value

    def get(self, **labels: str) -> float:
        with self._lock:
            return self._values.get(tuple(sorted(labels.items())), 0.0)

    def samples(self) -> Iterable[str]:
        with self._lock:
            values = sorted(self._values.items())
        if not values:
            yield f"{self.name}{_fmt_labels(self.const)} 0"
        for key, v in values:
            labels = {**self.const, **dict(key)}
            yield f"{self.name}{_fmt_labels(labels)} {v}"

    def expose(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.kind}"
        yield from self.samples()


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = value


class FuncGauge:
    """Gauge whose value is computed at scrape time from a callback —
    for live state (queue depths, tracked clients) that would otherwise
    need a set() call on every mutation. The callback is allowed to
    raise (e.g. after its owner is torn down while the registry is still
    scraped): both get() and exposition fall back to 0.0."""

    kind = "gauge"

    def __init__(self, name: str, help_: str, const_labels: dict[str, str],
                 fn: "Callable[[], float]"):
        self.name, self.help = name, help_
        self.const = const_labels
        self.fn = fn

    def get(self) -> float:
        try:
            return float(self.fn())
        except Exception:
            return 0.0

    def samples(self) -> Iterable[str]:
        yield f"{self.name}{_fmt_labels(self.const)} {self.get()}"

    def expose(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.kind}"
        yield from self.samples()


class Histogram:
    kind = "histogram"

    def __init__(self, name: str, help_: str, const_labels: dict[str, str],
                 buckets: tuple[float, ...] = DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.const = const_labels
        # Normalize to true floats so observe's comparisons and expose's
        # repr() agree even when callers pass numpy scalars / ints.
        self.buckets = tuple(float(b) for b in buckets) + (math.inf,)
        self._counts: dict[tuple, list[int]] = {}
        self._sum: dict[tuple, float] = defaultdict(float)
        self._n: dict[tuple, int] = defaultdict(int)
        self._lock = threading.Lock()

    def observe(self, value: float, **labels: str) -> None:
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
            self._sum[key] += value
            self._n[key] += 1

    def percentile(self, q: float, **labels: str) -> float:
        """Approximate percentile from bucket counts (for planner/tests)."""
        key = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.get(key)
            if not counts or self._n[key] == 0:
                return 0.0
            counts = list(counts)
            target = q * self._n[key]
        for i, c in enumerate(counts):
            if c >= target:
                return self.buckets[i] if self.buckets[i] != math.inf else self.buckets[i - 1]
        return self.buckets[-2]

    def samples(self) -> Iterable[str]:
        with self._lock:
            snap = {k: (list(c), self._sum[k], self._n[k])
                    for k, c in self._counts.items()}
        for key in sorted(snap):
            counts, total, n = snap[key]
            labels = {**self.const, **dict(key)}
            for i, ub in enumerate(self.buckets):
                lb = {**labels, "le": _fmt_le(ub)}
                yield f"{self.name}_bucket{_fmt_labels(lb)} {counts[i]}"
            yield f"{self.name}_sum{_fmt_labels(labels)} {total}"
            yield f"{self.name}_count{_fmt_labels(labels)} {n}"

    def expose(self) -> Iterable[str]:
        yield f"# HELP {self.name} {self.help}"
        yield f"# TYPE {self.name} {self.kind}"
        yield from self.samples()


# ---------------------------------------------------------------------------
# Parsing — the inverse of expose(). One parser for every scraper in the
# tree (planner, chaos invariants, loadgen, fleet aggregator) so label-value
# escaping has exactly one encoder and one decoder.
# ---------------------------------------------------------------------------

Sample = dict[tuple[str, frozenset], float]

_SAMPLE_NAME = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LABEL = re.compile(r'\s*([a-zA-Z_][a-zA-Z0-9_]*)\s*=\s*"((?:[^"\\]|\\.)*)"\s*(,|\})')
_UNESCAPE = re.compile(r"\\(.)")


def _unescape_label_value(v: str) -> str:
    """Inverse of _escape_label_value: \\n -> newline, \\" -> ", \\\\ -> \\."""
    return _UNESCAPE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), v)


def parse_prometheus(text: str) -> Sample:
    """Prometheus exposition text -> {(name, frozenset(label items)): value}.

    Label values are unescaped, so round-trips through expose() are exact
    even for values containing quotes, commas, newlines, or backslashes.
    Comment lines, malformed lines, and non-numeric values are skipped."""
    out: Sample = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_NAME.match(line)
        if not m:
            continue
        name = m.group(0)
        pos = m.end()
        labels: dict[str, str] = {}
        if line[pos:pos + 1] == "{":
            pos += 1
            if line[pos:pos + 1] == "}":  # empty label set: name{} value
                pos += 1
            else:
                while True:
                    lm = _LABEL.match(line, pos)
                    if not lm:
                        pos = -1
                        break
                    labels[lm.group(1)] = _unescape_label_value(lm.group(2))
                    pos = lm.end()
                    if lm.group(3) == "}":
                        break
            if pos < 0:
                continue
        rest = line[pos:].split()
        if not rest:
            continue
        try:
            value = float(rest[0])
        except ValueError:
            continue
        out[(name, frozenset(labels.items()))] = value
    return out


def metric_sum(samples: Mapping[tuple[str, frozenset], float], name: str,
               **where: str) -> float:
    """Sum every sample of ``name`` whose labels include ``where``."""
    want = set(where.items())
    return sum(v for (n, labels), v in samples.items()
               if n == name and want <= set(labels))


@dataclass
class MetricsRegistry:
    """Hierarchical registry: child registries inherit const labels
    (reference: drt→namespace→component→endpoint hierarchy)."""

    prefix: str = "dynamo"
    const_labels: dict[str, str] = field(default_factory=dict)
    _metrics: dict[str, object] = field(default_factory=dict)
    _children: list["MetricsRegistry"] = field(default_factory=list)

    def child(self, **labels: str) -> "MetricsRegistry":
        c = MetricsRegistry(prefix=self.prefix, const_labels={**self.const_labels, **labels})
        self._children.append(c)
        return c

    def _full(self, name: str) -> str:
        return f"{self.prefix}_{name}"

    def counter(self, name: str, help_: str = "") -> Counter:
        key = "c:" + name
        if key not in self._metrics:
            self._metrics[key] = Counter(self._full(name), help_, self.const_labels)
        return self._metrics[key]  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "") -> Gauge:
        key = "g:" + name
        if key not in self._metrics:
            self._metrics[key] = Gauge(self._full(name), help_, self.const_labels)
        return self._metrics[key]  # type: ignore[return-value]

    def func_gauge(self, name: str, fn, help_: str = "") -> FuncGauge:
        key = "f:" + name
        if key not in self._metrics:
            self._metrics[key] = FuncGauge(self._full(name), help_, self.const_labels, fn)
        return self._metrics[key]  # type: ignore[return-value]

    def histogram(self, name: str, help_: str = "", buckets: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        key = "h:" + name
        if key not in self._metrics:
            self._metrics[key] = Histogram(self._full(name), help_, self.const_labels, buckets)
        return self._metrics[key]  # type: ignore[return-value]

    def _walk(self) -> Iterable[object]:
        yield from self._metrics.values()
        for c in self._children:
            yield from c._walk()

    def expose(self) -> str:
        """Merge metric families across the registry tree: each family
        (full metric name) emits ONE # HELP/# TYPE header followed by the
        samples from every registry contributing to it. The first
        registration's kind/help wins; same-name metrics of a different
        kind would be invalid exposition, so their samples are grouped
        under the first header rather than emitting a duplicate TYPE."""
        headers: dict[str, tuple[str, str]] = {}
        by_name: dict[str, list[str]] = {}
        order: list[str] = []
        for m in self._walk():
            name = m.name  # type: ignore[attr-defined]
            if name not in headers:
                headers[name] = (m.kind, m.help)  # type: ignore[attr-defined]
                by_name[name] = []
                order.append(name)
            by_name[name].extend(m.samples())  # type: ignore[attr-defined]
        lines: list[str] = []
        for name in order:
            kind, help_ = headers[name]
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            lines.extend(by_name[name])
        return "\n".join(lines) + "\n"
