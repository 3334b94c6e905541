"""Dapper-style always-on tracer keyed off ``TraceContext``.

Spans are plain mutable records; the tracer hands them out from
``start_span`` and files them with the flight recorder (and any sinks,
e.g. the span→metrics bridge) when ``end_span`` closes them. Hops in
other processes serialize their closed spans onto the wire
(``LLMEngineOutput.spans``) and the frontend ``ingest``s them, so one
``/debug/traces`` endpoint shows the whole cross-process timeline.

The wire annotation ``obs.traceparent`` rides ``PreprocessedRequest``
annotations exactly like the QoS deadline keys (qos/deadline.py).

Copy of ``dynamo_tpu/obs/tracer.py``.
"""

from __future__ import annotations

import os
import secrets
import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Iterator

from dynamo_tpu_torch.utils.logging import TraceContext, get_logger

log = get_logger("obs.tracer")

# PreprocessedRequest annotation carrying the W3C traceparent across hops
# (same wire mechanism as qos.priority / qos.deadline_ts).
TRACE_KEY = "obs.traceparent"

#: HTTP header the frontend reads (W3C) and echoes back.
TRACEPARENT_HEADER = "traceparent"
TRACE_ID_RESPONSE_HEADER = "x-trace-id"


def trace_context_of(annotations: dict | None) -> TraceContext | None:
    """Parse the wire traceparent annotation stamped by the frontend."""
    if not annotations:
        return None
    return TraceContext.parse(annotations.get(TRACE_KEY))


class Span:
    """One timed operation. ``start``/``end`` are epoch seconds (float);
    attributes are a flat str→scalar dict. Mutable until ended."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start", "end",
                 "status", "component", "attrs")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str | None, start: float, component: str = "",
                 attrs: dict[str, Any] | None = None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = start
        self.end = 0.0
        self.status = "ok"
        self.component = component
        self.attrs = attrs or {}

    @property
    def duration(self) -> float:
        return max(self.end - self.start, 0.0)

    @property
    def ended(self) -> bool:
        return self.end > 0.0

    def context(self) -> TraceContext:
        """TraceContext naming THIS span as the parent for downstream hops."""
        return TraceContext(trace_id=self.trace_id, span_id=self.span_id)

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "start": self.start,
            "end": self.end,
            "status": self.status,
        }
        if self.parent_id:
            d["parent_id"] = self.parent_id
        if self.component:
            d["component"] = self.component
        if self.attrs:
            d["attrs"] = self.attrs
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Span":
        s = cls(
            name=d.get("name", ""),
            trace_id=d.get("trace_id", ""),
            span_id=d.get("span_id", ""),
            parent_id=d.get("parent_id"),
            start=float(d.get("start", 0.0)),
            component=d.get("component", ""),
            attrs=dict(d.get("attrs") or {}),
        )
        s.end = float(d.get("end", 0.0))
        s.status = d.get("status", "ok")
        return s


class Tracer:
    """Hands out spans and files the closed ones with the recorder +
    sinks. Thread-safe: span creation touches no shared state beyond the
    process trace id; end_span delegates to the (locked) recorder."""

    def __init__(self, component: str = "", recorder=None):
        from dynamo_tpu_torch.obs.recorder import FlightRecorder

        self.component = component
        self.recorder = recorder if recorder is not None else FlightRecorder()
        self._sinks: list[Callable[[Span], None]] = []
        # Stable per-process trace id for request-less spans (e.g. KV
        # offload transfers) so they share one timeline instead of
        # flooding the recorder with single-span traces.
        self.proc_trace_id = secrets.token_hex(16)

    def add_sink(self, fn: Callable[[Span], None]) -> None:
        self._sinks.append(fn)

    def start_span(self, name: str, *, ctx: TraceContext | None = None,
                   parent: Span | None = None, start: float | None = None,
                   fresh: bool = False, **attrs: Any) -> Span:
        """Open a span. ``parent`` (local) wins over ``ctx`` (wire); with
        neither, ``fresh`` mints a new trace (a root span) while the
        default joins the process-level timeline."""
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        elif ctx is not None:
            trace_id, parent_id = ctx.trace_id, ctx.span_id
        elif fresh:
            trace_id, parent_id = secrets.token_hex(16), None
        else:
            trace_id, parent_id = self.proc_trace_id, None
        return Span(name, trace_id, secrets.token_hex(8), parent_id,
                    start if start is not None else time.time(),
                    component=self.component, attrs=attrs)

    def end_span(self, span: Span, *, end: float | None = None,
                 status: str = "ok", **attrs: Any) -> Span:
        if span.ended:  # idempotent: double-close keeps the first record
            return span
        span.end = end if end is not None else time.time()
        if attrs:
            span.attrs.update(attrs)
        span.status = status
        self._file(span)
        # Auto-dump: a failed/cancelled root span dumps its whole
        # timeline to the log so the evidence survives the ring buffer.
        # "request" counts as a root even with an inbound traceparent
        # (its parent lives in the calling process).
        if status in ("error", "cancelled") and (
                span.parent_id is None or span.name == "request"):
            self._dump_on_failure(span)
        return span

    @contextmanager
    def span(self, name: str, *, ctx: TraceContext | None = None,
             parent: Span | None = None, **attrs: Any) -> Iterator[Span]:
        s = self.start_span(name, ctx=ctx, parent=parent, **attrs)
        try:
            yield s
        except BaseException as exc:
            self.end_span(s, status="error", error=type(exc).__name__)
            raise
        self.end_span(s)

    def ingest(self, span_dicts: list[dict] | None) -> int:
        """File spans closed by another process (shipped on the wire).
        Dedupes by span_id so migration/retry replays are harmless."""
        n = 0
        for d in span_dicts or ():
            try:
                s = Span.from_dict(d)
            except Exception:
                continue
            if not s.trace_id or not s.span_id or not s.ended:
                continue
            if self.recorder.record(s):
                for sink in self._sinks:
                    try:
                        sink(s)
                    except Exception:
                        log.debug("span sink failed", exc_info=True)
                n += 1
        return n

    # ------------------------------------------------------------------
    def _file(self, span: Span) -> None:
        if not self.recorder.record(span):
            return
        for sink in self._sinks:
            try:
                sink(span)
            except Exception:
                log.debug("span sink failed", exc_info=True)

    def _dump_on_failure(self, root: Span) -> None:
        try:
            dump = self.recorder.dump_jsonl(trace_id=root.trace_id)
            log.warning("request %s ended %s; trace dump:\n%s",
                        root.attrs.get("request_id", root.trace_id),
                        root.status, dump.rstrip("\n"))
        except Exception:
            log.debug("trace auto-dump failed", exc_info=True)


_TRACER: Tracer | None = None
_TRACER_LOCK = threading.Lock()


def get_tracer(component: str | None = None) -> Tracer:
    """Process-global tracer. The first caller (or an explicit
    ``component=``) names the process for Chrome-trace rows; capacity
    comes from ``DYN_FLIGHT_RECORDER_CAP`` (default 256 traces)."""
    global _TRACER
    with _TRACER_LOCK:
        if _TRACER is None:
            from dynamo_tpu_torch.obs.recorder import FlightRecorder

            cap = int(os.environ.get("DYN_FLIGHT_RECORDER_CAP", "256"))
            _TRACER = Tracer(component=component or "",
                             recorder=FlightRecorder(capacity=cap))
        elif component and not _TRACER.component:
            _TRACER.component = component
        return _TRACER
