"""Flight recorder: bounded, thread-safe ring of completed request
timelines.

Two export formats, both dependency-free:
  * JSONL — one span per line, consumed by ``tools/trace_report.py``.
  * Chrome trace-event JSON — ``{"traceEvents": [...]}`` with complete
    ("ph":"X") events in microseconds, loadable in Perfetto / chrome://tracing.

Copy of ``dynamo_tpu/obs/recorder.py`` without the engine's step ring
(``StepRecord`` / ``StepProfiler`` and its ``engine.batch`` counter
events), which comes with the engine-side spans (ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from typing import TYPE_CHECKING, Iterable

if TYPE_CHECKING:  # pragma: no cover - import cycle guard
    from dynamo_tpu_torch.obs.tracer import Span


class FlightRecorder:
    """Ring of the last ``capacity`` request timelines, keyed by
    trace_id. A timeline is the list of closed spans sharing a trace_id;
    eviction is LRU on trace insertion order (a trace that keeps
    receiving spans stays fresh)."""

    def __init__(self, capacity: int = 256, spans_per_trace: int = 512):
        self.capacity = max(capacity, 1)
        self.spans_per_trace = spans_per_trace
        self._traces: "OrderedDict[str, list[Span]]" = OrderedDict()
        self._span_ids: dict[str, set[str]] = {}
        self._lock = threading.Lock()

    def record(self, span: "Span") -> bool:
        """File a closed span. Returns False on duplicate span_id (wire
        replays) or per-trace overflow."""
        with self._lock:
            spans = self._traces.get(span.trace_id)
            if spans is None:
                spans = []
                self._traces[span.trace_id] = spans
                self._span_ids[span.trace_id] = set()
                while len(self._traces) > self.capacity:
                    old, _ = self._traces.popitem(last=False)
                    del self._span_ids[old]
            else:
                self._traces.move_to_end(span.trace_id)
            ids = self._span_ids[span.trace_id]
            if span.span_id in ids or len(spans) >= self.spans_per_trace:
                return False
            ids.add(span.span_id)
            spans.append(span)
            return True

    def trace_ids(self) -> list[str]:
        with self._lock:
            return list(self._traces)

    def spans_for(self, trace_id: str) -> "list[Span]":
        with self._lock:
            return list(self._traces.get(trace_id, ()))

    def _snapshot(self, trace_id: str | None) -> "list[Span]":
        with self._lock:
            if trace_id is not None:
                return list(self._traces.get(trace_id, ()))
            return [s for spans in self._traces.values() for s in spans]

    # -- exporters ------------------------------------------------------
    def dump_jsonl(self, trace_id: str | None = None) -> str:
        spans = self._snapshot(trace_id)
        spans.sort(key=lambda s: (s.trace_id, s.start))
        return "".join(
            json.dumps(s.to_dict(), separators=(",", ":")) + "\n"
            for s in spans)

    def dump_chrome(self, trace_id: str | None = None) -> dict:
        """Chrome trace-event JSON. pid = component (process row in the
        Perfetto UI), tid = short trace id (one track per request)."""
        events: list[dict] = []
        pids: dict[str, int] = {}
        tids: dict[str, int] = {}

        def _pid(comp: str) -> int:
            if comp not in pids:
                pids[comp] = len(pids) + 1
                events.append({
                    "ph": "M", "name": "process_name", "pid": pids[comp],
                    "tid": 0, "args": {"name": comp or "proc"}})
            return pids[comp]

        for s in self._snapshot(trace_id):
            key = (s.component, s.trace_id)
            pid = _pid(s.component)
            if key not in tids:
                tids[key] = len(tids) + 1
                events.append({
                    "ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tids[key],
                    "args": {"name": f"trace {s.trace_id[:8]}"}})
            args = {"trace_id": s.trace_id, "span_id": s.span_id,
                    "status": s.status, **s.attrs}
            if s.parent_id:
                args["parent_id"] = s.parent_id
            events.append({
                "ph": "X", "name": s.name, "cat": s.component or "span",
                "pid": pid, "tid": tids[key],
                "ts": s.start * 1e6, "dur": s.duration * 1e6,
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def iter_spans(self) -> "Iterable[Span]":
        return self._snapshot(None)
