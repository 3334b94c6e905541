"""Span→metrics bridge: derives ``dynamo_request_*`` phase-latency
histograms from closed spans, so operators get Prometheus aggregates
(TTFT, ITL, queue wait, prefill, decode/token, KV transfer, e2e)
without running a trace backend.

Registered as a tracer sink; also fed by ``Tracer.ingest`` for spans
closed in other processes (engine phases arrive on the wire attached to
the final ``LLMEngineOutput``), so the frontend's ``/metrics`` covers
the whole pipeline.

Copy of ``dynamo_tpu/obs/bridge.py``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

from dynamo_tpu_torch.utils.metrics import MetricsRegistry

if TYPE_CHECKING:  # pragma: no cover
    from dynamo_tpu_torch.obs.tracer import Span

_FAST = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
         0.5, 1.0, 2.5)


class SpanMetricsBridge:
    """Maps span names to histograms; call with each closed span."""

    def __init__(self, registry: MetricsRegistry):
        h = registry.histogram
        self.h_e2e = h("request_e2e_seconds",
                       "End-to-end request latency derived from request spans")
        self.h_ttft = h("request_ttft_seconds",
                        "Time to first token derived from request.ttft spans")
        self.h_itl = h("request_itl_seconds",
                       "Per-request mean inter-token latency derived from request spans",
                       buckets=_FAST)
        self.h_queue = h("request_queue_seconds",
                         "Engine admission queue wait derived from engine.queue spans")
        self.h_prefill = h("request_prefill_seconds",
                           "Prefill phase latency derived from engine.prefill spans")
        self.h_decode = h("request_decode_per_token_seconds",
                          "Engine decode time per token derived from engine.decode spans",
                          buckets=_FAST)
        self.h_kv = h("request_kv_transfer_seconds",
                      "KV block transfer latency derived from kv.transfer spans",
                      buckets=_FAST)

    def __call__(self, span: "Span") -> None:
        name, dur = span.name, span.duration
        labels = {}
        model = span.attrs.get("model")
        if model:
            labels["model"] = str(model)
        if name == "request":
            self.h_e2e.observe(dur, **labels)
            # Mean ITL over the request's decode stretch: cheap span-based
            # ITL without a per-token span (see docs/OBSERVABILITY.md).
            toks = span.attrs.get("output_tokens") or 0
            ttft = span.attrs.get("ttft_s")
            if toks and toks > 1 and ttft is not None and dur > ttft:
                self.h_itl.observe((dur - ttft) / (toks - 1), **labels)
        elif name == "request.ttft":
            self.h_ttft.observe(dur, **labels)
        elif name == "engine.queue":
            self.h_queue.observe(dur, **labels)
        elif name == "engine.prefill":
            self.h_prefill.observe(dur, **labels)
        elif name == "engine.decode":
            toks = span.attrs.get("tokens") or 0
            if toks > 0:
                self.h_decode.observe(dur / toks, **labels)
        elif name == "kv.transfer":
            self.h_kv.observe(dur, **labels)
