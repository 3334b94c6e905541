"""OpenAI-compatible HTTP frontend — copy of
``dynamo_tpu/frontend/service.py`` over the port's own HTTP/1.1 server
(``frontend/http.py``, stdlib asyncio) in place of aiohttp, which the
card's machine lacks.

Fills the role of the reference's axum HttpService
(reference: lib/llm/src/http/service/openai.rs /v1/* routes,
service_v2.rs HttpService, metrics.rs TTFT/ITL observations,
disconnect.rs SSE disconnect detection):

- POST /v1/chat/completions, /v1/completions (SSE streaming + aggregate)
- GET  /v1/models
- GET  /health, /live, /metrics (and HEAD of every GET route)
- GET  /engine_stats, /debug/traces, /debug/sched, /debug/mem
- POST /clear_kv_blocks (admin)

Client disconnects cancel the underlying generation (the engine abort path):
the streaming loop polls ``request.transport.is_closing()`` between deltas,
which on this server also reads the connection's EOF.

Not served yet: the KServe v2 routes of the JAX app are not registered
(ROADMAP Queue 1).
"""

from __future__ import annotations

import asyncio
import json
import time
import uuid

from dynamo_tpu_torch.frontend import http as web

from dynamo_tpu_torch.backend import DetokenizerBackend
from dynamo_tpu_torch.frontend.delta import (
    ChatDeltaGenerator,
    aggregate_chat,
    aggregate_completion,
)
from dynamo_tpu_torch.frontend.model_manager import ModelEntry, ModelManager
from dynamo_tpu_torch.obs.bridge import SpanMetricsBridge
from dynamo_tpu_torch.obs.tracer import (
    TRACE_KEY,
    TRACE_ID_RESPONSE_HEADER,
    TRACEPARENT_HEADER,
    get_tracer,
)
from dynamo_tpu_torch.protocols.common import BackendOutput, FinishReason
from dynamo_tpu_torch.protocols.openai import (
    ChatCompletionRequest,
    CompletionRequest,
    ErrorInfo,
    ErrorResponse,
    ModelInfo,
    ModelList,
)
from dynamo_tpu_torch.protocols.sse import DONE_EVENT, encode_sse_json
from dynamo_tpu_torch.engine.session import SESSION_KEY, session_id_from
from dynamo_tpu_torch.qos import QosConfig, QosGateway
from dynamo_tpu_torch.qos.deadline import CLIENT_HEADER, deadline_from, priority_from
from dynamo_tpu_torch.utils.logging import TraceContext, get_logger
from dynamo_tpu_torch.utils.metrics import MetricsRegistry
from dynamo_tpu_torch.utils.tls import validate_tls_pair

log = get_logger("frontend")


def _error(status: int, message: str,
           headers: dict[str, str] | None = None) -> web.Response:
    body = ErrorResponse(error=ErrorInfo(message=message, code=status)).model_dump_json()
    return web.Response(status=status, text=body, content_type="application/json",
                        headers=headers)



def _extract_image_bytes(messages) -> list[bytes]:
    """Image bytes from OpenAI list-content messages, in reading order.
    Only base64 data URLs are accepted (this serving tier has no business
    fetching remote URLs — zero-egress deployments are the TPU norm)."""
    import base64

    out: list[bytes] = []
    for m in messages:
        content = getattr(m, "content", None)
        if not isinstance(content, list):
            continue
        for part in content:
            if not isinstance(part, dict) or part.get("type") != "image_url":
                continue
            url = (part.get("image_url") or {}).get("url", "")
            if not url.startswith("data:"):
                raise ValueError(
                    "only data: URLs are supported for image_url content "
                    "(remote fetch is not performed by the server)")
            _, _, payload = url.partition(",")
            try:
                out.append(base64.b64decode(payload, validate=True))
            except Exception as exc:
                raise ValueError(f"invalid image data URL: {exc}") from None
    return out


def _wants_logprobs(req, chat: bool) -> bool:
    """THE chat-vs-completions logprob acceptance rule, in one place:
    chat uses a boolean flag; completions uses an int where 0 still means
    "sampled-token logprobs" (top-N alternatives are rejected upstream)."""
    return bool(req.logprobs) if chat else req.logprobs is not None

class HttpService:
    def __init__(self, models: ModelManager | None = None, metrics: MetricsRegistry | None = None,
                 qos: QosGateway | QosConfig | None = None):
        # NOT `models or ...`: ModelManager is empty (falsy by __len__) at
        # startup and models are registered later by the watcher.
        self.models = models if models is not None else ModelManager()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        if isinstance(qos, QosGateway):
            self.qos = qos
        else:
            # Default gateway: rate limiting off, capacity predicate fails
            # open until a stats source reports, so behavior only changes
            # under observed pressure or explicit configuration.
            self.qos = QosGateway(qos if isinstance(qos, QosConfig) else None,
                                  registry=self.metrics)
        m = self.metrics
        self._requests = m.counter("frontend_requests_total", "HTTP requests by route/status")
        self._inflight = m.gauge("frontend_inflight", "in-flight requests")
        self._ttft = m.histogram("frontend_time_to_first_token_seconds", "TTFT")
        self._itl = m.histogram("frontend_inter_token_latency_seconds", "ITL")
        self._req_dur = m.histogram("frontend_request_duration_seconds", "request duration")
        self._output_tokens = m.counter("frontend_output_tokens_total", "output tokens")
        self._input_tokens = m.counter("frontend_input_tokens_total", "prompt tokens")
        self._model_requests = m.counter("frontend_model_requests_total",
                                         "completed requests per model")
        # Tracing: the process-global tracer collects frontend + router
        # spans; worker/engine spans arrive on the wire and are ingested
        # in the generate loops. The bridge derives dynamo_request_*
        # histograms from every closed span (obs/bridge.py).
        self.tracer = get_tracer("frontend")
        self.tracer.add_sink(SpanMetricsBridge(m))
        self.app = web.HttpServer()
        self.app.add_post("/v1/chat/completions", self.chat_completions)
        self.app.add_post("/v1/completions", self.completions)
        self.app.add_post("/v1/embeddings", self.embeddings)
        self.app.add_post("/v1/responses", self.responses)
        self.app.add_get("/v1/models", self.list_models)
        self.app.add_get("/health", self.health)
        self.app.add_get("/live", self.live)
        self.app.add_get("/metrics", self.metrics_handler)
        self.app.add_post("/clear_kv_blocks", self.clear_kv_blocks)
        self.app.add_get("/engine_stats", self.engine_stats)
        self.app.add_get("/debug/traces", self.debug_traces)
        self.app.add_get("/debug/sched", self.debug_sched)
        self.app.add_get("/debug/mem", self.debug_mem)
        # Audit bus (reference: lib/llm/src/audit/) — enabled via
        # DYN_AUDIT_JSONL or a programmatic audit.init() before serving.
        from dynamo_tpu_torch.utils import audit as _audit

        self._audit = _audit
        self.port: int = 0

    # ------------------------------------------------------------------
    async def start(self, host: str = "127.0.0.1", port: int = 0,
                    tls_cert: str | None = None,
                    tls_key: str | None = None) -> int:
        """Serve plaintext, or TLS when a cert+key pair is given
        (reference: the axum HttpService's TLS option, service_v2.rs)."""
        # Validate BEFORE side effects (audit init, runner setup) so a
        # half-configured pair can't leak an initialized runner.
        ssl_ctx = None
        if validate_tls_pair(tls_cert, tls_key):
            import ssl

            # create_default_context carries the stdlib's server hardening
            # (cipher restrictions, OP_NO_COMPRESSION) a bare context lacks.
            ssl_ctx = ssl.create_default_context(ssl.Purpose.CLIENT_AUTH)
            ssl_ctx.load_cert_chain(tls_cert, tls_key)
        self._audit.maybe_init_from_env()
        self.port = await self.app.start(host, port, ssl_context=ssl_ctx)
        log.info("http%s service listening on %s:%d",
                 "s" if ssl_ctx else "", host, self.port)
        return self.port

    async def stop(self) -> None:
        await self.app.stop()

    # ------------------------------------------------------------------
    async def health(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "healthy", "models": self.models.names()})

    async def live(self, request: web.Request) -> web.Response:
        return web.json_response({"status": "live"})

    async def metrics_handler(self, request: web.Request) -> web.Response:
        return web.Response(text=self.metrics.expose(), content_type="text/plain")

    async def debug_traces(self, request: web.Request) -> web.Response:
        """Flight-recorder dump. ``?format=chrome`` (default) returns
        Chrome trace-event JSON loadable in Perfetto; ``?format=jsonl``
        one span per line for tools/trace_report.py; ``?trace_id=`` limits
        either to one request's timeline (docs/OBSERVABILITY.md)."""
        fmt = request.query.get("format", "chrome")
        trace_id = request.query.get("trace_id") or None
        rec = self.tracer.recorder
        if fmt == "jsonl":
            return web.Response(text=rec.dump_jsonl(trace_id=trace_id),
                                content_type="application/x-ndjson")
        if fmt != "chrome":
            return _error(400, f"unknown format '{fmt}' (chrome|jsonl)")
        return web.json_response(rec.dump_chrome(trace_id=trace_id))

    async def debug_sched(self, request: web.Request) -> web.Response:
        """Scheduling-ledger inspection (obs/sched_ledger.py): recent-step
        ring, goodput trend, top HOL culprits, and ``trace_culprits`` from
        the ``engine.hol_stall`` spans in this process's flight recorder."""
        from dynamo_tpu_torch.obs.sched_ledger import get_sched_ledger

        return web.json_response(
            get_sched_ledger().debug_info(recorder=self.tracer.recorder))

    async def debug_mem(self, request: web.Request) -> web.Response:
        """Memory-ledger inspection (obs/mem_ledger.py): tier occupancy
        waterfall, top pin owners, churn trend, TTX forecast, last leak
        audit. The engines in this process share its ledger, so the
        document covers them."""
        from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger

        return web.json_response(get_mem_ledger().debug_info())

    async def engine_stats(self, request: web.Request) -> web.Response:
        """Per-model engine stats (scheduler depth, KV usage, KVBM tiers) —
        the role of the reference's system status server
        (reference: lib/runtime/src/system_status_server.rs)."""
        out = {}
        for name in self.models.names():
            entry = self.models.get(name)
            if entry and entry.stats:
                out[name] = entry.stats()
        return web.json_response(out)

    async def list_models(self, request: web.Request) -> web.Response:
        data = ModelList(data=[ModelInfo(id=n) for n in self.models.names()])
        return web.Response(text=data.model_dump_json(), content_type="application/json")

    async def clear_kv_blocks(self, request: web.Request) -> web.Response:
        results = {}
        for name in self.models.names():
            entry = self.models.get(name)
            if entry and entry.clear_kv:
                await entry.clear_kv()
                results[name] = "cleared"
            else:
                results[name] = "unsupported"
        return web.json_response(results)

    # ------------------------------------------------------------------
    async def embeddings(self, request: web.Request) -> web.Response:
        """POST /v1/embeddings — last-token-pooled hidden states from the
        engine (reference route: http/service/openai.rs:1132)."""
        from dynamo_tpu_torch.protocols.openai import (
            EmbeddingData,
            EmbeddingRequest,
            EmbeddingResponse,
            Usage,
        )

        try:
            req = EmbeddingRequest(**(await request.json()))
        except Exception as exc:
            self._requests.inc(route="embeddings", status="400")
            return _error(400, f"invalid request: {exc}")
        entry = self.models.get(req.model)
        if entry is None:
            self._requests.inc(route="embeddings", status="404")
            return _error(404, f"model '{req.model}' not found")
        if entry.embed is None:
            self._requests.inc(route="embeddings", status="501")
            return _error(501, f"model '{req.model}' does not serve embeddings")
        if req.dimensions is not None:
            self._requests.inc(route="embeddings", status="400")
            return _error(400, "'dimensions' is not supported (embeddings are "
                               "full hidden-state size)")
        items = req.input if isinstance(req.input, list) else [req.input]
        if items and isinstance(items[0], int):
            items = [items]  # a single token list
        token_lists: list[list[int]] = []
        for it in items:
            if isinstance(it, str):
                token_lists.append(entry.tokenizer.encode(it, add_bos=True))
            else:
                token_lists.append([int(x) for x in it])
        if not token_lists or any(not ts for ts in token_lists):
            self._requests.inc(route="embeddings", status="400")
            return _error(400, "empty input")
        if len(token_lists) > 64:
            self._requests.inc(route="embeddings", status="400")
            return _error(400, "at most 64 inputs per request")
        too_long = max(len(ts) for ts in token_lists)
        if too_long > entry.defaults.max_model_len:
            self._requests.inc(route="embeddings", status="400")
            return _error(400, f"input of {too_long} tokens exceeds the "
                               f"model context ({entry.defaults.max_model_len})")
        try:
            vecs = await entry.embed(token_lists)
        except ValueError as exc:
            self._requests.inc(route="embeddings", status="400")
            return _error(400, str(exc))
        except Exception as exc:  # noqa: BLE001 - surfaced to the client
            log.exception("embeddings failed")
            self._requests.inc(route="embeddings", status="500")
            return _error(500, str(exc))
        n_in = sum(len(ts) for ts in token_lists)

        def enc(v):
            if req.encoding_format == "base64":
                import base64

                import numpy as _np

                return base64.b64encode(
                    _np.asarray(v, _np.float32).tobytes()).decode()
            return [float(x) for x in v]

        resp = EmbeddingResponse(
            model=req.model,
            data=[EmbeddingData(index=i, embedding=enc(v))
                  for i, v in enumerate(vecs)],
            usage=Usage(prompt_tokens=n_in, total_tokens=n_in),
        )
        self._requests.inc(route="embeddings", status="200")
        self._input_tokens.inc(n_in, model=req.model)
        return web.Response(text=resp.model_dump_json(),
                            content_type="application/json")

    async def responses(self, request: web.Request) -> web.Response:
        """POST /v1/responses — minimal OpenAI Responses API over the chat
        pipeline (reference route: http/service/openai.rs:1165)."""
        from dynamo_tpu_torch.protocols.openai import (
            ChatCompletionRequest,
            ChatMessage,
            ResponseMessage,
            ResponseOutputText,
            ResponsesRequest,
            ResponsesResponse,
            ResponsesUsage,
        )

        try:
            req = ResponsesRequest(**(await request.json()))
        except Exception as exc:
            self._requests.inc(route="responses", status="400")
            return _error(400, f"invalid request: {exc}")
        if req.stream:
            self._requests.inc(route="responses", status="400")
            return _error(400, "streaming /v1/responses is not supported yet")
        entry = self.models.get(req.model)
        if entry is None:
            self._requests.inc(route="responses", status="404")
            return _error(404, f"model '{req.model}' not found")
        request_id = request.headers.get("x-request-id") or uuid.uuid4().hex
        try:
            messages: list[ChatMessage] = []
            if req.instructions:
                messages.append(ChatMessage(role="system", content=req.instructions))
            if isinstance(req.input, str):
                messages.append(ChatMessage(role="user", content=req.input))
            else:
                for m in req.input:
                    messages.append(ChatMessage(
                        role=str(m.get("role", "user")),
                        content=m.get("content")))
            chat_req = ChatCompletionRequest(
                model=req.model, messages=messages,
                max_tokens=req.max_output_tokens,
                temperature=req.temperature, top_p=req.top_p)
            pre = entry.preprocessor.preprocess_chat(chat_req, request_id)
        except Exception as exc:
            self._requests.inc(route="responses", status="400")
            return _error(400, f"invalid input: {exc}")
        # Run the SAME aggregation path as chat (jail included, so reasoning/
        # tool text never leaks into output_text), then re-envelope.
        backend = DetokenizerBackend(entry.tokenizer, stops=pre.stop_conditions.stop)
        outs: list[BackendOutput] = []
        n_out = 0
        t0 = time.monotonic()
        first = True
        prev = t0
        self._inflight.inc(model=req.model)
        try:
            async for eo in entry.generate(pre):
                now = time.monotonic()
                if eo.spans:
                    self.tracer.ingest(eo.spans)
                if eo.token_ids:
                    if first:
                        self._ttft.observe(now - t0, model=req.model)
                        first = False
                    else:
                        self._itl.observe(now - prev, model=req.model)
                    prev = now
                if eo.error:
                    self._requests.inc(route="responses", status="500")
                    return _error(500, eo.error)
                n_out += len(eo.token_ids)
                outs.append(backend.step(eo))
                if backend.hit_stop:
                    break
        finally:
            self._inflight.inc(-1, model=req.model)
            self._req_dur.observe(time.monotonic() - t0, model=req.model)
        agg = aggregate_chat(req.model, outs, len(pre.token_ids),
                             jail=self._make_jail(entry, chat_req))
        text = agg.choices[0].message.content or "" if agg.choices else ""
        n_in = len(pre.token_ids)
        resp = ResponsesResponse(
            model=req.model,
            output=[ResponseMessage(
                id=f"msg-{request_id}",
                content=[ResponseOutputText(text=text)])],
            usage=ResponsesUsage(input_tokens=n_in, output_tokens=n_out,
                                 total_tokens=n_in + n_out),
        )
        self._requests.inc(route="responses", status="200")
        self._model_requests.inc(model=req.model)
        self._output_tokens.inc(n_out, model=req.model)
        self._input_tokens.inc(n_in, model=req.model)
        return web.Response(text=resp.model_dump_json(),
                            content_type="application/json")

    async def chat_completions(self, request: web.Request) -> web.StreamResponse:
        return await self._serve(request, chat=True)

    async def completions(self, request: web.Request) -> web.StreamResponse:
        return await self._serve(request, chat=False)

    async def _serve(self, request: web.Request, chat: bool) -> web.StreamResponse:
        route = "chat" if chat else "completions"
        try:
            payload = await request.json()
        except json.JSONDecodeError:
            self._requests.inc(route=route, status="400")
            return _error(400, "invalid JSON body")
        try:
            req = ChatCompletionRequest(**payload) if chat else CompletionRequest(**payload)
        except Exception as exc:
            self._requests.inc(route=route, status="400")
            return _error(400, f"invalid request: {exc}")
        entry = self.models.get(req.model)
        if entry is None:
            self._requests.inc(route=route, status="404")
            return _error(404, f"model '{req.model}' not found (have: {self.models.names()})")

        request_id = request.headers.get("x-request-id") or uuid.uuid4().hex
        # Root span: inherits the caller's W3C traceparent when present,
        # otherwise mints a fresh trace. Every hop downstream (router,
        # worker, engine) parents under this id via the obs.traceparent
        # request annotation (docs/OBSERVABILITY.md).
        wire = TraceContext.parse(request.headers.get(TRACEPARENT_HEADER))
        root = self.tracer.start_span("request", ctx=wire, fresh=True,
                                      route=route, model=req.model,
                                      request_id=request_id)
        try:
            resp = await self._serve_traced(request, req, payload, entry,
                                            chat, route, request_id, root)
        except BaseException as exc:
            self.tracer.end_span(root, status="error",
                                 error=type(exc).__name__)
            raise
        status = getattr(resp, "status", 200)
        cancelled = bool(root.attrs.pop("_cancelled", False))
        # Streamed engine errors keep HTTP 200 (headers already sent) but
        # still mark the trace failed via the "error" attr.
        failed = status >= 500 or bool(root.attrs.get("error"))
        self.tracer.end_span(
            root,
            status=("cancelled" if cancelled else "error" if failed
                    else "ok"),
            http_status=status)
        if not resp.prepared:  # streamed responses set these pre-prepare
            resp.headers[TRACE_ID_RESPONSE_HEADER] = root.trace_id
            resp.headers[TRACEPARENT_HEADER] = root.context().header()
        return resp

    async def _serve_traced(self, request: web.Request, req, payload: dict,
                            entry: ModelEntry, chat: bool, route: str,
                            request_id: str, root) -> web.StreamResponse:
        images = None
        if chat:
            try:
                img_bytes = _extract_image_bytes(req.messages)
            except ValueError as exc:
                self._requests.inc(route=route, status="400")
                return _error(400, str(exc))
            if img_bytes:
                if entry.image_encoder is None:
                    self._requests.inc(route=route, status="501")
                    return _error(501, f"model '{req.model}' has no image "
                                       "encoder configured")
                try:
                    images = await entry.image_encoder(img_bytes)
                except RuntimeError as exc:
                    # infrastructure failure (encode worker pool down /
                    # no response) — the CLIENT's request is fine: 502
                    self._requests.inc(route=route, status="502")
                    return _error(502, f"image encoder unavailable: {exc}")
                except Exception as exc:  # noqa: BLE001 - bad image payload
                    self._requests.inc(route=route, status="400")
                    return _error(400, f"image encoding failed: {exc}")
        try:
            with self.tracer.span("frontend.preprocess", parent=root,
                                  model=req.model):
                if chat:
                    pre = entry.preprocessor.preprocess_chat(req, request_id,
                                                             images=images)
                else:
                    pre = entry.preprocessor.preprocess_completion(req, request_id)
        except Exception as exc:
            self._requests.inc(route=route, status="400")
            return _error(400, f"preprocessing failed: {exc}")
        # Downstream hops (router/worker/engine) parent under the root via
        # the same wire-annotation mechanism as the QoS deadline keys.
        pre.annotations[TRACE_KEY] = root.context().header()
        root.attrs["input_tokens"] = len(pre.token_ids)
        # Session stickiness: the x-session-id header (or session_id body
        # field) rides the annotations to the router (turn-affinity) and
        # engine (KV retention) — same wire pattern as the QoS keys.
        session_id = session_id_from(request.headers, payload)
        if session_id is not None:
            pre.annotations[SESSION_KEY] = session_id
            root.attrs["session_id"] = session_id

        # Logprob surface: the sampled token's logprob streams end-to-end;
        # alternatives (top_logprobs / completions logprobs>0) would need the
        # engine to materialize top-k at sample time — rejected explicitly
        # rather than silently returning empty lists.
        if chat and (req.top_logprobs or 0) > 0:
            self._requests.inc(route=route, status="400")
            return _error(400, "top_logprobs > 0 is not supported "
                               "(sampled-token logprobs only)")
        if not chat and (req.logprobs or 0) > 0:
            self._requests.inc(route=route, status="400")
            return _error(400, "logprobs > 0 is not supported "
                               "(pass 0 for sampled-token logprobs)")
        if req.n != 1:
            # Validate here, before the per-model counters tick — a rejected
            # request must not inflate load metrics.
            if req.n < 1:
                self._requests.inc(route=route, status="400")
                return _error(400, "n must be >= 1")
            if req.stream:
                self._requests.inc(route=route, status="400")
                return _error(400, "n>1 with stream=true is not supported")
            if req.n > 16:
                self._requests.inc(route=route, status="400")
                return _error(400, "n must be <= 16")
        rejected = self._qos_gate(request, payload, req, entry, pre, route)
        if rejected is not None:
            return rejected
        self._inflight.inc(model=req.model)
        self._input_tokens.inc(len(pre.token_ids), model=req.model)
        self._model_requests.inc(model=req.model)
        t_start = time.monotonic()
        # TTFT as a span: opened at dispatch, closed (idempotently — n>1
        # runs race) on the first token by whichever path sees it first.
        # Left unended (and so never recorded) when no token arrives.
        ttft_span = self.tracer.start_span("request.ttft", parent=root,
                                           model=req.model)
        try:
            if req.n > 1:
                return await self._aggregate_n(req, entry, pre, chat, t_start,
                                               route, root, ttft_span)
            if req.stream:
                return await self._stream_response(request, req, entry, pre,
                                                   chat, t_start, root,
                                                   ttft_span)
            return await self._aggregate_response(req, entry, pre, chat,
                                                  t_start, route, root,
                                                  ttft_span)
        finally:
            self._inflight.inc(-1, model=req.model)
            self._req_dur.observe(time.monotonic() - t_start, model=req.model)

    # ------------------------------------------------------------------
    def _qos_gate(self, request: web.Request, payload: dict, req,
                  entry: ModelEntry, pre, route: str) -> web.Response | None:
        """Admission control: rate limit, capacity predicate, deadline.
        Returns an error response for rejected requests, None when
        admitted (after stamping priority/deadline annotations on `pre`
        and applying degradation actions)."""
        gw = self.qos
        cfg = gw.cfg
        priority = priority_from(request.headers, payload, cfg.default_priority)
        deadline_ts = deadline_from(request.headers, payload, cfg.default_deadline_ms)
        client = (request.headers.get(CLIENT_HEADER)
                  or getattr(req, "user", None)
                  or request.remote or "anonymous")
        stats = None
        if entry.stats is not None:
            try:
                stats = entry.stats()
            except Exception:  # noqa: BLE001 - stats are advisory
                stats = None
        decision = gw.admit(str(client), priority, stats, deadline_ts)
        if not decision.admitted:
            self._requests.inc(route=route, status=str(decision.status))
            headers = None
            if decision.status in (429, 503):
                import math as _math

                headers = {"Retry-After": str(max(1, _math.ceil(
                    decision.retry_after_s or cfg.retry_after_s)))}
            msgs = {
                "rate_limit": "rate limit exceeded for this client",
                "shed": f"server over capacity; '{priority}' requests are being shed",
                "overload": "server over capacity",
                "deadline": "deadline already expired on arrival",
            }
            return _error(decision.status,
                          msgs.get(decision.reason, "request rejected"),
                          headers=headers)
        gw.annotate(pre, priority, deadline_ts, decision)
        return None

    # ------------------------------------------------------------------
    @staticmethod
    def _make_jail(entry: ModelEntry, req):
        """Per-request StreamJail when the model has parsers configured.
        The tool jail normally engages only when the request sent tools —
        EXCEPT for structural formats (harmony), whose channel framing the
        model emits regardless; without the parser, raw protocol markers
        would leak into user-visible content."""
        tool_cfg = None
        reasoning = None
        if entry.tool_parser:
            from dynamo_tpu_torch.parsers import get_tool_parser

            cfg = get_tool_parser(entry.tool_parser)
            if getattr(req, "tools", None) or cfg.format == "harmony":
                tool_cfg = cfg
        if entry.reasoning_parser:
            from dynamo_tpu_torch.parsers import get_reasoning_parser

            reasoning = get_reasoning_parser(entry.reasoning_parser)
        if tool_cfg is None and reasoning is None:
            return None
        from dynamo_tpu_torch.parsers import StreamJail

        return StreamJail(tool_cfg=tool_cfg, reasoning=reasoning)

    async def _collect_outputs(self, entry: ModelEntry, pre, model: str,
                               t_start: float, root=None,
                               ttft_span=None) -> list[BackendOutput]:
        """Drive one generation to completion: observe TTFT/ITL, detokenize,
        stop at the jail's hidden stop. The single shared unary collection
        loop (used by both the n=1 and n>1 aggregators so metric/stop
        semantics can't diverge). Raises RuntimeError on an engine error."""
        backend = DetokenizerBackend(entry.tokenizer, stops=pre.stop_conditions.stop)
        outs: list[BackendOutput] = []
        first = True
        prev = t_start
        async for eo in entry.generate(pre):
            now = time.monotonic()
            if eo.spans:
                self.tracer.ingest(eo.spans)
            if eo.token_ids:
                if first:
                    self._ttft.observe(now - t_start, model=model)
                    first = False
                    if ttft_span is not None:
                        self.tracer.end_span(ttft_span)
                    if root is not None:
                        root.attrs.setdefault("ttft_s", now - t_start)
                else:
                    self._itl.observe(now - prev, model=model)
                prev = now
            if eo.error:
                raise RuntimeError(eo.error)
            if root is not None and eo.finish_reason is FinishReason.CANCELLED:
                root.attrs["_cancelled"] = True
            outs.append(backend.step(eo))
            if backend.hit_stop:
                break
        if root is not None:
            root.attrs["output_tokens"] = (
                root.attrs.get("output_tokens", 0)
                + sum(len(o.token_ids) for o in outs))
            self._emit_detok_span(root, backend, model)
        return outs

    def _emit_detok_span(self, root, backend: DetokenizerBackend,
                         model: str) -> None:
        """One aggregate frontend.detokenize span per request — the
        accumulated per-delta wall time (DetokenizerBackend.elapsed_s)
        rendered as a span ending now."""
        if backend.elapsed_s <= 0:
            return
        end = time.time()
        sp = self.tracer.start_span(
            "frontend.detokenize", parent=root,
            start=end - backend.elapsed_s, model=model, aggregate=True)
        self.tracer.end_span(sp, end=end)

    async def _aggregate_n(self, req, entry: ModelEntry, pre, chat: bool,
                           t_start: float, route: str, root=None,
                           ttft_span=None) -> web.Response:
        """n>1: run n INDEPENDENT generations concurrently (they batch
        together inside the engine's continuous scheduler) and merge their
        choices. Distinct request ids give each its own sampling slot;
        an explicit seed offsets per choice so results are reproducible yet
        diverse (reference gap: the thin OpenAI surface had no n>1)."""
        import copy

        async def one(i: int):
            sub = copy.deepcopy(pre)
            sub.request_id = f"{pre.request_id}-n{i}"
            if sub.sampling_options.seed is not None:
                sub.sampling_options.seed += i
            return await self._collect_outputs(entry, sub, req.model, t_start,
                                               root=root, ttft_span=ttft_span)

        tasks = [asyncio.ensure_future(one(i)) for i in range(req.n)]
        error: str | None = None
        try:
            all_outs = await asyncio.gather(*tasks)
        except Exception as exc:  # noqa: BLE001 - engine error
            # Cancel the siblings: detached generations would keep consuming
            # scheduler slots and KV blocks after the client already got 500.
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            error = str(exc)
        if error is not None:
            if chat and self._audit.bus() is not None:
                self._audit.publish(self._audit.AuditRecord(
                    request_id=pre.request_id, model=req.model,
                    request=req.model_dump(exclude_none=True), error=error))
            self._requests.inc(route=route, status="500")
            return _error(500, error)
        n_prompt = len(pre.token_ids)
        wants_lp = _wants_logprobs(req, chat)
        agg = ((lambda outs: aggregate_chat(req.model, outs, n_prompt,
                                            jail=self._make_jail(entry, req),
                                            logprobs=wants_lp,
                                            tokenizer=entry.tokenizer))
               if chat else
               (lambda outs: aggregate_completion(req.model, outs, n_prompt,
                                                  logprobs=wants_lp,
                                                  tokenizer=entry.tokenizer)))
        parts = [agg(outs) for outs in all_outs]
        resp = parts[0]
        for i, part in enumerate(parts):
            part.choices[0].index = i
        resp.choices = [p.choices[0] for p in parts]
        from dynamo_tpu_torch.protocols.openai import Usage

        total_out = sum(sum(len(o.token_ids) for o in outs) for outs in all_outs)
        resp.usage = Usage(
            prompt_tokens=n_prompt, completion_tokens=total_out,
            total_tokens=n_prompt + total_out)
        if chat and self._audit.bus() is not None:
            self._audit.publish(self._audit.AuditRecord(
                request_id=pre.request_id, model=req.model,
                request=req.model_dump(exclude_none=True),
                response=resp.model_dump(exclude_none=True)))
        self._output_tokens.inc(total_out, model=req.model)
        self._requests.inc(route=route, status="200")
        return web.Response(text=resp.model_dump_json(exclude_none=True),
                            content_type="application/json")

    async def _aggregate_response(self, req, entry: ModelEntry, pre, chat: bool,
                                  t_start: float, route: str, root=None,
                                  ttft_span=None) -> web.Response:
        try:
            outs = await self._collect_outputs(entry, pre, req.model, t_start,
                                               root=root, ttft_span=ttft_span)
        # RuntimeError: engine error surfaced mid-stream (StreamError,
        # NoInstancesError). ConnectionError/OSError: the data plane itself
        # died and Migration exhausted its retries re-raising the original —
        # every admitted request must still end in a terminal 500, not an
        # unrecorded propagation (the chaos balance invariant).
        except (RuntimeError, ConnectionError, OSError) as exc:
            self._requests.inc(route=route, status="500")
            if chat and self._audit.bus() is not None:
                # Anomalous requests are exactly what a compliance log
                # must not miss (the streaming path audits from finally).
                self._audit.publish(self._audit.AuditRecord(
                    request_id=pre.request_id, model=req.model,
                    requested_streaming=False,
                    request=req.model_dump(exclude_none=True),
                    error=str(exc)))
            return _error(500, str(exc))
        self._output_tokens.inc(sum(len(o.token_ids) for o in outs), model=req.model)
        wants_lp = _wants_logprobs(req, chat)
        if chat:
            resp = aggregate_chat(req.model, outs, len(pre.token_ids),
                                  jail=self._make_jail(entry, req),
                                  logprobs=wants_lp, tokenizer=entry.tokenizer)
            if self._audit.bus() is not None:
                self._audit.publish(self._audit.AuditRecord(
                    request_id=pre.request_id, model=req.model,
                    requested_streaming=False,
                    request=req.model_dump(exclude_none=True),
                    response=resp.model_dump(exclude_none=True)))
        else:
            resp = aggregate_completion(req.model, outs, len(pre.token_ids),
                                        logprobs=wants_lp,
                                        tokenizer=entry.tokenizer)
        self._requests.inc(route=route, status="200")
        return web.Response(text=resp.model_dump_json(exclude_none=True), content_type="application/json")

    async def _stream_response(self, request: web.Request, req, entry: ModelEntry, pre,
                               chat: bool, t_start: float, root=None,
                               ttft_span=None) -> web.StreamResponse:
        headers = {"Content-Type": "text/event-stream", "Cache-Control": "no-cache",
                   "x-request-id": pre.request_id}
        if root is not None:
            headers[TRACE_ID_RESPONSE_HEADER] = root.trace_id
            headers[TRACEPARENT_HEADER] = root.context().header()
        resp = web.StreamResponse(status=200, headers=headers)
        await resp.prepare(request)
        backend = DetokenizerBackend(entry.tokenizer, stops=pre.stop_conditions.stop)
        wants_lp = _wants_logprobs(req, chat)
        gen = ChatDeltaGenerator(req.model, pre.request_id,
                                 logprobs=wants_lp, tokenizer=entry.tokenizer)
        gen.prompt_tokens = len(pre.token_ids)
        jail = self._make_jail(entry, req) if chat else None
        jail_flushed = False
        first = True
        prev = t_start
        ntokens = 0
        audit_text: list[str] = []
        audit_tool_calls: list = []
        audit_error: str | None = None
        lp_pending: list[BackendOutput] = []  # completions: jailed-delta lps
        lp_offset = 0                         # completions: cumulative text pos
        stream = entry.generate(pre)
        disconnected = False
        try:
            if chat:
                await resp.write(encode_sse_json(gen.role_chunk()))
            async for eo in stream:
                if request.transport is None or request.transport.is_closing():
                    # Poll the transport each delta: between deltas nothing
                    # writes, so a dead client would otherwise go unnoticed
                    # until the next write — burning the token budget into a
                    # void (reference: http/service/disconnect.rs:205). The
                    # finally's stream.aclose() propagates the abort down to
                    # the engine/worker.
                    disconnected = True
                    break
                now = time.monotonic()
                if eo.spans:
                    self.tracer.ingest(eo.spans)
                if eo.token_ids:
                    if first:
                        self._ttft.observe(now - t_start, model=req.model)
                        first = False
                        if ttft_span is not None:
                            self.tracer.end_span(ttft_span)
                        if root is not None:
                            root.attrs.setdefault("ttft_s", now - t_start)
                    else:
                        self._itl.observe(now - prev, model=req.model)
                    prev = now
                    ntokens += len(eo.token_ids)
                if root is not None and eo.finish_reason is FinishReason.CANCELLED:
                    root.attrs["_cancelled"] = True
                if eo.error:
                    audit_error = eo.error
                    await resp.write(encode_sse_json({"error": {"message": eo.error, "code": 500}}))
                    break
                out = backend.step(eo)
                if chat:
                    if jail is not None:
                        jd = jail.feed(out.text)
                        if jd.reasoning:
                            await resp.write(encode_sse_json(gen.reasoning_chunk(jd.reasoning)))
                        if out.finish_reason is not None:
                            fin = jail.finish()
                            jail_flushed = True
                            tail = jd.content + fin.content
                            if fin.reasoning:
                                await resp.write(encode_sse_json(gen.reasoning_chunk(fin.reasoning)))
                            if fin.tool_calls:
                                if tail:
                                    audit_text.append(tail)
                                    await resp.write(encode_sse_json(gen.chunk(
                                        BackendOutput(text=tail, token_ids=out.token_ids,
                                                      log_probs=out.log_probs))))
                                    final_out = None  # tokens emitted above
                                else:
                                    gen.completion_tokens += len(out.token_ids)
                                    final_out = out
                                audit_tool_calls.extend(
                                    c.to_openai(index=i)
                                    for i, c in enumerate(fin.tool_calls))
                                await resp.write(encode_sse_json(
                                    gen.tool_calls_chunk(fin.tool_calls, final_out)))
                                if backend.hit_stop:
                                    break
                                continue
                            out = BackendOutput(text=tail, token_ids=out.token_ids,
                                                finish_reason=out.finish_reason,
                                                cum_log_probs=out.cum_log_probs,
                                                log_probs=out.log_probs)
                        else:
                            out = BackendOutput(text=jd.content, token_ids=out.token_ids,
                                                cum_log_probs=out.cum_log_probs,
                                                log_probs=out.log_probs)
                    chunk = gen.chunk(out)
                    if chunk is not None:
                        if out.text:
                            audit_text.append(out.text)
                        await resp.write(encode_sse_json(chunk))
                else:
                    if not out.text and out.finish_reason is None:
                        # jailed/empty delta: hold its tokens' logprobs for
                        # the next emitted chunk (stream completeness).
                        if wants_lp and out.token_ids:
                            lp_pending.append(out)
                    else:
                        from dynamo_tpu_torch.frontend.delta import completion_logprobs
                        from dynamo_tpu_torch.protocols.openai import CompletionChoice, CompletionResponse

                        lp = None
                        if wants_lp:
                            carried = lp_pending + ([out] if out.token_ids else [])
                            lp_pending = []
                            if carried:
                                lp = completion_logprobs(
                                    carried, entry.tokenizer,
                                    start_offset=lp_offset)
                                lp_offset = (lp["text_offset"][-1]
                                             + len(lp["tokens"][-1]))
                        cr = CompletionResponse(
                            id=f"cmpl-{pre.request_id}", model=req.model,
                            choices=[CompletionChoice(
                                text=out.text,
                                finish_reason=str(out.finish_reason) if out.finish_reason else None,
                                logprobs=lp)],
                        )
                        await resp.write(encode_sse_json(cr))
                if backend.hit_stop:
                    break
            if disconnected:
                # Own terminal path — never fall through to the success tail
                # (jail flush, usage, DONE, the 200 counter) on a dead
                # transport; 499 is recorded HERE, not via a failed write.
                log.info("client disconnected mid-stream; aborting %s",
                         pre.request_id)
                audit_error = "client disconnected"
                if root is not None:
                    root.attrs["_cancelled"] = True
                self._requests.inc(route="chat" if chat else "completions",
                                   status="499")
                return resp
            if jail is not None and not jail_flushed:
                # Stream ended without a finish_reason (engine error or stop
                # mid-jail): flush withheld text — a bare-JSON/mistral payload
                # the jail held to end-of-stream would otherwise vanish.
                fin = jail.finish()
                jail_flushed = True
                if fin.reasoning:
                    await resp.write(encode_sse_json(gen.reasoning_chunk(fin.reasoning)))
                if fin.content:
                    audit_text.append(fin.content)
                    tail_chunk = gen.chunk(BackendOutput(text=fin.content))
                    if tail_chunk is not None:
                        await resp.write(encode_sse_json(tail_chunk))
                if fin.tool_calls:
                    audit_tool_calls.extend(
                        c.to_openai(index=i) for i, c in enumerate(fin.tool_calls))
                    await resp.write(encode_sse_json(gen.tool_calls_chunk(fin.tool_calls)))
            if (req.stream_options or {}).get("include_usage"):
                # OpenAI include_usage shape: final chunk, empty choices.
                # ntokens counts engine token_ids directly, so the count is
                # exact for both routes (chat additionally mirrors it in
                # gen.completion_tokens).
                if chat:
                    await resp.write(encode_sse_json(gen.usage_chunk()))
                else:
                    from dynamo_tpu_torch.protocols.openai import CompletionResponse, Usage

                    await resp.write(encode_sse_json(CompletionResponse(
                        id=f"cmpl-{pre.request_id}", model=req.model, choices=[],
                        usage=Usage(prompt_tokens=len(pre.token_ids),
                                    completion_tokens=ntokens,
                                    total_tokens=len(pre.token_ids) + ntokens))))
            await resp.write(DONE_EVENT)
            self._requests.inc(route="chat" if chat else "completions", status="200")
        except (ConnectionResetError, asyncio.CancelledError):
            # client went away — generator cleanup aborts the engine request
            log.info("client disconnected request_id=%s", pre.request_id)
            audit_error = audit_error or "client disconnected"
            if root is not None:
                root.attrs["_cancelled"] = True
            self._requests.inc(route="chat" if chat else "completions", status="499")
        except Exception as exc:  # noqa: BLE001 - backend died mid-stream
            # Headers are already sent, so the client can't get an HTTP 500 —
            # but the request still needs a TERMINAL status (every admitted
            # request must end in exactly one of 200/499/500; the chaos
            # invariant checker holds us to it) and the client a typed error
            # event instead of a silently truncated stream. Migration
            # exhaustion (worker killed repeatedly) lands here.
            log.warning("stream failed mid-flight for %s: %s: %s",
                        pre.request_id, type(exc).__name__, exc)
            audit_error = audit_error or str(exc)
            try:
                await resp.write(encode_sse_json(
                    {"error": {"message": str(exc), "code": 500}}))
            except (ConnectionError, RuntimeError):
                pass  # client is gone too; the counter below still ticks
            self._requests.inc(route="chat" if chat else "completions", status="500")
        finally:
            # Deterministic teardown: close the generation stream NOW (not at
            # GC) so a disconnect-abort reaches the engine/worker while this
            # request's slot is still the thing being freed. The bookkeeping
            # below lives in a nested finally: teardown awaits the data
            # plane, so a CancelledError landing there (the disconnect path
            # itself!) must not skip the metric/audit lines.
            try:
                aclose = getattr(stream, "aclose", None)
                if aclose is not None:
                    await aclose()
            except asyncio.CancelledError:
                # handler is already terminating; the request's terminal
                # state is recorded below either way
                log.info("stream teardown cancelled for %s", pre.request_id)
            except Exception:  # noqa: BLE001
                log.exception("generation stream teardown failed for %s",
                              pre.request_id)
            finally:
                self._output_tokens.inc(ntokens, model=req.model)
                if root is not None:
                    root.attrs["output_tokens"] = ntokens
                    if audit_error and not root.attrs.get("_cancelled"):
                        root.attrs["error"] = audit_error
                    self._emit_detok_span(root, backend, req.model)
                if chat and self._audit.bus() is not None:
                    # From finally so disconnects and engine errors are
                    # audited too — a compliance log that misses exactly the
                    # anomalous streams would be worthless. Streamed text is
                    # accumulated (the reference captures the full response
                    # the same way).
                    self._audit.publish(self._audit.AuditRecord(
                        request_id=pre.request_id, model=req.model,
                        requested_streaming=True,
                        request=req.model_dump(exclude_none=True),
                        response={"content": "".join(audit_text),
                                  "tool_calls": audit_tool_calls or None,
                                  "completion_tokens": gen.completion_tokens},
                        error=audit_error))
        return resp
