"""KServe v2 inference-protocol frontend (REST binding) — copy of
``dynamo_tpu/frontend/kserve.py`` over the port's HTTP/1.1 server
(``frontend/http.py``, whose ``{name}`` path segments stand in for the
JAX app's routes) and the port's pipeline.

The v2 protocol's HTTP/REST binding (KServe's ModelInfer with the Triton
LLM tensor convention: BYTES ``text_input`` [1] in, ``text_output`` out,
BOOL ``streaming`` flag), plus Triton's LLM extension endpoints
``/generate`` and ``/generate_stream`` for streaming:

    GET  /v2/health/live | /v2/health/ready
    GET  /v2/models/{name}          (metadata: tensor signature)
    GET  /v2/models/{name}/ready
    POST /v2/models/{name}/infer    (unary ModelInfer)
    POST /v2/models/{name}/generate          (Triton LLM extension)
    POST /v2/models/{name}/generate_stream   (SSE deltas)

Requests run through the same preprocessor → engine → detokenizer
pipeline as the OpenAI routes; the routes mount on the same server
(frontend/service.py), so every frontend speaks both protocols on one
port. The gRPC binding of the JAX package is not ported: the card's
machine has neither grpc nor protobuf.
"""

from __future__ import annotations

import json
import uuid

from dynamo_tpu_torch.backend.detokenizer import DetokenizerBackend
from dynamo_tpu_torch.frontend import http as web
from dynamo_tpu_torch.frontend.model_manager import ModelManager
from dynamo_tpu_torch.protocols.openai import CompletionRequest
from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("kserve")

TEXT_INPUT = "text_input"
TEXT_OUTPUT = "text_output"


def _err(status: int, msg: str) -> web.Response:
    return web.json_response({"error": msg}, status=status)


def _sampling_request(model: str, text: str, params: dict) -> CompletionRequest:
    """Map KServe request parameters onto the internal completion request."""
    return CompletionRequest(
        model=model,
        prompt=text,
        max_tokens=int(params.get("max_tokens", 128)),
        temperature=float(params.get("temperature", 0.0)),
        top_p=float(params.get("top_p", 1.0)),
        top_k=int(params["top_k"]) if "top_k" in params else None,
        seed=int(params["seed"]) if "seed" in params else None,
        stop=params.get("stop"),
        min_tokens=int(params["min_tokens"]) if "min_tokens" in params else None,
        ignore_eos=bool(params.get("ignore_eos", False)),
    )


def _parse_infer_inputs(body: dict) -> tuple[str, bool]:
    """Validate the v2 ``inputs`` tensors; returns (text, streaming).

    Mirrors the reference's validation (grpc/service/openai.rs:206-260):
    ``text_input`` must be BYTES with shape [1] (or [1,1]); the optional
    ``streaming``/``stream`` tensor must be BOOL shape [1]."""
    if not isinstance(body, dict):
        raise ValueError("request body must be a JSON object")
    text: str | None = None
    streaming = False
    for t in body.get("inputs") or []:
        if not isinstance(t, dict):
            raise ValueError("each input tensor must be a JSON object")
        name = t.get("name")
        shape = list(t.get("shape") or [])
        data = t.get("data") or []
        if name == TEXT_INPUT:
            if t.get("datatype") != "BYTES":
                raise ValueError(
                    f"expected '{TEXT_INPUT}' to be BYTES, got {t.get('datatype')!r}")
            if shape not in ([1], [1, 1]):
                raise ValueError(
                    f"expected '{TEXT_INPUT}' to have shape [1], got {shape}")
            if len(data) != 1:
                raise ValueError(f"'{TEXT_INPUT}' must contain exactly one element")
            text = str(data[0])
        elif name in ("streaming", "stream"):
            if t.get("datatype") != "BOOL":
                raise ValueError(f"expected '{name}' to be BOOL")
            streaming = bool(data and data[0])
        else:
            raise ValueError(f"unexpected input tensor {name!r}")
    if text is None:
        raise ValueError(f"missing required input tensor '{TEXT_INPUT}'")
    return text, streaming


async def collect_text(entry, pre, model: str, svc=None,
                       on_delta=None) -> tuple[str, str]:
    """Drive the full pipeline to completion; returns (text, finish_reason).

    The one collection loop behind unary infer and generate, so their
    stop/finish semantics and the frontend metric accounting (inflight,
    input/output tokens, TTFT) cannot drift apart.
    ``on_delta(text, finish_reason | None)`` is awaited per detokenized
    delta when given (the streaming flavor); the aggregated text is
    returned either way."""
    import time as _time

    backend = DetokenizerBackend(entry.tokenizer, stops=pre.stop_conditions.stop)
    pieces: list[str] = []
    finish = "stop"
    if svc is not None:
        svc._inflight.inc(model=model)
        svc._input_tokens.inc(len(pre.token_ids), model=model)
    t0 = _time.monotonic()
    first = True
    n_out = 0
    try:
        async for eo in entry.generate(pre):
            if eo.error:
                raise RuntimeError(eo.error)
            if first and eo.token_ids and svc is not None:
                svc._ttft.observe(_time.monotonic() - t0, model=model)
                first = False
            n_out += len(eo.token_ids)
            out = backend.step(eo)
            if out.text:
                pieces.append(out.text)
            if out.finish_reason is not None:
                finish = str(out.finish_reason)
            if on_delta is not None and (out.text or out.finish_reason is not None):
                await on_delta(out.text, str(out.finish_reason)
                               if out.finish_reason is not None else None)
            if backend.hit_stop:
                break
    finally:
        if svc is not None:
            svc._inflight.inc(-1, model=model)
            svc._output_tokens.inc(n_out, model=model)
            svc._model_requests.inc(model=model)
    return "".join(pieces), finish


class KServeFrontend:
    """v2-protocol routes over a ModelManager. ``service`` (the owning
    HttpService) supplies the frontend metric instruments so /v2 traffic
    shows up on /metrics exactly like the OpenAI routes."""

    def __init__(self, models: ModelManager, service=None):
        self.models = models
        self._svc = service

    def _count(self, status: str) -> None:
        if self._svc is not None:
            self._svc._requests.inc(route="kserve", status=status)

    def register(self, app: web.HttpServer) -> None:
        app.add_get("/v2/health/live", self.live)
        app.add_get("/v2/health/ready", self.ready)
        app.add_get("/v2/models/{name}", self.model_metadata)
        app.add_get("/v2/models/{name}/ready", self.model_ready)
        app.add_post("/v2/models/{name}/infer", self.infer)
        app.add_post("/v2/models/{name}/generate", self.generate)
        app.add_post("/v2/models/{name}/generate_stream", self.generate_stream)

    # -- health / metadata -------------------------------------------------
    async def live(self, request: web.Request) -> web.Response:
        return web.json_response({"live": True})

    async def ready(self, request: web.Request) -> web.Response:
        ok = len(self.models) > 0
        return web.json_response({"ready": ok}, status=200 if ok else 503)

    async def model_ready(self, request: web.Request) -> web.Response:
        name = request.match_info["name"]
        ok = self.models.get(name) is not None
        return web.json_response({"ready": ok}, status=200 if ok else 404)

    async def model_metadata(self, request: web.Request) -> web.Response:
        name = request.match_info["name"]
        if self.models.get(name) is None:
            return _err(404, f"model '{name}' not found")
        return web.json_response({
            "name": name,
            "versions": ["1"],
            "platform": "dynamo_tpu",
            "inputs": [
                {"name": TEXT_INPUT, "datatype": "BYTES", "shape": [1]},
                {"name": "streaming", "datatype": "BOOL", "shape": [1]},
            ],
            "outputs": [
                {"name": TEXT_OUTPUT, "datatype": "BYTES", "shape": [1]},
                {"name": "finish_reason", "datatype": "BYTES", "shape": [1]},
            ],
        })

    # -- inference ---------------------------------------------------------
    def _preprocess(self, name: str, text: str, params: dict):
        """Build + preprocess; raises ValueError for malformed client
        parameters (mapped to 400, like the tensor validation)."""
        entry = self.models.get(name)
        assert entry is not None
        if not isinstance(params, dict):
            raise ValueError("'parameters' must be a JSON object")
        try:
            req = _sampling_request(name, text, params)
            return entry, entry.preprocessor.preprocess_completion(req, uuid.uuid4().hex)
        except (ValueError, TypeError, AttributeError) as exc:
            raise ValueError(f"invalid parameters: {exc}") from exc

    async def _run(self, entry, pre, model: str) -> tuple[str, str]:
        return await collect_text(entry, pre, model, self._svc)

    async def infer(self, request: web.Request) -> web.Response:
        name = request.match_info["name"]
        if self.models.get(name) is None:
            return _err(404, f"model '{name}' not found")
        try:
            body = await request.json()
        except json.JSONDecodeError:
            self._count("400")
            return _err(400, "invalid JSON body")
        try:
            text, streaming = _parse_infer_inputs(body)
        except ValueError as exc:
            self._count("400")
            return _err(400, str(exc))
        if streaming:
            self._count("400")
            return _err(400, "REST ModelInfer is unary; use /generate_stream")
        try:
            entry, pre = self._preprocess(name, text, body.get("parameters") or {})
        except ValueError as exc:
            self._count("400")
            return _err(400, str(exc))
        try:
            out_text, finish = await self._run(entry, pre, name)
        except Exception as exc:  # noqa: BLE001 - surfaced to the client
            log.exception("kserve infer failed")
            self._count("500")
            return _err(500, str(exc))
        self._count("200")
        return web.json_response({
            "model_name": name,
            "model_version": "1",
            "id": body.get("id") or uuid.uuid4().hex,
            "outputs": [
                {"name": TEXT_OUTPUT, "datatype": "BYTES", "shape": [1],
                 "data": [out_text]},
                {"name": "finish_reason", "datatype": "BYTES", "shape": [1],
                 "data": [finish]},
            ],
        })

    async def generate(self, request: web.Request) -> web.Response:
        """Triton LLM extension: {"text_input": ..., "parameters": {...}}."""
        name = request.match_info["name"]
        if self.models.get(name) is None:
            return _err(404, f"model '{name}' not found")
        try:
            body = await request.json()
        except json.JSONDecodeError:
            self._count("400")
            return _err(400, "invalid JSON body")
        if not isinstance(body, dict) or TEXT_INPUT not in body:
            self._count("400")
            return _err(400, f"missing '{TEXT_INPUT}'")
        try:
            entry, pre = self._preprocess(
                name, str(body[TEXT_INPUT]), body.get("parameters") or {})
        except ValueError as exc:
            self._count("400")
            return _err(400, str(exc))
        try:
            out_text, finish = await self._run(entry, pre, name)
        except Exception as exc:  # noqa: BLE001
            log.exception("kserve generate failed")
            self._count("500")
            return _err(500, str(exc))
        self._count("200")
        return web.json_response({
            "model_name": name, TEXT_OUTPUT: out_text, "finish_reason": finish,
        })

    async def generate_stream(self, request: web.Request) -> web.StreamResponse:
        """Triton LLM extension, SSE: one event per text delta."""
        name = request.match_info["name"]
        entry = self.models.get(name)
        if entry is None:
            return _err(404, f"model '{name}' not found")
        try:
            body = await request.json()
        except json.JSONDecodeError:
            self._count("400")
            return _err(400, "invalid JSON body")
        if not isinstance(body, dict) or TEXT_INPUT not in body:
            self._count("400")
            return _err(400, f"missing '{TEXT_INPUT}'")
        try:
            entry, pre = self._preprocess(
                name, str(body[TEXT_INPUT]), body.get("parameters") or {})
        except ValueError as exc:
            self._count("400")
            return _err(400, str(exc))
        backend = DetokenizerBackend(entry.tokenizer, stops=pre.stop_conditions.stop)
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream", "Cache-Control": "no-cache"})
        await resp.prepare(request)

        def event(obj: dict) -> bytes:
            return f"data: {json.dumps(obj)}\n\n".encode()

        import time as _time

        svc = self._svc
        if svc is not None:
            svc._inflight.inc(model=name)
            svc._input_tokens.inc(len(pre.token_ids), model=name)
        t0 = _time.monotonic()
        first = True
        n_out = 0
        try:
            async for eo in entry.generate(pre):
                if request.transport is None or request.transport.is_closing():
                    return resp  # client gone; generator finalizer aborts
                if eo.error:
                    await resp.write(event({"error": eo.error}))
                    return resp
                if first and eo.token_ids and svc is not None:
                    svc._ttft.observe(_time.monotonic() - t0, model=name)
                    first = False
                n_out += len(eo.token_ids)
                out = backend.step(eo)
                if out.text or out.finish_reason is not None:
                    await resp.write(event({
                        "model_name": name,
                        TEXT_OUTPUT: out.text,
                        **({"finish_reason": str(out.finish_reason)}
                           if out.finish_reason is not None else {}),
                    }))
                if backend.hit_stop:
                    break
        except ConnectionResetError:
            pass
        finally:
            if svc is not None:
                svc._inflight.inc(-1, model=name)
                svc._output_tokens.inc(n_out, model=name)
                svc._model_requests.inc(model=name)
        self._count("200")
        return resp


def register_kserve(app: web.HttpServer, models: ModelManager,
                    service=None) -> KServeFrontend:
    fe = KServeFrontend(models, service=service)
    fe.register(app)
    return fe
