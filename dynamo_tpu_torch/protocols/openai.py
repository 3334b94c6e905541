"""OpenAI-compatible API types — copy of ``dynamo_tpu/protocols/openai.py``
without pydantic, which the card's machine lacks.

Each model is a dataclass (``OpenAIModel``) whose keyword constructor
validates and coerces its fields from their annotations as pydantic's lax
mode does, on every field type these models use:

* ``str`` takes strings only (a number is rejected);
* ``int`` takes ints, bools, integral floats inside the int64 range, and
  strings of an integer (``" 2 "``, ``"1_000"``, ``"2.00"``);
* ``float`` takes ints, floats, bools and strings of a float (``"0.5"``,
  ``"1e3"``, ``"inf"``, ``"1_0.5"``);
* ``bool`` takes bools, 0 / 1 (int or float) and the strings
  ``true/false/yes/no/on/off/t/f/y/n/1/0`` in any case;
* a union takes the first member that accepts the value strictly (no
  coercion), else the first that accepts it laxly — pydantic's smart mode
  (``prompt: str | list[str] | list[int] | list[list[int]]`` reads
  ``[1.0, 2.0]`` as ``[1, 2]`` and ``["a", 1]`` not at all);
* ``Literal`` takes its listed values; a nested model takes an instance or
  a dict of its fields; ``list`` / ``dict`` check their items.

``extra="allow"`` keeps unknown keys (read back as attributes, dumped after
the fields); the default ignores them. ``model_dump(exclude_none=True)``
drops ``None`` fields and extras, not ``None`` inside a dict value;
``model_dump_json`` writes compact UTF-8 JSON with non-finite floats as
``null``, as pydantic does (``json.dumps`` would write ``-Infinity``, which
is not JSON). A rejected payload raises ``ValidationError`` (a
``ValueError``) naming each field at fault.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import time
import types
import typing
import uuid
from typing import Any, Callable, Literal

# ---------------------------------------------------------------------------
# Validation and serialization (the subset of pydantic's lax mode in use)
# ---------------------------------------------------------------------------


class ValidationError(ValueError):
    """A payload a model rejects; ``errors`` holds (location, message)."""

    def __init__(self, title: str, errors: list[tuple[str, str]]):
        self.title = title
        self.errors = errors
        n = len(errors)
        lines = [f"{n} validation error{'s' if n != 1 else ''} for {title}"]
        for loc, msg in errors:
            lines += [loc or title, f"  {msg}"]
        super().__init__("\n".join(lines))


class _Invalid(Exception):
    """One field's rejection, raised inside the validators."""

    def __init__(self, msg: str, loc: tuple = ()):
        self.msg, self.loc = msg, loc


_INT_STR = re.compile(r"([+-]?[0-9]+(?:_[0-9]+)*)(?:\.0+)?", re.ASCII)
_FLOAT_STR = re.compile(
    r"[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?|inf|infinity|nan)",
    re.ASCII | re.IGNORECASE)
_BOOL_STR = {"0": False, "off": False, "f": False, "false": False, "n": False, "no": False,
             "1": True, "on": True, "t": True, "true": True, "y": True, "yes": True}
_I64 = 2.0 ** 63


def _desc(v: Any) -> str:
    return f"input_value={v!r:.60}, input_type={type(v).__name__}"


def _v_any(v, strict):
    return v


def _v_str(v, strict):
    if isinstance(v, str):
        return v
    raise _Invalid(f"Input should be a valid string [{_desc(v)}]")


def _v_int(v, strict):
    if type(v) is int:
        return v
    if not strict:
        if isinstance(v, bool):
            return int(v)
        if isinstance(v, float):
            if math.isfinite(v) and v.is_integer() and -_I64 < v < _I64:
                return int(v)
        elif isinstance(v, str):
            m = _INT_STR.fullmatch(v.strip())
            if m is not None:
                try:
                    return int(m.group(1))
                except ValueError:
                    pass  # past int()'s digit limit
        elif isinstance(v, int):
            return int(v)
    raise _Invalid(f"Input should be a valid integer [{_desc(v)}]")


def _v_float(v, strict):
    if isinstance(v, float):
        return v
    if isinstance(v, int) and not isinstance(v, bool):
        try:
            return float(v)
        except OverflowError:
            pass
    elif not strict:
        if isinstance(v, bool):
            return float(v)
        if isinstance(v, str):
            s = v.strip()
            if "_" in s and not (s.startswith("_") or s.endswith("_") or "__" in s):
                s = s.replace("_", "")
            if _FLOAT_STR.fullmatch(s):
                return float(s)
    raise _Invalid(f"Input should be a valid number [{_desc(v)}]")


def _v_bool(v, strict):
    if isinstance(v, bool):
        return v
    if not strict:
        if isinstance(v, (int, float)) and v in (0, 1):
            return bool(v)
        if isinstance(v, str) and v.lower() in _BOOL_STR:
            return _BOOL_STR[v.lower()]
    raise _Invalid(f"Input should be a valid boolean [{_desc(v)}]")


def _v_none(v, strict):
    if v is None:
        return None
    raise _Invalid(f"Input should be None [{_desc(v)}]")


def _compile(tp) -> Callable[[Any, bool], Any]:
    """The validator of annotation ``tp``: ``f(value, strict) -> value``,
    raising ``_Invalid``."""
    simple = {Any: _v_any, str: _v_str, int: _v_int, float: _v_float, bool: _v_bool,
              type(None): _v_none, None: _v_none}
    if tp in simple:
        return simple[tp]
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if origin in (typing.Union, types.UnionType):
        members = [_compile(a) for a in args]

        def v_union(v, strict):
            for check in (True, False) if not strict else (True,):
                for m in members:
                    try:
                        return m(v, check)
                    except _Invalid:
                        pass
            raise _Invalid(f"Input matches no member of {tp} [{_desc(v)}]")
        return v_union
    if origin is Literal:
        choices = args

        def v_literal(v, strict):
            if any(v == c and type(v) is type(c) for c in choices):
                return v
            raise _Invalid(f"Input should be {' or '.join(map(repr, choices))} [{_desc(v)}]")
        return v_literal
    if tp is list or origin is list:
        item = _compile(args[0]) if args else _v_any

        def v_list(v, strict):
            if not isinstance(v, list) and (strict or not isinstance(v, tuple)):
                raise _Invalid(f"Input should be a valid list [{_desc(v)}]")
            out = []
            for i, x in enumerate(v):
                try:
                    out.append(item(x, strict))
                except _Invalid as e:
                    raise _Invalid(e.msg, (i, *e.loc)) from None
            return out
        return v_list
    if tp is dict or origin is dict:
        val = _compile(args[1]) if args else _v_any

        def v_dict(v, strict):
            if not isinstance(v, dict):
                raise _Invalid(f"Input should be a valid dictionary [{_desc(v)}]")
            out = {}
            for k, x in v.items():
                if not isinstance(k, str):
                    raise _Invalid(f"Keys should be strings [{_desc(k)}]", (k,))
                try:
                    out[k] = val(x, strict)
                except _Invalid as e:
                    raise _Invalid(e.msg, (k, *e.loc)) from None
            return out
        return v_dict
    if isinstance(tp, type) and issubclass(tp, OpenAIModel):
        def v_model(v, strict):
            if isinstance(v, tp):
                return v
            if isinstance(v, dict):
                try:
                    return tp(**v)
                except ValidationError as e:
                    loc, msg = e.errors[0]
                    raise _Invalid(msg, tuple(loc.split("."))) from None
            raise _Invalid(f"Input should be a valid dictionary or instance of "
                           f"{tp.__name__} [{_desc(v)}]")
        return v_model
    raise TypeError(f"no validator for annotation {tp!r}")


def _dump(v: Any, exclude_none: bool) -> Any:
    if isinstance(v, OpenAIModel):
        return v.model_dump(exclude_none=exclude_none)
    if isinstance(v, (list, tuple)):
        return [_dump(x, exclude_none) for x in v]
    if isinstance(v, dict):
        return {k: _dump(x, exclude_none) for k, x in v.items()}
    return v


def _json_safe(v: Any) -> Any:
    """Non-finite floats → None (JSON has no Infinity or NaN)."""
    if isinstance(v, float):
        return v if math.isfinite(v) else None
    if isinstance(v, list):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {k: _json_safe(x) for k, x in v.items()}
    return v


def dump_json(obj: Any) -> str:
    """Compact UTF-8 JSON of plain data, non-finite floats as ``null``."""
    return json.dumps(_json_safe(obj), ensure_ascii=False, separators=(",", ":"))


class OpenAIModel:
    """Base of the API models: a subclass is made a dataclass (without its
    generated ``__init__``) whose keyword constructor validates each field
    against its annotation. ``class M(OpenAIModel, extra="allow")`` keeps
    unknown keys."""

    _extra_mode: typing.ClassVar[str] = "ignore"
    _validators: typing.ClassVar[dict | None] = None

    def __init_subclass__(cls, extra: str | None = None, **kw):
        super().__init_subclass__(**kw)
        if extra is not None:
            cls._extra_mode = extra
        cls._validators = None
        dataclasses.dataclass(init=False)(cls)

    @classmethod
    def _fields(cls) -> dict:
        if cls.__dict__.get("_validators") is None:
            hints = typing.get_type_hints(cls)
            cls._validators = {f.name: (_compile(hints[f.name]), f)
                               for f in dataclasses.fields(cls)}
        return cls._validators

    def __init__(self, /, **data: Any):
        errors: list[tuple[str, str]] = []
        for name, (check, f) in self._fields().items():
            if name in data:
                try:
                    value = check(data[name], False)
                except _Invalid as e:
                    errors.append((".".join(map(str, (name, *e.loc))), e.msg))
                    continue
            elif f.default is not dataclasses.MISSING:
                value = f.default
            elif f.default_factory is not dataclasses.MISSING:
                value = f.default_factory()
            else:
                errors.append((name, "Field required"))
                continue
            object.__setattr__(self, name, value)
        if errors:
            raise ValidationError(type(self).__name__, errors)
        extra = {}
        if self._extra_mode == "allow":
            extra = {k: v for k, v in data.items() if k not in self._fields()}
        object.__setattr__(self, "_extra", extra)

    def __getattr__(self, name: str) -> Any:
        # only reached when normal lookup fails: the extras
        extra = self.__dict__.get("_extra") or {}
        if name in extra:
            return extra[name]
        raise AttributeError(f"{type(self).__name__!r} object has no attribute {name!r}")

    def model_dump(self, exclude_none: bool = False) -> dict[str, Any]:
        out = {}
        for name in self._fields():
            v = getattr(self, name)
            if v is None and exclude_none:
                continue
            out[name] = _dump(v, exclude_none)
        for k, v in self._extra.items():
            if v is None and exclude_none:
                continue
            out[k] = _dump(v, exclude_none)
        return out

    def model_dump_json(self, exclude_none: bool = False) -> str:
        return dump_json(self.model_dump(exclude_none=exclude_none))


# ---------------------------------------------------------------------------
# The API models (field for field the JAX package's)
# ---------------------------------------------------------------------------


class NvExt(OpenAIModel, extra="allow"):
    """Framework extension field (reference: nvext.rs) — annotations request
    server-side events like ttft breakdown; use_raw_prompt skips templating."""

    annotations: list[str] | None = None
    use_raw_prompt: bool | None = None
    greed_sampling: bool | None = None


class ChatMessage(OpenAIModel, extra="allow"):
    role: str
    content: str | list[dict[str, Any]] | None = None
    name: str | None = None
    tool_calls: list[dict[str, Any]] | None = None
    tool_call_id: str | None = None
    reasoning_content: str | None = None

    def text_content(self) -> str:
        if self.content is None:
            return ""
        if isinstance(self.content, str):
            return self.content
        # multimodal content parts; concatenate text parts
        return "".join(p.get("text", "") for p in self.content if isinstance(p, dict) and p.get("type") == "text")


class ChatCompletionRequest(OpenAIModel, extra="allow"):
    model: str
    messages: list[ChatMessage]
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None  # extension (vLLM-compatible)
    n: int = 1
    stream: bool = False
    stream_options: dict[str, Any] | None = None
    stop: str | list[str] | None = None
    max_tokens: int | None = None
    max_completion_tokens: int | None = None
    min_tokens: int | None = None
    presence_penalty: float | None = None
    frequency_penalty: float | None = None
    repetition_penalty: float | None = None
    logprobs: bool | None = None
    top_logprobs: int | None = None
    seed: int | None = None
    user: str | None = None
    tools: list[dict[str, Any]] | None = None
    tool_choice: str | dict[str, Any] | None = None
    response_format: dict[str, Any] | None = None
    ignore_eos: bool | None = None
    nvext: NvExt | None = None

    def stop_list(self) -> list[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)

    def effective_max_tokens(self) -> int | None:
        return self.max_completion_tokens or self.max_tokens


class CompletionRequest(OpenAIModel, extra="allow"):
    model: str
    prompt: str | list[str] | list[int] | list[list[int]]
    suffix: str | None = None
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    n: int = 1
    stream: bool = False
    stream_options: dict[str, Any] | None = None
    stop: str | list[str] | None = None
    max_tokens: int | None = None
    min_tokens: int | None = None
    presence_penalty: float | None = None
    frequency_penalty: float | None = None
    repetition_penalty: float | None = None
    logprobs: int | None = None
    echo: bool = False
    seed: int | None = None
    user: str | None = None
    response_format: dict[str, Any] | None = None
    ignore_eos: bool | None = None
    nvext: NvExt | None = None

    def stop_list(self) -> list[str]:
        if self.stop is None:
            return []
        return [self.stop] if isinstance(self.stop, str) else list(self.stop)


class EmbeddingRequest(OpenAIModel, extra="allow"):
    model: str
    input: str | list[str] | list[int] | list[list[int]]
    encoding_format: Literal["float", "base64"] = "float"
    dimensions: int | None = None
    user: str | None = None


class Usage(OpenAIModel):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


def _gen_id(prefix: str) -> str:
    return f"{prefix}-{uuid.uuid4().hex}"


def now_s() -> int:
    return int(time.time())


_field = dataclasses.field


class ChatChoiceDelta(OpenAIModel):
    role: str | None = None
    content: str | None = None
    tool_calls: list[dict[str, Any]] | None = None
    reasoning_content: str | None = None


class ChatChunkChoice(OpenAIModel):
    index: int = 0
    delta: ChatChoiceDelta
    finish_reason: str | None = None
    logprobs: dict[str, Any] | None = None


class ChatCompletionChunk(OpenAIModel):
    id: str
    object: Literal["chat.completion.chunk"] = "chat.completion.chunk"
    created: int = _field(default_factory=now_s)
    model: str = ""
    choices: list[ChatChunkChoice] = _field(default_factory=list)
    usage: Usage | None = None


class ChatChoice(OpenAIModel):
    index: int = 0
    message: ChatMessage
    finish_reason: str | None = None
    logprobs: dict[str, Any] | None = None


class ChatCompletionResponse(OpenAIModel):
    id: str = _field(default_factory=lambda: _gen_id("chatcmpl"))
    object: Literal["chat.completion"] = "chat.completion"
    created: int = _field(default_factory=now_s)
    model: str = ""
    choices: list[ChatChoice] = _field(default_factory=list)
    usage: Usage = _field(default_factory=Usage)


class CompletionChoice(OpenAIModel):
    index: int = 0
    text: str = ""
    finish_reason: str | None = None
    logprobs: dict[str, Any] | None = None


class ResponsesRequest(OpenAIModel):
    """POST /v1/responses, minimal surface (reference route:
    http/service/openai.rs:1165)."""

    model: str = ""
    input: str | list[dict] = ""
    instructions: str | None = None
    max_output_tokens: int | None = None
    temperature: float | None = None
    top_p: float | None = None
    stream: bool = False


class ResponseOutputText(OpenAIModel):
    type: Literal["output_text"] = "output_text"
    text: str = ""
    annotations: list = _field(default_factory=list)


class ResponseMessage(OpenAIModel):
    type: Literal["message"] = "message"
    id: str = ""
    role: Literal["assistant"] = "assistant"
    status: str = "completed"
    content: list[ResponseOutputText] = _field(default_factory=list)


class ResponsesUsage(OpenAIModel):
    input_tokens: int = 0
    output_tokens: int = 0
    total_tokens: int = 0


class ResponsesResponse(OpenAIModel):
    id: str = _field(default_factory=lambda: _gen_id("resp"))
    object: Literal["response"] = "response"
    created_at: int = _field(default_factory=now_s)
    status: str = "completed"
    model: str = ""
    output: list[ResponseMessage] = _field(default_factory=list)
    usage: ResponsesUsage | None = None


class CompletionResponse(OpenAIModel):
    id: str = _field(default_factory=lambda: _gen_id("cmpl"))
    object: Literal["text_completion"] = "text_completion"
    created: int = _field(default_factory=now_s)
    model: str = ""
    choices: list[CompletionChoice] = _field(default_factory=list)
    usage: Usage | None = None


class ModelInfo(OpenAIModel):
    id: str
    object: Literal["model"] = "model"
    created: int = _field(default_factory=now_s)
    owned_by: str = "dynamo_tpu"


class ModelList(OpenAIModel):
    object: Literal["list"] = "list"
    data: list[ModelInfo] = _field(default_factory=list)


class EmbeddingData(OpenAIModel):
    object: Literal["embedding"] = "embedding"
    index: int
    # list for encoding_format="float", base64 string of f32 LE bytes else
    embedding: list[float] | str


class EmbeddingResponse(OpenAIModel):
    object: Literal["list"] = "list"
    data: list[EmbeddingData] = _field(default_factory=list)
    model: str = ""
    usage: Usage = _field(default_factory=Usage)


class ErrorInfo(OpenAIModel):
    message: str
    type: str = "invalid_request_error"
    code: int | str | None = None


class ErrorResponse(OpenAIModel):
    error: ErrorInfo
