"""Internal engine-facing protocol types — copy of
``dynamo_tpu/protocols/common.py``.

``PreprocessedRequest`` is what flows to an engine (token ids plus
sampling/stop options); ``LLMEngineOutput`` is what an engine streams back
(token deltas); ``BackendOutput`` is a detokenized delta on its way to
the OpenAI response. The wire dicts are the JAX package's, field for field.
"""

from __future__ import annotations

import enum
import uuid
from dataclasses import dataclass, field
from typing import Any


class FinishReason(str, enum.Enum):
    STOP = "stop"            # eos or stop-sequence hit
    LENGTH = "length"        # max_tokens reached
    CANCELLED = "cancelled"  # client disconnected / context stopped
    ERROR = "error"

    def __str__(self) -> str:  # serialize as plain string
        return self.value


@dataclass
class StopConditions:
    max_tokens: int | None = None
    stop: list[str] = field(default_factory=list)           # string stop sequences
    stop_token_ids: list[int] = field(default_factory=list)  # exact token stops
    min_tokens: int | None = None
    ignore_eos: bool = False

    def to_dict(self) -> dict:
        return {
            "max_tokens": self.max_tokens,
            "stop": self.stop,
            "stop_token_ids": self.stop_token_ids,
            "min_tokens": self.min_tokens,
            "ignore_eos": self.ignore_eos,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "StopConditions":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})  # type: ignore[arg-type]


@dataclass
class SamplingOptions:
    temperature: float | None = None
    top_p: float | None = None
    top_k: int | None = None
    frequency_penalty: float | None = None
    presence_penalty: float | None = None
    repetition_penalty: float | None = None
    seed: int | None = None
    logprobs: int | None = None
    n: int = 1
    # Structured output (OpenAI response_format): None = unconstrained,
    # {} = json_object mode, non-empty dict = json_schema subset
    # (engine/guided.py).
    guided_json: dict | None = None

    def to_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}

    @classmethod
    def from_dict(cls, d: dict) -> "SamplingOptions":
        return cls(**{k: d[k] for k in cls.__dataclass_fields__ if k in d})  # type: ignore[arg-type]


def tensor_to_wire(arr) -> dict:
    """ONE envelope for tensors riding a request ({data, shape, dtype}:
    multimodal embedding spans). Both directions live here so encoders,
    frontends and engines can never drift on the format."""
    import numpy as np

    a = np.ascontiguousarray(arr, np.float32)
    return {"data": a.tobytes(), "shape": list(a.shape), "dtype": "float32"}


def tensor_from_wire(d: dict):
    import numpy as np

    return np.frombuffer(
        d["data"], np.dtype(d.get("dtype", "float32"))
    ).reshape(d["shape"]).astype(np.float32)


@dataclass
class PreprocessedRequest:
    """Tokenized request handed to an engine."""

    token_ids: list[int]
    model: str = ""
    request_id: str = field(default_factory=lambda: uuid.uuid4().hex)
    stop_conditions: StopConditions = field(default_factory=StopConditions)
    sampling_options: SamplingOptions = field(default_factory=SamplingOptions)
    eos_token_ids: list[int] = field(default_factory=list)
    annotations: dict[str, Any] = field(default_factory=dict)
    kv_transfer_params: dict[str, Any] | None = None
    estimated_prefix_hit_blocks: int = 0
    # Multimodal embedding spans ({pos, data, shape, dtype}: the forward
    # takes these rows in place of the placeholder tokens' embeddings).
    mm_embeddings: list[dict] | None = None

    def to_dict(self) -> dict:
        return {
            "token_ids": self.token_ids,
            "model": self.model,
            "request_id": self.request_id,
            "stop_conditions": self.stop_conditions.to_dict(),
            "sampling_options": self.sampling_options.to_dict(),
            "eos_token_ids": self.eos_token_ids,
            "annotations": self.annotations,
            "kv_transfer_params": self.kv_transfer_params,
            "estimated_prefix_hit_blocks": self.estimated_prefix_hit_blocks,
            "mm_embeddings": self.mm_embeddings,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "PreprocessedRequest":
        return cls(
            token_ids=list(d["token_ids"]),
            model=d.get("model", ""),
            request_id=d.get("request_id") or uuid.uuid4().hex,
            stop_conditions=StopConditions.from_dict(d.get("stop_conditions") or {}),
            sampling_options=SamplingOptions.from_dict(d.get("sampling_options") or {}),
            eos_token_ids=list(d.get("eos_token_ids") or []),
            annotations=dict(d.get("annotations") or {}),
            kv_transfer_params=d.get("kv_transfer_params"),
            estimated_prefix_hit_blocks=d.get("estimated_prefix_hit_blocks", 0),
            mm_embeddings=d.get("mm_embeddings"),
        )


@dataclass
class LLMEngineOutput:
    """One streamed engine delta (a batch of new tokens for one request)."""

    token_ids: list[int] = field(default_factory=list)
    finish_reason: FinishReason | None = None
    cum_log_probs: float | None = None
    log_probs: list[float] | None = None
    kv_transfer_params: dict[str, Any] | None = None
    error: str | None = None
    spans: list[dict] | None = None

    def to_dict(self) -> dict:
        d: dict[str, Any] = {"token_ids": self.token_ids}
        if self.finish_reason is not None:
            d["finish_reason"] = str(self.finish_reason)
        if self.cum_log_probs is not None:
            d["cum_log_probs"] = self.cum_log_probs
        if self.log_probs is not None:
            d["log_probs"] = self.log_probs
        if self.kv_transfer_params is not None:
            d["kv_transfer_params"] = self.kv_transfer_params
        if self.error is not None:
            d["error"] = self.error
        if self.spans is not None:
            d["spans"] = self.spans
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LLMEngineOutput":
        fr = d.get("finish_reason")
        return cls(
            token_ids=list(d.get("token_ids") or []),
            finish_reason=FinishReason(fr) if fr else None,
            cum_log_probs=d.get("cum_log_probs"),
            log_probs=d.get("log_probs"),
            kv_transfer_params=d.get("kv_transfer_params"),
            error=d.get("error"),
            spans=d.get("spans"),
        )


@dataclass
class BackendOutput:
    """Post-detokenization delta: text plus the tokens that produced it."""

    text: str = ""
    token_ids: list[int] = field(default_factory=list)
    finish_reason: FinishReason | None = None
    cum_log_probs: float | None = None
    log_probs: list[float] | None = None  # per token in token_ids
