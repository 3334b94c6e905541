"""Model registry for the frontend.

Fills the role of the reference's ModelManager + ModelWatcher
(reference: lib/llm/src/discovery/model_manager.rs:35, watcher.rs:50):
models appear/disappear at runtime (static registration here; the
discovery-watcher wires into this in runtime/), each carrying its
preprocessor, detokenizer config, and an engine-facing generate function.

Copy of ``dynamo_tpu/frontend/model_manager.py``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import AsyncIterator, Awaitable, Callable

from dynamo_tpu_torch.preprocessor.preprocessor import ModelDefaults, OpenAIPreprocessor
from dynamo_tpu_torch.protocols.common import LLMEngineOutput, PreprocessedRequest
from dynamo_tpu_torch.tokenizer import BaseTokenizer

# An engine entry point: PreprocessedRequest -> async stream of outputs.
GenerateFn = Callable[[PreprocessedRequest], AsyncIterator[LLMEngineOutput]]


@dataclass
class ModelEntry:
    """One servable model (reference: discovery/model_entry.rs ModelEntry +
    model card)."""

    name: str
    tokenizer: BaseTokenizer
    generate: GenerateFn
    defaults: ModelDefaults
    preprocessor: OpenAIPreprocessor
    stats: Callable[[], dict] | None = None
    clear_kv: Callable[[], Awaitable[None]] | None = None
    # Parser names (dynamo_tpu_torch.parsers registries); None = feature off.
    tool_parser: str | None = None
    reasoning_parser: str | None = None
    # async callable: list[list[int]] -> [N, H] array (None = unsupported)
    embed: "Callable | None" = None
    # async callable: list[bytes] (image files) -> list of [K, H] float32
    # embeddings (None = multimodal unsupported for this model)
    image_encoder: "Callable | None" = None


class ModelManager:
    def __init__(self) -> None:
        self._models: dict[str, ModelEntry] = {}

    def register(
        self,
        name: str,
        tokenizer: BaseTokenizer,
        generate: GenerateFn,
        defaults: ModelDefaults | None = None,
        stats: Callable[[], dict] | None = None,
        clear_kv: Callable[[], Awaitable[None]] | None = None,
        tool_parser: str | None = None,
        reasoning_parser: str | None = None,
        embed: Callable | None = None,
        image_encoder: Callable | None = None,
    ) -> ModelEntry:
        # Fail fast on bad parser names — a typo'd --tool-call-parser must
        # surface at registration, not mid-SSE-stream on the first request.
        if tool_parser:
            from dynamo_tpu_torch.parsers import get_tool_parser

            get_tool_parser(tool_parser)
        if reasoning_parser:
            from dynamo_tpu_torch.parsers import get_reasoning_parser

            get_reasoning_parser(reasoning_parser)
        defaults = defaults or ModelDefaults()
        entry = ModelEntry(
            name=name,
            tokenizer=tokenizer,
            generate=generate,
            defaults=defaults,
            preprocessor=OpenAIPreprocessor(name, tokenizer, defaults),
            stats=stats,
            clear_kv=clear_kv,
            tool_parser=tool_parser,
            reasoning_parser=reasoning_parser,
            embed=embed,
            image_encoder=image_encoder,
        )
        self._models[name] = entry
        return entry

    def unregister(self, name: str) -> None:
        self._models.pop(name, None)

    def get(self, name: str) -> ModelEntry | None:
        return self._models.get(name)

    def names(self) -> list[str]:
        return sorted(self._models)

    def __len__(self) -> int:
        return len(self._models)
