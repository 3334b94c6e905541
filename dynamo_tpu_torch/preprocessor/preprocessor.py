"""OpenAI → internal request translation (tokenize, template, defaults) —
copy of ``dynamo_tpu/preprocessor/preprocessor.py``. The card's machine has
no ``xxhash``: the placeholder ids of image spans come from the port's own
XXH3-64 (``dynamo_tpu_torch.tokens.xxh3_64``), equal to
``xxh3_64_intdigest`` bit for bit, since they feed the prefix hashes.

Fills the role of the reference's OpenAIPreprocessor
(reference: lib/llm/src/preprocessor.rs:4-66): apply the model card's
defaults, render the prompt template (chat messages → text), tokenize, and
produce a ``PreprocessedRequest``; the reverse edge builds OpenAI deltas
from backend output (see frontend/delta.py).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from dynamo_tpu_torch.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
from dynamo_tpu_torch.protocols.openai import ChatCompletionRequest, CompletionRequest
from dynamo_tpu_torch.tokenizer import BaseTokenizer
from dynamo_tpu_torch.tokens import xxh3_64


@dataclass
class ModelDefaults:
    """Per-model generation defaults (subset of the reference's
    ModelDeploymentCard, lib/llm/src/model_card.rs:91)."""

    max_model_len: int = 8192
    default_max_tokens: int = 1024
    eos_token_ids: list[int] | None = None
    temperature: float | None = None
    top_p: float | None = None


class OpenAIPreprocessor:
    def __init__(self, model_name: str, tokenizer: BaseTokenizer, defaults: ModelDefaults | None = None):
        self.model_name = model_name
        self.tokenizer = tokenizer
        self.defaults = defaults or ModelDefaults()
        if self.defaults.eos_token_ids is None:
            eos = getattr(tokenizer, "eos_id", None)
            self.defaults.eos_token_ids = [eos] if eos is not None else []

    # ------------------------------------------------------------------
    def _sampling(self, req: ChatCompletionRequest | CompletionRequest) -> SamplingOptions:
        d = self.defaults
        return SamplingOptions(
            temperature=req.temperature if req.temperature is not None else d.temperature,
            top_p=req.top_p if req.top_p is not None else d.top_p,
            top_k=getattr(req, "top_k", None),
            frequency_penalty=req.frequency_penalty,
            presence_penalty=req.presence_penalty,
            repetition_penalty=getattr(req, "repetition_penalty", None),
            seed=req.seed,
            n=req.n or 1,
            guided_json=self._guided(req),
        )

    @staticmethod
    def _guided(req) -> dict | None:
        """OpenAI response_format → the engine's guided_json constraint
        (engine/guided.py): {} for json_object, the schema dict for
        json_schema, None otherwise ("text" passes through)."""
        rf = getattr(req, "response_format", None)
        if not rf:
            return None
        kind = rf.get("type")
        if kind == "json_object":
            return {}
        if kind == "json_schema":
            js = rf.get("json_schema") or {}
            schema = js.get("schema") if isinstance(js, dict) else None
            return schema if isinstance(schema, dict) else {}
        return None

    def _stops(self, req: ChatCompletionRequest | CompletionRequest, max_tokens: int | None,
               prompt_len: int) -> StopConditions:
        cap = self.defaults.max_model_len - prompt_len
        mt = max_tokens if max_tokens is not None else self.defaults.default_max_tokens
        return StopConditions(
            max_tokens=max(min(mt, cap), 0),
            stop=req.stop_list(),
            min_tokens=getattr(req, "min_tokens", None),
            ignore_eos=bool(getattr(req, "ignore_eos", False)),
        )

    # ------------------------------------------------------------------
    # Sentinel survives any chat template verbatim; replaced token-wise.
    MM_SENTINEL = "␟IMG␟"

    def preprocess_chat(self, req: ChatCompletionRequest, request_id: str | None = None,
                        images: "list[np.ndarray] | None" = None) -> PreprocessedRequest:
        """``images``: pre-encoded embeddings ([K, H] float32 per image, in
        reading order) matching the request's image content parts — the
        caller runs the vision encoder (in-process or the encode worker);
        this stage owns PLACEMENT: image parts become sentinel text, the
        rendered prompt is tokenized piecewise around the sentinels, and
        each image's span gets digest-salted placeholder ids (same image →
        same ids → the prefix cache reuses image prefixes; different image
        → different hash chain, never aliased). Reference role: the
        multimodal processors of components/src/dynamo/sglang + the
        encode→PD embedding handoff of dynamo.nixl_connect."""
        use_raw = bool(req.nvext and req.nvext.use_raw_prompt)
        messages = [m.model_dump(exclude_none=True) for m in req.messages]
        n_image_parts = self._flatten_image_parts(messages)
        if images is None:
            images = []
        if n_image_parts != len(images):
            raise ValueError(
                f"request has {n_image_parts} image part(s) but "
                f"{len(images)} encoded image(s) were supplied")
        if use_raw and images:
            raise ValueError("use_raw_prompt does not support image content")
        if use_raw and messages and isinstance(messages[-1].get("content"), str):
            prompt = messages[-1]["content"]
        else:
            prompt = self.tokenizer.apply_chat_template(
                messages, add_generation_prompt=True, tools=req.tools)

        mm_embeddings: list[dict] | None = None
        if images:
            token_ids, mm_embeddings = self._tokenize_with_images(prompt, images)
        else:
            token_ids = self.tokenizer.encode(prompt, add_bos=True)
        out = PreprocessedRequest(
            token_ids=token_ids,
            model=req.model,
            stop_conditions=self._stops(req, req.effective_max_tokens(), len(token_ids)),
            sampling_options=self._sampling(req),
            eos_token_ids=list(self.defaults.eos_token_ids or []),
            annotations={"formatted_prompt": prompt} if (req.nvext and req.nvext.annotations) else {},
            mm_embeddings=mm_embeddings,
        )
        if request_id:
            out.request_id = request_id
        return out

    def _flatten_image_parts(self, messages: list[dict]) -> int:
        """Returns the image-part count. ONLY when images are present are
        list-content messages flattened (text parts concatenate, image
        parts become sentinels; user text is scrubbed of the sentinel so
        adversarial content can't relocate embeddings or truncate the
        prompt) — text-only requests keep their original content shape for
        the chat template."""
        n = sum(1 for m in messages if isinstance(m.get("content"), list)
                for part in m["content"]
                if isinstance(part, dict) and part.get("type") == "image_url")
        if n == 0:
            return 0
        for m in messages:
            content = m.get("content")
            if isinstance(content, str):
                m["content"] = content.replace(self.MM_SENTINEL, "")
                continue
            if not isinstance(content, list):
                continue
            pieces: list[str] = []
            for part in content:
                ptype = part.get("type")
                if ptype == "text":
                    pieces.append(
                        part.get("text", "").replace(self.MM_SENTINEL, ""))
                elif ptype == "image_url":
                    pieces.append(self.MM_SENTINEL)
            m["content"] = "".join(pieces)
        return n

    def _tokenize_with_images(self, prompt: str, images: "list[np.ndarray]"
                              ) -> tuple[list[int], list[dict]]:
        from dynamo_tpu_torch.protocols.common import tensor_to_wire

        pieces = prompt.split(self.MM_SENTINEL)
        if len(pieces) - 1 != len(images):
            # belt: _flatten_image_parts scrubs user sentinels, so any
            # mismatch here is a template mangling the sentinel
            raise ValueError(
                f"prompt rendered {len(pieces) - 1} image slot(s) for "
                f"{len(images)} image(s)")
        token_ids = self.tokenizer.encode(pieces[0], add_bos=True)
        spans: list[dict] = []
        vocab = getattr(self.tokenizer, "vocab_size", None) or 1 << 20
        for img, piece in zip(images, pieces[1:]):
            emb = np.ascontiguousarray(img, np.float32)
            k = emb.shape[0]
            digest = xxh3_64(emb.tobytes())
            # digest-salted placeholders: position/hash bookkeeping only —
            # the forward overrides these positions with the embeddings.
            # Each position gets an INDEPENDENT mix of (digest, j): a
            # single `(digest + j) % vocab` chain would collapse the whole
            # span to log2(vocab) bits and alias different images at
            # ~1/vocab probability; K independent draws give K*log2(vocab)
            # bits — cache collisions between images become negligible.
            m = max(vocab - 1, 1)
            placeholders = [
                xxh3_64(struct.pack("<QQ", digest, j)) % m
                for j in range(k)]
            spans.append({"pos": len(token_ids), **tensor_to_wire(emb)})
            token_ids.extend(placeholders)
            if piece:
                token_ids.extend(self.tokenizer.encode(piece, add_bos=False))
        return token_ids, spans

    def preprocess_completion(self, req: CompletionRequest, request_id: str | None = None) -> PreprocessedRequest:
        prompt = req.prompt
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            token_ids = list(prompt)  # pre-tokenized
        elif isinstance(prompt, list):
            token_ids = self.tokenizer.encode("".join(str(p) for p in prompt), add_bos=True)
        else:
            token_ids = self.tokenizer.encode(str(prompt), add_bos=True)
        out = PreprocessedRequest(
            token_ids=token_ids,
            model=req.model,
            stop_conditions=self._stops(req, req.max_tokens, len(token_ids)),
            sampling_options=self._sampling(req),
            eos_token_ids=list(self.defaults.eos_token_ids or []),
        )
        if request_id:
            out.request_id = request_id
        return out
