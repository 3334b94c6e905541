"""Server-Sent Events codec (reference: lib/llm/src/protocols/codec.rs).

Copy of ``dynamo_tpu/protocols/sse.py``: the server side (its client-side
decoder serves the JAX tests and tools, nothing of the port).
"""

from __future__ import annotations

from typing import Any

DONE_EVENT = b"data: [DONE]\n\n"


def encode_sse(data: str) -> bytes:
    return f"data: {data}\n\n".encode()


def encode_sse_json(obj: Any) -> bytes:
    # API models expose model_dump_json; fall back to json.dumps
    if hasattr(obj, "model_dump_json"):
        payload = obj.model_dump_json(exclude_none=True)
    else:
        import json

        payload = json.dumps(obj, separators=(",", ":"))
    return encode_sse(payload)
