"""Logging for the port: human-readable lines on stderr, or JSONL, and
the W3C ``traceparent`` context that correlates a request's spans across
processes.

Copy of ``dynamo_tpu/utils/logging.py``. ``DYN_LOG`` sets the level and
``DYN_LOGGING_JSONL=1`` switches to one JSON object per line.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import sys
import time
from dataclasses import dataclass

_CONFIGURED = False


@dataclass(frozen=True)
class TraceContext:
    """W3C traceparent: 00-<trace_id 32hex>-<span_id 16hex>-<flags 2hex>."""

    trace_id: str
    span_id: str
    flags: str = "01"

    @classmethod
    def new(cls) -> "TraceContext":
        return cls(trace_id=secrets.token_hex(16), span_id=secrets.token_hex(8))

    @classmethod
    def parse(cls, traceparent: str | None) -> "TraceContext | None":
        if not traceparent:
            return None
        parts = traceparent.strip().split("-")
        if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        return cls(trace_id=parts[1], span_id=parts[2], flags=parts[3])

    def child(self) -> "TraceContext":
        return TraceContext(trace_id=self.trace_id, span_id=secrets.token_hex(8), flags=self.flags)

    def header(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"


class JsonlFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": round(time.time(), 6),
            "level": record.levelname,
            "target": record.name,
            "msg": record.getMessage(),
        }
        for key in ("trace_id", "span_id", "request_id", "component", "endpoint"):
            val = getattr(record, key, None)
            if val is not None:
                entry[key] = val
        if record.exc_info:
            entry["exception"] = self.formatException(record.exc_info)
        return json.dumps(entry, separators=(",", ":"))


def configure_logging(level: str | None = None, jsonl: bool | None = None) -> None:
    global _CONFIGURED
    if _CONFIGURED:
        return
    _CONFIGURED = True
    level = level or os.environ.get("DYN_LOG", "info")
    if jsonl is None:
        jsonl = os.environ.get("DYN_LOGGING_JSONL", "").lower() in ("1", "true")
    handler = logging.StreamHandler(sys.stderr)
    if jsonl:
        handler.setFormatter(JsonlFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname).1s %(name)s: %(message)s", datefmt="%H:%M:%S")
        )
    root = logging.getLogger("dynamo_tpu_torch")
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    root.addHandler(handler)
    root.propagate = False


def get_logger(name: str) -> logging.Logger:
    configure_logging()
    return logging.getLogger(f"dynamo_tpu_torch.{name}")
