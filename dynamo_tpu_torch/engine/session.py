"""The session wire keys — the part of ``dynamo_tpu/engine/session.py`` the
frontend reads.

A ``session.id`` annotation rides the OpenAI request (``x-session-id``
header or ``session_id`` body field) through preprocessing to the engine
(same wire pattern as qos/deadline.py). Session-sticky KV retention
itself (``SessionStore``, the ``dynamo_session_*`` family) is not ported:
the engine refuses ``session_ttl > 0`` (``engine.check_supported``).
"""

from __future__ import annotations

from typing import Any, Mapping

SESSION_KEY = "session.id"
SESSION_HEADER = "x-session-id"


def session_id_from(headers: Mapping[str, str] | None = None,
                    body: Mapping[str, Any] | None = None) -> str | None:
    """Frontend-side extraction: header wins over body, blanks are None."""
    sid = None
    if headers is not None:
        sid = headers.get(SESSION_HEADER)
    if sid is None and body is not None:
        sid = body.get("session_id")
    if sid is None:
        return None
    sid = str(sid).strip()
    return sid or None
