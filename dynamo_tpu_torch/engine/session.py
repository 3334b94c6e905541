"""Session-sticky KV retention: keep a conversation's KV across turns —
port of ``dynamo_tpu/engine/session.py``.

A ``session.id`` annotation rides the OpenAI request (``x-session-id``
header or ``session_id`` body field) through preprocessing to the engine
(same wire pattern as qos/deadline.py). When a stream carrying one
finishes, the engine does NOT let its committed blocks fall straight to
the LRU inactive pool — it takes a session-owned reference on the chain
(:class:`SessionStore`), so turn N+1's admission-time prefix match finds
the whole previous context on device and prefills only the new suffix.

Retention is bounded three ways:

* **TTL** (``EngineConfig.session_ttl``): an idle session's pins are
  released after this many seconds of step time;
* **pressure**: if waiting requests can't admit because session pins
  hold the pool, the oldest sessions are released first;
* **capacity**: at most ``max_sessions`` entries, LRU.

Releasing a pin demotes the blocks to the normal inactive LRU — still
matchable; with ``session_tiers`` the engine first writes the chain
through to the KVBM host/disk/remote ladder, so a later turn can
re-import it even after device eviction (kvbm/offload.py).

The ``dynamo_session_*`` family below has the JAX package's names.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Mapping

from dynamo_tpu_torch.obs.mem_ledger import get_mem_ledger
from dynamo_tpu_torch.utils.metrics import MetricsRegistry

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


def session_id_of(annotations: Mapping[str, Any] | None) -> str | None:
    """Engine/router-side read of the preprocessed annotation."""
    if not annotations:
        return None
    sid = annotations.get(SESSION_KEY)
    if sid is None:
        return None
    sid = str(sid).strip()
    return sid or None


class SessionMetrics:
    """The dynamo_session_* family (the JAX package's names)."""

    def __init__(self, registry: MetricsRegistry | None = None):
        self.bind(registry or MetricsRegistry())

    def bind(self, registry: MetricsRegistry) -> None:
        self.registry = registry
        self.lookups = registry.counter(
            "session_lookups",
            "Admitted requests carrying a session.id annotation")
        self.hits = registry.counter(
            "session_hits",
            "Session lookups that claimed a retained previous turn")
        self.avoided_tokens = registry.counter(
            "session_avoided_tokens",
            "Prompt tokens whose prefill was skipped on a session turn "
            "(measured prefix-match blocks at admission, not estimated)")
        self.retained_blocks = registry.gauge(
            "session_retained_blocks",
            "Device KV blocks currently pinned by session retention")
        self.active = registry.gauge(
            "session_active",
            "Sessions currently holding retained KV on this engine")
        self.expired = registry.counter(
            "session_expired",
            "Sessions released by the TTL sweep, pool pressure, or the "
            "capacity cap")
        self.demoted_blocks = registry.counter(
            "session_demoted_blocks",
            "Session blocks write-staged down the KVBM tier ladder when "
            "their pins were released")
        self.remote_resumes = registry.counter(
            "session_remote_resumes",
            "Session turns resumed from a remote session record "
            "(pull-to-warm after evacuate_sessions)")


_metrics: SessionMetrics | None = None


def get_session_metrics() -> SessionMetrics:
    global _metrics
    if _metrics is None:
        _metrics = SessionMetrics()
    return _metrics


def install_session_metrics(registry: MetricsRegistry) -> SessionMetrics:
    """Re-home the singleton into a runtime registry (worker /metrics)."""
    m = get_session_metrics()
    m.bind(registry)
    return m


@dataclass
class SessionEntry:
    """One retained turn: the committed hash chain and the pins holding it."""

    seq_hashes: tuple[int, ...]
    pinned: list[int] = field(default_factory=list)
    tokens: int = 0
    last_used: float = 0.0


class SessionStore:
    """Engine-core-thread-only registry of session pins over a PrefixPool.

    Every pin this store takes is released through exactly one of
    :meth:`claim`, :meth:`pop_expired`, :meth:`pop_oldest`, or
    :meth:`release_all` — the zero-leaked-pins invariant the engine
    tests assert by comparing ``pool.num_free`` against baseline.
    """

    def __init__(self, pool, *, ttl: float, max_sessions: int = 256):
        self.pool = pool
        self.ttl = ttl
        self.max_sessions = max_sessions
        self._entries: "OrderedDict[str, SessionEntry]" = OrderedDict()
        # Memory ledger (obs/mem_ledger.py): session-owner pin taxonomy.
        # Pins tag/untag exactly with _entries membership, so the audit's
        # live set is simply the store's current session ids.
        self._mled = get_mem_ledger()

    def session_ids(self) -> list[str]:
        """Live session ids (the mem-ledger audit's live set)."""
        return list(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def pinned_blocks(self) -> int:
        return sum(len(e.pinned) for e in self._entries.values())

    def _gauges(self) -> None:
        m = get_session_metrics()
        m.active.set(float(len(self._entries)))
        m.retained_blocks.set(float(self.pinned_blocks))

    def retain(self, session_id: str, seq_hashes: list[int],
               now: float | None) -> SessionEntry | None:
        """Pin the committed, device-resident prefix of ``seq_hashes``
        under ``session_id`` (replacing any prior entry for it). Returns
        the new entry, or None when nothing was committable. Evicted
        prior/overflow entries are returned to the caller via
        :meth:`pop_oldest` pressure — here they are just released."""
        stale = self._entries.pop(session_id, None)
        if stale is not None:
            if self._mled.enabled:
                self._mled.unpin("session", session_id)
            self.pool.release(stale.pinned)
            stale.pinned = []
        pinned = self.pool.match_prefix(list(seq_hashes))
        if not pinned:
            self._gauges()
            return None
        if self._mled.enabled:
            self._mled.pin("session", session_id, len(pinned))
        entry = SessionEntry(
            seq_hashes=tuple(seq_hashes[: len(pinned)]),
            pinned=pinned,
            tokens=len(pinned) * self.pool.block_size,
            last_used=now if now is not None else 0.0,
        )
        self._entries[session_id] = entry
        self._gauges()
        return entry

    def claim(self, session_id: str, now: float | None) -> SessionEntry | None:
        """Consume a retained turn for its next request. The store's pins
        are released here — the blocks park in the matchable inactive pool
        for the instant before the claiming request's own admission-time
        ``match_prefix`` re-references them (engine core is single-threaded,
        so nothing allocates in between)."""
        entry = self._entries.pop(session_id, None)
        if entry is None:
            return None
        if self._mled.enabled:
            self._mled.unpin("session", session_id)
        self.pool.release(entry.pinned)
        entry.pinned = []
        if now is not None:
            entry.last_used = now
        self._gauges()
        return entry

    def pop_expired(self, now: float | None) -> list[tuple[str, SessionEntry]]:
        """Remove entries idle past the TTL (the engine's step clock). The
        caller demotes/releases their pins (EngineCore._demote_session)."""
        if now is None or self.ttl <= 0:
            return []
        out = [(sid, e) for sid, e in self._entries.items()
               if now - e.last_used >= self.ttl]
        for sid, _ in out:
            del self._entries[sid]
            if self._mled.enabled:
                # Pin ownership passes to the caller's demote path, which
                # releases within the same engine step — the ledger drops
                # the session tag at store-exit time.
                self._mled.unpin("session", sid)
        if out:
            self._gauges()
        return out

    def pop_oldest(self) -> tuple[str, SessionEntry] | None:
        """Remove the LRU entry (pool-pressure / capacity valve)."""
        if not self._entries:
            return None
        sid, entry = self._entries.popitem(last=False)
        if self._mled.enabled:
            self._mled.unpin("session", sid)
        self._gauges()
        return sid, entry

    def release_all(self) -> int:
        """Drop every pin (engine wipe / fail_all). Returns blocks freed."""
        n = 0
        for sid, entry in self._entries.items():
            n += len(entry.pinned)
            if self._mled.enabled:
                self._mled.unpin("session", sid)
            self.pool.release(entry.pinned)
            entry.pinned = []
        self._entries.clear()
        self._gauges()
        return n

    def snapshot(self) -> dict:
        return {
            "sessions": len(self._entries),
            "pinned_blocks": self.pinned_blocks,
            "retained_tokens": sum(e.tokens for e in self._entries.values()),
            "ttl": self.ttl,
        }
