"""Token-bucket rate limiting with a bounded per-client registry.

Copy of ``dynamo_tpu/qos/token_bucket.py``.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable


class TokenBucket:
    """Classic token bucket. `now_fn` is injectable for deterministic tests."""

    def __init__(self, rate: float, burst: float,
                 now_fn: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self._now = now_fn
        self.tokens = float(burst)
        self._t_last = now_fn()

    def _refill(self) -> None:
        t = self._now()
        if t > self._t_last:
            self.tokens = min(self.burst, self.tokens + (t - self._t_last) * self.rate)
        self._t_last = t

    def try_acquire(self, n: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def retry_after(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available (0 if already)."""
        self._refill()
        deficit = n - self.tokens
        if deficit <= 0:
            return 0.0
        if self.rate <= 0:
            return 60.0
        return deficit / self.rate


class ClientRateLimiter:
    """Per-client token buckets with an LRU cap on tracked clients.

    rate <= 0 disables limiting entirely (check() always admits).
    """

    def __init__(self, rate: float, burst: float, max_clients: int = 10_000,
                 now_fn: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.max_clients = max_clients
        self._now = now_fn
        self._buckets: OrderedDict[str, TokenBucket] = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self) -> int:
        return len(self._buckets)

    def check(self, client_id: str, n: float = 1.0) -> tuple[bool, float]:
        """Returns (allowed, retry_after_seconds)."""
        if self.rate <= 0:
            return True, 0.0
        with self._lock:
            bucket = self._buckets.get(client_id)
            if bucket is None:
                bucket = TokenBucket(self.rate, self.burst, self._now)
                self._buckets[client_id] = bucket
                while len(self._buckets) > self.max_clients:
                    self._buckets.popitem(last=False)
            else:
                self._buckets.move_to_end(client_id)
            if bucket.try_acquire(n):
                return True, 0.0
            return False, bucket.retry_after(n)
