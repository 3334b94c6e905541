"""Structured task management: tracker hierarchy, policies, compute pool.

Fills the role of the reference's task-tracker subsystem
(reference: lib/runtime/src/utils/tasks/tracker.rs:407,785,890,966 —
scheduling policies via semaphore, error policies incl. retry/cancel-on-
error, continuations, hierarchical child trackers;
``CriticalTaskExecutionHandle`` utils/tasks/critical.rs) and of the
compute pool (reference: lib/runtime/src/compute/pool.rs:76-240 — rayon
offload of blocking compute from async context).

Python/TPU framing: asyncio is the runtime's only event loop, so the
tracker manages ``asyncio.Task``s; the compute pool is a thread pool —
the GIL is irrelevant for its real workload (blocking device transfers,
``np.asarray`` materialization, tokenizer encode on big prompts — all
release the GIL).

- :class:`TaskTracker` — spawn with bounded concurrency (scheduling
  policy), per-task retry policies with exponential backoff (error
  policy), cancel-all teardown, hierarchical children (cancelling a
  parent cancels its subtree), task counters for observability.
- :class:`RetryPolicy` — which exceptions retry, how many attempts,
  backoff shape.
- :func:`TaskTracker.spawn_critical` — a failure beyond retries invokes
  the ``on_fatal`` callback (process shutdown hook), the
  CriticalTaskExecutionHandle contract.
- :class:`ComputePool` — ``await pool.run(fn, *args)`` executes blocking
  work off-loop; bounded queue so unbounded blocking work can't pile up.

Copy of ``dynamo_tpu/runtime/tasks.py``.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable

from dynamo_tpu_torch.utils.logging import get_logger

log = get_logger("tasks")


@dataclass(frozen=True)
class RetryPolicy:
    """Error policy: retry matching failures with exponential backoff
    (reference: tracker.rs error policies)."""

    max_attempts: int = 3
    backoff_base_s: float = 0.1
    backoff_cap_s: float = 5.0
    retry_on: tuple[type[BaseException], ...] = (Exception,)

    def delay(self, attempt: int) -> float:
        return min(self.backoff_base_s * (2 ** (attempt - 1)), self.backoff_cap_s)


@dataclass
class TaskCounts:
    spawned: int = 0
    succeeded: int = 0
    failed: int = 0
    cancelled: int = 0
    retries: int = 0

    def to_dict(self) -> dict:
        return self.__dict__.copy()


class TaskTracker:
    """Hierarchical structured task manager.

    Every coroutine spawned through a tracker is owned by it: closing the
    tracker cancels the whole subtree and awaits it, so background work
    can never outlive the component that started it (the tokio
    JoinSet/tracker discipline the reference enforces, done the asyncio
    way)."""

    def __init__(self, name: str = "root", max_concurrency: int | None = None,
                 parent: "TaskTracker | None" = None):
        self.name = name
        self._sem = (asyncio.Semaphore(max_concurrency)
                     if max_concurrency else None)
        self._tasks: set[asyncio.Task] = set()
        self._children: list[TaskTracker] = []
        self._parent = parent
        self._closed = False
        self.counts = TaskCounts()

    # -- hierarchy ---------------------------------------------------------
    def child(self, name: str, max_concurrency: int | None = None) -> "TaskTracker":
        c = TaskTracker(f"{self.name}/{name}", max_concurrency, parent=self)
        self._children.append(c)
        return c

    # -- spawning ----------------------------------------------------------
    def spawn(self, fn: Callable[..., Awaitable[Any]], *args: Any,
              name: str | None = None, retry: RetryPolicy | None = None,
              ) -> asyncio.Task:
        """Run ``fn(*args)`` under this tracker's scheduling policy.

        The returned task resolves to the coroutine's result; with a
        retry policy, matching failures re-run ``fn`` (fresh coroutine)
        up to ``max_attempts`` with backoff."""
        if self._closed:
            raise RuntimeError(f"tracker {self.name} is closed")
        self.counts.spawned += 1
        task = asyncio.create_task(
            self._run(fn, args, retry), name=name or fn.__qualname__)
        self._tasks.add(task)
        task.add_done_callback(self._on_done)
        return task

    def spawn_critical(self, fn: Callable[..., Awaitable[Any]], *args: Any,
                       on_fatal: Callable[[BaseException], None],
                       name: str | None = None,
                       retry: RetryPolicy | None = None) -> asyncio.Task:
        """A task whose unrecovered failure must not pass silently:
        ``on_fatal(exc)`` runs when it fails beyond any retries
        (reference: CriticalTaskExecutionHandle)."""
        async def critical() -> Any:
            try:
                return await self._run(fn, args, retry)
            except asyncio.CancelledError:
                raise
            except BaseException as exc:  # noqa: BLE001 - handed to on_fatal
                log.error("critical task %s failed: %s", name or fn.__qualname__, exc)
                on_fatal(exc)
                raise

        if self._closed:
            raise RuntimeError(f"tracker {self.name} is closed")
        self.counts.spawned += 1
        task = asyncio.create_task(critical(), name=name or fn.__qualname__)
        self._tasks.add(task)
        task.add_done_callback(self._on_done)
        return task

    async def _attempt(self, fn, args) -> Any:
        """One execution under the scheduling policy (semaphore slot held
        only while the coroutine runs — backoff sleeps never hold one)."""
        if self._sem is not None:
            async with self._sem:
                return await fn(*args)
        return await fn(*args)

    async def _run(self, fn, args, retry: RetryPolicy | None) -> Any:
        attempt = 0
        while True:
            attempt += 1
            try:
                return await self._attempt(fn, args)
            except asyncio.CancelledError:
                raise
            except (retry.retry_on if retry else ()) as exc:
                if attempt >= retry.max_attempts:
                    raise
                self.counts.retries += 1
                log.warning("task %s retry %d/%d after %s: %s", self.name,
                            attempt, retry.max_attempts, type(exc).__name__, exc)
                await asyncio.sleep(retry.delay(attempt))

    def _on_done(self, task: asyncio.Task) -> None:
        self._tasks.discard(task)
        if task.cancelled():
            self.counts.cancelled += 1
        elif task.exception() is not None:
            self.counts.failed += 1
        else:
            self.counts.succeeded += 1

    # -- lifecycle ---------------------------------------------------------
    @property
    def active(self) -> int:
        return len(self._tasks)

    async def join(self) -> None:
        """Wait for all current tasks (and children's) to finish."""
        for c in self._children:
            await c.join()
        while self._tasks:
            await asyncio.gather(*list(self._tasks), return_exceptions=True)

    async def close(self, timeout: float | None = None) -> None:
        """Cancel the subtree and await teardown, bounded by ``timeout``
        (None = wait forever). A task that survives cancellation past the
        deadline (e.g. wedged in a blocking executor call) is abandoned
        with a log line rather than blocking shutdown. Idempotent."""
        self._closed = True
        deadline = (asyncio.get_running_loop().time() + timeout
                    if timeout is not None else None)
        for c in self._children:
            left = (None if deadline is None
                    else max(deadline - asyncio.get_running_loop().time(), 0.0))
            await c.close(left)
        for t in list(self._tasks):
            t.cancel()
        if self._tasks:
            left = (None if deadline is None
                    else max(deadline - asyncio.get_running_loop().time(), 0.01))
            done, pending = await asyncio.wait(list(self._tasks), timeout=left)
            if pending:
                log.warning("tracker %s: abandoning %d task(s) that ignored "
                            "cancellation", self.name, len(pending))
                self._tasks.clear()

    def snapshot(self) -> dict:
        out = {"name": self.name, "active": self.active, **self.counts.to_dict()}
        if self._children:
            out["children"] = [c.snapshot() for c in self._children]
        return out


class ComputePool:
    """Blocking compute off the event loop (reference: compute/pool.rs
    ``execute_sync``). ``max_pending`` bounds admission so a stalled
    consumer can't queue unbounded blocking work."""

    def __init__(self, max_workers: int = 4, max_pending: int = 256,
                 name: str = "compute"):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix=name)
        self._admission = asyncio.Semaphore(max_pending)

    async def run(self, fn: Callable[..., Any], *args: Any) -> Any:
        async with self._admission:
            return await asyncio.get_running_loop().run_in_executor(
                self._pool, fn, *args)

    def shutdown(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)
