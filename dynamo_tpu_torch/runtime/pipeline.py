"""Typed operator pipeline: the reusable request/stream DAG.

Fills the role of the reference's pipeline graph
(reference: lib/runtime/src/pipeline.rs:8-60 — Source/Sink/Operator with
``link()`` chaining; node impls pipeline/nodes.rs:1-339). The reference
models forward edges (request transforms) and backward edges (response
transforms) as separate graph links; in Python both directions collapse
into ONE natural shape: an operator is an async generator that receives
the request and a ``next`` callable, transforms the request on the way
in (forward edge), delegates, and transforms/filters/retries the yielded
stream on the way out (backward edge). Cancellation propagates the
async-generator way — closing the outer stream closes every inner one —
so no separate Context plumbing is needed for teardown.

Used by the frontend's routed model pipelines
(components/frontend.py: migration → decode → router) and available to
any component that composes streaming stages.

    # stream direction runs sink→left: Migration (innermost, next to the
    # sink) retries over raw wire dicts; MapOutput decodes for the consumer
    pipe = link(MapOutput(LLMEngineOutput.from_dict),
                Migration(migration_limit=3), sink=router_sink)
    async for item in pipe.generate(req): ...

Copy of ``dynamo_tpu/runtime/pipeline.py``.
"""

from __future__ import annotations

import abc
from typing import Any, AsyncIterator, Callable

# A sink-shaped callable: request -> async iterator of items.
NextFn = Callable[[Any], AsyncIterator[Any]]


class Sink(abc.ABC):
    """Terminal stage: turns a request into a stream (the reference's
    ServiceBackend / SegmentSink role)."""

    @abc.abstractmethod
    def generate(self, req: Any) -> AsyncIterator[Any]:
        ...


class Operator(abc.ABC):
    """Mid-pipeline stage. ``generate`` MUST delegate to ``next`` (exactly
    once per attempt — retrying operators may call it again) and may
    transform the request before and each item after."""

    @abc.abstractmethod
    def generate(self, req: Any, next: NextFn) -> AsyncIterator[Any]:
        ...


class FnSink(Sink):
    """Adapt a bare ``req -> async iterator`` callable to the Sink type."""

    def __init__(self, fn: NextFn):
        self._fn = fn

    def generate(self, req: Any) -> AsyncIterator[Any]:
        return self._fn(req)


class Pipeline(Sink):
    """Operators folded onto a sink; itself a Sink, so pipelines nest."""

    def __init__(self, operators: list[Operator], sink: Sink):
        self.operators = list(operators)
        self.sink = sink
        nxt: NextFn = sink.generate
        for op in reversed(self.operators):
            # bind loop variables by default-arg capture
            def nxt(req: Any, _op: Operator = op, _next: NextFn = nxt
                    ) -> AsyncIterator[Any]:
                return _op.generate(req, _next)
        self._entry = nxt

    def generate(self, req: Any) -> AsyncIterator[Any]:
        return self._entry(req)


def link(*stages: Any, sink: Any = None) -> Pipeline:
    """Compose stages left-to-right onto a sink (the reference's ``link()``
    chaining, pipeline.rs:31-42). ``stages`` are Operators; ``sink`` (or
    the last positional stage) is a Sink or a bare request→stream
    callable."""
    stages_l = list(stages)
    if sink is None:
        if not stages_l:
            raise ValueError("link() needs at least a sink")
        sink = stages_l.pop()
    if not isinstance(sink, Sink):
        sink = FnSink(sink)
    for s in stages_l:
        if not isinstance(s, Operator):
            raise TypeError(f"mid-pipeline stage {s!r} is not an Operator")
    return Pipeline(stages_l, sink)


# ---------------------------------------------------------------------------
# General-purpose operators
# ---------------------------------------------------------------------------

class MapRequest(Operator):
    """Forward-edge transform (the reference's forward link)."""

    def __init__(self, fn: Callable[[Any], Any]):
        self._fn = fn

    async def generate(self, req: Any, next: NextFn) -> AsyncIterator[Any]:
        async for item in next(self._fn(req)):
            yield item


class MapOutput(Operator):
    """Backward-edge transform applied to every streamed item."""

    def __init__(self, fn: Callable[[Any], Any]):
        self._fn = fn

    async def generate(self, req: Any, next: NextFn) -> AsyncIterator[Any]:
        async for item in next(req):
            yield self._fn(item)
