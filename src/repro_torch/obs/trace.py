"""Query-level tracing: hierarchical spans with Chrome-trace export.

The torch counterpart of ``repro.obs.trace``.  A ``Tracer`` records a tree
of ``Span``s for ONE query execution (query -> stage -> shuffle / morsel ->
collective chunk).  All bookkeeping is **host-side**: spans are plain Python objects created around program
dispatches, never inside a stage callable — enabling tracing cannot change
what gets built (a test locks that stage-cache keys are identical with
tracing on and off).

Timing convention: span end times are taken on the host clock after the
caller fences device work, so a stage span's duration covers dispatch +
device execution, not just the Python submit.  On a card the fence is a
CUDA event recorded on the current stream and waited on (the executors
synchronize the env's device, which waits for the same work); on the CPU
PyTorch runs eagerly and the work is done when the call returns.
``Span.fence(x)`` is the helper for that pattern.

The finished ``QueryTrace`` exports to the Chrome/Perfetto ``trace_event``
JSON format (``to_chrome_trace``) viewable in ``chrome://tracing`` or
https://ui.perfetto.dev: spans become complete ("X") events, zero-duration
markers (per-shuffle data volumes, per-chunk all-to-all steps) become
instant ("i") events nested inside their parent span's time range.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import time
from typing import Any, Dict, List, Optional

_span_ids = itertools.count(1)
_query_ids = itertools.count(1)


def _cuda_devices(x: Any, out: set) -> set:
    """The CUDA devices of every tensor in ``x`` (nested tuples, lists,
    dicts, and objects with ``columns`` / ``row_counts`` such as
    ``DistTable``)."""
    if hasattr(x, "device") and hasattr(x, "is_cuda"):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif hasattr(x, "row_counts") and hasattr(x, "columns"):
        _cuda_devices(x.row_counts, out)
        _cuda_devices(x.columns, out)
    return out


def device_fence(x: Any) -> Any:
    """Wait for the device work that produces ``x``: on each card ``x``
    lives on, record a CUDA event on the current stream and wait on it.
    CPU tensors are complete when the call that made them returns, so
    a value with none on a card passes straight through.  Returns ``x``."""
    devices = _cuda_devices(x, set())
    if devices:
        import torch
        for dev in devices:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            ev.synchronize()
    return x

@dataclasses.dataclass
class Span:
    """One timed region (or instant marker when ``end_s`` == ``start_s``
    and ``instant`` is set).  ``attrs`` carry rows/bytes/rank/etc."""

    name: str
    category: str                      # "query" | "stage" | "shuffle" | ...
    start_s: float
    end_s: Optional[float] = None
    span_id: int = 0
    parent_id: Optional[int] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    instant: bool = False

    @property
    def duration_s(self) -> float:
        return (self.end_s - self.start_s) if self.end_s is not None else 0.0

    def set(self, **attrs: Any) -> "Span":
        """Attach attributes (rows, bytes, ...) to the span."""
        self.attrs.update(attrs)
        return self

    def fence(self, x: Any) -> Any:
        """Block until ``x``'s device work completes, so the span end time
        (taken at ``__exit__``) covers execution, not just dispatch."""
        return device_fence(x)


class _SpanHandle:
    """Context manager that closes a span on exit (driver-side clock)."""

    __slots__ = ("_tracer", "span")

    def __init__(self, tracer: "Tracer", span: Span):
        self._tracer = tracer
        self.span = span

    def set(self, **attrs: Any) -> "_SpanHandle":
        self.span.set(**attrs)
        return self

    def fence(self, x: Any) -> Any:
        return self.span.fence(x)

    def __enter__(self) -> "_SpanHandle":
        return self

    def __exit__(self, *exc) -> None:
        self._tracer._end(self.span)


class _NullHandle:
    """No-op stand-in so instrumented code needs no ``if tracer`` guards."""

    __slots__ = ()
    span = None

    def set(self, **attrs: Any) -> "_NullHandle":
        return self

    def fence(self, x: Any) -> Any:
        return x

    def __enter__(self) -> "_NullHandle":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_HANDLE = _NullHandle()


class _NullTracer:
    """Disabled tracer: every call is a no-op and ``bool()`` is False, so
    instrumented code pays one attribute lookup when tracing is off."""

    __slots__ = ()
    enabled = False

    def __bool__(self) -> bool:
        return False

    def span(self, name: str, category: str = "span", **attrs) -> _NullHandle:
        return _NULL_HANDLE

    def instant(self, name: str, category: str = "span", **attrs) -> None:
        return None

    def finish(self) -> None:
        return None


NULL_TRACER = _NullTracer()


class Tracer:
    """Records one query's span tree.  Not thread-safe by design: a tracer
    belongs to one driver-side execution (create one per query)."""

    enabled = True

    def __init__(self, name: str = "query",
                 clock=time.perf_counter):
        self.name = name
        self.query_id = next(_query_ids)
        self._clock = clock
        self._spans: List[Span] = []
        self._stack: List[Span] = []
        self._trace: Optional[QueryTrace] = None

    def __bool__(self) -> bool:
        return True

    # -- span API -------------------------------------------------------- #
    def span(self, name: str, category: str = "span", **attrs) -> _SpanHandle:
        """Open a span; use as a context manager.  Nesting follows the
        driver-side call structure (the innermost open span is the parent).
        """
        parent = self._stack[-1].span_id if self._stack else None
        s = Span(name, category, self._clock(), span_id=next(_span_ids),
                 parent_id=parent, attrs=dict(attrs))
        self._spans.append(s)
        self._stack.append(s)
        return _SpanHandle(self, s)

    def instant(self, name: str, category: str = "span", **attrs) -> Span:
        """Zero-duration marker under the currently open span (data-volume
        records for device-side ops whose timing the driver cannot see)."""
        parent = self._stack[-1].span_id if self._stack else None
        t = self._clock()
        s = Span(name, category, t, t, span_id=next(_span_ids),
                 parent_id=parent, attrs=dict(attrs), instant=True)
        self._spans.append(s)
        return s

    def _end(self, span: Span) -> None:
        span.end_s = self._clock()
        # tolerate mis-nested exits instead of corrupting the stack
        if self._stack and self._stack[-1] is span:
            self._stack.pop()
        elif span in self._stack:
            self._stack.remove(span)

    # -- completion ------------------------------------------------------ #
    def finish(self) -> "QueryTrace":
        """Close any open spans and freeze into a ``QueryTrace``."""
        while self._stack:
            self._end(self._stack[-1])
        if self._trace is None:
            self._trace = QueryTrace(self.name, self.query_id,
                                     list(self._spans))
            _set_last_trace(self._trace)
        return self._trace


class QueryTrace:
    """Finished span tree for one query."""

    def __init__(self, name: str, query_id: int, spans: List[Span]):
        self.name = name
        self.query_id = query_id
        self.spans = spans

    # -- structure ------------------------------------------------------- #
    def root(self) -> Optional[Span]:
        for s in self.spans:
            if s.parent_id is None and not s.instant:
                return s
        return None

    def children(self, span: Span) -> List[Span]:
        return [s for s in self.spans if s.parent_id == span.span_id]

    def find(self, category: Optional[str] = None,
             name_prefix: str = "") -> List[Span]:
        return [s for s in self.spans
                if (category is None or s.category == category)
                and s.name.startswith(name_prefix)]

    @property
    def duration_s(self) -> float:
        r = self.root()
        return r.duration_s if r is not None else 0.0

    # -- export ---------------------------------------------------------- #
    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "query_id": self.query_id,
            "duration_s": self.duration_s,
            "spans": [dataclasses.asdict(s) for s in self.spans],
        }

    def to_chrome_trace(self, path: Optional[str] = None) -> Dict[str, Any]:
        """Chrome/Perfetto ``trace_event`` JSON.  Returns the payload dict;
        writes it to ``path`` when given (open the file in
        ``chrome://tracing`` or https://ui.perfetto.dev).

        Spans -> complete ("X") events; instants -> "i" events.  All events
        share pid 0 / tid 0 so the viewer nests them by time containment,
        mirroring the driver-side call structure.  Timestamps are
        microseconds relative to the query start.
        """
        t0 = min((s.start_s for s in self.spans), default=0.0)

        def us(t: float) -> float:
            return round((t - t0) * 1e6, 3)

        events: List[Dict[str, Any]] = []
        for s in self.spans:
            args = {k: v for k, v in s.attrs.items()}
            if s.instant:
                events.append({"name": s.name, "cat": s.category, "ph": "i",
                               "ts": us(s.start_s), "pid": 0, "tid": 0,
                               "s": "t", "args": args})
            else:
                end = s.end_s if s.end_s is not None else s.start_s
                events.append({"name": s.name, "cat": s.category, "ph": "X",
                               "ts": us(s.start_s),
                               "dur": round((end - s.start_s) * 1e6, 3),
                               "pid": 0, "tid": 0, "args": args})
        payload = {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "otherData": {"query": self.name, "query_id": self.query_id},
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(payload, f, indent=1)
                f.write("\n")
        return payload


# ---------------------------------------------------------------------- #
# Ambient access: resolve the trace= argument, keep the last trace around
# ---------------------------------------------------------------------- #
_LAST_TRACE: List[Optional[QueryTrace]] = [None]


def _set_last_trace(trace: QueryTrace) -> None:
    _LAST_TRACE[0] = trace


def last_trace() -> Optional[QueryTrace]:
    """The most recently finished ``QueryTrace`` in this process — the
    retrieval path for ``execute(..., trace=True)`` callers that did not
    hold their own ``Tracer``."""
    return _LAST_TRACE[0]


def resolve_tracer(trace: Any, name: str = "query"):
    """Normalize the user-facing ``trace=`` argument.

    ``None`` consults the ``REPRO_TRACE`` env var (opt-in flag; "0"/"" off);
    ``False`` forces off; ``True`` builds a fresh ``Tracer``; a ``Tracer``
    passes through.  Returns ``NULL_TRACER`` when disabled, so call sites
    can use the handle unconditionally.
    """
    import os
    if isinstance(trace, (Tracer, _NullTracer)):
        return trace
    if trace is None:
        trace = os.environ.get("REPRO_TRACE", "") not in ("", "0")
    return Tracer(name) if trace else NULL_TRACER
