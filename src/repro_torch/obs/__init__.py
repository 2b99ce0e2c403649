"""``repro_torch.obs`` — tracing + metrics: make every execution
self-describing (the torch counterpart of ``repro.obs``).

Three layers:

* ``trace``   — ``Tracer`` / ``Span`` / ``QueryTrace``: host-side
                hierarchical spans (query -> stage -> shuffle -> chunk)
                with Chrome/Perfetto ``trace_event`` export; on a card a
                span's end waits on a CUDA event, so it covers the device
                work it launched,
* ``metrics`` — process-global ``MetricsRegistry`` (labeled counters /
                gauges / histograms + per-query records),
* ``analyze`` — EXPLAIN ANALYZE (``QueryReport``): the EXPLAIN tree
                re-rendered with *measured* per-node rows / bytes / times
                plus a per-stage roofline table against the card's own
                peaks (``launch.roofline``).

Tracing is opt-in (``trace=`` argument or ``REPRO_TRACE=1``) and purely
host-side: the stage callables are the same with tracing on or off.

``analyze`` is imported lazily: it depends on ``repro_torch.planner``,
which itself imports this package's trace layer — eager import would
cycle.
"""

from .trace import (NULL_TRACER, QueryTrace, Span, Tracer, last_trace,
                    resolve_tracer)
from .metrics import (METRICS, MetricsRegistry, record_exec,
                      record_serve_query)

_ANALYZE_NAMES = ("QueryReport", "run_analyzed", "render_analyze",
                  "stage_table")

__all__ = [
    "METRICS", "MetricsRegistry", "NULL_TRACER", "QueryReport", "QueryTrace",
    "Span", "Tracer", "last_trace", "record_exec", "record_serve_query",
    "render_analyze", "resolve_tracer", "run_analyzed", "stage_table",
]


def __getattr__(name: str):
    if name in _ANALYZE_NAMES:
        from . import analyze
        return getattr(analyze, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
