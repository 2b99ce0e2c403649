"""Process-global metrics: labeled counters / gauges / histograms plus a
per-query record log.

The torch counterpart of ``repro.obs.metrics``.  This is the feed a
multi-query admission controller needs: every
``collect_stats=True`` / traced execution appends one machine-readable
record (fingerprint, mode, wall time, rows/bytes shuffled, drops, cache
traffic) to ``MetricsRegistry.query_records`` and bumps the engine-wide
counters.  ``snapshot()`` / ``to_json()`` export the whole registry.

Instruments are cheap (a dict update under a lock, driver-side only) and
created lazily by name, Prometheus-style:

    METRICS.counter("queries_total").inc(mode="bsp")
    METRICS.histogram("query_wall_s").observe(0.12)
    METRICS.snapshot()["counters"]["queries_total"]

Label sets are kwargs; each distinct label combination tracks its own
series.  The registry is process-global (``repro_torch.obs.METRICS``) so
many queries — eventually many concurrent sessions — accumulate into one place.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

_LabelKey = Tuple[Tuple[str, Any], ...]


def _key(labels: Dict[str, Any]) -> _LabelKey:
    return tuple(sorted(labels.items()))


class Counter:
    """Monotonically increasing sum per label set."""

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name, self.help = name, help
        self._lock = lock
        self._values: Dict[_LabelKey, float] = {}

    def inc(self, value: float = 1.0, **labels: Any) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        k = _key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + value

    def value(self, **labels: Any) -> float:
        return self._values.get(_key(labels), 0.0)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._values.items())]


class Gauge:
    """Last-set value per label set (pool occupancy, queue depth, ...)."""

    def __init__(self, name: str, help: str, lock: threading.Lock):
        self.name, self.help = name, help
        self._lock = lock
        self._values: Dict[_LabelKey, float] = {}

    def set(self, value: float, **labels: Any) -> None:
        with self._lock:
            self._values[_key(labels)] = float(value)

    def value(self, **labels: Any) -> float:
        return self._values.get(_key(labels), 0.0)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"labels": dict(k), "value": v}
                    for k, v in sorted(self._values.items())]


#: default histogram buckets: ~log-spaced from 1ms to ~2min (seconds) —
#: sized for query wall times; byte-valued histograms pass their own
DEFAULT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 30.0, 120.0)


class Histogram:
    """Cumulative-bucket histogram per label set (count/sum/min/max too)."""

    def __init__(self, name: str, help: str, lock: threading.Lock,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(buckets))
        self._lock = lock
        self._series: Dict[_LabelKey, Dict[str, Any]] = {}

    def observe(self, value: float, **labels: Any) -> None:
        k = _key(labels)
        with self._lock:
            s = self._series.get(k)
            if s is None:
                s = self._series[k] = {
                    "count": 0, "sum": 0.0,
                    "min": float("inf"), "max": float("-inf"),
                    "bucket_counts": [0] * (len(self.buckets) + 1)}
            s["count"] += 1
            s["sum"] += value
            s["min"] = min(s["min"], value)
            s["max"] = max(s["max"], value)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    s["bucket_counts"][i] += 1
                    break
            else:
                s["bucket_counts"][-1] += 1

    def series(self, **labels: Any) -> Optional[Dict[str, Any]]:
        s = self._series.get(_key(labels))
        return dict(s) if s is not None else None

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [{"labels": dict(k), "buckets": list(self.buckets),
                     **{kk: (vv if kk != "bucket_counts" else list(vv))
                        for kk, vv in s.items()}}
                    for k, s in sorted(self._series.items())]


class MetricsRegistry:
    """Named instruments + the per-query record log.

    ``max_query_records`` bounds the log (drop-oldest) so a long-lived
    serving process cannot grow without bound.
    """

    def __init__(self, max_query_records: int = 4096):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self.max_query_records = max_query_records
        self._query_records: List[Dict[str, Any]] = []

    # -- instrument accessors (create-on-first-use) ---------------------- #
    def counter(self, name: str, help: str = "") -> Counter:
        with self._lock:
            if name not in self._counters:
                self._counters[name] = Counter(name, help, threading.Lock())
            return self._counters[name]

    def gauge(self, name: str, help: str = "") -> Gauge:
        with self._lock:
            if name not in self._gauges:
                self._gauges[name] = Gauge(name, help, threading.Lock())
            return self._gauges[name]

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        with self._lock:
            if name not in self._histograms:
                self._histograms[name] = Histogram(name, help,
                                                   threading.Lock(), buckets)
            return self._histograms[name]

    # -- per-query records ----------------------------------------------- #
    def record_query(self, record: Dict[str, Any]) -> Dict[str, Any]:
        """Append one per-query record (adds a wall-clock timestamp)."""
        rec = {"recorded_at": time.time(), **record}
        with self._lock:
            self._query_records.append(rec)
            if len(self._query_records) > self.max_query_records:
                del self._query_records[
                    :len(self._query_records) - self.max_query_records]
        return rec

    @property
    def query_records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._query_records)

    # -- export ----------------------------------------------------------- #
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._histograms)
            records = list(self._query_records)
        return {
            "counters": {n: c.snapshot() for n, c in sorted(counters.items())},
            "gauges": {n: g.snapshot() for n, g in sorted(gauges.items())},
            "histograms": {n: h.snapshot() for n, h in sorted(hists.items())},
            "query_records": records,
        }

    def to_json(self, path: Optional[str] = None, indent: int = 1) -> str:
        text = json.dumps(self.snapshot(), indent=indent, sort_keys=True,
                          default=str)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    def reset(self) -> None:
        """Drop all instruments and records (tests / fresh serving epoch)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._query_records.clear()


#: the process-global registry every execution reports into
METRICS = MetricsRegistry()


def record_serve_query(stats: Dict[str, Any], scheduler: str = "serve",
                       registry: Optional[MetricsRegistry] = None
                       ) -> Dict[str, Any]:
    """Fold one finished scheduler query (a ``QueryHandle.stats`` dict)
    into the registry: per-outcome completion counters plus queue-wait and
    execution-wall histograms, all labeled by scheduler name.  The
    per-stage engine metrics still arrive via ``record_exec`` from the
    worker's own execution.  ``repro_torch.serve.QueryScheduler`` calls
    it as each query finishes; over a process group every process calls
    it once a query, with the coordinator's queue wait and the gang's
    wall."""
    reg = registry if registry is not None else METRICS
    state = stats.get("state", "unknown")
    reg.counter("serve_completed_total",
                "scheduler queries finished, by outcome").inc(
        scheduler=scheduler, state=state)
    if "queue_wait_s" in stats:
        reg.histogram("serve_queue_wait_s",
                      "time from submit to dequeue").observe(
            stats["queue_wait_s"], scheduler=scheduler)
    if "wall_s" in stats:
        reg.histogram("serve_query_wall_s",
                      "gang execution wall time").observe(
            stats["wall_s"], scheduler=scheduler, state=state)
    record = {"kind": "serve", "scheduler": scheduler}
    record.update({k: v for k, v in stats.items()
                   if not k.endswith("_monotonic")})
    return reg.record_query(record)


def record_exec(stats: Any, fingerprint: str, wall_time_s: float,
                query: str = "", registry: Optional[MetricsRegistry] = None
                ) -> Dict[str, Any]:
    """Fold one finished execution's ``ExecStats`` into the registry:
    engine-wide counters + one per-query record.  Called by the executors
    (``run_physical`` / ``run_morsel``) when stats were collected."""
    reg = registry if registry is not None else METRICS
    mode = stats.mode
    reg.counter("queries_total", "completed executions").inc(mode=mode)
    reg.counter("dispatches_total", "program dispatches").inc(
        stats.dispatches, mode=mode)
    reg.counter("rows_shuffled_total", "rows moved by shuffles").inc(
        stats.rows_shuffled, mode=mode)
    reg.counter("bytes_shuffled_total", "bytes moved by shuffles").inc(
        stats.bytes_shuffled, mode=mode)
    reg.counter("rows_dropped_total", "rows lost to capacity pressure").inc(
        stats.rows_dropped, mode=mode)
    reg.counter("compile_cache_hits_total", "compile-cache hits").inc(
        stats.cache_hits)
    reg.counter("compile_cache_misses_total", "compile-cache misses").inc(
        stats.cache_misses)
    if getattr(stats, "retries", 0):
        reg.counter("retries_total",
                    "dispatch units replayed after a fault").inc(
            stats.retries, mode=mode)
    if getattr(stats, "degraded", 0):
        reg.counter("degraded_total",
                    "capacity-degrade re-executions").inc(
            stats.degraded, mode=mode)
    if getattr(stats, "faults_injected", 0):
        reg.counter("faults_injected_total",
                    "faults fired by the active FaultPlan").inc(
            stats.faults_injected, mode=mode)
    if getattr(stats, "rows_read", 0):
        reg.counter("rows_read_total",
                    "rows ingested from scan sources").inc(
            stats.rows_read, mode=mode)
    if getattr(stats, "bytes_read", 0):
        reg.counter("bytes_read_total",
                    "source bytes ingested from scan sources").inc(
            stats.bytes_read, mode=mode)
    if getattr(stats, "salted_shuffles", 0):
        reg.counter("salted_shuffles_total",
                    "shuffle boundaries re-routed by hot-key salting").inc(
            stats.salted_shuffles, mode=mode)
    if getattr(stats, "splitter_refreshes", 0):
        reg.counter("splitter_refreshes_total",
                    "range-splitter re-samples on sort imbalance").inc(
            stats.splitter_refreshes, mode=mode)
    if getattr(stats, "autotune_steps", 0):
        reg.counter("autotune_steps_total",
                    "morsel-size autotuner adjustments").inc(
            stats.autotune_steps, mode=mode)
    if wall_time_s > 0:
        reg.histogram("query_wall_s", "end-to-end query wall time").observe(
            wall_time_s, mode=mode)
    record = {
        "query": query,
        "fingerprint": fingerprint,
        "mode": mode,
        "wall_time_s": wall_time_s,
        "stage_times": list(getattr(stats, "stage_times", ())),
        "dispatches": stats.dispatches,
        "num_stages": stats.num_stages,
        "num_shuffles": stats.num_shuffles,
        "rows_shuffled": stats.rows_shuffled,
        "bytes_shuffled": stats.bytes_shuffled,
        "rows_dropped": stats.rows_dropped,
        "cache_hits": stats.cache_hits,
        "cache_misses": stats.cache_misses,
        "shuffle_impl": stats.shuffle_impl,
        "morsels": getattr(stats, "morsels", 0),
        "spill_bytes": getattr(stats, "spill_bytes", 0),
        "h2d_bytes": getattr(stats, "h2d_bytes", 0),
        "retries": getattr(stats, "retries", 0),
        "degraded": getattr(stats, "degraded", 0),
        "faults_injected": getattr(stats, "faults_injected", 0),
        "rows_read": getattr(stats, "rows_read", 0),
        "bytes_read": getattr(stats, "bytes_read", 0),
        "salted_shuffles": getattr(stats, "salted_shuffles", 0),
        "splitter_refreshes": getattr(stats, "splitter_refreshes", 0),
        "autotune_steps": getattr(stats, "autotune_steps", 0),
    }
    return reg.record_query(record)
