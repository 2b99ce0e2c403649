"""Process-level stage cache with single-flight builds.

The torch counterpart of ``repro.serve.cache`` (a copy: the port imports
nothing of the JAX package).  Each ``CylonEnv`` keeps a memo of the stage
callables it has built; without a shared store a *freshly carved* gang (a
new env over leased rank slots, the serving scheduler's normal mode of
operation) would build every stage again.  ``ProgramCache`` hoists that
storage to process level: entries are keyed by

    (program key, gang signature)

where the program key is whatever the env submission layer uses (the
structural plan fingerprint + mode/communicator/shuffle knobs), and the
gang signature pins the *placement* — device, rank-slot ids, communicator
— because a built stage holds its communicator and device.  Two gangs
carved over the same slots (the common case under the ``DevicePool``
free-list, which hands out lowest ids first so released partitions are
re-carved identically) therefore share one stage; gangs over other slots
build their own, as in the JAX package.

Builds are **single-flight**: when two threads race the same key, exactly
one runs the builder while the rest wait on the entry's event and then
reuse the result.  A failed build clears the entry so a later caller can
retry (waiters of a failed build re-enter the loop and may become the new
builder).

``GLOBAL_PROGRAM_CACHE`` is the process-wide instance the serving
scheduler wires into every gang it carves; ``CylonEnv`` defaults to a
private instance so single-env semantics (and the cache counters) are
unchanged.

A gang of processes (a pool over a process group) signs its placement
the same way: its ranks are the slot ids, and its communicator is the
one the pool keeps for that gang, so a gang re-carved over the same
ranks finds every stage its predecessor built.

In the port a build only wraps the stage function in a closure (nothing
is compiled), so on one card the cache saves next to nothing; it keeps
the JAX package's semantics and counters.  Since every slot of a pool is
on one device, keying gangs by slot ids keeps one copy per partition of
the same closure.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Tuple

__all__ = ["ProgramCache", "GLOBAL_PROGRAM_CACHE"]


class _Entry:
    __slots__ = ("event", "value", "ready")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.ready = False


class ProgramCache:
    """Thread-safe map ``key -> built stage`` with single-flight
    population and hit/miss/wait counters.

    ``registry``: a ``repro_torch.obs.MetricsRegistry`` (default: the process
    registry) receiving ``program_cache_*`` counters; pass ``False`` to
    disable metric export (micro-tests).
    """

    def __init__(self, registry: Any = None):
        self._lock = threading.Lock()
        self._entries: Dict[Any, _Entry] = {}
        #: cumulative counters (also exported to the metrics registry)
        self.hits = 0
        self.misses = 0
        self.singleflight_waits = 0
        if registry is False:
            self._registry = None
        else:
            from ..obs.metrics import METRICS
            self._registry = registry if registry is not None else METRICS

    def _count(self, what: str) -> None:
        if self._registry is not None:
            self._registry.counter(
                f"program_cache_{what}_total",
                f"shared program-cache {what.replace('_', ' ')}").inc()

    def get_or_build(self, key: Any, builder: Callable[[], Any]
                     ) -> Tuple[Any, bool]:
        """Return ``(program, built)``: the cached stage for ``key``,
        building it via ``builder()`` at most once per key across all
        threads.  ``built`` is True iff *this* call ran the builder."""
        while True:
            with self._lock:
                entry = self._entries.get(key)
                if entry is None:
                    entry = self._entries[key] = _Entry()
                    owner = True
                elif entry.ready:
                    self.hits += 1
                    self._count("hits")
                    return entry.value, False
                else:
                    owner = False
                    self.singleflight_waits += 1
            if owner:
                try:
                    value = builder()
                except BaseException:
                    with self._lock:
                        # clear the failed entry so a later caller retries
                        if self._entries.get(key) is entry:
                            del self._entries[key]
                        self.misses += 1
                    self._count("misses")
                    entry.event.set()
                    raise
                with self._lock:
                    entry.value = value
                    entry.ready = True
                    self.misses += 1
                entry.event.set()
                self._count("misses")
                return value, True
            self._count("singleflight_waits")
            entry.event.wait()
            # entry is either ready (common) or was cleared by a failed
            # build — loop to re-read under the lock (and maybe rebuild)

    def peek(self, key: Any) -> Optional[Any]:
        """The cached stage for ``key`` or None (never builds/waits)."""
        with self._lock:
            entry = self._entries.get(key)
            return entry.value if entry is not None and entry.ready else None

    def __len__(self) -> int:
        with self._lock:
            return sum(1 for e in self._entries.values() if e.ready)

    def __contains__(self, key: Any) -> bool:
        with self._lock:
            e = self._entries.get(key)
            return e is not None and e.ready

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": sum(1 for e in self._entries.values()
                                   if e.ready),
                    "hits": self.hits, "misses": self.misses,
                    "singleflight_waits": self.singleflight_waits}

    def clear(self) -> None:
        """Drop all completed entries (in-flight builds finish into the
        void: their owners still return the built program)."""
        with self._lock:
            done = [k for k, e in self._entries.items() if e.ready]
            for k in done:
                del self._entries[k]


#: the process-level cache the serving scheduler shares across every gang
#: it carves — the "thousandth user's query builds nothing" cache
GLOBAL_PROGRAM_CACHE = ProgramCache()
