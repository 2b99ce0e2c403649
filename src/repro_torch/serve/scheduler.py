"""Host-side multi-query scheduler: many ``collect()``s, one card.

The torch counterpart of ``repro.serve.scheduler``.  The paper's core move
(§IV-A) is running the BSP dataframe engine *inside* a generic executor
so many independent applications share one set of resources — CylonFlow
partitions a Dask/Ray cluster into gangs and serves jobs onto them.
``QueryScheduler`` is that front end: it owns a ``core.env.DevicePool`` of
rank slots, carves **per-query gangs** (a fresh ``CylonEnv`` of
``gang_size`` stacked ranks over a leased, disjoint slot partition),
executes each admitted query on a worker thread, and hands back
``Future``-style ``QueryHandle``s::

    sched = QueryScheduler(gang_size=2, max_inflight=4, slots=8)
    h = sched.submit(df)            # non-blocking
    out = h.result(timeout=30.0)    # DistTable, bit-identical to df.collect()

    with rdf.session(scheduler=sched):
        out = df.collect()          # routed: submit + handle.result()

Admission control: at most ``max_inflight`` queries execute concurrently
(one worker thread each); up to ``max_queue`` more wait in FIFO order;
past that, ``submit`` raises ``AdmissionRejected`` immediately.  Every
query gets a ``repro_torch.faults.CancellationToken`` — armed with
``timeout`` (submit argument, else the scheduler default) and parented on
a scheduler-wide token — whose deadline covers *queue wait plus
execution*; ``cancel()`` works mid-queue (the entry is unlinked and
completes immediately with ``QueryCancelled``) and mid-flight
(cooperative, at the executors' check points).
``close(cancel_pending=True)`` cancels everything via the parent token.

On a card the gangs share the device, so each worker thread owns one CUDA
stream (created once, reused across its queries) and runs its query on
it: the kernels launch on the current stream, so two gangs' work may
overlap.  ``submit`` records an event on the submitter's current stream,
and the worker's stream waits on it before the query starts (the
submitter's uploads land first); a result goes back to the caller only
after the gang's stream barrier, so it is complete on any stream.  Its
tensors were allocated on the worker's stream, so ``result()`` also
records the taking thread's current stream on each of them
(``record_stream``): when the caller drops the result, the caching
allocator keeps the blocks from the worker's next query until what the
caller queued on them has run.

Built stages are shared across gangs through a process-level
``ProgramCache`` (``repro_torch.serve.cache``): a freshly carved gang
over slots an earlier gang already used reuses every stage — the repeat
query builds nothing (``handle.stats["cache_misses"] == 0``).

The device work stays the same stages as single-query execution, which is
why concurrent results are bit-identical to sequential runs.

Over a process group (``pool=DevicePool(process_group=...)``) the gangs
are gangs of processes, one rank each, and every process runs the same
program: world rank 0 coordinates, and every process sees the same
admission, gang and outcome of each submission (``serve.group``).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Deque, Dict, List, Optional

import torch

from ..core.env import CylonEnv, DevicePool, DistTable
from ..faults import CancellationToken, QueryCancelled, QueryTimeout
from ..obs.metrics import METRICS, record_serve_query
from .cache import GLOBAL_PROGRAM_CACHE, ProgramCache

__all__ = ["AdmissionRejected", "QueryHandle", "QueryScheduler"]

_seq = itertools.count()


def _use_on(obj: Any, stream: "torch.cuda.Stream", seen=None) -> None:
    """``record_stream(stream)`` on every CUDA tensor in ``obj`` (what
    ``collect`` returned: a ``DistTable``, or containers and dataclasses
    holding one)."""
    if isinstance(obj, (str, bytes, int, float, type(None))):
        return
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            obj.record_stream(stream)
    elif isinstance(obj, DistTable):     # its dictionaries are host strings
        _use_on(obj.columns, stream, seen)
        _use_on(obj.row_counts, stream, seen)
    elif isinstance(obj, dict):
        for v in obj.values():
            _use_on(v, stream, seen)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _use_on(v, stream, seen)
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _use_on(getattr(obj, f.name), stream, seen)


def _state_of(exc: Optional[BaseException]) -> str:
    """A finished query's state: ``done``, ``cancelled``, ``timeout`` or
    ``failed``."""
    if exc is None:
        return "done"
    if isinstance(exc, QueryCancelled):
        return "cancelled"
    return "timeout" if isinstance(exc, QueryTimeout) else "failed"


class AdmissionRejected(RuntimeError):
    """``submit`` refused: queue and inflight capacity are both full."""


class _Item:
    __slots__ = ("handle", "frame", "kw", "gang_size", "ready")

    def __init__(self, handle, frame, kw, gang_size, ready):
        self.handle = handle
        self.frame = frame
        self.kw = kw
        self.gang_size = gang_size
        #: CUDA event on the submitter's stream at submit, or None
        self.ready = ready


class QueryHandle:
    """Future-style handle for one submitted query.

    ``stats`` is a live dict the scheduler updates as the query moves
    ``queued -> running -> done|failed|cancelled``: submit/start/finish
    wall-clock timestamps, queue wait, execution wall time (to the gang's
    stream barrier), the gang's rank-slot ids, and the per-query
    stage-cache traffic.
    """

    def __init__(self, scheduler: "QueryScheduler", label: str,
                 token: CancellationToken):
        self._scheduler = scheduler
        self._event = threading.Event()
        self._result: Any = None
        self._exception: Optional[BaseException] = None
        self.label = label
        self.token = token
        self.stats: Dict[str, Any] = {
            "label": label, "state": "queued",
            "submitted_at": time.time(),
            "submitted_monotonic": time.monotonic(),
        }

    # -- completion ------------------------------------------------------ #
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Block until the query finishes and return what ``collect``
        returned (re-raising its error).  ``timeout`` bounds *this wait*,
        not the query — on expiry the query keeps running and ``result``
        raises ``TimeoutError``.  On a card the result's tensors are
        marked as used on the calling thread's current stream."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"query {self.label!r} not finished after {timeout}s "
                f"(state: {self.stats['state']})")
        if self._exception is not None:
            raise self._exception
        if self._scheduler._on_card():
            _use_on(self._result,
                    torch.cuda.current_stream(self._scheduler.device))
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"query {self.label!r} not finished after {timeout}s")
        return self._exception

    def cancel(self, reason: str = "") -> bool:
        """Cancel the query: a queued entry completes immediately with
        ``QueryCancelled``; a running one is cancelled cooperatively at
        the executors' next token check.  Returns False if the query had
        already finished.  Over a process group the request goes to the
        coordinator, which cancels the query on every process."""
        if self.done():
            return False
        reason = reason or f"handle.cancel() on {self.label!r}"
        if self._scheduler._group is not None:
            self._scheduler._group.cancel(self, reason)
            return True
        self.token.cancel(reason)
        self._scheduler._cancel_queued(self)
        return True

    def __repr__(self) -> str:
        return f"<QueryHandle {self.label!r} {self.stats['state']}>"


class QueryScheduler:
    """Admit many concurrent queries onto gangs carved from one pool.

    Parameters
    ----------
    pool:          a ``DevicePool`` of rank slots to carve gangs from
                   (default: a fresh pool of ``slots`` slots on ``device``,
                   or over ``devices``).  The pool may be shared with
                   non-scheduler users; the scheduler only blocks on its
                   own reservations.
    devices:       an explicit slot list for the default pool.
    gang_size:     rank slots per query gang (default 1).  Ingests made
                   inside ``session(scheduler=...)`` partition for this.
    max_inflight:  concurrently executing queries (default: pool size //
                   gang_size — every gang busy).  Over a process group,
                   the pool's slots are the group's ranks and every
                   process constructs the scheduler, in the same order
                   (``serve.group``).
    max_queue:     queued submissions past that before ``submit`` raises
                   ``AdmissionRejected`` (default 64; 0 = no queueing).
    timeout:       default per-query deadline in seconds, covering queue
                   wait + execution (``submit(timeout=...)`` overrides).
    communicator:  communicator for carved gangs ("xla" | "ring" | "bruck").
    program_cache: the shared ``ProgramCache`` (default: the process-level
                   ``GLOBAL_PROGRAM_CACHE``).
    name:          label for metrics/threads (default "serve").
    slots, device: the default pool's size (default 1) and device
                   (``None`` means the card, and raises without one; pass
                   ``device="cpu"`` for the plain PyTorch path).
    """

    def __init__(self, pool: Optional[DevicePool] = None,
                 devices: Optional[List[Any]] = None,
                 gang_size: int = 1,
                 max_inflight: Optional[int] = None,
                 max_queue: int = 64,
                 timeout: Optional[float] = None,
                 communicator: str = "xla",
                 program_cache: Optional[ProgramCache] = None,
                 registry: Any = None,
                 name: str = "serve", *,
                 slots: Optional[int] = None, device: Any = None):
        if pool is not None and (devices is not None or slots is not None
                                 or device is not None):
            raise TypeError("pass either pool= or devices= / slots= / "
                            "device=, not both")
        self.pool = (pool if pool is not None
                     else DevicePool(devices, slots=slots, device=device))
        if gang_size < 1 or gang_size > self.pool.size:
            raise ValueError(
                f"gang_size {gang_size} not in [1, pool size "
                f"{self.pool.size}]")
        self.gang_size = gang_size
        capacity = max(1, self.pool.size // gang_size)
        self.max_inflight = (capacity if max_inflight is None
                             else max(1, int(max_inflight)))
        if max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.max_queue = max_queue
        self.default_timeout = timeout
        self.communicator = communicator
        self.programs = (program_cache if program_cache is not None
                         else GLOBAL_PROGRAM_CACHE)
        #: the device the pool's slots stack their ranks on (None for
        #: slots without one); ingests in a scheduler session land here
        self.device = self.pool.device
        self.name = name
        self._registry = registry if registry is not None else METRICS
        self._token = CancellationToken()   # parent of every query token
        self._cond = threading.Condition(threading.Lock())
        self._queue: Deque[_Item] = collections.deque()
        #: queued submissions over a process group (the coordinator
        #: holds the queue itself)
        self._queued = 0
        self._inflight = 0
        self._closed = False
        self._counts = {"submitted": 0, "completed": 0, "failed": 0,
                        "cancelled": 0, "rejected": 0}
        self._group = None
        self._workers: List[threading.Thread] = []
        if self.pool.process_group is not None:
            from .group import GroupServing
            self._group = GroupServing(self)
            return
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{name}-worker-{i}")
            for i in range(self.max_inflight)]
        for w in self._workers:
            w.start()

    # ------------------------------------------------------------------ #
    # submission
    # ------------------------------------------------------------------ #
    def submit(self, frame: Any, *, timeout: Optional[float] = None,
               label: Optional[str] = None, gang_size: Optional[int] = None,
               **collect_kw: Any) -> QueryHandle:
        """Admit one query (non-blocking): ``frame.collect(...)`` will run
        on a freshly carved gang; ``collect_kw`` passes through to it.

        ``timeout`` (else the scheduler default) arms the query's
        ``CancellationToken`` at *submission*, so the deadline covers
        queue wait + execution.  Raises ``AdmissionRejected`` when the
        queue is full.
        """
        gang = self.gang_size if gang_size is None else int(gang_size)
        if gang < 1 or gang > self.pool.size:
            raise ValueError(f"gang_size {gang} not in [1, pool size "
                             f"{self.pool.size}]")
        if self._group is not None:
            with self._cond:
                if self._closed:
                    raise RuntimeError(f"scheduler {self.name!r} is closed")
            return self._group.submit(
                frame, dict(collect_kw), gang,
                timeout if timeout is not None else self.default_timeout,
                label, lambda lbl, tok: QueryHandle(self, lbl, tok))
        token = CancellationToken(
            timeout if timeout is not None else self.default_timeout,
            parent=self._token)
        handle = QueryHandle(self, label or f"q{next(_seq)}", token)
        with self._cond:
            if self._closed:
                raise RuntimeError(f"scheduler {self.name!r} is closed")
            if (self._inflight + len(self._queue)
                    >= self.max_inflight + self.max_queue):
                # every worker slot busy and the overflow queue is full
                self._counts["rejected"] += 1
                self._registry.counter(
                    "serve_admission_rejected_total",
                    "submissions shed by admission control").inc(
                    scheduler=self.name)
                raise AdmissionRejected(
                    f"scheduler {self.name!r} at capacity: "
                    f"{self._inflight} inflight (max {self.max_inflight}), "
                    f"{len(self._queue)} queued (max {self.max_queue})")
            self._counts["submitted"] += 1
            self._queue.append(_Item(handle, frame, dict(collect_kw), gang,
                                     self._ready_event()))
            self._cond.notify()
            self._export_gauges_locked()
        self._registry.counter("serve_submitted_total",
                               "queries admitted").inc(scheduler=self.name)
        return handle

    def _on_card(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def _ready_event(self) -> Optional["torch.cuda.Event"]:
        """An event on the submitter's current stream: what it queued
        before ``submit`` (an upload of the query's tables) comes first."""
        if not self._on_card():
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    # ------------------------------------------------------------------ #
    # worker side
    # ------------------------------------------------------------------ #
    def _worker(self) -> None:
        # this worker's stream, created once and reused for its queries
        stream = torch.cuda.Stream(self.device) if self._on_card() else None
        while True:
            with self._cond:
                while not self._queue and not self._closed:
                    self._cond.wait()
                if not self._queue:      # closed and drained
                    return
                item = self._queue.popleft()
                self._inflight += 1
                self._export_gauges_locked()
            try:
                self._execute(item, stream)
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._export_gauges_locked()
                    self._cond.notify_all()

    def _execute(self, item: _Item, stream) -> None:
        handle = item.handle
        if handle.done():                # cancelled while queued, unlinked
            return
        stats = handle.stats
        stats["queue_wait_s"] = (time.monotonic()
                                 - stats["submitted_monotonic"])
        try:
            handle.token.check(f"queued ({handle.label})")
        except BaseException as e:       # deadline passed / cancelled in queue
            self._finish(handle, None, e)
            return
        lease = None
        try:
            lease = self.pool.reserve(item.gang_size, block=True,
                                      token=handle.token)
            env = CylonEnv(devices=lease, communicator=self.communicator,
                           program_cache=self.programs)
            stats["devices"] = [d.id for d in lease]
            stats["state"] = "running"
            stats["started_at"] = time.time()
            stats["started_monotonic"] = time.monotonic()
            if stream is None:
                result = item.frame.collect(env=env, timeout=handle.token,
                                            **item.kw)
            else:
                with torch.cuda.stream(stream):
                    if item.ready is not None:
                        stream.wait_event(item.ready)
                    result = item.frame.collect(env=env,
                                                timeout=handle.token,
                                                **item.kw)
                    # the gang's barrier: the result is complete before
                    # it reaches the caller's stream
                    env.synchronize()
            stats["wall_s"] = time.monotonic() - stats["started_monotonic"]
            stats["cache_hits"] = env.cache_hits
            stats["cache_misses"] = env.cache_misses
            self._finish(handle, result, None)
        except BaseException as e:
            if "started_monotonic" in stats:
                stats["wall_s"] = (time.monotonic()
                                   - stats["started_monotonic"])
            self._finish(handle, None, e)
        finally:
            if lease is not None:
                # record completion before freeing the gang so overlapping
                # [started, finished] intervals imply concurrently held,
                # disjoint slot partitions
                lease.release()

    def _finish(self, handle: QueryHandle, result: Any,
                exc: Optional[BaseException],
                state: Optional[str] = None) -> None:
        """Complete ``handle``; ``state`` (over a process group, the
        gang's) else from ``exc``."""
        if handle.done():
            return
        stats = handle.stats
        stats["finished_at"] = time.time()
        stats["finished_monotonic"] = time.monotonic()
        if state is None:
            state = _state_of(exc)
        stats["state"] = state
        outcome = {"done": "completed",
                   "cancelled": "cancelled"}.get(state, "failed")
        if exc is not None and state not in ("done", "cancelled"):
            stats["error"] = f"{type(exc).__name__}: {exc}"
        handle._result = result
        handle._exception = exc
        with self._cond:
            self._counts[outcome] += 1
        record_serve_query(stats, scheduler=self.name,
                           registry=self._registry)
        handle._event.set()

    def _cancel_queued(self, handle: QueryHandle) -> None:
        """Unlink a cancelled entry from the queue so it completes now
        instead of waiting for a worker slot."""
        removed = False
        with self._cond:
            for item in self._queue:
                if item.handle is handle:
                    self._queue.remove(item)
                    removed = True
                    break
            if removed:
                self._export_gauges_locked()
        if removed:
            try:
                handle.token.check("cancelled in queue")
                e: BaseException = QueryCancelled(
                    f"query {handle.label!r} cancelled while queued")
            except BaseException as caught:
                e = caught
            self._finish(handle, None, e)

    # ------------------------------------------------------------------ #
    # lifecycle / introspection
    # ------------------------------------------------------------------ #
    def stats(self) -> Dict[str, Any]:
        """Point-in-time snapshot: counts, queue depth, inflight, pool
        occupancy, shared-program-cache totals (and, over a process
        group, this process's control messages and their seconds)."""
        with self._cond:
            snap = dict(self._counts)
            snap["queue_depth"] = self._depth()
            snap["inflight"] = self._inflight
        snap["pool_available"] = self.pool.available
        snap["pool_size"] = self.pool.size
        snap["gang_size"] = self.gang_size
        snap["max_inflight"] = self.max_inflight
        snap["max_queue"] = self.max_queue
        snap["program_cache"] = self.programs.stats()
        if self._group is not None:
            # this process's control messages and the last decision it
            # applied (``serve.group``)
            snap["control"] = dict(self._group.channel.stats)
            snap["last_decision"] = self._group.last
        return snap

    def close(self, cancel_pending: bool = False, wait: bool = True) -> None:
        """Stop admitting; optionally cancel everything queued/running via
        the scheduler-wide parent token; ``wait`` joins the workers after
        they drain the queue.  Over a process group every process calls
        it; the coordinator's ``cancel_pending`` decides."""
        if self._group is not None:
            self._group.close(cancel_pending, wait)
            return
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if cancel_pending:
            self._token.cancel(f"scheduler {self.name!r} shutting down")
            with self._cond:
                pending = [item.handle for item in self._queue]
                self._queue.clear()
                self._cond.notify_all()
            for handle in pending:
                self._finish(handle, None, QueryCancelled(
                    f"query {handle.label!r} cancelled: scheduler "
                    f"{self.name!r} shutting down"))
        if wait:
            for w in self._workers:
                w.join()

    def __enter__(self) -> "QueryScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close(cancel_pending=exc[0] is not None)

    def _depth(self) -> int:
        return self._queued if self._group is not None else len(self._queue)

    def _export_gauges_locked(self) -> None:
        self._registry.gauge(
            "serve_queue_depth", "queued submissions").set(
            self._depth(), scheduler=self.name)
        self._registry.gauge(
            "serve_inflight", "concurrently executing queries").set(
            self._inflight, scheduler=self.name)

    def __repr__(self) -> str:
        with self._cond:
            return (f"<QueryScheduler {self.name!r} gang_size="
                    f"{self.gang_size} inflight={self._inflight}/"
                    f"{self.max_inflight} queued={self._depth()}/"
                    f"{self.max_queue}>")
