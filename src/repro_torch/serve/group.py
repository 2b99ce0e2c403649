"""Query serving over gangs of processes: the ``QueryScheduler`` of a pool
over a ``torch.distributed`` process group.

The JAX package carves gangs out of the devices of one process; the port
reaches more than one card only as the processes of a group, one rank
each (``comm/process_group.py``), which is also CylonFlow's own model
(Cylon inside Dask or Ray workers, one worker process a rank).  A
``QueryScheduler(pool=DevicePool(process_group=...))`` serves queries on
gangs of those processes.  Its contract extends ``CylonEnv``'s over a
group:

* Every process runs the same program (SPMD): it makes the same
  submissions in the same order, each given the whole input of its query
  (ingests inside ``session(scheduler=)`` partition for the gang size,
  and a member keeps its gang rank's rows, ``DataFrame.on_gang``).
* A query runs on the processes of its gang alone, and each member ends
  with exactly rank r of the same query run on a stacked gang of that
  size.
* Every process sees the same outcome of each submission: admitted or
  ``AdmissionRejected``, the same gang (``stats["devices"]``: the member
  ranks), and done, failed, cancelled or timed out with the same
  exception type.  A non-member's ``result()`` is ``None`` once the gang
  is done, or raises what the gang raised.

How: world rank 0 is the *coordinator*.  It takes every decision whose
outcome depends on timing — admission, the queue's order, which queued
query takes freed ranks, a deadline that passes in the queue, a
cancellation, the end of ``close`` — and sends each, in one order, to
every process over a *control channel*: a gloo group over the world
(CPU tensors, under NCCL too), separate from every gang's data group,
served by one dispatcher thread a process.  Every process applies the
decisions in that order, so its copy of the pool's free list, its counts
and its handles evolve alike, and every process makes the gangs'
sub-groups on its dispatcher thread in that order (``DevicePool.reserve``
makes a new rank set's group; only its members connect).  ``submit``
waits for the decision on its sequence number.  A member runs its query
on its worker thread (one a process: a process is in at most one gang
at a time) on its CUDA stream, as the stacked scheduler does.  Every
member reports its own outcome to the coordinator, which waits for the
whole gang's, takes the one that prevails (``_agree``: a member's own
failure before a peer's echo of it, then a deadline, a cancellation,
success) and sends it to every process; each completes its handle with
that state and an exception of that type, so a member that failed alone
after the last fault site (say, in the stream's closing synchronize)
fails the query everywhere.  ``handle.cancel()`` on any process goes to
the coordinator.  A deadline is armed by the coordinator at
submission; a member's token takes what is left of it when the query
starts.  Mid-flight the members agree at every fault-site visit
(``faults.GroupFaults``, over the gang's sub-group: the scheduler's
tokens always arm it), so a cancellation or a passed deadline raises on
every member at the same site and no member is left in a collective.

Messages are pickled Python tuples sent with ``dist.send`` / ``recv``
(a length, then the bytes): decisions from rank 0 on one tag, requests
to rank 0 (cancel, outcome, the end of a process's part) on another, one
receiving thread per peer on the coordinator.  ``stats["control"]``
counts the messages a process sent and received and their seconds.
"""

from __future__ import annotations

import collections
import importlib
import pickle
import queue
import threading
import time
from datetime import timedelta
from typing import Any, Deque, Dict, List, Optional, Tuple

import torch

from ..core.env import CylonEnv
from ..faults import CancellationToken, QueryCancelled, QueryTimeout
from .scheduler import AdmissionRejected, _state_of

__all__ = ["ControlChannel", "GroupServing"]

#: tags of the control channel's two streams
DECISION, REQUEST = 1, 2
#: how long the dispatcher waits for the next decision (an idle server
#: waits, so this is long; a spawn's own timeout turns a hang into a
#: failure)
CONTROL_TIMEOUT = timedelta(hours=24)


class ControlChannel:
    """Pickled messages between the processes of the world over a gloo
    group of its own.  Sends from one process are serialized (a length
    and its bytes go out together)."""

    def __init__(self):
        import torch.distributed as dist
        self.group = dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self._lock = threading.Lock()
        #: messages sent and received by this process, their seconds
        self.stats = {"sent": 0, "received": 0, "seconds": 0.0}

    def send(self, obj: Any, dst: int, tag: int) -> None:
        import torch.distributed as dist
        data = pickle.dumps(obj)
        head = torch.tensor([len(data)], dtype=torch.int64)
        body = torch.frombuffer(bytearray(data), dtype=torch.uint8)
        with self._lock:
            t = time.perf_counter()
            dist.send(head, dst, group=self.group, tag=tag)
            dist.send(body, dst, group=self.group, tag=tag)
            self.stats["sent"] += 1
            self.stats["seconds"] += time.perf_counter() - t

    def recv(self, src: int, tag: int) -> Any:
        import torch.distributed as dist
        head = torch.empty(1, dtype=torch.int64)
        dist.recv(head, src, group=self.group, tag=tag)
        t = time.perf_counter()
        body = torch.empty(int(head[0]), dtype=torch.uint8)
        dist.recv(body, src, group=self.group, tag=tag)
        self.stats["received"] += 1
        self.stats["seconds"] += time.perf_counter() - t
        return pickle.loads(body.numpy().tobytes())


def _exc_info(exc: BaseException) -> Tuple[str, str, str]:
    return (type(exc).__module__, type(exc).__qualname__, str(exc))


def _rebuild(info: Tuple[str, str, str]) -> BaseException:
    """An exception of the type a member raised, with its message (the
    class's own ``__init__`` is bypassed: some take a site first)."""
    mod, name, msg = info
    try:
        cls = importlib.import_module(mod)
        for part in name.split("."):
            cls = getattr(cls, part)
        if isinstance(cls, type) and issubclass(cls, BaseException):
            exc = cls.__new__(cls)
            BaseException.__init__(exc, msg)
            return exc
    except Exception:       # a type this process cannot import
        pass
    return RuntimeError(f"{mod}.{name}: {msg}")


#: the order in which the members' outcomes prevail (lowest first)
_PREVAIL = {"failed": 0, "timeout": 1, "cancelled": 2, "done": 3}


def _agree(ranks: Tuple[int, ...], reports: Dict[int, Dict[str, Any]]
           ) -> Dict[str, Any]:
    """The gang's outcome from each member's report: the state that
    prevails, a member's own failure before another's ``PeerFault`` (its
    echo at the same site), then the lowest rank; the gang's wall is the
    slowest member's, its cache counts its rank 0's."""
    def order(r):
        rep = reports[r]
        echo = rep["exc"] is not None and rep["exc"][1] == "PeerFault"
        return _PREVAIL[rep["state"]], echo, r
    out = dict(reports[min(ranks, key=order)])
    out["wall_s"] = max(rep["wall_s"] for rep in reports.values())
    for k in ("cache_hits", "cache_misses"):
        if k in reports[ranks[0]]:
            out[k] = reports[ranks[0]][k]
    return out


class _Query:
    """One submission's record on one process, made at whichever comes
    first: this process's ``submit`` or a decision about it."""

    def __init__(self, seq: int):
        self.seq = seq
        self.handle = None
        self.frame = None
        self.kw: Dict[str, Any] = {}
        self.ready = None               # CUDA event at submit, or None
        self.timeout: Optional[float] = None
        self.submitted = threading.Event()
        self.decided = threading.Event()
        self.reject: Optional[str] = None
        self.lease = None
        self.member = False
        self.local_done = False
        self.result: Any = None
        self.exc: Optional[BaseException] = None
        self.local: Dict[str, Any] = {}
        self.finish: Optional[Dict[str, Any]] = None
        self.completed = False


class GroupServing:
    """The process-group half of a ``QueryScheduler`` (``sched``): the
    control channel, the dispatcher, the coordinator's loop and this
    process's worker.  Constructed on every process, in the same order
    (the control channel's group is a collective of the world)."""

    def __init__(self, sched):
        self.sched = sched
        self.pool = sched.pool
        self.channel = ControlChannel()
        self.rank = self.channel.rank
        self.world = self.channel.world
        self.coordinator = self.rank == 0
        self._lock = threading.Lock()
        #: the last decision this process applied (for diagnosing a hang)
        self.last: Optional[tuple] = None
        self._records: Dict[int, _Query] = {}
        self._next_seq = 0
        self._ended = threading.Event()
        self._work: "queue.Queue[Optional[_Query]]" = queue.Queue()
        self._inbox: "queue.Queue[tuple]" = queue.Queue()
        self._threads: List[threading.Thread] = []
        name = sched.name
        if self.coordinator:
            self._threads.append(threading.Thread(
                target=self._coordinate, daemon=True,
                name=f"{name}-coordinator"))
            self._threads += [threading.Thread(
                target=self._receive, args=(peer,), daemon=True,
                name=f"{name}-from-{peer}") for peer in range(1, self.world)]
        else:
            self._threads.append(threading.Thread(
                target=self._dispatch, daemon=True,
                name=f"{name}-dispatcher"))
        self._worker = threading.Thread(target=self._run_work, daemon=True,
                                        name=f"{name}-worker")
        for t in self._threads + [self._worker]:
            t.start()

    # ------------------------------------------------------------------ #
    # the caller's side
    # ------------------------------------------------------------------ #
    def _record(self, seq: int) -> _Query:
        with self._lock:
            rec = self._records.get(seq)
            if rec is None:
                rec = self._records[seq] = _Query(seq)
            return rec

    def submit(self, frame, kw, gang: int, timeout, label, make_handle):
        """This process's submission number ``seq``: waits for the
        coordinator's decision on it; the handle, or
        ``AdmissionRejected``."""
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
        rec = self._record(seq)
        handle = make_handle(label or f"{self.sched.name}-{seq}",
                             CancellationToken(parent=self.sched._token))
        handle._seq = seq
        rec.frame, rec.kw, rec.timeout = frame, kw, timeout
        rec.ready = self.sched._ready_event()
        with self._lock:
            rec.handle = handle
        rec.submitted.set()
        if self.coordinator:
            self._inbox.put(("submit", seq, gang, timeout))
        rec.decided.wait()
        if rec.reject is not None:
            raise AdmissionRejected(rec.reject)
        self._try_complete(rec)
        return handle

    def cancel(self, handle, reason: str) -> None:
        msg = ("cancel", handle._seq, reason)
        if self.coordinator:
            self._inbox.put(msg)
        else:
            self.channel.send(msg, 0, REQUEST)

    def close(self, cancel_pending: bool, wait: bool) -> None:
        if self.coordinator:
            self._inbox.put(("close", cancel_pending))
        if wait:
            self._ended.wait()
            for t in self._threads + [self._worker]:
                t.join()

    # ------------------------------------------------------------------ #
    # the coordinator (world rank 0)
    # ------------------------------------------------------------------ #
    def _receive(self, peer: int) -> None:
        while True:
            msg = self.channel.recv(peer, REQUEST)
            self._inbox.put(msg)
            if msg[0] == "bye":
                return

    def _emit(self, decision: tuple) -> None:
        """Send ``decision`` to every peer, then apply it here (a START
        may make the gang's sub-group, which waits for its other members:
        they must have the decision first)."""
        for peer in range(1, self.world):
            self.channel.send(decision, peer, DECISION)
        self._apply(decision)

    def _coordinate(self) -> None:
        s = self.sched
        waiting: Deque[int] = collections.deque()
        info: Dict[int, Tuple[int, Optional[float], float]] = {}
        #: the running queries' gangs, and their members' reports
        running: Dict[int, Tuple[int, ...]] = {}
        reports: Dict[int, Dict[int, Dict[str, Any]]] = {}
        closing, ended, byes = None, False, 0
        while True:
            deadlines = [info[q][1] for q in waiting
                         if info[q][1] is not None]
            wait = (max(0.0, min(deadlines) - time.monotonic())
                    if deadlines else None)
            try:
                msg = self._inbox.get(timeout=wait)
            except queue.Empty:
                msg = ("tick",)
            kind = msg[0]
            if kind == "submit":
                _, seq, gang, timeout = msg
                if len(running) + len(waiting) >= \
                        s.max_inflight + s.max_queue:
                    self._emit(("reject", seq,
                                f"scheduler {s.name!r} at capacity: "
                                f"{len(running)} inflight (max "
                                f"{s.max_inflight}), {len(waiting)} queued "
                                f"(max {s.max_queue})"))
                else:
                    now = time.monotonic()
                    info[seq] = (gang, None if timeout is None
                                 else now + timeout, now)
                    waiting.append(seq)
                    self._emit(("admit", seq))
            elif kind == "cancel":
                _, seq, reason = msg
                if seq in waiting:
                    waiting.remove(seq)
                    self._emit(("dequeued", seq, "cancelled",
                                f"query cancelled while queued"
                                + (f": {reason}" if reason else ""),
                                time.monotonic() - info[seq][2]))
                elif seq in running:
                    self._emit(("cancel_running", seq, reason))
            elif kind == "outcome":
                _, seq, member, report = msg
                got = reports.setdefault(seq, {})
                got[member] = report
                if len(got) == len(running[seq]):
                    self._emit(("finish", seq,
                                _agree(running.pop(seq), reports.pop(seq))))
            elif kind == "close":
                closing = msg[1]
                self._emit(("close", closing))
                if closing:
                    for seq in list(waiting):
                        self._emit(("dequeued", seq, "cancelled",
                                    f"query cancelled: scheduler "
                                    f"{s.name!r} shutting down",
                                    time.monotonic() - info[seq][2]))
                    waiting.clear()
            elif kind == "bye":
                byes += 1
            now = time.monotonic()
            for seq in list(waiting):
                deadline = info[seq][1]
                if deadline is not None and deadline <= now:
                    waiting.remove(seq)
                    self._emit(("dequeued", seq, "timeout",
                                f"query deadline ({deadline - info[seq][2]:g}"
                                f"s) passed while queued",
                                now - info[seq][2]))
            while waiting and len(running) < s.max_inflight:
                seq = waiting[0]
                gang, deadline, t0 = info[seq]
                free = self.pool.free_slots()
                if len(free) < gang:
                    break
                waiting.popleft()
                now = time.monotonic()
                running[seq] = tuple(free[:gang])
                self._emit(("start", seq, running[seq],
                            None if deadline is None else deadline - now,
                            now - t0))
            if closing is not None and not waiting and not running \
                    and not ended:
                ended = True
                self._emit(("end",))
            if ended and byes == self.world - 1:
                return

    # ------------------------------------------------------------------ #
    # every other process: the dispatcher
    # ------------------------------------------------------------------ #
    def _dispatch(self) -> None:
        while True:
            decision = self.channel.recv(0, DECISION)
            self._apply(decision)
            if decision[0] == "end":
                self.channel.send(("bye", self.rank), 0, REQUEST)
                return

    # ------------------------------------------------------------------ #
    # applying a decision (every process, in the coordinator's order)
    # ------------------------------------------------------------------ #
    def _apply(self, d: tuple) -> None:
        s = self.sched
        kind = d[0]
        self.last = d[:2]
        if kind in ("admit", "reject"):
            rec = self._record(d[1])
            with s._cond:
                if kind == "admit":
                    s._counts["submitted"] += 1
                    s._queued += 1
                else:
                    s._counts["rejected"] += 1
                    rec.reject = d[2]
                s._export_gauges_locked()
            if kind == "admit":
                s._registry.counter("serve_submitted_total",
                                    "queries admitted").inc(scheduler=s.name)
            else:
                s._registry.counter(
                    "serve_admission_rejected_total",
                    "submissions shed by admission control").inc(
                    scheduler=s.name)
            rec.decided.set()
        elif kind == "dequeued":
            _, seq, state, msg, waited = d
            rec = self._record(seq)
            with s._cond:
                s._queued -= 1
                s._export_gauges_locked()
            exc = (QueryCancelled(msg) if state == "cancelled"
                   else QueryTimeout(msg))
            rec.finish = {"state": state, "exc": _exc_info(exc),
                          "queue_wait_s": waited}
            self._try_complete(rec)
        elif kind == "start":
            _, seq, ranks, remaining, waited = d
            rec = self._record(seq)
            lease = self.pool.reserve(len(ranks))
            if lease.indices != tuple(ranks):
                raise RuntimeError(f"the pool's copy on rank {self.rank} "
                                   f"leased {lease.indices}, the "
                                   f"coordinator {ranks}")
            rec.lease, rec.member = lease, lease.is_member
            with s._cond:
                s._queued -= 1
                s._inflight += 1
                s._export_gauges_locked()
            rec.local.update(queue_wait_s=waited, devices=list(ranks),
                             started_at=time.time(),
                             started_monotonic=time.monotonic(),
                             remaining=remaining)
            if rec.member:      # its group made by the reserve above
                self._work.put(rec)
        elif kind == "cancel_running":
            rec = self._record(d[1])
            if rec.member and rec.handle is not None:
                rec.handle.token.cancel(d[2] or "handle.cancel()")
        elif kind == "finish":
            _, seq, report = d
            rec = self._record(seq)
            rec.lease.release()
            with s._cond:
                s._inflight -= 1
                s._export_gauges_locked()
                s._cond.notify_all()
            rec.finish = report
            self._try_complete(rec)
        elif kind == "close":
            with s._cond:
                s._closed = True
                s._cond.notify_all()
            if d[1]:
                s._token.cancel(f"scheduler {s.name!r} shutting down")
        elif kind == "end":
            self._work.put(None)
            self._ended.set()

    def _try_complete(self, rec: _Query) -> None:
        """Complete ``rec``'s handle once the decision that ends it has
        come and, on a member, its own run has ended."""
        with self._lock:
            if rec.completed or rec.handle is None or rec.finish is None \
                    or (rec.member and not rec.local_done):
                return
            rec.completed = True
            # the handle holds the result from here on; the record lets go
            # of it (and of the frame's inputs) with the caller
            self._records.pop(rec.seq, None)
        rep, handle = rec.finish, rec.handle
        state = rep["state"]
        stats = handle.stats
        stats.update({k: v for k, v in rec.local.items()
                      if k != "remaining"})
        stats["queue_wait_s"] = rep.get("queue_wait_s",
                                        rec.local.get("queue_wait_s"))
        for k in ("wall_s", "cache_hits", "cache_misses"):
            if k in rep:
                stats[k] = rep[k]
        if rec.member:
            stats.update({k: rec.local[k] for k in ("cache_hits",
                                                    "cache_misses")
                          if k in rec.local})
        # the gang's outcome: a member's own result only where the gang
        # is done, its own exception where it is of the agreed type
        own = rec.exc if rec.member else None
        result = rec.result if rec.member and state == "done" else None
        exc = None
        if state != "done":
            if own is not None and _exc_info(own)[:2] == tuple(
                    rep["exc"][:2]):
                exc = own
            else:
                exc = _rebuild(rep["exc"])
                exc.__cause__ = own
        rec.result = rec.exc = rec.frame = None
        self.sched._finish(handle, result, exc, state=state)

    # ------------------------------------------------------------------ #
    # this process's worker: runs its gang's queries
    # ------------------------------------------------------------------ #
    def _run_work(self) -> None:
        s = self.sched
        stream = torch.cuda.Stream(s.device) if s._on_card() else None
        while True:
            rec = self._work.get()
            if rec is None:
                return
            rec.submitted.wait()        # the frame comes with the submit
            self._run_one(rec, stream)

    def _run_one(self, rec: _Query, stream) -> None:
        s = self.sched
        token = rec.handle.token
        if rec.local.get("remaining") is not None:
            token.timeout = rec.timeout
            token.deadline = time.monotonic() + rec.local["remaining"]
        result, exc, env = None, None, None
        t0 = time.monotonic()
        try:
            env = CylonEnv(devices=rec.lease, communicator=s.communicator,
                           program_cache=s.programs)
            frame = rec.frame
            if hasattr(frame, "on_gang"):
                frame = frame.on_gang(env.comm)
            if stream is None:
                result = frame.collect(env=env, timeout=token, **rec.kw)
            else:
                with torch.cuda.stream(stream):
                    if rec.ready is not None:
                        stream.wait_event(rec.ready)
                    result = frame.collect(env=env, timeout=token,
                                           **rec.kw)
                    env.synchronize()
        except BaseException as e:
            exc = e
        wall = time.monotonic() - t0
        rec.result, rec.exc = result, exc
        report = {"state": _state_of(exc),
                  "exc": None if exc is None else _exc_info(exc),
                  "wall_s": wall}
        if env is not None:
            report.update(cache_hits=env.cache_hits,
                          cache_misses=env.cache_misses)
            rec.local.update(cache_hits=env.cache_hits,
                             cache_misses=env.cache_misses)
        with self._lock:
            rec.local_done = True
        # every member reports; the coordinator agrees the gang's outcome
        msg = ("outcome", rec.seq, self.pool.rank, report)
        if self.coordinator:
            self._inbox.put(msg)
        else:
            self.channel.send(msg, 0, REQUEST)
        self._try_complete(rec)
