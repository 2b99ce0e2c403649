"""Deterministic fault injection + the recovery machinery it proves out.

The torch counterpart of ``repro.faults``: the same sites, plans, retry
policy, deadline token and overflow policy, with the same host-side
``random.Random`` draws, so one seed gives the same plan and the same
backoff in both packages.

* **Injection** — every hazard point in the execution spine is a registered
  *site* (``SITES``).  A ``FaultPlan`` — a seeded, deterministic list of
  ``FaultSpec`` (site pattern x occurrence index x failure kind) — decides
  which site visits fail.  Kinds: ``raise`` (the dispatch dies), ``hang``
  (the dispatch blocks until the query deadline), ``corrupt-capacity``
  (a buffer is silently under-sized, forcing capacity overflow).  Plans
  come from code, from the ``REPRO_FAULTS`` env var (via
  ``repro_torch.flags``), or from ``random_plan`` (chaos testing under a
  fixed seed).

* **Retry** — ``RetryPolicy``: exponential backoff with deterministic
  jitter.  The executors replay failed dispatch units from host-held
  inputs (in-core) or from comm-boundary spill checkpoints
  (``core.store.Checkpoint``, out-of-core), so a recovered query is
  bit-identical to the fault-free run.

* **Deadline / cancellation** — ``CancellationToken``: a host-side
  deadline checked between morsels/stages and inside backoff sleeps, so
  hung dispatches and long retry loops are fenced by
  ``df.collect(timeout=...)``.

* **Overflow policy** — ``OverflowPolicy`` (``raise | warn | degrade``)
  replaces silent row drops: under ``degrade`` (the default) an overflowing
  segment re-executes out-of-core with auto-halved ``morsel_rows`` (then
  grown working capacity) until it fits — slower, never wrong.

All injection and recovery is **host-side**: no site check runs inside a
stage callable, so with injection disabled the stage-cache keys are
identical to a build without the harness.

* **Over a process group** — each process runs its own ``FaultRun`` and
  deadline, so a fault or an expired deadline may hit one process alone
  while the others go on into a collective it never joins.
  ``GroupFaults`` makes every site visit end in one agreement over the
  group (an all-gather of "this visit failed, and how"): when any
  process faults, every process raises there (``PeerFault`` where it did
  not fault itself) and every process discards and replays the unit
  together, so ``ExecStats.retries`` is equal on every process; an
  expired deadline anywhere raises ``QueryTimeout`` everywhere.  The
  executors' own deadline checks then defer to those agreements
  (``AgreedToken``).  The visits are made from counts the group agrees
  on (morsels, sub-buckets, segments), so every process makes the same
  ones.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import random
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from . import flags

__all__ = [
    "SITES", "FaultError", "InjectedFault", "PeerFault", "QueryTimeout",
    "QueryCancelled", "GroupFaults", "AgreedToken", "over_group",
    "CapacityOverflow", "FaultSpec", "FaultPlan", "FaultRun", "NULL_FAULTS",
    "parse_fault_plan", "random_plan", "resolve_faults",
    "RetryPolicy", "resolve_retry", "CancellationToken", "resolve_token",
    "OverflowPolicy", "resolve_overflow", "default_degrade_step",
    "run_with_retries",
]

#: Every registered injection site in the execution spine.  ``FaultSpec``
#: patterns must match at least one of these (typo guard), and the chaos
#: suite + hypothesis property test enumerate them.
SITES: Tuple[str, ...] = (
    "stage:launch",      # in-core: one per dispatch unit (program/stage/op)
    "a2a:chunk",         # in-core: one per all-to-all chunk of a shuffle unit
    "segment:launch",    # out-of-core: one per segment attempt
    "morsel:compile",    # out-of-core: first morsel of a segment (trace+build)
    "morsel:execute",    # out-of-core: every morsel dispatch
    "transfer:h2d",      # out-of-core: host->device morsel staging
    "transfer:d2h",      # out-of-core: device->host spill of a morsel output
    "spill:append",      # out-of-core: appending a chunk to a spill bucket
    "spill:respill",     # out-of-core: re-bucketing the input spill
    "spill:combine",     # out-of-core: cross-morsel groupby combine dispatch
    "build:resident",    # out-of-core: resident join build-side execution
)

KINDS: Tuple[str, ...] = ("raise", "hang", "corrupt-capacity")


# ---------------------------------------------------------------------- #
# Exceptions
# ---------------------------------------------------------------------- #
class FaultError(RuntimeError):
    """A recoverable execution fault (retried by the executors)."""


class InjectedFault(FaultError):
    """Raised by a firing ``raise`` (or expired ``hang``) fault."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(message or f"injected fault at {site}")
        self.site = site


class PeerFault(FaultError):
    """Another process of the group faulted at this site visit: this one
    replays the unit with it (``GroupFaults``)."""

    def __init__(self, site: str, message: str = ""):
        super().__init__(message or f"a peer process faulted at {site}")
        self.site = site


class QueryCancelled(RuntimeError):
    """The query's ``CancellationToken`` was cancelled."""


class QueryTimeout(TimeoutError):
    """The query's deadline passed (``df.collect(timeout=...)``)."""


class CapacityOverflow(RuntimeError):
    """Capacity pressure dropped rows and the overflow policy forbids it
    (``raise``) or degradation could not make the data fit."""


# ---------------------------------------------------------------------- #
# Fault plans
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: fire ``kind`` at occurrence ``at`` of sites matching
    ``site`` (an ``fnmatch`` pattern), at most ``times`` times per query.

    ``at=None`` matches every occurrence (until ``times`` is exhausted).
    Occurrences are counted per concrete site name within one query run,
    so plans are deterministic given a deterministic execution order.
    """

    site: str
    kind: str = "raise"
    at: Optional[int] = 0
    times: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")
        if not any(fnmatch.fnmatch(s, self.site) for s in SITES):
            raise ValueError(f"fault site pattern {self.site!r} matches no "
                             f"registered site; sites are {SITES}")

    def matches(self, site: str, occurrence: int) -> bool:
        return (fnmatch.fnmatch(site, self.site)
                and (self.at is None or occurrence == self.at))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic set of faults for one query (or many: each
    ``start()`` yields a fresh per-query ``FaultRun`` with its own
    occurrence counters)."""

    specs: Tuple[FaultSpec, ...] = ()
    seed: int = 0
    hang_s: float = 30.0   # how long a ``hang`` blocks without a deadline

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))

    def start(self) -> "FaultRun":
        return FaultRun(self)

    def __str__(self) -> str:
        parts = []
        for s in self.specs:
            at = "*" if s.at is None else str(s.at)
            parts.append(f"{s.site}@{at}x{s.times}={s.kind}")
        return ";".join(parts)


class FaultRun:
    """Per-query injection state: occurrence counters per concrete site and
    fire counts per spec.  Executors call ``check``/``capacity`` at every
    hazard point; both are no-ops on the shared ``NULL_FAULTS`` singleton.
    """

    enabled = True

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._seen: Dict[str, int] = {}
        self._fired: Dict[int, int] = {}
        self.injected = 0          # total faults fired this query

    def _arm(self, site: str,
             kinds: Tuple[str, ...] = KINDS) -> Optional[FaultSpec]:
        occ = self._seen.get(site, 0)
        self._seen[site] = occ + 1
        for i, spec in enumerate(self.plan.specs):
            if spec.kind not in kinds or self._fired.get(i, 0) >= spec.times:
                continue
            if spec.matches(site, occ):
                self._fired[i] = self._fired.get(i, 0) + 1
                self.injected += 1
                return spec
        return None

    def _fire(self, spec: FaultSpec, site: str,
              token: Optional["CancellationToken"], idx: Dict[str, Any]):
        where = site + (f" {idx}" if idx else "")
        if spec.kind == "raise":
            raise InjectedFault(site, f"injected fault at {where}")
        # hang: block until the query deadline fences us (or a bounded
        # fallback elapses, surfacing as a retryable fault)
        t0 = time.monotonic()
        while time.monotonic() - t0 < self.plan.hang_s:
            if token is not None:
                token.check(where)   # raises QueryTimeout / QueryCancelled
            time.sleep(0.002)
        raise InjectedFault(site, f"injected hang at {where} expired "
                                  f"after {self.plan.hang_s}s")

    def check(self, site: str, token: Optional["CancellationToken"] = None,
              **idx: Any) -> None:
        """Fire any armed ``raise``/``hang`` fault for this site visit.

        ``idx`` (stage=, morsel=, ...) is advisory labeling for the error
        message; matching is by site occurrence order, which is
        deterministic for a deterministic execution.
        """
        spec = self._arm(site, kinds=("raise", "hang"))
        if spec is None:
            return
        self._fire(spec, site, token, idx)

    def capacity(self, site: str, value: int,
                 token: Optional["CancellationToken"] = None,
                 **idx: Any) -> int:
        """Visit a site whose hazard is a buffer capacity: an armed
        ``corrupt-capacity`` fault shrinks ``value`` to a quarter (8-rounded,
        forcing overflow the overflow policy must repair); ``raise``/``hang``
        faults fire exactly as ``check``.  Each hazard point calls either
        ``check`` or ``capacity``, never both, so every site has one
        deterministic occurrence stream."""
        spec = self._arm(site)
        if spec is None:
            return value
        if spec.kind == "corrupt-capacity":
            return max(8, int(value) // 4 // 8 * 8)
        self._fire(spec, site, token, idx)
        return value


class _NullFaults:
    """Disabled harness: every call is a no-op (one attr lookup when off)."""

    __slots__ = ()
    enabled = False
    injected = 0

    def __bool__(self) -> bool:
        return False

    def check(self, site: str, token: Any = None, **idx: Any) -> None:
        return None

    def capacity(self, site: str, value: int, **idx: Any) -> int:
        return value


NULL_FAULTS = _NullFaults()


def parse_fault_plan(text: str) -> FaultPlan:
    """Parse the ``REPRO_FAULTS`` syntax: ``;``-separated entries
    ``site[@occurrence][xtimes]=kind`` plus optional ``seed=N``.

    ``site`` is an fnmatch pattern over ``SITES``; ``@occurrence`` defaults
    to 0 (first visit), ``@*`` means every visit; ``xN`` caps fires per
    query (default 1).  Examples::

        morsel:execute@2=raise
        stage:*=hang;seed=7
        transfer:h2d@*x3=raise
    """
    specs: List[FaultSpec] = []
    seed = 0
    for entry in text.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(f"bad REPRO_FAULTS entry {entry!r}: "
                             f"expected site[@occ][xN]=kind")
        lhs, kind = entry.rsplit("=", 1)
        lhs, kind = lhs.strip(), kind.strip()
        if lhs == "seed":
            seed = int(kind)
            continue
        times = 1
        if "x" in lhs.rsplit("@", 1)[-1]:
            lhs, times_s = lhs.rsplit("x", 1)
            times = int(times_s)
        at: Optional[int] = 0
        if "@" in lhs:
            lhs, at_s = lhs.rsplit("@", 1)
            at = None if at_s == "*" else int(at_s)
        specs.append(FaultSpec(lhs, kind=kind, at=at, times=times))
    return FaultPlan(tuple(specs), seed=seed)


def random_plan(seed: int, nfaults: int = 1,
                kinds: Sequence[str] = ("raise",),
                max_occurrence: int = 3,
                sites: Sequence[str] = SITES) -> FaultPlan:
    """A deterministic random plan for chaos testing: ``nfaults`` single
    faults at uniformly drawn (site, occurrence, kind) triples."""
    rng = random.Random(seed)
    specs = tuple(
        FaultSpec(rng.choice(list(sites)), kind=rng.choice(list(kinds)),
                  at=rng.randrange(max_occurrence + 1))
        for _ in range(nfaults))
    return FaultPlan(specs, seed=seed)


def resolve_faults(faults: Any):
    """Normalize the ``faults=`` argument of the executors.

    ``None`` consults ``repro_torch.flags`` / the ``REPRO_FAULTS`` env var;
    ``False`` forces off; a ``FaultPlan`` starts a fresh per-query run; a
    ``FaultRun`` continues (degrade re-entry keeps one occurrence stream);
    a string is parsed as ``REPRO_FAULTS`` syntax."""
    if isinstance(faults, (FaultRun, _NullFaults)):
        return faults
    if isinstance(faults, FaultPlan):
        return faults.start()
    if faults is False:
        return NULL_FAULTS
    if faults is None:
        spec = flags.fault_spec()
        return parse_fault_plan(spec).start() if spec else NULL_FAULTS
    if isinstance(faults, str):
        return parse_fault_plan(faults).start()
    raise TypeError(f"faults= must be None/False/str/FaultPlan, "
                    f"got {type(faults).__name__}")


# ---------------------------------------------------------------------- #
# Retry with exponential backoff + deterministic jitter
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Replay a failed dispatch unit up to ``retries`` times, sleeping
    ``backoff_s * 2**attempt`` (capped at ``backoff_max_s``) with
    deterministic jitter (seeded, so reproductions reproduce)."""

    retries: int = 2
    backoff_s: float = 0.005
    backoff_max_s: float = 0.25
    jitter: float = 0.5
    seed: int = 0

    def delay(self, attempt: int) -> float:
        base = min(self.backoff_max_s, self.backoff_s * (2.0 ** attempt))
        frac = random.Random(self.seed * 1000003 + attempt).random()
        return base * (1.0 + self.jitter * frac)

    def sleep(self, attempt: int,
              token: Optional["CancellationToken"] = None) -> None:
        """Back off before attempt ``attempt`` (0-based retry index),
        polling the cancellation token so a deadline fires mid-backoff."""
        remaining = self.delay(attempt)
        while remaining > 0:
            if token is not None:
                token.check(f"retry backoff (attempt {attempt + 1})")
            step = min(0.01, remaining)
            time.sleep(step)
            remaining -= step


def resolve_retry(retry: Any) -> RetryPolicy:
    """``None`` -> default policy; an int -> that many retries; a
    ``RetryPolicy`` passes through."""
    if retry is None:
        return RetryPolicy()
    if isinstance(retry, RetryPolicy):
        return retry
    if isinstance(retry, int) and not isinstance(retry, bool):
        return RetryPolicy(retries=retry)
    raise TypeError(f"retries= must be None/int/RetryPolicy, "
                    f"got {type(retry).__name__}")


# ---------------------------------------------------------------------- #
# Deadline / cancellation token
# ---------------------------------------------------------------------- #
class CancellationToken:
    """Host-side deadline + cooperative cancellation for one query.

    Executors call ``check()`` between morsels / stages and before each
    dispatch; injected hangs poll it, so a hung dispatch surfaces as
    ``QueryTimeout`` rather than blocking forever.

    ``parent`` links tokens into a tree: a child observes its parent's
    cancellation and deadline as well as its own (the query scheduler,
    ``repro_torch.serve.QueryScheduler``, parents per-query tokens on one
    scheduler-wide token).  Cancellation is a
    plain flag write (atomic under CPython), safe to call from any thread.
    """

    def __init__(self, timeout: Optional[float] = None,
                 parent: Optional["CancellationToken"] = None):
        self.deadline = (time.monotonic() + timeout
                         if timeout is not None else None)
        self.timeout = timeout
        self.parent = parent
        self._cancelled = False
        self.reason = ""

    @property
    def cancelled(self) -> bool:
        return self._cancelled or (self.parent is not None
                                   and self.parent.cancelled)

    @property
    def cancel_reason(self) -> str:
        if self._cancelled or self.parent is None:
            return self.reason
        return self.parent.cancel_reason

    def cancel(self, reason: str = "") -> None:
        self.reason = reason
        self._cancelled = True

    def remaining(self) -> Optional[float]:
        own = (None if self.deadline is None
               else self.deadline - time.monotonic())
        if self.parent is None:
            return own
        up = self.parent.remaining()
        if own is None:
            return up
        return own if up is None else min(own, up)

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0

    def check(self, where: str = "") -> None:
        if self.cancelled:
            reason = self.cancel_reason
            raise QueryCancelled(
                f"query cancelled{': ' + reason if reason else ''}"
                + (f" (at {where})" if where else ""))
        if self.expired():
            timeout = self.timeout
            if timeout is None and self.parent is not None:
                timeout = self.parent.timeout
            raise QueryTimeout(
                f"query deadline ({timeout}s) passed"
                + (f" at {where}" if where else ""))


def resolve_token(timeout: Any) -> CancellationToken:
    """``None``/seconds -> fresh token; an existing token passes through."""
    if isinstance(timeout, CancellationToken):
        return timeout
    if timeout is not None and not isinstance(timeout, (int, float)):
        raise TypeError(f"timeout= must be None/seconds/CancellationToken, "
                        f"got {type(timeout).__name__}")
    return CancellationToken(timeout)


# ---------------------------------------------------------------------- #
# Overflow policy
# ---------------------------------------------------------------------- #
class OverflowPolicy:
    """What to do when capacity pressure drops rows (observable in morsel
    mode always, in-core when stats are collected):

    * ``raise``   — fail the query with ``CapacityOverflow``;
    * ``warn``    — keep the (truncated) result, emit one deduplicated
                    ``RuntimeWarning`` attributing the drops;
    * ``degrade`` — (default) re-execute the overflowing segment
                    out-of-core with auto-halved ``morsel_rows`` (then
                    grown working capacity) until every row fits —
                    slower, never wrong.
    """

    RAISE = "raise"
    WARN = "warn"
    DEGRADE = "degrade"
    ALL = (RAISE, WARN, DEGRADE)


def resolve_overflow(overflow: Any) -> str:
    if overflow is None:
        return OverflowPolicy.DEGRADE
    if overflow in OverflowPolicy.ALL:
        return overflow
    raise ValueError(f"overflow= must be one of {OverflowPolicy.ALL}, "
                     f"got {overflow!r}")


def default_degrade_step(morsel_rows: int, capacity: int) -> Tuple[int, int]:
    """The original blind degrade step: halve ``morsel_rows`` until the
    floor (8), then double the working ``capacity``.

    This is what ``overflow="degrade"`` replays with when morsel
    autotuning is off (``adaptive=False``) — kept as a standalone policy
    function so the adaptive controller (``repro_torch.adapt.MorselTuner``) and
    the legacy path share one call site and the legacy behavior stays
    bit-for-bit the blind halving.
    """
    def _round8(x: int) -> int:
        return max(8, -(-int(x) // 8) * 8)
    if morsel_rows > 8:
        return max(8, _round8(morsel_rows // 2)), capacity
    return morsel_rows, _round8(capacity * 2)


def run_with_retries(fn, *, policy: RetryPolicy,
                     token: Optional[CancellationToken] = None,
                     tracer=None, label: str = "",
                     on_retry=None):
    """Call ``fn()`` with up to ``policy.retries`` replays on ``FaultError``.

    Timeouts/cancellations propagate immediately (they are not transient).
    ``on_retry(attempt, exc)`` is invoked before each replay (counter
    bumps); ``tracer`` gets a ``retry:{label}`` span around each replay.
    """
    attempt = 0
    while True:
        try:
            return fn()
        except FaultError as e:
            if attempt >= policy.retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            policy.sleep(attempt, token)
            attempt += 1
            if tracer is not None and tracer.enabled:
                tracer.instant(f"retry:{label or 'unit'}", "retry",
                               attempt=attempt, error=str(e))


# ---------------------------------------------------------------------- #
# Over a process group: one agreement per site visit
# ---------------------------------------------------------------------- #
#: agreement codes, in order of precedence (the group takes the largest)
_OK, _FAULT, _TIMEOUT, _CANCELLED = 0, 1, 2, 3


class AgreedToken(CancellationToken):
    """The executors' token over a process group: its own ``check`` does
    nothing, because a deadline that expires between two collectives on
    one process alone would leave the others blocked in the next one.
    The wrapped token's deadline is checked at every site visit instead,
    where the group agrees (``GroupFaults``)."""

    def __init__(self, token: CancellationToken):
        super().__init__(None)
        self.inner = token
        self.timeout = token.timeout

    @property
    def cancelled(self) -> bool:
        return self.inner.cancelled

    def remaining(self) -> Optional[float]:
        return self.inner.remaining()

    def check(self, where: str = "") -> None:
        return None


class GroupFaults:
    """A ``FaultRun`` (or ``NULL_FAULTS``) and a deadline over a process
    group: every ``check`` / ``capacity`` visit fires the process's own
    faults, checks its deadline, then agrees with the group (one
    all-gather of a code and the capacity).  Every process then raises
    alike — its own ``InjectedFault``, else a ``PeerFault``; a
    ``QueryTimeout`` / ``QueryCancelled`` anywhere wins over a fault — or
    takes the group's smallest capacity, so a ``corrupt-capacity`` on one
    process shrinks every process's buffers alike.  A ``hang`` blocks its
    process until its deadline, while the others wait in the agreement,
    so the group's collective timeout must exceed the query's."""

    enabled = True

    def __init__(self, inner, token: CancellationToken, comm):
        self.inner = inner
        self.token = token
        self.comm = comm

    def __bool__(self) -> bool:
        return True

    @property
    def injected(self) -> int:
        return self.inner.injected

    def _visit(self, site: str, fire, value: int, idx: Dict[str, Any]
               ) -> int:
        code, err = _OK, None
        try:
            value = fire()
            self.token.check(site)
        except InjectedFault as e:
            code, err = _FAULT, e
        except QueryTimeout as e:
            code, err = _TIMEOUT, e
        except QueryCancelled as e:
            code, err = _CANCELLED, e
        every = self.comm.gather_ints([code, value])
        got = int(every[:, 0].max())
        if got == _OK:
            return int(every[:, 1].min())
        if err is not None and code == got:
            raise err
        where = site + (f" {idx}" if idx else "")
        if got == _FAULT:
            raise PeerFault(site, f"a peer process faulted at {where}")
        if got == _TIMEOUT:
            raise QueryTimeout(f"query deadline ({self.token.timeout}s) "
                               f"passed on a peer process at {where}")
        raise QueryCancelled(f"query cancelled on a peer process at {where}")

    def check(self, site: str, token: Any = None, **idx: Any) -> None:
        self._visit(site, lambda: self.inner.check(site, token=self.token,
                                                   **idx) or 0, 0, idx)

    def capacity(self, site: str, value: int, token: Any = None,
                 **idx: Any) -> int:
        return self._visit(site, lambda: self.inner.capacity(
            site, value, token=self.token, **idx), value, idx)


def over_group(faults, token: CancellationToken, comm):
    """``(faults, token)`` for an executor on ``comm``: over a process
    group where any process arms a fault plan or a deadline (agreed
    once, so every process wraps alike), ``GroupFaults`` and an
    ``AgreedToken``; otherwise both unchanged."""
    if isinstance(faults, GroupFaults) or comm is None or \
            comm.ranks_held() == comm.size():
        return faults, token
    armed = bool(faults) or token.deadline is not None or \
        token.parent is not None
    if not comm.gather_ints([int(armed)]).any():
        return faults, token
    return GroupFaults(faults, token, comm), AgreedToken(token)
