"""Session management: which ``CylonEnv`` a lazy DataFrame executes on.

The torch counterpart of ``repro.df.session``.  Users write ordinary
dataframe code while the environment underneath is supplied for them:
``collect()`` resolves the *active* env — the innermost ``session(...)``
context manager, else a process-wide default created lazily (one rank on
the card, ``CylonEnv()``):

    import repro_torch.df as rdf

    df = rdf.read_numpy({"k": keys, "v": vals})        # default env
    out = df[df.k > 0].collect()

    with rdf.session(parallelism=8, device="cpu") as env:
        out = df2.collect()                             # runs on `env`

Sessions nest (a stack per thread); an explicit ``env=`` argument on
``collect`` / ``read_numpy`` always wins.  ``set_default_env`` pins the
process-wide fallback without a ``with`` block.  As in the JAX package,
``session(devices=lease)`` runs on the rank slots of a ``DevicePool``
lease (``repro_torch.core``); the port also takes ``parallelism=`` (ranks
stacked on one device) and ``device=`` (``None`` means the card).

``session(scheduler=sched)`` scopes a ``repro_torch.serve.QueryScheduler``
instead of an env: every ``collect()`` in scope without an explicit or
ingest-pinned env is submitted to it and blocks on its handle, and
ingests partition for its gang size.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Iterator, List, Optional

from ..core.env import CylonEnv

__all__ = ["session", "get_env", "set_default_env", "reset_default_env",
           "get_session_defaults", "get_active_scheduler"]

_lock = threading.Lock()
_default: Optional[CylonEnv] = None
_tls = threading.local()

def _stack() -> List[Optional[CylonEnv]]:
    """Per-thread session stack: concurrent threads scope independently
    (the process default below is shared, guarded by ``_lock``).  A
    scheduler session pushes ``None``: it scopes no env."""
    try:
        return _tls.stack
    except AttributeError:
        _tls.stack = []
        return _tls.stack


def _defaults_stack() -> List[dict]:
    """Per-thread stack of session-scoped collect() defaults (parallel to
    ``_stack``)."""
    try:
        return _tls.defaults
    except AttributeError:
        _tls.defaults = []
        return _tls.defaults


def get_session_defaults() -> dict:
    """Effective fault-tolerance / adaptivity defaults for this thread:
    innermost session values win, outer sessions fill the gaps."""
    merged: dict = {}
    for layer in _defaults_stack():
        merged.update(layer)
    return merged


def get_active_scheduler():
    """The ``repro_torch.serve.QueryScheduler`` the innermost session
    scopes on this thread, or None.  An inner env-bearing ``session(...)``
    masks an outer scheduler session (its layer pins ``scheduler=None``),
    so plain in-thread execution wins wherever it is the innermost
    choice."""
    return get_session_defaults().get("scheduler")


def get_env() -> CylonEnv:
    """The active env: innermost env-bearing ``session`` on this thread
    (scheduler sessions scope no env and are skipped), else the
    lazily-created process default (``CylonEnv()``: one rank on the card,
    raising without one)."""
    global _default
    for e in reversed(_stack()):
        if e is not None:
            return e
    with _lock:
        if _default is None:
            _default = CylonEnv()
        return _default


def set_default_env(env: CylonEnv) -> None:
    """Pin the process-wide fallback env (overrides lazy creation)."""
    global _default
    with _lock:
        _default = env


def reset_default_env() -> None:
    """Drop the process default so the next ``get_env`` recreates it."""
    global _default
    with _lock:
        _default = None


@contextlib.contextmanager
def session(env: Optional[CylonEnv] = None, *,
            devices: Any = None,
            parallelism: Optional[int] = None, device: Any = None,
            communicator: Optional[str] = None,
            scheduler=None, timeout=None, retries=None, overflow=None,
            faults=None, adaptive=None) -> Iterator[Any]:
    """Scope an active env: ``with session(...) as env: df.collect()``.

    Pass an existing ``env``, or let the session build one from
    ``devices`` or from ``parallelism`` (default 1) and ``device``
    (default: the card), and from ``communicator`` (default ``"xla"``).
    ``devices`` is what ``CylonEnv(devices=)`` takes, passed on as it is:
    a ``Lease`` from a ``DevicePool`` (over stacked slots or over a
    process group's ranks) or a sequence of its ``RankSlot``s; it fixes
    the parallelism and the device, so passing ``parallelism=`` or
    ``device=`` beside it raises ``TypeError``.  Passing any of those
    alongside an explicit ``env=`` raises ``TypeError`` too — the env
    already pins them, so silently ignoring one would misconfigure the
    gang.  The stage cache lives on the env, so reusing one session across
    many ``collect`` calls is what makes repeat execution cheap.

    ``scheduler=`` scopes a ``repro_torch.serve.QueryScheduler`` instead
    of an env: every ``collect()`` in scope (without an explicit ``env=``
    or an ingest-pinned env) is submitted to the scheduler and blocks on
    its ``QueryHandle`` — many threads each inside such a session share
    the scheduler's gangs.  The session yields the scheduler.  Mutually
    exclusive with ``env=`` / ``devices=`` / ``parallelism=`` /
    ``device=`` / ``communicator=``; a nested env-bearing session masks
    it.

    ``timeout`` / ``retries`` / ``overflow`` / ``faults`` set the
    session-wide fault-tolerance defaults applied to every ``collect()``
    in scope; a per-call argument overrides, and nested sessions override
    outer ones per key.  A session-level ``timeout`` is a *per-query*
    deadline, re-armed at each collect.  ``adaptive`` defaults the
    runtime skew-mitigation knob the same way: ``session(adaptive=False)``
    pins every collect in scope to the non-adaptive stages; a dict or
    ``repro_torch.adapt.AdaptiveConfig`` tunes detection thresholds.
    """
    if scheduler is not None:
        if (env is not None or devices is not None or parallelism is not None
                or device is not None or communicator is not None):
            raise TypeError("pass either scheduler= or an env (env= / "
                            "devices= / parallelism= / device= / "
                            "communicator=), not both")
    elif env is not None and devices is not None:
        raise TypeError("pass either env= or devices=, not both")
    elif devices is not None and (parallelism is not None
                                  or device is not None):
        raise TypeError("devices= sets the parallelism and the device; "
                        "pass neither parallelism= nor device= beside it")
    elif env is not None and parallelism is not None:
        raise TypeError("pass either env= or parallelism=, not both")
    elif env is not None and device is not None:
        raise TypeError(
            "pass either env= or device=, not both: the env already "
            f"carries its device ({env.device})")
    elif env is not None and communicator is not None:
        raise TypeError(
            "pass either env= or communicator=, not both: the env already "
            f"carries its communicator ({env.communicator_name!r})")
    if scheduler is None and env is None:
        env = CylonEnv(1 if parallelism is None else parallelism,
                       device=device, devices=devices,
                       communicator=communicator or "xla")
    layer = {k: v for k, v in (("timeout", timeout), ("retries", retries),
                               ("overflow", overflow), ("faults", faults),
                               ("adaptive", adaptive))
             if v is not None}
    # a scheduler session scopes the scheduler; an env session masks any
    # outer scheduler (innermost wins)
    layer["scheduler"] = scheduler
    stack = _stack()
    stack.append(env)
    _defaults_stack().append(layer)
    try:
        yield scheduler if scheduler is not None else env
    finally:
        stack.pop()
        _defaults_stack().pop()
