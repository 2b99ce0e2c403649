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
process-wide fallback without a ``with`` block.  Where the JAX package's
env takes ``devices=``, the port's takes ``parallelism=`` (ranks stacked
on one device) and ``device=`` (``None`` means the card).
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

#: ``session`` / ``collect`` options of the JAX package that later slices
#: of the port add, with the ROADMAP queue-1 item that brings each
DEFERRED = {"timeout": 10, "retries": 10, "overflow": 10, "faults": 10,
            "adaptive": 10, "scheduler": 11}


def not_ported(what: str, item: int) -> NotImplementedError:
    """The error for a part of ``repro.df`` that ROADMAP queue 1, item
    ``item`` brings to the port."""
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"ROADMAP queue 1, item {item}")


def refuse_deferred(where: str, **options: Any) -> None:
    """Raise ``not_ported`` for the first option in ``options`` that is
    set."""
    for name, value in options.items():
        if value is not None:
            raise not_ported(f"{where}({name}=...)", DEFERRED[name])


def _stack() -> List[CylonEnv]:
    """Per-thread session stack: concurrent threads scope independently
    (the process default below is shared, guarded by ``_lock``)."""
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
    """Effective collect() defaults for this thread: innermost session
    values win, outer sessions fill the gaps.  No default is settable
    yet (the fault-tolerance and adaptive ones come with ROADMAP item 10),
    so this holds only the ``scheduler`` layer key."""
    merged: dict = {}
    for layer in _defaults_stack():
        merged.update(layer)
    return merged


def get_active_scheduler():
    """The query scheduler the innermost session scopes on this thread,
    or None.  Scheduler sessions come with ROADMAP item 11, so this is
    None until then."""
    return get_session_defaults().get("scheduler")


def get_env() -> CylonEnv:
    """The active env: innermost ``session`` on this thread, else the
    lazily-created process default (``CylonEnv()``: one rank on the card,
    raising without one)."""
    global _default
    stack = _stack()
    if stack:
        return stack[-1]
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
            parallelism: Optional[int] = None, device: Any = None,
            scheduler=None, timeout=None, retries=None, overflow=None,
            faults=None, adaptive=None) -> Iterator[Any]:
    """Scope an active env: ``with session(...) as env: df.collect()``.

    Pass an existing ``env``, or let the session build one from
    ``parallelism`` (default 1) and ``device`` (default: the card).
    Passing ``parallelism=`` or ``device=`` alongside an explicit ``env=``
    raises ``TypeError`` — the env already pins both, so silently
    ignoring either would misconfigure the gang.  The stage cache lives on
    the env, so reusing one session across many ``collect`` calls is what
    makes repeat execution cheap.

    ``scheduler=`` (ROADMAP item 11) and the collect defaults
    ``timeout`` / ``retries`` / ``overflow`` / ``faults`` / ``adaptive``
    (item 10) are not ported yet and raise ``NotImplementedError``;
    ``scheduler=`` together with an env raises ``TypeError`` first, as in
    the JAX package.
    """
    if scheduler is not None:
        if env is not None or parallelism is not None or device is not None:
            raise TypeError("pass either scheduler= or an env (env= / "
                            "parallelism= / device=), not both")
    elif env is not None and parallelism is not None:
        raise TypeError("pass either env= or parallelism=, not both")
    elif env is not None and device is not None:
        raise TypeError(
            "pass either env= or device=, not both: the env already "
            f"carries its device ({env.device})")
    refuse_deferred("session", scheduler=scheduler, timeout=timeout,
                    retries=retries, overflow=overflow, faults=faults,
                    adaptive=adaptive)
    if env is None:
        env = CylonEnv(1 if parallelism is None else parallelism,
                       device=device)
    stack = _stack()
    stack.append(env)
    # an env session masks any outer scheduler (innermost wins)
    _defaults_stack().append({"scheduler": None})
    try:
        yield env
    finally:
        stack.pop()
        _defaults_stack().pop()
