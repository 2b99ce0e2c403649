"""Overflow policy and its error (the part of ``repro.faults`` this slice
of the port needs; fault injection, retries and cancellation come later).
"""

from __future__ import annotations

from typing import Optional


class CapacityOverflow(RuntimeError):
    """Capacity pressure dropped rows and the overflow policy forbids it."""


class OverflowPolicy:
    """What to do when capacity pressure drops rows (observable in-core
    when stats are collected):

    * ``raise``   — fail the query with ``CapacityOverflow``;
    * ``warn``    — keep the (truncated) result and warn, attributing the
                    drops;
    * ``degrade`` — (default) re-execute out-of-core until every row fits.
                    The out-of-core executor is not ported yet, so here it
                    fails with ``CapacityOverflow`` and says so.
    """

    RAISE = "raise"
    WARN = "warn"
    DEGRADE = "degrade"
    ALL = (RAISE, WARN, DEGRADE)


def resolve_overflow(overflow: Optional[str]) -> str:
    if overflow is None:
        return OverflowPolicy.DEGRADE
    if overflow in OverflowPolicy.ALL:
        return overflow
    raise ValueError(f"overflow= must be one of {OverflowPolicy.ALL}, "
                     f"got {overflow!r}")
