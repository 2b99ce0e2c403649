"""Overflow policy, its error and the degrade step (the part of
``repro.faults`` the port has so far; fault injection, retries and
cancellation come with ROADMAP queue 1, item 10).
"""

from __future__ import annotations

from typing import Optional, Tuple


class CapacityOverflow(RuntimeError):
    """Capacity pressure dropped rows and the overflow policy forbids it."""


class OverflowPolicy:
    """What to do when capacity pressure drops rows (observable in-core
    when stats are collected):

    * ``raise``   — fail the query with ``CapacityOverflow``;
    * ``warn``    — keep the (truncated) result and warn, attributing the
                    drops;
    * ``degrade`` — (default) re-execute out-of-core until every row fits:
                    in-core runs replay the plan through the morsel
                    executor, which halves its morsels (then grows its
                    working capacity) until no row is dropped.
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


def default_degrade_step(morsel_rows: int, capacity: int) -> Tuple[int, int]:
    """The degrade step: halve ``morsel_rows`` until the floor (8), then
    double the working ``capacity``."""
    def _round8(x: int) -> int:
        return max(8, -(-int(x) // 8) * 8)
    if morsel_rows > 8:
        return max(8, _round8(morsel_rows // 2)), capacity
    return morsel_rows, _round8(capacity * 2)
