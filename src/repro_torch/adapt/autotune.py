"""The torch counterpart of ``repro.adapt.autotune`` (host logic,
unchanged).

Morsel-size autotuning for ``overflow="degrade"``.

The blind degrade loop: on any overflow it halved the segment's
morsel rows (or, once at the floor, doubled the shuffle capacity) and
replayed — each attempt a fresh stage build.  The overflow report already
says *how far* over capacity the hot rank landed; :class:`MorselTuner`
uses it to jump straight to a morsel size that fits:

    peak ≈ W + max per-rank dropped rows        (from the stat triples)
    M'   = round8(M · (W / peak) · margin)

so a 10x overflow costs one replay, not four.  Two refinements:

* **no double-split** — a segment that salting already rebalanced but
  which still overflows (e.g. the capacity estimate was simply too
  small) must not also shrink its morsels; the tuner grows ``W`` to the
  observed peak instead, keeping the salted routing intact;
* **expansion carry-over** — segments that blow up row counts (joins)
  report their observed output/input expansion; the next segment's
  *initial* morsel size is pre-shrunk when the expansion exceeds the
  capacity factor, avoiding the first overflow entirely.

With ``autotune`` off the driver falls back to
``faults.default_degrade_step`` — the original blind halving, preserved
verbatim so ``adaptive=False`` replays are bit-identical to it.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .config import AdaptiveConfig


def _round8(x: float) -> int:
    return max(8, -(-int(x) // 8) * 8)


class MorselTuner:
    """Per-run controller for degrade replays and initial morsel sizing."""

    def __init__(self, cfg: AdaptiveConfig, capacity_factor: float = 2.0,
                 events: Optional[List[Dict[str, Any]]] = None):
        self._cfg = cfg
        self._capacity_factor = max(capacity_factor, 1.0)
        self._events = events
        self.steps = 0          # surfaces as ExecStats.autotune_steps
        self._expansion = 1.0   # max observed out/in row expansion

    @property
    def enabled(self) -> bool:
        return bool(self._cfg.enabled and self._cfg.autotune)

    # -- expansion carry-over ------------------------------------------- #
    def observe_expansion(self, in_rows: int, out_rows: int) -> None:
        """Record a finished segment's row expansion (joins > 1.0)."""
        if in_rows > 0:
            self._expansion = max(self._expansion, out_rows / in_rows)

    def initial_morsel(self, m0: int) -> int:
        """Initial morsel rows for the next segment, pre-shrunk when the
        observed expansion would overflow ``W = factor * m0`` anyway."""
        if not self.enabled or self._expansion <= self._capacity_factor:
            return m0
        return min(m0, _round8(m0 * self._capacity_factor / self._expansion))

    # -- degrade replanning --------------------------------------------- #
    @staticmethod
    def _peak_drop(stat_arrays: Sequence[np.ndarray]) -> int:
        """Worst per-rank dropped-row count across the attempt's shuffle
        stat triples ``(p, 3) = [rows, bytes, dropped]``."""
        worst = 0
        for arr in stat_arrays:
            a = np.asarray(arr)
            if a.ndim == 2 and a.shape[1] >= 3:
                worst = max(worst, int(a[:, 2].max()))
        return worst

    def degrade(self, m_seg: int, w_seg: int,
                stat_arrays: Sequence[np.ndarray],
                salted: bool = False, label: str = ""
                ) -> Tuple[int, int]:
        """Pick the next ``(morsel_rows, capacity)`` after an overflow."""
        peak = w_seg + self._peak_drop(stat_arrays)
        if salted:
            # the routing is already balanced — splitting morsels would
            # rebuild every salted stage for no routing benefit;
            # grow the capacity to the observed peak instead
            m_new, w_new = m_seg, _round8(peak * 1.25)
            how = "grow-capacity"
        elif m_seg <= 8:
            m_new, w_new = m_seg, _round8(w_seg * 2)
            how = "grow-capacity"
        else:
            m_new = _round8(m_seg * (w_seg / peak) * self._cfg.autotune_margin)
            if m_new >= m_seg:   # estimate said "fits" but it didn't
                m_new = _round8(m_seg // 2)
            m_new = max(8, m_new)
            w_new = w_seg
            how = "shrink-morsel"
        self.steps += 1
        if self._events is not None:
            self._events.append({"kind": "autotune", "label": label,
                                 "how": how, "peak": int(peak),
                                 "morsel_rows": [int(m_seg), int(m_new)],
                                 "capacity": [int(w_seg), int(w_new)]})
        return m_new, w_new
