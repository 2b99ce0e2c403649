"""The torch counterpart of ``repro.adapt.splitters`` (host logic,
unchanged).

Sample-refreshed range splitters for the out-of-core sort path.

The morsel driver's original contract was one-shot: pool a small
evenly-spaced sample per rank before the segment runs, take ``p-1``
quantiles, and route every morsel with those splitters forever.  On
adversarial value distributions (all rows in one quantile bucket, sorted
input, heavy duplicates) the one-shot sample lands all traffic on one
rank and the segment degrades into overflow replays.

:class:`SplitterEstimator` keeps the same splitters *values* flowing
into the same built stage (splitters are a runtime argument — the
stage is keyed on shape/dtype, so a refresh never rebuilds it) but
watches the per-rank routed-row counts each morsel actually produced.
When the hottest rank's cumulative share exceeds ``imbalance_bound``
times its fair share (max / mean — median would hide a split where half
the ranks sit empty, and max/mean is capped at ``p`` so the bound stays
meaningful at small gang sizes) it re-samples with a ``refresh_boost``x
larger budget and swaps in the new splitters for subsequent morsels.

A mid-stream refresh intentionally breaks the range-disjointness
invariant (early morsels were routed by the old splitters), so the
driver MUST host-re-route the output spill by the *final* splitters
whenever ``refreshes > 0`` before the per-rank local sort.  The
estimator only decides; the driver owns the re-route.

Over a process group (``comm``) each process observes the routed rows of
the ranks it holds; ``observe`` gathers every rank's before it judges,
so every process takes the same refresh decision.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .config import AdaptiveConfig

#: don't judge imbalance before this many routed rows have been seen
_MIN_OBSERVED = 256


class SplitterEstimator:
    """Refreshable splitter source for one sort segment.

    ``sample_fn(samples)`` re-pools from the segment's input spill and
    returns a fresh ``(p-1,)`` splitter array — supplied by the driver so
    this module stays free of spill-layout knowledge.
    """

    def __init__(self, splitters: np.ndarray,
                 sample_fn: Callable[[int], np.ndarray],
                 samples: int, cfg: AdaptiveConfig,
                 events: Optional[List[Dict[str, Any]]] = None,
                 label: str = "", comm: Any = None):
        self.splitters = splitters
        self._comm = comm
        self._sample_fn = sample_fn
        self._samples = samples
        self._cfg = cfg
        self._events = events
        self._label = label
        self.refreshes = 0
        p = len(splitters) + 1
        self._routed = np.zeros(p, np.int64)

    @property
    def enabled(self) -> bool:
        return bool(self._cfg.enabled and self._cfg.splitter_refresh)

    def imbalance(self) -> float:
        """Hottest rank's routed rows over the fair (mean) share, since
        the last refresh."""
        mean = float(self._routed.mean())
        return float(self._routed.max()) / max(mean, 1.0)

    def observe(self, row_counts: np.ndarray) -> bool:
        """Feed one morsel's per-rank routed rows (of the ranks held, with
        a ``comm``); True iff this call triggered a refresh (so the morsel
        executor can log / count it)."""
        if self._comm is not None:
            import torch
            row_counts = self._comm.world(
                torch.as_tensor(np.asarray(row_counts, np.int64))).numpy()
        self._routed += np.asarray(row_counts, np.int64)
        if (not self.enabled
                or self.refreshes >= self._cfg.max_refreshes
                or int(self._routed.sum()) < _MIN_OBSERVED
                or self.imbalance() <= self._cfg.imbalance_bound):
            return False
        seen = self.imbalance()
        self._samples *= max(2, self._cfg.refresh_boost)
        fresh = self._sample_fn(self._samples)
        if fresh is None or np.array_equal(fresh, self.splitters):
            # a bigger sample told the same story: the imbalance is the
            # data, not the sample — stop burning refresh budget on it
            self.refreshes = self._cfg.max_refreshes
            return False
        self.splitters = fresh
        self.refreshes += 1
        self._routed[:] = 0
        if self._events is not None:
            self._events.append({"kind": "splitter_refresh",
                                 "label": self._label,
                                 "imbalance": round(seen, 3),
                                 "samples": self._samples,
                                 "refresh": self.refreshes})
        return True
