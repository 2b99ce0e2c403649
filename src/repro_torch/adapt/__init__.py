"""Runtime skew mitigation.

The torch counterpart of ``repro.adapt``.  The planner trusts
compile-time partitioning; production key distributions do not return
the favor.  ``repro_torch.adapt`` threads three runtime mitigations
through both executors, all gated by the ``adaptive=`` knob (default on,
keyed into the stage cache only when a mitigation actually fires — a run
where nothing fires builds the exact same stages as ``adaptive=False``):

* **hot-key salting** (``hotkeys``) — a cheap host-side sample pass at
  shuffle boundaries detects keys whose frequency would overwhelm one
  rank; hot keys are salted into ``k`` sub-partitions for groupby
  (partials re-merged on their home rank) and broadcast-joined for join
  (hot build rows replicated, hot probe rows kept local);
* **sample-refreshed range splitters** (``splitters``) — the
  out-of-core sort path's one-shot splitter sample becomes a refreshable
  estimator that re-samples with a larger budget when observed per-rank
  imbalance exceeds a bound, re-routing subsequent morsels;
* **morsel autotuning** (``autotune``) — ``overflow="degrade"``'s blind
  morsel halving is replaced by a controller that picks ``morsel_rows``
  from the observed overflow magnitude and spill/H2D expansion ratios,
  per segment.

``tests/test_torch_skew.py`` holds every mitigation to the JAX
package's, and to the port's own non-adaptive path.
"""

from .autotune import MorselTuner
from .config import AdaptiveConfig, resolve_adaptive
from .hotkeys import (SaltDecision, detect_hot_keys, plan_salt_decisions,
                      sample_key_columns)
from .splitters import SplitterEstimator

__all__ = [
    "AdaptiveConfig", "resolve_adaptive",
    "SaltDecision", "detect_hot_keys", "plan_salt_decisions",
    "sample_key_columns",
    "SplitterEstimator", "MorselTuner",
]
