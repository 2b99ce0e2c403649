"""The torch counterpart of ``repro.adapt.config``.

The ``adaptive=`` knob: one frozen config for all three mitigations.

``resolve_adaptive`` normalizes what executors accept::

    adaptive=None            -> defaults (enabled)
    adaptive=True / False    -> enabled / disabled wholesale
    adaptive={"salt_k": 4}   -> defaults with overrides
    adaptive=AdaptiveConfig  -> passes through

Feature toggles (``salting`` / ``splitter_refresh`` / ``autotune``) turn
individual mitigations off while keeping the rest; thresholds are
the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class AdaptiveConfig:
    """Knobs for runtime skew mitigation (``repro_torch.adapt``)."""

    #: master switch; ``False`` disables every mitigation (and, by
    #: construction, leaves every stage-cache key untouched)
    enabled: bool = True
    # -- hot-key salting -------------------------------------------------- #
    salting: bool = True
    #: a key is *hot* when its sampled frequency exceeds
    #: ``hot_key_factor / p`` (i.e. ``factor``x its fair share of rows)
    hot_key_factor: float = 2.0
    #: at most this many distinct hot keys are salted per shuffle boundary
    max_hot_keys: int = 8
    #: sub-partitions a hot key is spread over for groupby salting;
    #: 0 = auto (the gang size ``p``)
    salt_k: int = 0
    #: detection sample size (driver-side, evenly spaced over valid rows)
    sample_rows: int = 4096
    #: tables smaller than this never trigger salting (skew on tiny
    #: inputs is not worth a second shuffle / a broadcast)
    min_table_rows: int = 256
    #: broadcast-join cap: if the *build* side holds more hot rows than
    #: this, replication would cost more than the skew, so don't salt
    max_broadcast_rows: int = 65536
    # -- sample-refreshed range splitters (out-of-core sort) -------------- #
    splitter_refresh: bool = True
    #: refresh when the hottest rank's observed routed-rows share exceeds
    #: this multiple of the fair (mean) share
    imbalance_bound: float = 1.5
    #: sample-budget multiplier applied on each refresh
    refresh_boost: int = 4
    #: refreshes per sort segment (each forces one host re-route pass)
    max_refreshes: int = 2
    # -- morsel-size autotuning (overflow="degrade") ---------------------- #
    autotune: bool = True
    #: safety margin under the capacity implied by the observed overflow
    autotune_margin: float = 0.9

    def token(self):
        """Stable value tuple (used in adapt-event reporting only — the
        stage cache keys on fired *decisions*, never on the config)."""
        return tuple(getattr(self, f.name)
                     for f in dataclasses.fields(self))


#: the everything-off config ``adaptive=False`` resolves to
DISABLED = AdaptiveConfig(enabled=False, salting=False,
                          splitter_refresh=False, autotune=False)


def resolve_adaptive(adaptive: Any) -> AdaptiveConfig:
    """Normalize the ``adaptive=`` argument to an ``AdaptiveConfig``."""
    if adaptive is None or adaptive is True:
        return AdaptiveConfig()
    if adaptive is False:
        return DISABLED
    if isinstance(adaptive, AdaptiveConfig):
        return adaptive
    if isinstance(adaptive, dict):
        unknown = set(adaptive) - {f.name
                                   for f in dataclasses.fields(AdaptiveConfig)}
        if unknown:
            raise TypeError(f"unknown adaptive= keys: {sorted(unknown)}")
        return AdaptiveConfig(**adaptive)
    raise TypeError(f"adaptive= must be None/bool/dict/AdaptiveConfig, "
                    f"got {type(adaptive).__name__}")
