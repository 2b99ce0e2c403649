"""Pseudo-BSP DDF execution (the paper's primary contribution) in PyTorch:
``CylonEnv`` (stateful BSP environment over stacked ranks), ``DistTable``,
``Plan`` / ``execute`` (logical plan + coalescing, with the AMT baseline
mode), ``CylonStore`` (downstream hand-off + repartition) and the
out-of-core pieces (``SpillTable``, ``MorselSource``, ``rescatter``)."""

from .env import CylonEnv, DistTable, EnvContext, MorselSource, resolve_device
from .plan import Plan, execute
from .store import CylonStore, SpillTable, repartition, rescatter

__all__ = ["CylonEnv", "CylonStore", "DistTable", "EnvContext",
           "MorselSource", "Plan", "SpillTable", "execute", "repartition",
           "rescatter", "resolve_device"]
