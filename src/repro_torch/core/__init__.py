"""Pseudo-BSP DDF execution (the paper's primary contribution) in PyTorch:
``CylonEnv`` (stateful BSP environment over stacked ranks), ``DistTable``,
``CylonExecutor`` and ``DevicePool`` / ``Lease`` (actor-gang resource
partitioning over rank slots), ``Plan`` / ``execute`` (logical plan +
coalescing, with the AMT baseline mode), ``CylonStore`` (downstream
hand-off + repartition) and the out-of-core pieces (``SpillTable``,
``MorselSource``, ``rescatter``)."""

from .env import (CylonEnv, DevicePool, DistTable, EnvContext, Lease,
                  MorselSource, PoolExhausted, RankSlot, resolve_device)
from .actor import CylonExecutor
from .plan import Plan, execute
from .store import CylonStore, SpillTable, repartition, rescatter

__all__ = ["CylonEnv", "CylonExecutor", "CylonStore", "DevicePool",
           "DistTable", "EnvContext", "Lease", "MorselSource", "Plan",
           "PoolExhausted", "RankSlot", "SpillTable", "execute",
           "repartition", "rescatter", "resolve_device"]
