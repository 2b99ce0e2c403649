"""Pseudo-BSP DDF execution (the paper's primary contribution) in PyTorch:
``CylonEnv`` (stateful BSP environment over stacked ranks), ``DistTable``
and ``Plan`` / ``execute`` (logical plan + coalescing, with the AMT
baseline mode)."""

from .env import CylonEnv, DistTable, EnvContext, resolve_device
from .plan import Plan, execute

__all__ = ["CylonEnv", "DistTable", "EnvContext", "Plan", "execute",
           "resolve_device"]
