"""CylonExecutor: actor-gang resource partitioning (paper §IV-A).

The torch counterpart of ``repro.core.actor``, with the paper's API:

  * ``start_executable``  — install a stateful executable on the gang,
  * ``execute_cylon``     — run a method of the installed executable,
  * ``run_cylon``         — run a free function against the env.

An executor reserves ``parallelism`` rank slots from a ``DevicePool``
(the analogue of Ray placement groups / Dask worker selection) and owns a
``CylonEnv`` of that many stacked ranks whose communicator and stage cache
persist across submissions — the stateful pseudo-BSP environment.
Independent executors on disjoint partitions give the paper's
application-level parallelism.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .env import CylonEnv, DevicePool


class CylonExecutor:
    """``pool=None`` makes a pool of ``parallelism`` slots on ``device``
    (``None`` means the card, and raises without one)."""

    def __init__(self, parallelism: int, pool: Optional[DevicePool] = None,
                 communicator: str = "xla", device: Any = None):
        pool = pool or DevicePool(slots=parallelism, device=device)
        self.lease = pool.reserve(parallelism)   # a core.env.Lease
        self.devices = self.lease               # sequence view of the gang
        self.env = CylonEnv(devices=self.devices, communicator=communicator)
        self._executable = None

    @property
    def parallelism(self) -> int:
        return self.env.parallelism

    def release(self) -> None:
        """Return the gang's slots to the pool (idempotent)."""
        self.lease.release()

    # -- the paper's three endpoints ------------------------------------ #
    def start_executable(self, executable_cls: Callable, *args, **kwargs):
        """Instantiate a stateful executable inside the gang."""
        self._executable = executable_cls(*args, **kwargs)
        return self._executable

    def execute_cylon(self, method_name: str, *dist_args, **kw):
        if self._executable is None:
            raise RuntimeError("no executable installed; call start_executable")
        method = getattr(self._executable, method_name)
        return self.env.run(method, *dist_args, **kw)

    def run_cylon(self, fn: Callable, *dist_args, **kw):
        """Run ``fn(ctx, *tables)`` on the gang (ctx carries the communicator)."""
        return self.env.run(fn, *dist_args, **kw)
