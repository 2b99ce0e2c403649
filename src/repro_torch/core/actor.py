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

Over a process group (``pool=DevicePool(process_group=...)``) the gang is
``parallelism`` processes: every process constructs the executor, in the
same order as every other, so every process's copy of the pool hands out
the same lease (the lowest-indexed free ranks) with no coordinator.  A
member (``is_member``) owns a ``CylonEnv`` of its rank of the gang's
sub-group; on any other process the endpoints run nothing and return
``None``.  ``release`` is called on every process, in the same order as
the constructors, so the copies of the free list stay alike.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from .env import CylonEnv, DevicePool, DistTable


class CylonExecutor:
    """``pool=None`` makes a pool of ``parallelism`` slots on ``device``
    (``None`` means the card, and raises without one)."""

    def __init__(self, parallelism: int, pool: Optional[DevicePool] = None,
                 communicator: str = "xla", device: Any = None):
        pool = pool or DevicePool(slots=parallelism, device=device)
        self.lease = pool.reserve(parallelism)   # a core.env.Lease
        self.devices = self.lease               # sequence view of the gang
        #: whether this process runs the gang's work (always, unless the
        #: pool is over a process group and this process is not leased)
        self.is_member = self.lease.is_member
        self.env: Optional[CylonEnv] = (
            CylonEnv(devices=self.devices, communicator=communicator)
            if self.is_member else None)
        self._executable = None

    @property
    def parallelism(self) -> int:
        return len(self.lease)

    def release(self) -> None:
        """Return the gang's slots to the pool (idempotent)."""
        self.lease.release()

    # -- the paper's three endpoints ------------------------------------ #
    def start_executable(self, executable_cls: Callable, *args, **kwargs):
        """Instantiate a stateful executable inside the gang (on its
        members)."""
        if not self.is_member:
            return None
        self._executable = executable_cls(*args, **kwargs)
        return self._executable

    def execute_cylon(self, method_name: str, *dist_args, **kw):
        if not self.is_member:
            return None
        if self._executable is None:
            raise RuntimeError("no executable installed; call start_executable")
        method = getattr(self._executable, method_name)
        return self.env.run(method, *self._held(dist_args), **kw)

    def run_cylon(self, fn: Callable, *dist_args, **kw):
        """Run ``fn(ctx, *tables)`` on the gang (ctx carries the
        communicator); ``None`` on a process outside it.  A whole table
        given to every process keeps the member's rank
        (``DistTable.select``)."""
        if not self.is_member:
            return None
        return self.env.run(fn, *self._held(dist_args), **kw)

    def _held(self, args):
        return [a.select(self.env.comm) if isinstance(a, DistTable) else a
                for a in args]
