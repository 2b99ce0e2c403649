"""Shared helpers of the port's kernels (a copy of ``repro.kernels.common``'s
``round_up``; the port imports nothing of the JAX package) and the launch
counter every CUDA wrapper carries."""

from __future__ import annotations

import sys
import threading
from typing import Dict, Optional, Sequence


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def refuse_dtensor(name: str, *tensors) -> None:
    """A kernel computes on local tensors: raise ``TypeError`` when a
    DTensor reaches its dispatcher (a sharded call site runs the kernel
    under ``local_map``)."""
    mod = sys.modules.get("torch.distributed.tensor")
    if mod is None:                      # no DTensor can exist yet
        return
    if any(isinstance(t, mod.DTensor) for t in tensors):
        raise TypeError(f"{name} takes local tensors, got a DTensor: call it "
                        f"under torch.distributed.tensor.experimental."
                        f"local_map")


class LaunchCounter:
    """``launches`` (and ``route_launches`` when the wrapper has routes),
    counted under a lock: the query scheduler's workers launch the same
    kernel from several threads at once."""

    def __init__(self, routes: Sequence[str] = ()):
        self._count_lock = threading.Lock()
        self.launches = 0
        self.route_launches: Dict[str, int] = {r: 0 for r in routes}

    def _count(self, route: Optional[str] = None) -> None:
        with self._count_lock:
            self.launches += 1
            if route is not None:
                self.route_launches[route] += 1

    def reset(self) -> None:
        """Set ``launches`` to 0 (``route_launches`` keep running, as the
        callers read them as differences)."""
        with self._count_lock:
            self.launches = 0
