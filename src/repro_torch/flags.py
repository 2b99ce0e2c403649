"""Process-wide run flags: the active fault-injection plan.

The torch counterpart of the fault-injection half of ``repro.flags``.
Its scan-unroll half (``unrolled_scans``, ``scan_unroll_layers``,
``scan_unroll_inner``) has no counterpart: it unrolls ``lax.scan`` so
that XLA's cost analysis counts every loop iteration, and the port's
layer loop is eager, so its dry run (``launch/dryrun.py``) counts every
layer as it runs.  ``FLAGS.faults`` holds a fault plan
string (``site[@occ][xN]=kind;...``); when unset, the ``REPRO_FAULTS``
env var is consulted.  ``fault_injection(...)`` scopes a plan; the
executors resolve the active plan via ``repro_torch.faults.
resolve_faults``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional


@dataclasses.dataclass
class _Flags:
    faults: Optional[str] = None  # fault plan string; None -> $REPRO_FAULTS


FLAGS = _Flags()


def fault_spec() -> Optional[str]:
    """The active fault plan string: ``FLAGS.faults`` if set, else the
    ``REPRO_FAULTS`` env var ("" / "0" mean off)."""
    if FLAGS.faults is not None:
        return FLAGS.faults or None
    spec = os.environ.get("REPRO_FAULTS", "")
    return spec if spec not in ("", "0") else None


@contextlib.contextmanager
def fault_injection(spec: str):
    """Scope a fault plan string: every execution inside the block resolves
    it (unless an explicit ``faults=`` argument overrides)."""
    old = FLAGS.faults
    FLAGS.faults = spec
    try:
        yield
    finally:
        FLAGS.faults = old
