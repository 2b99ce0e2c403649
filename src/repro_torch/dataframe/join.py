"""Distributed equi-join: co-hash shuffle of both sides + local sort-merge.

The torch counterpart of ``repro.dataframe.join`` (the paper's Fig 2
decomposition): both sides hash-partition on the key, so co-partitioned
rows land on the same rank, then each rank sort-merges locally.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ..comm import Communicator
from .ops_local import join_local
from .shuffle import ShuffleStats, shuffle
from .table import Table


def join(
    left: Table,
    right: Table,
    comm: Communicator,
    on: str,
    out_capacity: Optional[int] = None,
    **shuffle_kw,
) -> Tuple[Table, ShuffleStats, ShuffleStats]:
    """Distributed inner join over all ranks."""
    l_sh, l_stats = shuffle(left, comm, key_cols=[on], **shuffle_kw)
    r_sh, r_stats = shuffle(right, comm, key_cols=[on], **shuffle_kw)
    out = join_local(l_sh, r_sh, on, out_capacity=out_capacity)
    return out, l_stats, r_stats
