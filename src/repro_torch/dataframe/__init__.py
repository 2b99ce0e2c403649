"""Distributed dataframe engine (the paper's HP-DDF), batched over stacked
ranks in PyTorch."""

from .table import Table
from .ops_local import (
    add_scalar,
    drop_null_keys,
    filter_expr,
    groupby_local,
    hash_columns,
    hash_columns_np,
    join_local,
    join_overflow,
    sort_local,
    with_columns,
)
from .shuffle import ShuffleStats, default_bucket_capacity, shuffle
from .groupby import finalize_groupby, groupby
from .join import join
from .sort import sort

__all__ = [
    "Table",
    "add_scalar", "drop_null_keys", "filter_expr", "groupby_local",
    "hash_columns", "hash_columns_np", "join_local", "join_overflow",
    "sort_local", "with_columns",
    "ShuffleStats", "default_bucket_capacity", "shuffle",
    "finalize_groupby", "groupby", "join", "sort",
]
