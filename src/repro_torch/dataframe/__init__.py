"""Distributed dataframe engine (the paper's HP-DDF), batched over stacked
ranks in PyTorch."""

from .table import Table, concat_tables
from .ops_local import (
    add_scalar,
    drop_null_keys,
    filter_expr,
    filter_rows,
    groupby_local,
    hash_columns,
    hash_columns_np,
    join_local,
    join_overflow,
    map_columns,
    recode,
    sort_local,
    with_columns,
)
from .schema import (decode_codes, encode_strings, merge_dictionaries,
                     recode_mapping)
from .shuffle import (ShuffleStats, default_bucket_capacity,
                      replicate_hot_rows, shuffle)
from .groupby import (combine_groupby_partials, finalize_groupby, groupby,
                      groupby_partial, groupby_salted, salted_dest)
from .join import join
from .sort import repartition_balanced, sort

__all__ = [
    "Table", "concat_tables",
    "add_scalar", "drop_null_keys", "filter_expr", "filter_rows",
    "groupby_local", "hash_columns", "hash_columns_np", "join_local",
    "join_overflow", "map_columns", "recode", "sort_local", "with_columns",
    "decode_codes", "encode_strings", "merge_dictionaries",
    "recode_mapping",
    "ShuffleStats", "default_bucket_capacity", "replicate_hot_rows",
    "shuffle", "combine_groupby_partials", "finalize_groupby", "groupby",
    "groupby_partial", "groupby_salted", "join", "repartition_balanced",
    "salted_dest", "sort",
]
