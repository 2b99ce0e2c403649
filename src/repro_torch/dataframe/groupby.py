"""Distributed groupby: optional local pre-aggregation + shuffle + final agg.

The torch counterpart of ``repro.dataframe.groupby``, with the out-of-core
partial/combine pair (the salted functions come with a later slice of the
port).

The paper's groupby is shuffle-then-aggregate (map-reduce style).  We add a
*partial-aggregation pushdown* (classic distributed-DB optimization, and the
direction the paper's "coalescing" points at): aggregate locally first so the
shuffle moves one row per (rank, group) instead of one row per input row.
With 90%-cardinality data (the paper's worst case) pushdown barely helps; at
low cardinality it slashes the collective term.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from ..comm import Communicator
from ..nulls import mask_name
from .ops_local import drop_null_keys, groupby_local
from .shuffle import ShuffleStats, shuffle
from .table import Table

# agg -> (stage1 agg on raw col, stage2 agg on partial col, combiner name)
# ``count`` counts non-null values (pandas count); ``size`` counts rows.
_DECOMP = {
    "sum": ("sum", "sum"),
    "count": ("count", "sum"),
    "size": ("size", "sum"),
    "min": ("min", "min"),
    "max": ("max", "max"),
}


def _normalize(aggs: Mapping[str, Sequence[str]]):
    """Expand mean into sum+count; return (physical aggs, post-processing)."""
    physical: Dict[str, List[str]] = {}
    post: List[Tuple[str, str, str]] = []  # (out_name, kind, col)
    for col, names in aggs.items():
        for a in names:
            if a == "mean":
                physical.setdefault(col, [])
                for b in ("sum", "count"):
                    if b not in physical[col]:
                        physical[col].append(b)
                post.append((f"{col}_mean", "mean", col))
            elif a in _DECOMP:
                physical.setdefault(col, [])
                if a not in physical[col]:
                    physical[col].append(a)
                post.append((f"{col}_{a}", "copy", f"{col}_{a}"))
            else:
                raise ValueError(f"unsupported agg {a!r}")
    return physical, post


def nullable_agg_cols(table: Table,
                      physical: Mapping[str, Sequence[str]]) -> Tuple[str, ...]:
    """Aggregated columns that carry a validity mask in the *input* table.

    Finalization needs this (a group whose values are all null has
    ``count == 0`` and a null mean/min/max), and the partial tables alone
    cannot reveal it — sum/count partials carry no mask.
    """
    return tuple(sorted(c for c in physical
                        if mask_name(c) in table.columns))


def finalize_groupby(final: Table, keys: Sequence[str],
                     post: Sequence[Tuple[str, str, str]],
                     nullable_cols: Sequence[str] = ()) -> Table:
    """Post-processing (mean reconstruction) + column selection in user
    order.  ``nullable_cols`` names the aggregated input columns that were
    nullable: their mean outputs get a ``count > 0`` validity mask, and
    their min/max masks (computed by ``groupby_local``) are carried over."""
    nullable = set(nullable_cols)
    out_cols = {k: final.columns[k] for k in keys}
    for out_name, kind, src in post:
        if kind == "copy":
            out_cols[out_name] = final.columns[src]
            m = final.columns.get(mask_name(src))
            if m is not None:
                out_cols[mask_name(out_name)] = m
        else:  # mean
            s = final.columns[f"{src}_sum"]
            c = final.columns[f"{src}_count"]
            out_cols[out_name] = torch.where(
                c > 0, s / torch.clamp(c, min=1).to(s.dtype),
                torch.zeros((), dtype=s.dtype, device=s.device))
            if src in nullable:
                out_cols[mask_name(out_name)] = c > 0
    return Table(out_cols, final.row_count)


def _stage2_spec(physical: Mapping[str, Sequence[str]]):
    """Stage-2 agg spec over partial columns + the rename back to partial
    names (so stage-2 output composes with further stage-2 passes).

    The rename also maps each partial's validity mask (present only for
    min/max of nullable columns); ``Table.rename`` ignores absent keys."""
    stage2: Dict[str, List[str]] = {}
    rename: Dict[str, str] = {}
    for col, names in physical.items():
        for a in names:
            s2 = _DECOMP[a][1]
            stage2[f"{col}_{a}"] = [s2]
            rename[f"{col}_{a}_{s2}"] = f"{col}_{a}"
            rename[mask_name(f"{col}_{a}_{s2}")] = mask_name(f"{col}_{a}")
    return stage2, rename


def groupby(
    table: Table,
    comm: Communicator,
    keys: Sequence[str],
    aggs: Mapping[str, Sequence[str]],
    pre_aggregate: bool = True,
    **shuffle_kw,
) -> Tuple[Table, ShuffleStats]:
    """Distributed groupby over all ranks."""
    physical, post = _normalize(aggs)
    nullable = nullable_agg_cols(table, physical)
    table = drop_null_keys(table, keys)  # before the shuffle: less wire

    if pre_aggregate:
        partial = groupby_local(table, keys, physical)
        # stage 2 operates on the partial columns
        stage2, rename = _stage2_spec(physical)
        shuffled, stats = shuffle(partial, comm, key_cols=list(keys), **shuffle_kw)
        final = groupby_local(shuffled, keys, stage2).rename(rename)
    else:
        shuffled, stats = shuffle(table, comm, key_cols=list(keys), **shuffle_kw)
        final = groupby_local(shuffled, keys, physical)

    return finalize_groupby(final, keys, post, nullable), stats


# ---------------------------------------------------------------------- #
# Out-of-core: per-morsel partials + rank-local cross-morsel combine
# ---------------------------------------------------------------------- #
def groupby_partial(
    table: Table,
    comm: Communicator,
    keys: Sequence[str],
    physical: Mapping[str, Sequence[str]],
    pre_aggregate: bool = False,
    elide_shuffle: bool = False,
    **shuffle_kw,
) -> Tuple[Table, Optional[ShuffleStats]]:
    """One morsel's contribution to a distributed groupby.

    Rows are placed on their final rank (``hash(keys) % p``) and aggregated
    into *mergeable* partial columns ``{col}_{agg}`` (mean stays sum+count;
    no finalization).  Because the hash placement is row-wise, partials for
    the same key land on the same rank in **every** morsel, so the
    cross-morsel combine (``combine_groupby_partials``) is rank-local — no
    further communication.
    """
    stage2, rename = _stage2_spec(physical)
    table = drop_null_keys(table, keys)
    if elide_shuffle:
        # input already co-partitioned on the keys: local partial only
        return groupby_local(table, keys, physical), None
    if pre_aggregate:
        partial = groupby_local(table, keys, physical)
        shuffled, stats = shuffle(partial, comm, key_cols=list(keys),
                                  **shuffle_kw)
        return groupby_local(shuffled, keys, stage2).rename(rename), stats
    shuffled, stats = shuffle(table, comm, key_cols=list(keys), **shuffle_kw)
    return groupby_local(shuffled, keys, physical), stats


def combine_groupby_partials(
    partials: Table,
    keys: Sequence[str],
    physical: Mapping[str, Sequence[str]],
    post: Sequence[Tuple[str, str, str]],
    nullable_cols: Sequence[str] = (),
) -> Table:
    """Cross-morsel combiner: re-aggregate mergeable partials + finalize.

    Purely local (runs per rank): the morsel layer guarantees every key's
    partials are co-resident.  Partial aggs compose under their stage-2
    combiner (sum of sums, min of mins, sum of counts), so this is exact
    for any morsel split of the input.  ``nullable_cols`` (the *input*
    columns that carried masks — the caller knows, the partials don't)
    restores null mean/min/max for all-null groups at finalize.
    """
    stage2, rename = _stage2_spec(physical)
    final = groupby_local(partials, keys, stage2).rename(rename)
    return finalize_groupby(final, keys, post, nullable_cols)
