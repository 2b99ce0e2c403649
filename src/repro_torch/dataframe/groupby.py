"""Distributed groupby: optional local pre-aggregation + shuffle + final agg.

The torch counterpart of ``repro.dataframe.groupby``, with the out-of-core
partial/combine pair and the hot-key salted groupby (``repro_torch.adapt``).

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
from .ops_local import drop_null_keys, groupby_local, hash_columns
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
# Hot-key salting (repro_torch.adapt): spread a hot key over k ranks,
# re-merge
# ---------------------------------------------------------------------- #
def hot_mask(h: torch.Tensor, hot_hashes: Sequence[int]) -> torch.Tensor:
    """Rows whose key hash (``hash_columns``' uint32 values) is one of the
    hot constants."""
    hot = torch.zeros(h.shape, dtype=torch.bool, device=h.device)
    for v in hot_hashes:
        hot = hot | (h == int(v))
    return hot


def salted_dest(table: Table, comm: Communicator, keys: Sequence[str],
                hot_hashes: Sequence[int], k: int):
    """Per-row destinations with hot keys spread over ``k`` ranks.

    Cold rows route to their hash home ``h % p`` exactly as an unsalted
    shuffle would; rows whose key hash is in ``hot_hashes`` (constants
    the decision layer fixed for this stage) rotate over the ``k`` ranks
    following the home — the per-row ``arange % k`` salt is what spreads
    rows that all share one ``h``.  Returns ``(dest, is_hot)``, each
    ``(p, cap)``.
    """
    p = comm.size()
    h = hash_columns(table, list(keys))
    base = (h % p).to(torch.int32)
    hot = hot_mask(h, hot_hashes)
    salt = (torch.arange(table.capacity, dtype=torch.int32,
                         device=table.device) % max(k, 1))[None, :]
    return torch.where(hot, (base + salt) % p, base), hot


def groupby_salted(
    table: Table,
    comm: Communicator,
    keys: Sequence[str],
    aggs: Mapping[str, Sequence[str]],
    hot_hashes: Sequence[int],
    k: int,
    shuffle_kw: Optional[Mapping] = None,
    remerge_kw: Optional[Mapping] = None,
) -> Tuple[Table, ShuffleStats, ShuffleStats]:
    """Skew-mitigated distributed groupby.

    Stage 1 shuffles rows by salted destination (a hot key's rows land on
    ``k`` ranks instead of one) and aggregates locally into mergeable
    partials; a second shuffle — tiny, one partial row per (rank, key) —
    re-merges each key's partials on its unsalted home rank, where stage 2
    combines them.  Exactly the pre-aggregation decomposition, so it is
    exact for every agg ``_DECOMP`` supports.  Returns
    ``(result, stage1 stats, re-merge stats)``.
    """
    physical, post = _normalize(aggs)
    nullable = nullable_agg_cols(table, physical)
    table = drop_null_keys(table, keys)
    dest, _ = salted_dest(table, comm, keys, hot_hashes, k)
    shuffled, st1 = shuffle(table, comm, dest=dest, **dict(shuffle_kw or {}))
    partial = groupby_local(shuffled, keys, physical)
    stage2, rename = _stage2_spec(physical)
    merged, st2 = shuffle(partial, comm, key_cols=list(keys),
                          **dict(remerge_kw or {}))
    final = groupby_local(merged, keys, stage2).rename(rename)
    return finalize_groupby(final, keys, post, nullable), st1, st2


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
    salt: Optional[Tuple[Sequence[int], int]] = None,
    **shuffle_kw,
) -> Tuple[Table, Optional[ShuffleStats]]:
    """One morsel's contribution to a distributed groupby.

    Rows are placed on their final rank (``hash(keys) % p``) and aggregated
    into *mergeable* partial columns ``{col}_{agg}`` (mean stays sum+count;
    no finalization).  Because the hash placement is row-wise, partials for
    the same key land on the same rank in **every** morsel, so the
    cross-morsel combine (``combine_groupby_partials``) is rank-local — no
    further communication.

    ``salt=(hot_hashes, k)`` spreads hot keys over ``k`` ranks instead
    (``salted_dest``); the co-residency guarantee then holds only after
    the morsel executor host-re-routes the partial spill by ``hash % p``
    ahead of the combine.
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
    if salt is not None:
        hot_hashes, k = salt
        dest, _ = salted_dest(table, comm, keys, hot_hashes, k)
        shuffled, stats = shuffle(table, comm, dest=dest, **shuffle_kw)
    else:
        shuffled, stats = shuffle(table, comm, key_cols=list(keys),
                                  **shuffle_kw)
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
