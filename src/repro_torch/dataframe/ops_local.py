"""Local (per-partition) DDF sub-operators, batched over stacked ranks.

The torch counterpart of ``repro.dataframe.ops_local``: the same
sort-based, static-shape algorithms, each written over ``(p, capacity)``
columns so one launch covers every rank.  JAX idioms map as follows:

* uint32 arithmetic runs in int64 masked with ``0xFFFFFFFF`` (torch has no
  ``>>`` or ``%`` for uint32 on the CPU);
* ``jnp.lexsort`` becomes a chain of stable sorts, least significant key
  first;
* ``.at[i].set(v, mode="drop")`` becomes a scatter into one extra trash
  slot that is sliced off (``table.scatter_rows``).

No function here reads a tensor back to the host: capacities are Python
ints and row counts stay on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dtypes import order_view, signed_view
from ..expr import as_tensor
from ..kernels.segmented_reduce import segmented_sum
from ..nulls import mask_name
from .table import Table, _sentinel_for, gather_rows, stable_partition_order

# ---------------------------------------------------------------------- #
# Hashing (murmur3-style finalizer) — used for shuffle partitioning
# ---------------------------------------------------------------------- #
_U32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for ``h`` in [0, 2**32), without int64
    overflow: split ``c`` into 16-bit halves."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _u32_bits(v: torch.Tensor) -> torch.Tensor:
    """The uint32 bit pattern of a key column, as int64 in [0, 2**32)."""
    if v.dtype.is_floating_point:
        v = v.to(torch.float32).view(torch.int32)
    return v.to(torch.int64) & _U32


def hash_columns(table: Table, key_cols: Sequence[str]) -> torch.Tensor:
    """Combined 32-bit hash of the key columns (row-wise), as (p, cap)
    int64 holding the uint32 value; bit-identical to
    ``repro.dataframe.ops_local.hash_columns``."""
    h = torch.full((table.parallelism, table.capacity), _GOLDEN,
                   dtype=torch.int64, device=table.device)
    for name in key_cols:
        bits = _u32_bits(table.columns[name])
        # same precedence as the jnp expression: ^ binds looser than +
        h = _mix32(h ^ ((_mix32(bits) + _GOLDEN + ((h << 6) & _U32)
                         + (h >> 2)) & _U32))
    return h


def _mix32_np(h: np.ndarray) -> np.ndarray:
    h = h.astype(np.uint32)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h


def hash_columns_np(columns, key_cols: Sequence[str]) -> np.ndarray:
    """Host-side numpy mirror of ``hash_columns`` (bit-identical)."""
    n = len(next(iter(columns.values())))
    h = np.full((n,), _GOLDEN, np.uint32)
    for name in key_cols:
        v = np.asarray(columns[name])
        if np.issubdtype(v.dtype, np.floating):
            bits = v.astype(np.float32).view(np.uint32)
        else:
            bits = v.astype(np.uint32)
        h = _mix32_np(h ^ (_mix32_np(bits) + np.uint32(_GOLDEN)
                           + (h << np.uint32(6)) + (h >> np.uint32(2))))
    return h


# ---------------------------------------------------------------------- #
# Sort keys with invalid rows pushed to the end
# ---------------------------------------------------------------------- #
def _order_keys(table: Table, by: Sequence[str]) -> Tuple[torch.Tensor, ...]:
    """Sort keys from least to most significant, padding forced last.

    Nullable sort columns contribute a null flag *more significant* than
    their value key, so nulls sort last within each column (pandas
    ``na_position="last"``).  The final key is the validity flag."""
    valid = table.valid_mask()
    keys = []
    for name in reversed(by):
        v = order_view(table.columns[name])
        keys.append(torch.where(valid, v, _sentinel_for(v.dtype)))
        m = table.columns.get(mask_name(name))
        if m is not None:
            keys.append((valid & ~m).to(torch.int32))
    return tuple(keys) + ((~valid).to(torch.int32),)


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-rank ``jnp.lexsort`` (last key most significant) as chained
    stable sorts; (p, n) keys -> (p, n) int64 permutation."""
    perm = None
    for k in keys:
        kk = k if perm is None else torch.gather(k, 1, perm)
        o = torch.sort(kk, dim=1, stable=True).indices
        perm = o if perm is None else torch.gather(perm, 1, o)
    return perm


def sort_local(table: Table, by: Sequence[str]) -> Table:
    """Stable multi-key sort of the valid prefix (padding stays at the end)."""
    return table.take(lexsort(_order_keys(table, by)), table.row_count)


def _compact(table: Table, keep: torch.Tensor) -> Table:
    """Stable compaction of the rows where ``keep`` holds."""
    keep = keep & table.valid_mask()
    return table.take(stable_partition_order(keep),
                      keep.sum(dim=1, dtype=torch.int32))


def drop_null_keys(table: Table, keys: Sequence[str]) -> Table:
    """Drop rows whose value in any of ``keys`` is null, and retire the
    now-all-True key masks (pandas ``merge`` / ``groupby`` semantics).
    No-op when no key carries a mask."""
    masks = [table.columns[m]
             for m in (mask_name(k) for k in keys) if m in table.columns]
    if not masks:
        return table
    keep = masks[0]
    for m in masks[1:]:
        keep = keep & m
    t = _compact(table, keep)
    dead = {mask_name(k) for k in keys}
    return Table({n: v for n, v in t.columns.items() if n not in dead},
                 t.row_count).mask_padding()


# ---------------------------------------------------------------------- #
# Filter / projection / elementwise
# ---------------------------------------------------------------------- #
def filter_rows(table: Table,
                pred: Callable[[Table], torch.Tensor]) -> Table:
    """Keep rows where ``pred(table)`` ((p, capacity) bool) holds; a
    stable compaction, as the reference's argsort of ``where(keep, 0,
    1)``."""
    return _compact(table, pred(table))


def filter_expr(table: Table, expr) -> Table:
    """Keep rows where the boolean ``repro_torch.expr`` expression holds
    (a null predicate keeps nothing, SQL ``WHERE``)."""
    keep, pvalid = expr.evaluate_masked(table)
    keep = as_tensor(keep, table.device)
    if keep.dtype != torch.bool:
        raise TypeError(
            f"filter expression must be boolean, got {keep.dtype}: {expr!r}")
    shape = (table.parallelism, table.capacity)
    keep = keep.expand(shape)
    if pvalid is not None:
        keep = keep & as_tensor(pvalid, table.device).expand(shape)
    return _compact(table, keep)


def with_columns(table: Table, exprs: Mapping[str, "object"]) -> Table:
    """Add/replace columns from ``{name: Expr}``; every expression reads
    the *input* table (simultaneous assignment).  Scalar results broadcast
    to full columns; a nullable result materializes its ``__m_`` mask."""
    shape = (table.parallelism, table.capacity)
    out = dict(table.columns)
    for name, e in exprs.items():
        v, valid = e.evaluate_masked(table)
        out[name] = as_tensor(v, table.device).expand(shape).contiguous()
        if valid is not None:
            out[mask_name(name)] = as_tensor(valid, table.device).expand(
                shape).contiguous()
        else:
            out.pop(mask_name(name), None)
    return Table(out, table.row_count)


def recode(table: Table, mappings: Mapping[str, "object"]) -> Table:
    """Remap dictionary codes: ``new = mapping[old]`` per recoded column.

    ``mappings`` maps column name -> int32 gather table
    (``dataframe.schema.recode_mapping``; a numpy array or a tensor, which
    the planner moves to the device once per built stage).  Codes are
    clipped into the table, as ``jnp.take(mode="clip")``: padding rows
    gather garbage, like every other operator here."""
    out = dict(table.columns)
    for name, mapping in mappings.items():
        m = torch.as_tensor(mapping, dtype=torch.int32, device=table.device)
        codes = table.columns[name].to(torch.int64).clamp(0, m.shape[0] - 1)
        out[name] = m[codes]
    return Table(out, table.row_count)


def add_scalar(table: Table, value, cols: Optional[Sequence[str]] = None
               ) -> Table:
    """The paper's pipeline terminal op: add a scalar to value columns."""
    names = cols or table.column_names
    out = dict(table.columns)
    for n in names:
        v = table.columns[n]
        out[n] = v + torch.as_tensor(value, dtype=v.dtype, device=v.device)
    return Table(out, table.row_count)


def map_columns(table: Table, fn: Callable[[torch.Tensor], torch.Tensor],
                cols: Sequence[str]) -> Table:
    """Replace each of ``cols`` by ``fn`` of it."""
    out = dict(table.columns)
    for n in cols:
        out[n] = fn(table.columns[n])
    return Table(out, table.row_count)


# ---------------------------------------------------------------------- #
# Local groupby: sort + segment reduce
# ---------------------------------------------------------------------- #
def _max_identity(dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("-inf")
    return torch.iinfo(dtype).min


def _segment_reduce(vals: torch.Tensor, seg: torch.Tensor, how: str,
                    identity) -> torch.Tensor:
    """Per-rank ``jax.ops.segment_{min,max}`` (``how`` = ``amin`` /
    ``amax``) over ``capacity`` segments; empty segments hold
    ``identity``.  Sums go to ``kernels.segmented_sum`` instead."""
    out = torch.full_like(vals, identity)
    return out.scatter_reduce_(1, seg, vals, reduce=how, include_self=True)


def groupby_local(table: Table, keys: Sequence[str],
                  aggs: Mapping[str, Sequence[str]]) -> Table:
    """Group by ``keys``; ``aggs`` maps value column -> list of agg names.

    Output columns: keys plus ``f"{col}_{agg}"``.  Null semantics (pandas):
    rows with a null key are dropped; sum/count/min/max skip null values
    (``count`` counts non-null, ``size`` counts rows); min/max over an
    all-null group are null, so those outputs carry a ``__m_`` mask when
    their input does.

    Sum, count and size reduce with ``kernels.segmented_sum`` (the CUDA
    kernel on the card, its plain version on the CPU) over int32 segment
    ids that are sorted within each rank (valid rows' ids count up from 0,
    padding rows take ``cap - 1``, at or above every valid id), so they
    pass ``sorted_ids=True`` and take the kernel's sorted route; min and
    max stay
    ``scatter_reduce_``, as JAX's ``segment_min/max`` are no Pallas kernel.
    """
    table = drop_null_keys(table, keys)
    sorted_t = sort_local(table, keys)
    valid = sorted_t.valid_mask()
    cap = table.capacity
    # segment ids: new segment where any key changes (within valid prefix)
    change = torch.zeros_like(valid)
    for name in keys:
        v = order_view(sorted_t.columns[name])
        change[:, 0] = True
        change[:, 1:] |= v[:, 1:] != v[:, :-1]
    change &= valid
    seg32 = torch.cumsum(change, dim=1, dtype=torch.int32) - 1
    seg32 = torch.where(valid, seg32, cap - 1)
    seg = seg32.to(torch.int64)          # the index type of scatter_
    num_groups = change.sum(dim=1, dtype=torch.int32)

    out_cols: Dict[str, torch.Tensor] = {}
    for name in keys:
        v = signed_view(sorted_t.columns[name])
        # first row of each segment carries the key (padding writes 0 to
        # slot cap-1, which is padding itself unless the table is full)
        out_cols[name] = torch.zeros_like(v).scatter_(
            1, seg, torch.where(valid, v, torch.zeros_like(v))).view(
                sorted_t.columns[name].dtype)
    for col, agg_names in aggs.items():
        v = sorted_t.columns[col]
        cmask = sorted_t.columns.get(mask_name(col))
        eff = valid if cmask is None else (valid & cmask)
        for agg in agg_names:
            out_mask = None
            if agg == "sum":
                # zeroed as bits: CUDA has no torch.where for uint16/32
                sv = signed_view(v)
                r = segmented_sum(
                    seg32, torch.where(eff, sv, torch.zeros_like(sv)).view(
                        v.dtype), cap, sorted_ids=True)
            elif agg == "count":
                r = segmented_sum(seg32, eff.to(torch.int32), cap,
                                  sorted_ids=True)
            elif agg == "size":
                r = segmented_sum(seg32, valid.to(torch.int32), cap,
                                  sorted_ids=True)
            elif agg in ("min", "max"):
                # unsigned values reduce widened (identities of their own
                # dtype, so empty segments match jax.ops.segment_min/max)
                ident = (_sentinel_for(v.dtype) if agg == "min"
                         else _max_identity(v.dtype))
                r = _segment_reduce(torch.where(eff, order_view(v), ident),
                                    seg, "amin" if agg == "min" else "amax",
                                    ident).to(v.dtype)
                if cmask is not None:
                    out_mask = _segment_reduce(
                        eff.to(torch.int32), seg, "amax",
                        torch.iinfo(torch.int32).min) > 0
            else:
                raise ValueError(f"unsupported agg {agg!r}")
            if out_mask is not None:
                # canonical zero where the whole group was null
                r = torch.where(out_mask, r, torch.zeros_like(r))
                out_cols[mask_name(f"{col}_{agg}")] = out_mask
            out_cols[f"{col}_{agg}"] = r
    return Table(out_cols, num_groups).mask_padding()


# ---------------------------------------------------------------------- #
# Local join: sort-merge with bounded output capacity
# ---------------------------------------------------------------------- #
def _merge_ranges(ls: Table, rs: Table, on: str):
    """Per left row: [lo, hi) of its matches in the sorted right side, and
    the match count (0 for padding rows)."""
    lvalid = ls.valid_mask()
    lk, rk = order_view(ls.columns[on]), order_view(rs.columns[on])
    lkey = torch.where(lvalid, lk, _sentinel_for(lk.dtype)).contiguous()
    rkey = torch.where(rs.valid_mask(), rk,
                       _sentinel_for(rk.dtype)).contiguous()
    lo = torch.searchsorted(rkey, lkey, side="left")
    hi = torch.searchsorted(rkey, lkey, side="right")
    hi = torch.minimum(hi, rs.row_count[:, None].to(hi.dtype))
    counts = torch.where(lvalid, torch.clamp(hi - lo, min=0),
                         torch.zeros_like(lo))
    return lo, counts


def join_local(left: Table, right: Table, on: str,
               out_capacity: Optional[int] = None,
               suffix: str = "_r", with_overflow: bool = False):
    """Inner equi-join via sort + searchsorted (vectorized merge).

    Output capacity is static: ``out_capacity`` (default: left.capacity).
    Output slot ``o`` is owned by the first left row whose cumulative match
    count exceeds ``o``.  ``with_overflow=True`` also returns the (p,)
    number of result rows the capacity dropped.  Null keys never match.
    """
    out_cap = out_capacity or left.capacity
    left = drop_null_keys(left, [on])
    right = drop_null_keys(right, [on])
    ls = sort_local(left, [on])
    rs = sort_local(right, [on])
    lo, counts = _merge_ranges(ls, rs, on)
    cum = torch.cumsum(counts, dim=1)
    p = ls.parallelism
    total = (cum[:, -1] if cum.shape[1]
             else torch.zeros((p,), dtype=torch.int64, device=ls.device))

    out_idx = torch.arange(out_cap, dtype=torch.int64,
                           device=ls.device).expand(p, out_cap).contiguous()
    # left row owning output slot o: first l with cum[l] > o
    l_row = torch.searchsorted(cum, out_idx, side="right")
    l_row_c = torch.clamp(l_row, max=left.capacity - 1)
    start = torch.where(l_row_c > 0,
                        torch.gather(cum, 1, torch.clamp(l_row_c - 1, min=0)),
                        torch.zeros_like(l_row_c))
    r_row = torch.clamp(torch.gather(lo, 1, l_row_c) + out_idx - start,
                        max=right.capacity - 1)

    cols: Dict[str, torch.Tensor] = {}
    for name in ls.column_names:
        cols[name] = gather_rows(ls.columns[name], l_row_c)
    for name in rs.column_names:
        if name == on or name.startswith(mask_name("")):
            continue
        tgt = name if name not in cols else name + suffix
        cols[tgt] = gather_rows(rs.columns[name], r_row)
        rmask = rs.columns.get(mask_name(name))
        if rmask is not None:
            cols[mask_name(tgt)] = gather_rows(rmask, r_row)
    out = Table(cols, torch.clamp(total, max=out_cap).to(torch.int32))
    out = out.mask_padding()
    if with_overflow:
        return out, torch.clamp(total - out_cap, min=0).to(torch.int32)
    return out


def join_overflow(left: Table, right: Table, on: str,
                  out_capacity: int) -> torch.Tensor:
    """(p,) number of join result rows dropped by the output capacity."""
    ls = sort_local(drop_null_keys(left, [on]), [on])
    rs = sort_local(drop_null_keys(right, [on]), [on])
    _, counts = _merge_ranges(ls, rs, on)
    return torch.clamp(counts.sum(dim=1) - out_capacity, min=0)
