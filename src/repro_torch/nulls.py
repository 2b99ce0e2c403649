"""Validity-mask conventions: how missing values exist inside the engine.

A copy of ``repro.nulls`` (pure numpy), kept here so the torch port imports
nothing from the JAX package.

A nullable column ``c`` is physically a *pair* of columns: the data column
``c`` plus a boolean companion ``__m_c`` (True = valid).  Masks are ordinary
columns — they ride through ``take`` / shuffle / spill / rescatter with zero
extra plumbing — but they are **not** part of the logical schema: the
planner, EXPLAIN, and the frontend all see only ``c`` (annotated nullable),
and ``to_numpy`` / ``to_pandas`` re-materialize masks as NaN / None.

Two invariants make nulls cheap and bit-exact:

* **canonical zero** — a null slot holds the column's zero value (0 / 0.0 /
  code 0 / False).  Hashing, the packed shuffle, and bit-identity checks
  never see garbage; equal tables are equal byte-for-byte regardless of
  what the nulls "were" before ingest.
* **Kleene evaluation** (``repro_torch.expr``) — masked expressions canonicalize
  their outputs, so the invariant is maintained through arithmetic,
  comparisons, and boolean logic.

This module is dependency-free on purpose: ``repro_torch.expr`` and the
``repro_torch.dataframe`` layers both import it.  See ``docs/data_model.md``.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Set

import numpy as np

__all__ = ["MASK_PREFIX", "mask_name", "is_mask", "base_name",
           "data_columns", "nullable_columns", "extract_null_columns",
           "apply_null_columns", "check_reserved_names"]

#: reserved column-name prefix for validity masks (True = valid)
MASK_PREFIX = "__m_"


def mask_name(col: str) -> str:
    """The validity-mask column name for data column ``col``."""
    return MASK_PREFIX + col


def is_mask(name: str) -> bool:
    return name.startswith(MASK_PREFIX)


def base_name(mask: str) -> str:
    """Inverse of ``mask_name`` (callers check ``is_mask`` first)."""
    return mask[len(MASK_PREFIX):]


def data_columns(names: Iterable[str]) -> List[str]:
    """The logical (non-mask) column names, order preserved."""
    return [n for n in names if not is_mask(n)]


def nullable_columns(names: Iterable[str]) -> Set[str]:
    """Data columns that carry a validity mask in ``names``."""
    names = set(names)
    return {base_name(n) for n in names
            if is_mask(n) and base_name(n) in names}


def check_reserved_names(names: Iterable[str]) -> None:
    """Reject user columns squatting on the mask prefix with no base column
    (ingest boundary check; a well-formed mask is silently accepted)."""
    names = list(names)
    have = set(names)
    for n in names:
        if is_mask(n) and base_name(n) not in have:
            raise ValueError(
                f"column name {n!r} uses the reserved validity-mask prefix "
                f"{MASK_PREFIX!r} but no column {base_name(n)!r} exists")


def _valid_of(arr: np.ndarray) -> np.ndarray:
    """Element-is-valid for a host array: NaN and None are null."""
    if arr.dtype.kind == "f":
        return ~np.isnan(arr)
    if arr.dtype.kind == "O":
        # None / float NaN / pandas NA inside an object column are null
        def ok(x):
            if x is None:
                return False
            if isinstance(x, float) and np.isnan(x):
                return False
            return not (x is getattr(np, "nan", None))
        return np.fromiter((ok(x) for x in arr), dtype=bool, count=len(arr))
    return np.ones(len(arr), dtype=bool)


def extract_null_columns(data: Dict[str, np.ndarray]
                         ) -> Dict[str, np.ndarray]:
    """Host-side ingest normalization: NaN / None become explicit masks.

    For every data column, null slots are canonicalized — floats to ``0.0``,
    object (string) columns to their lexicographically smallest valid value
    (so the later dictionary encode assigns them code 0 without polluting
    the dictionary).  Pre-supplied ``__m_*`` columns are validated, cast to
    bool, and their bases canonicalized too.  Columns with no nulls and no
    explicit mask pass through untouched (no mask is created).
    """
    check_reserved_names(data.keys())
    out: Dict[str, np.ndarray] = {}
    for name, arr in data.items():
        if is_mask(name):
            continue
        arr = np.asarray(arr)
        m = data.get(mask_name(name))
        if m is not None:
            valid = np.asarray(m).astype(bool)
            if len(valid) != len(arr):
                raise ValueError(
                    f"mask {mask_name(name)!r} length {len(valid)} != "
                    f"column {name!r} length {len(arr)}")
            valid = valid & _valid_of(arr)
        else:
            valid = _valid_of(arr)
        if valid.all() and m is None:
            out[name] = arr
            continue
        arr = arr.copy()
        if arr.dtype.kind == "O":
            vals = arr[valid]
            fill = min(vals) if len(vals) else ""
            arr[~valid] = fill
        elif arr.dtype.kind == "f":
            arr[~valid] = 0.0
        else:
            arr[~valid] = 0
        out[name] = arr
        out[mask_name(name)] = valid
    return out


def apply_null_columns(cols: Dict[str, np.ndarray]
                       ) -> Dict[str, np.ndarray]:
    """Host-side output: re-materialize masks as pandas-style missing values.

    Floats get NaN; integers are widened to float64 with NaN (pandas
    behaviour for nullable ints); object/string columns get ``None``;
    booleans widen to object with ``None``.  Mask columns are consumed.
    A column whose mask is all-True still widens (nullability is a schema
    property, not a data property) so dtypes are stable across batches.
    """
    out: Dict[str, np.ndarray] = {}
    for name, arr in cols.items():
        if is_mask(name):
            continue
        m = cols.get(mask_name(name))
        if m is None:
            out[name] = arr
            continue
        valid = np.asarray(m).astype(bool)
        arr = np.asarray(arr)
        if arr.dtype.kind == "f":
            a = arr.astype(arr.dtype, copy=True)
            a[~valid] = np.nan
        elif arr.dtype.kind in "iu":
            a = arr.astype(np.float64)
            a[~valid] = np.nan
        else:
            a = arr.astype(object)
            a[~valid] = None
        out[name] = a
    return out
