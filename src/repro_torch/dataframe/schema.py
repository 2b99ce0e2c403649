"""Dictionary-encoded string columns: the host-side half of the dtype
system.

The torch counterpart of ``repro.dataframe.schema`` (numpy code plus the
lowering of string literals onto ``repro_torch.expr``), kept here so the
port imports nothing of the JAX package.

Dataframe partitions are Arrow-like tables of typed columns, but the
device moves fixed-width numbers only.  Strings are dictionary-encoded,
with one extra invariant: every dictionary is **lexicographically
sorted**, so the int32 codes are *order-isomorphic* to the strings they
stand for —

    sort / min / max / range-partition on codes  ==  the same on strings,
    code equality                                ==  string equality
                                                     (same dictionary).

That invariant lets every device-side operator (sort-based join/groupby,
sample-sort, radix shuffle, the murmur hash) run on plain int32 tensors
with **zero** string-awareness.  The string side lives on the host:

* ``encode_strings``    — ingest: values -> (codes, sorted dictionary),
* ``decode_codes``      — egress: codes -> numpy unicode array,
* ``recode_mapping``    — old-dictionary codes -> new-dictionary codes
                          (an int32 gather table; the planner inserts it
                          as a ``recode`` node when two join inputs'
                          dictionaries differ),
* ``merge_dictionaries``— sorted union (the recode target),
* ``lower_expr``        — rewrite string literals inside ``repro_torch.expr``
                          trees into code comparisons against a column's
                          dictionary (``col("s") < "oak"`` becomes an int32
                          compare via ``searchsorted``),
* ``expr_dictionary``   — which dictionary (if any) an expression's output
                          codes belong to.

Dictionaries are plain tuples of python str, carried by the host-side
table holder (``core.DistTable.dictionaries``) and by every annotated
logical plan node (``LogicalNode.dicts``); the batched device
``dataframe.Table`` never sees them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from ..expr import BinOp, Col, Expr, FillNull, IsNull, Lit, OpaqueExpr, \
    UnaryOp, _ARITH, _BOOL, _COMPARE

__all__ = [
    "Dictionary", "is_string_array", "encode_strings", "decode_codes",
    "encode_columns", "decode_columns", "merge_dictionaries",
    "recode_mapping", "lower_expr", "expr_dictionary", "DictTypeError",
]

#: a column dictionary: lexicographically sorted, duplicate-free strings
Dictionary = Tuple[str, ...]

#: device dtype of dictionary codes
CODE_DTYPE = np.int32


class DictTypeError(TypeError):
    """An operation is not defined on dictionary-encoded string columns."""


def is_string_array(arr: np.ndarray) -> bool:
    """True for numpy arrays holding strings (object / unicode / bytes)."""
    return arr.dtype.kind in ("O", "U", "S")


def _as_str_array(arr: np.ndarray, name: str = "column") -> np.ndarray:
    """Validate an object array holds only strings; normalize to unicode."""
    if arr.dtype.kind == "O":
        for v in arr:
            if not isinstance(v, str):
                raise TypeError(
                    f"{name} mixes strings with {type(v).__name__}; "
                    f"dictionary encoding needs all-string values")
        return arr.astype(str) if arr.size else arr.astype("U1")
    if arr.dtype.kind == "S":
        return arr.astype(str)
    return arr


def encode_strings(arr: np.ndarray, name: str = "column"
                   ) -> Tuple[np.ndarray, Dictionary]:
    """Host-side ingest: string values -> (int32 codes, sorted dictionary).

    ``np.unique`` returns the *sorted* distinct values, so ``codes`` are
    order-isomorphic to the strings (the module-level invariant).
    """
    arr = _as_str_array(np.asarray(arr), name)
    if arr.size == 0:
        return np.zeros((0,), CODE_DTYPE), ()
    values, codes = np.unique(arr, return_inverse=True)
    return codes.astype(CODE_DTYPE), tuple(str(v) for v in values)


def dictionary_of(arr: np.ndarray) -> Dictionary:
    """Sorted dictionary of a string array WITHOUT computing codes.

    Used by the planner catalog, which only needs the dictionary — skips
    ``return_inverse`` and the per-element validation of
    ``encode_strings`` (ingest re-validates and must yield the identical
    dictionary, since both sort the same distinct values).
    """
    arr = np.asarray(arr)
    if arr.size == 0:
        return ()
    if arr.dtype.kind in ("O", "S"):
        arr = arr.astype(str)
    return tuple(str(v) for v in np.unique(arr))


def decode_codes(codes: np.ndarray, dictionary: Dictionary) -> np.ndarray:
    """Host-side egress: int32 codes -> numpy unicode array.

    Decode runs on valid rows only (padding is sliced off before it), so
    an out-of-range code means upstream corruption — raise loudly instead
    of silently returning some dictionary entry.
    """
    codes = np.asarray(codes)
    if codes.size == 0:
        return np.zeros(codes.shape, "U1")
    if (not dictionary or int(codes.min()) < 0
            or int(codes.max()) >= len(dictionary)):
        raise ValueError(
            f"dictionary codes out of range [0, {len(dictionary)}): "
            f"min={int(codes.min()) if codes.size else 0}, "
            f"max={int(codes.max()) if codes.size else 0} — the table's "
            f"dictionary does not match its code column")
    return np.asarray(dictionary)[codes]


def encode_columns(data: Mapping[str, np.ndarray]
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, Dictionary]]:
    """Encode every string column of a host column dict; numeric columns
    pass through.  Returns ``(columns, dictionaries)``."""
    cols: Dict[str, np.ndarray] = {}
    dicts: Dict[str, Dictionary] = {}
    for name, arr in data.items():
        arr = np.asarray(arr)
        if is_string_array(arr):
            cols[name], dicts[name] = encode_strings(arr, name=repr(name))
        else:
            cols[name] = arr
    return cols, dicts


def decode_columns(cols: Mapping[str, np.ndarray],
                   dicts: Mapping[str, Dictionary]) -> Dict[str, np.ndarray]:
    """Decode the dictionary-encoded columns of a host column dict."""
    return {name: decode_codes(v, dicts[name]) if name in dicts else v
            for name, v in cols.items()}


def merge_dictionaries(a: Dictionary, b: Dictionary) -> Dictionary:
    """Sorted union — the recode target when two inputs disagree."""
    return tuple(sorted(set(a) | set(b)))


def recode_mapping(old: Dictionary, new: Dictionary) -> np.ndarray:
    """Static gather table: ``new_codes = mapping[old_codes]``.

    Every ``old`` entry must exist in ``new`` (``new`` is a superset by
    construction).  Never empty — a length-1 zero table keeps the device
    gather well-defined for all-padding columns.
    """
    if not old:
        return np.zeros((1,), CODE_DTYPE)
    missing = sorted(set(old) - set(new))
    if missing:
        raise ValueError(f"recode target is missing entries {missing[:5]}")
    pos = np.searchsorted(np.asarray(new), np.asarray(old))
    return pos.astype(CODE_DTYPE)


# ---------------------------------------------------------------------- #
# Expression lowering: string literals -> code comparisons
# ---------------------------------------------------------------------- #
class _StrLit:
    """Marker meta for a raw string literal awaiting a dictionary context."""

    __slots__ = ("value",)

    def __init__(self, value: str):
        self.value = value


def _code_lit(v: int) -> Lit:
    # a plain python int: weakly typed, so comparisons keep the code
    # column's int32 dtype (and EXPLAIN renders `s >= 4`, not a numpy repr)
    return Lit(int(v))


_UNSUPPORTED = ("only == != < <= > >= comparisons against string literals "
                "or same-dictionary columns are supported on "
                "dictionary-encoded string columns (plus join/groupby/sort "
                "keys and min/max/count aggregates)")


def _lower_compare(op: str, cexpr: Expr, d: Dictionary, s: str,
                   swap: bool) -> Expr:
    """Rewrite ``col <op> "s"`` into an int32 code comparison.

    ``d`` is sorted, so with ``lo/hi = searchsorted(d, s, left/right)``:
    ``x < s``  ⇔ ``code < lo``;   ``x <= s`` ⇔ ``code < hi``;
    ``x > s``  ⇔ ``code >= hi``;  ``x >= s`` ⇔ ``code >= lo``;
    ``x == s`` ⇔ ``code == lo`` when present, else always-False (``-1``).
    ``swap`` mirrors for ``"s" <op> col``.
    """
    if swap:
        op = {"<": ">", "<=": ">=", ">": "<", ">=": "<="}.get(op, op)
    arr = np.asarray(d) if d else np.zeros((0,), "U1")
    lo = int(np.searchsorted(arr, s, side="left"))
    hi = int(np.searchsorted(arr, s, side="right"))
    present = hi > lo
    if op == "==":
        return BinOp("==", cexpr, _code_lit(lo if present else -1))
    if op == "!=":
        return BinOp("!=", cexpr, _code_lit(lo if present else -1))
    if op == "<":
        return BinOp("<", cexpr, _code_lit(lo))
    if op == "<=":
        return BinOp("<", cexpr, _code_lit(hi))
    if op == ">":
        return BinOp(">=", cexpr, _code_lit(hi))
    if op == ">=":
        return BinOp(">=", cexpr, _code_lit(lo))
    raise AssertionError(op)


def _lower(e: Expr, dicts: Mapping[str, Dictionary]):
    """Recursive lowering: returns ``(expr, meta)`` where meta is ``None``
    (numeric value), a ``Dictionary`` (value is codes in that dictionary),
    or ``_StrLit`` (raw string literal, resolved by an enclosing compare)."""
    if isinstance(e, Col):
        return e, dicts.get(e.name)
    if isinstance(e, Lit):
        if isinstance(e.value, (str, np.str_)):
            return e, _StrLit(str(e.value))
        return e, None
    if isinstance(e, UnaryOp):
        op, meta = _lower(e.operand, dicts)
        if meta is not None:
            raise DictTypeError(
                f"unary {e.op!r} on a dictionary-encoded string value "
                f"({e!r}): {_UNSUPPORTED}")
        return UnaryOp(e.op, op), None
    if isinstance(e, IsNull):
        # null-ness lives in the validity mask, not the codes: defined for
        # every column type, always a plain boolean result
        op, meta = _lower(e.operand, dicts)
        if isinstance(meta, _StrLit):
            op = _code_lit(0)          # a literal is never null
        return IsNull(op), None
    if isinstance(e, FillNull):
        op, om = _lower(e.operand, dicts)
        fl, fm = _lower(e.fill, dicts)
        if isinstance(om, _StrLit):    # literal operand: never null
            return op, om
        if isinstance(om, tuple):
            if isinstance(fm, _StrLit):
                s = fm.value
                arr = np.asarray(om) if om else np.zeros((0,), "U1")
                lo = int(np.searchsorted(arr, s, side="left"))
                if not (lo < len(om) and om[lo] == s):
                    raise DictTypeError(
                        f"fill_null value {s!r} is not in the column's "
                        f"dictionary ({e!r}); fill with an existing value "
                        f"or extend the dictionary at ingest")
                return FillNull(op, _code_lit(lo)), om
            if isinstance(fm, tuple):
                if fm != om:
                    raise DictTypeError(
                        f"fill_null fill column uses a different dictionary "
                        f"than its operand ({e!r}); join/merge them first "
                        f"so the planner recodes to a shared dictionary")
                return FillNull(op, fl), om
            raise DictTypeError(
                f"cannot fill_null a dictionary-encoded string column "
                f"with a numeric value ({e!r})")
        if isinstance(fm, (tuple, _StrLit)):
            raise DictTypeError(
                f"cannot fill_null a numeric column with a string value "
                f"({e!r})")
        return FillNull(op, fl), None
    if isinstance(e, OpaqueExpr):
        cols = e.columns()
        touched = sorted(dicts if cols is None
                         else set(cols) & set(dicts))
        if touched:
            raise DictTypeError(
                f"opaque callable {e!r} touches dictionary-encoded "
                f"column(s) {touched}; rewrite it as a typed expression "
                f"so string literals can be lowered against the dictionary")
        return e, None
    if isinstance(e, BinOp):
        l, lm = _lower(e.left, dicts)
        r, rm = _lower(e.right, dicts)
        if lm is None and rm is None:
            return BinOp(e.op, l, r), None
        if e.op in _COMPARE:
            if isinstance(lm, tuple) and isinstance(rm, _StrLit):
                return _lower_compare(e.op, l, lm, rm.value, swap=False), None
            if isinstance(lm, _StrLit) and isinstance(rm, tuple):
                return _lower_compare(e.op, r, rm, lm.value, swap=True), None
            if isinstance(lm, tuple) and isinstance(rm, tuple):
                if lm != rm:
                    raise DictTypeError(
                        f"cannot compare dictionary-encoded columns with "
                        f"different dictionaries ({e!r}); join/merge them "
                        f"first so the planner recodes to a shared "
                        f"dictionary")
                return BinOp(e.op, l, r), None
            raise DictTypeError(
                f"cannot compare a dictionary-encoded string value with a "
                f"numeric value ({e!r})")
        kind = "arithmetic" if e.op in _ARITH else \
            "boolean" if e.op in _BOOL else "binary"
        raise DictTypeError(
            f"{kind} {e.op!r} on a dictionary-encoded string value "
            f"({e!r}): {_UNSUPPORTED}")
    raise TypeError(f"cannot lower {type(e).__name__}")


def lower_expr(e: Expr, dicts: Mapping[str, Dictionary]
               ) -> Tuple[Expr, Optional[Dictionary]]:
    """Lower string literals in ``e`` against the input's per-column
    ``dicts``; returns ``(lowered expr, output dictionary or None)``.

    A bare string literal becomes a constant column over the singleton
    dictionary ``(s,)`` (code 0).  Raises ``DictTypeError`` for operations
    with no dictionary-code semantics (arithmetic on strings, mixed-type
    comparisons, cross-dictionary column comparisons).
    """
    out, meta = _lower(e, dicts)
    if isinstance(meta, _StrLit):
        return _code_lit(0), (meta.value,)
    return out, meta


def expr_dictionary(e: Expr, dicts: Mapping[str, Dictionary]
                    ) -> Optional[Dictionary]:
    """The dictionary an expression's output codes belong to, or ``None``
    for numeric results.  Structural only (no validation): ``col(c)``
    passthroughs keep ``c``'s dictionary, bare string literals get the
    singleton dictionary — everything else is numeric.
    """
    if isinstance(e, Col):
        return dicts.get(e.name)
    if isinstance(e, Lit) and isinstance(e.value, (str, np.str_)):
        return (str(e.value),)
    if isinstance(e, FillNull):
        return expr_dictionary(e.operand, dicts)
    return None
