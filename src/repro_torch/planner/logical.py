"""Typed logical plan with per-node physical properties.

The torch counterpart of ``repro.planner.logical`` (pure Python).

This replaces the ad-hoc ``core.plan.Node`` as the optimizer's working
representation.  Every node carries three derived properties, recomputed by
``annotate`` after each rewrite pass:

* ``schema``        — sorted tuple of live output columns,
* ``partitioning``  — how rows are placed across ranks
                      (``none`` | ``hash(cols)`` | ``range(col)``),
* ``est_rows``      — global row-count estimate (heuristic; drives
                      join-side selection and EXPLAIN only).

The partitioning lattice is what makes shuffle elision sound:

* ``hash(C)``  — row placement is ``hash_columns(C) % p`` (the deterministic
  murmur-style hash in ``dataframe.ops_local``), so two tables hashed on the
  same columns are co-partitioned.
* ``range(c)`` — rank ``r`` holds the ``r``-th contiguous key range of ``c``
  (sample-sort splitters); equal keys are co-located but *not* aligned with
  any hash partitioning.

``colocates(cols)`` (equal keys share a rank) is the requirement of
``groupby``; ``matches_hash`` (exact placement equality) is the stronger
requirement of ``join`` co-partitioning; ``matches_range`` is required by
``sort``.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np

#: ops that may execute a shuffle (communication boundaries)
COMM_OPS = ("shuffle", "join", "groupby", "sort")
#: purely local ops (``recode`` remaps dictionary codes via a gather
#: table — inserted by ``planner.dictionary``, never by users)
LOCAL_OPS = ("scan", "project", "filter", "with_columns", "add_scalar",
             "recode", "noop")

#: paper §V data recipe: ~90% key cardinality (drives groupby estimates)
DEFAULT_GROUP_RATIO = 0.9
#: selectivity guess for filters with unknown predicates
DEFAULT_FILTER_SELECTIVITY = 0.5

_ids = itertools.count()


@dataclasses.dataclass(frozen=True)
class Partitioning:
    kind: str = "none"            # "none" | "hash" | "range"
    cols: Tuple[str, ...] = ()

    @staticmethod
    def none() -> "Partitioning":
        return Partitioning()

    @staticmethod
    def hash_(cols: Sequence[str]) -> "Partitioning":
        return Partitioning("hash", tuple(cols))

    @staticmethod
    def range_(col: str) -> "Partitioning":
        return Partitioning("range", (col,))

    def colocates(self, cols: Sequence[str]) -> bool:
        """Rows with equal values on ``cols`` are guaranteed to share a rank."""
        return (bool(self.cols) and self.kind in ("hash", "range")
                and set(self.cols) <= set(cols))

    def matches_hash(self, cols: Sequence[str]) -> bool:
        """Placement is exactly ``hash_columns(cols) % p``."""
        return self.kind == "hash" and self.cols == tuple(cols)

    def matches_range(self, col: str) -> bool:
        """Rank r holds the r-th contiguous range of ``col``."""
        return self.kind == "range" and self.cols == (col,)

    def restrict(self, live: Sequence[str]) -> "Partitioning":
        """Drop the property if its columns are no longer live."""
        if self.kind == "none" or set(self.cols) <= set(live):
            return self
        return Partitioning.none()

    def __str__(self) -> str:
        if self.kind == "none":
            return "none"
        return f"{self.kind}({','.join(self.cols)})"


@dataclasses.dataclass
class LogicalNode:
    """One operator in the logical DAG (mutable: rules rewrite in place)."""

    op: str
    inputs: List["LogicalNode"]
    params: Dict[str, Any]
    schema: Tuple[str, ...] = ()
    partitioning: Partitioning = dataclasses.field(default_factory=Partitioning)
    est_rows: float = 0.0
    #: per-column dictionaries of dictionary-encoded string columns in the
    #: output schema (``dataframe.schema``); device columns hold codes
    dicts: Dict[str, Tuple[str, ...]] = dataclasses.field(default_factory=dict)
    #: output columns that MAY contain nulls (carry a ``__m_*`` validity
    #: mask at runtime).  Conservative in the nullable direction: the
    #: optimizer uses ``c not in nulls`` to elide mask work, never the
    #: reverse, so over-approximating nullability is always sound.
    nulls: frozenset = frozenset()
    nid: int = dataclasses.field(default_factory=lambda: next(_ids))

    # -- physical classification (consulted by lowering & staging) ------- #
    def is_comm(self) -> bool:
        """True if this node still executes at least one shuffle."""
        return self.shuffle_count() > 0

    def shuffle_count(self) -> int:
        p = self.params
        if self.op == "shuffle":
            return 1
        if self.op == "join":
            return int(not p.get("elide_left")) + int(not p.get("elide_right"))
        if self.op in ("groupby", "sort"):
            return 0 if p.get("elide_shuffle") else 1
        return 0


def topo(root: LogicalNode) -> List[LogicalNode]:
    seen, order = set(), []

    def visit(n: LogicalNode) -> None:
        if n.nid in seen:
            return
        seen.add(n.nid)
        for i in n.inputs:
            visit(i)
        order.append(n)

    visit(root)
    return order


def consumers(root: LogicalNode) -> Dict[int, int]:
    """nid -> number of consumers in the DAG (root counts as one extra)."""
    count: Dict[int, int] = {root.nid: 1}
    for n in topo(root):
        for i in n.inputs:
            count[i.nid] = count.get(i.nid, 0) + 1
        count.setdefault(n.nid, 0)
    return count


# ---------------------------------------------------------------------- #
# Schema inference helpers
# ---------------------------------------------------------------------- #
def join_schema(left: Sequence[str], right: Sequence[str], on: str,
                suffix: str = "_r") -> Tuple[str, ...]:
    cols = list(left)
    for name in right:
        if name == on:
            continue
        cols.append(name if name not in left else name + suffix)
    return tuple(sorted(cols))


def groupby_schema(keys: Sequence[str], aggs: Mapping[str, Sequence[str]]
                   ) -> Tuple[str, ...]:
    from ..dataframe.groupby import _normalize
    _, post = _normalize(aggs)
    return tuple(sorted(set(keys) | {name for name, _, _ in post}))


# ---------------------------------------------------------------------- #
# Property annotation (bottom-up, idempotent)
# ---------------------------------------------------------------------- #
def annotate(root: LogicalNode,
             catalog: Optional[Mapping[str, Tuple[Tuple[str, ...], float]]] = None
             ) -> LogicalNode:
    """Recompute schema / partitioning / est_rows for every node.

    ``catalog`` maps scan names to ``(columns, est_rows)``; when omitted,
    scan nodes keep whatever properties they already carry (used when
    re-annotating after a rewrite pass).
    """
    for n in topo(root):
        _annotate_node(n, catalog)
    return root


def _restrict_dicts(dicts: Mapping[str, Tuple[str, ...]],
                    schema: Sequence[str]) -> Dict[str, Tuple[str, ...]]:
    live = set(schema)
    return {c: d for c, d in dicts.items() if c in live}


def _annotate_node(n: LogicalNode, catalog) -> None:
    p = n.params
    ins = n.inputs
    if n.op == "scan":
        if catalog is not None:
            name = p["name"]
            if name not in catalog:
                raise KeyError(
                    f"scan {name!r} has no schema: pass it in `tables` "
                    f"(a DistTable, a column sequence, or a (cols, rows) "
                    f"pair); known names: {sorted(catalog)}")
            entry = catalog[name]
            cols, rows = entry[0], entry[1]
            n.schema = tuple(sorted(cols))
            n.est_rows = float(rows)
            n.dicts = dict(entry[2]) if len(entry) > 2 else {}
            n.nulls = frozenset(entry[3]) if len(entry) > 3 else frozenset()
        n.partitioning = Partitioning.none()  # block-distributed source
        return

    i0 = ins[0]
    if n.op == "noop":                        # identity left by shuffle elision
        n.schema, n.partitioning, n.est_rows = i0.schema, i0.partitioning, i0.est_rows
        n.dicts = dict(i0.dicts)
        n.nulls = i0.nulls
    elif n.op == "project":
        n.schema = tuple(sorted(p["cols"]))
        n.partitioning = i0.partitioning.restrict(n.schema)
        n.est_rows = i0.est_rows
        n.dicts = _restrict_dicts(i0.dicts, n.schema)
        n.nulls = i0.nulls & set(n.schema)
    elif n.op == "filter":
        n.schema = i0.schema
        n.partitioning = i0.partitioning
        n.est_rows = i0.est_rows * DEFAULT_FILTER_SELECTIVITY
        n.dicts = dict(i0.dicts)
        n.nulls = i0.nulls
    elif n.op == "with_columns":
        # assignments may introduce new columns; rewriting a partitioning
        # column's values breaks the placement property
        assigned = set(p["exprs"])
        n.schema = tuple(sorted(set(i0.schema) | assigned))
        n.partitioning = (Partitioning.none()
                          if assigned & set(i0.partitioning.cols)
                          else i0.partitioning)
        n.est_rows = i0.est_rows
        from ..dataframe.schema import expr_dictionary
        dicts = {c: d for c, d in i0.dicts.items() if c not in assigned}
        # already-lowered string-literal assignments record their output
        # dictionary in ``assign_dicts`` (planner.dictionary)
        assign_dicts = p.get("assign_dicts", {})
        for name, e in p["exprs"].items():
            d = (assign_dicts.get(name)
                 or expr_dictionary(e, i0.dicts))
            if d is not None:
                dicts[name] = d
        n.dicts = dicts
        nulls = set(i0.nulls) - assigned
        for name, e in p["exprs"].items():
            nullable = getattr(e, "nullable", None)
            if nullable is None or nullable(i0.nulls):
                nulls.add(name)
        n.nulls = frozenset(nulls)
    elif n.op == "add_scalar":
        n.schema = i0.schema
        touched = p.get("cols")
        touched = set(i0.schema if touched is None else touched)
        n.partitioning = (Partitioning.none()
                          if touched & set(i0.partitioning.cols)
                          else i0.partitioning)
        n.est_rows = i0.est_rows
        n.dicts = dict(i0.dicts)
        n.nulls = i0.nulls
    elif n.op == "recode":
        # per-column code remap onto the target dictionaries; the recoded
        # columns' hash placement no longer holds (codes changed)
        n.schema = i0.schema
        n.partitioning = (Partitioning.none()
                          if set(p["cols"]) & set(i0.partitioning.cols)
                          else i0.partitioning)
        n.est_rows = i0.est_rows
        n.dicts = {**i0.dicts, **p["targets"]}
        n.nulls = i0.nulls
    elif n.op == "shuffle":
        n.schema = i0.schema
        # an explicit dest array routes rows arbitrarily — no hash property
        n.partitioning = (Partitioning.none() if "dest" in p
                          else Partitioning.hash_(p["key_cols"]))
        n.est_rows = i0.est_rows
        n.dicts = dict(i0.dicts)
        n.nulls = i0.nulls
    elif n.op == "join":
        l, r = ins
        n.schema = join_schema(l.schema, r.schema, p["on"])
        n.partitioning = (l.partitioning if p.get("elide_left")
                          and p.get("elide_right")
                          else Partitioning.hash_((p["on"],)))
        n.est_rows = max(l.est_rows, r.est_rows)
        # key column comes from the left side (inputs agree post-recode);
        # colliding right columns follow the ``_r`` suffix rename
        dicts = dict(l.dicts)
        lcols = set(l.schema)
        for c, d in r.dicts.items():
            if c == p["on"]:
                continue
            dicts[c if c not in lcols else c + "_r"] = d
        n.dicts = _restrict_dicts(dicts, n.schema)
        # null join keys never match (they are dropped): the output key is
        # non-null; value columns keep nullability through the _r rename
        nulls = set(l.nulls) - {p["on"]}
        for c in r.nulls:
            if c == p["on"]:
                continue
            nulls.add(c if c not in lcols else c + "_r")
        n.nulls = frozenset(nulls & set(n.schema))
    elif n.op == "groupby":
        n.schema = groupby_schema(p["keys"], p["aggs"])
        if p.get("elide_shuffle"):
            # groups stay where their rows already were
            n.partitioning = i0.partitioning.restrict(n.schema)
        else:
            n.partitioning = Partitioning.hash_(p["keys"])
        n.est_rows = i0.est_rows * DEFAULT_GROUP_RATIO
        # keys keep their dictionaries; min/max of codes = min/max of
        # strings (sorted dictionaries), so those outputs stay encoded
        dicts = {k: i0.dicts[k] for k in p["keys"] if k in i0.dicts}
        for col, agg_names in p["aggs"].items():
            if col in i0.dicts:
                for a in agg_names:
                    if a in ("min", "max"):
                        dicts[f"{col}_{a}"] = i0.dicts[col]
        n.dicts = _restrict_dicts(dicts, n.schema)
        # null keys form no groups; sum/count/size never yield null; an
        # all-null group has null min/max/mean of a nullable input column
        nulls = set()
        for col, agg_names in p["aggs"].items():
            if col in i0.nulls:
                for a in agg_names:
                    if a in ("min", "max", "mean"):
                        nulls.add(f"{col}_{a}")
        n.nulls = frozenset(nulls & set(n.schema))
    elif n.op == "sort":
        n.schema = i0.schema
        n.partitioning = Partitioning.range_(p["by"][0])
        n.est_rows = i0.est_rows
        n.dicts = dict(i0.dicts)
        n.nulls = i0.nulls
    else:
        raise ValueError(f"unknown op {n.op!r}")


# ---------------------------------------------------------------------- #
# Conversion from the core plan (duck-typed: needs .op/.inputs/.params)
# ---------------------------------------------------------------------- #
def from_plan(node, catalog: Mapping[str, Tuple[Tuple[str, ...], float]]
              ) -> LogicalNode:
    """Convert a ``core.plan`` plan tree into an annotated logical DAG."""
    memo: Dict[int, LogicalNode] = {}

    def conv(n) -> LogicalNode:
        if id(n) in memo:
            return memo[id(n)]
        out = LogicalNode(n.op, [conv(i) for i in n.inputs], dict(n.params))
        memo[id(n)] = out
        return out

    return annotate(conv(node), catalog)


def copy_dag(root: LogicalNode) -> LogicalNode:
    """Structural copy of a LogicalNode DAG (sharing preserved, params
    shallow-copied like ``from_plan``).  ``compile_plan`` copies before
    the rewrite passes so a caller-held DAG is never mutated — compiling
    it twice against different catalogs must not leak recode tables or
    lowered literals from the first run into the second."""
    memo: Dict[int, LogicalNode] = {}

    def conv(n: LogicalNode) -> LogicalNode:
        if n.nid in memo:
            return memo[n.nid]
        out = LogicalNode(n.op, [conv(i) for i in n.inputs], dict(n.params),
                          schema=n.schema, partitioning=n.partitioning,
                          est_rows=n.est_rows, dicts=dict(n.dicts),
                          nulls=n.nulls)
        memo[n.nid] = out
        return out

    return conv(root)


def build_catalog(tables: Optional[Mapping[str, Any]]
                  ) -> Dict[str, Tuple[Tuple[str, ...], float,
                                       Dict[str, Tuple[str, ...]],
                                       frozenset]]:
    """Normalize scan metadata to ``(columns, est_rows, dictionaries,
    nullable_columns)``.

    Values may be DistTable-likes (``column_names`` + ``total_rows`` +
    optional ``dictionaries``), numpy column dicts, ``(cols, rows)`` pairs,
    or plain column sequences; dictionaries default to none (all-numeric)
    and nullability to none.  ``__m_*`` validity-mask columns are physical
    companions, not logical schema: they are stripped from the column list
    and recorded as their base column's nullability instead.
    """
    from ..dataframe.schema import dictionary_of, is_string_array
    from ..nulls import _valid_of, data_columns, nullable_columns
    cat: Dict[str, Tuple[Tuple[str, ...], float,
                         Dict[str, Tuple[str, ...]], frozenset]] = {}
    for name, t in (tables or {}).items():
        if hasattr(t, "column_names"):
            rows = float(t.total_rows()) if hasattr(t, "total_rows") else 1024.0
            dicts = dict(getattr(t, "dictionaries", {}) or {})
            names = tuple(t.column_names)
            cat[name] = (tuple(data_columns(names)), rows, dicts,
                         frozenset(nullable_columns(names)))
        elif isinstance(t, Mapping):
            # raw numpy column dict: string columns will be dictionary-
            # encoded at ingest — mirror the dictionary here (codes not
            # needed) so the plan agrees.  NaN/None slots (or an explicit
            # __m_* companion) make the column nullable, as
            # ``extract_null_columns`` will normalize it at ingest; its
            # smallest-valid-value fill keeps the dictionary null-free.
            cols, dicts, rows = [], {}, 1024.0
            nulls = set(nullable_columns(t.keys()))
            for cname, arr in t.items():
                if cname.startswith("__m_"):
                    continue
                arr = np.asarray(arr)
                cols.append(cname)
                rows = float(len(arr))
                valid = _valid_of(arr)
                if not valid.all():
                    nulls.add(cname)
                if is_string_array(arr):
                    vals = arr[valid] if not valid.all() else arr
                    # all-null columns ingest as the "" fill value
                    dicts[cname] = (dictionary_of(vals) if len(vals)
                                    else ("",))
            cat[name] = (tuple(cols), rows, dicts, frozenset(nulls))
        elif (isinstance(t, tuple) and len(t) in (2, 3, 4)
              and not isinstance(t[0], str)):
            dicts = dict(t[2]) if len(t) > 2 else {}
            nulls = frozenset(t[3]) if len(t) > 3 else frozenset()
            cat[name] = (tuple(data_columns(t[0])), float(t[1]), dicts,
                         nulls | frozenset(nullable_columns(t[0])))
        else:
            cat[name] = (tuple(t), 1024.0, {}, frozenset())
    return cat
