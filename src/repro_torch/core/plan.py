"""Logical plan construction + execution entry point.

The torch counterpart of ``repro.core.plan``.

The paper's BSP execution *implicitly* coalesces every local sub-operator
between two communication boundaries (§III-B1).  The ``Plan`` class below records
the operator DAG; optimization and lowering live in ``repro.planner``:

  * ``repro.planner.logical``  — typed plan with partitioning / cardinality
                                 / liveness properties,
  * ``repro.planner.rules``    — shuffle elision, join-side selection,
                                 predicate & projection pushdown, pre-agg,
  * ``repro.planner.physical`` — stage DAG lowering + structural-fingerprint
                                 compile cache,
  * ``repro.planner.explain``  — EXPLAIN rendering.

``execute`` keeps the paper's three execution modes:

  * ``bsp``        — the entire plan as ONE stage callable (CylonFlow
                     execution: one dispatch, no host round-trip between
                     operators; communicator state persists).
  * ``bsp_staged`` — one dispatch per *stage*, with a host round-trip
                     (device synchronization) at every communication
                     boundary.  Quantifies the coalescing gain alone.
  * ``amt``        — Dask-DDF-style baseline: one dispatch per sub-operator
                     and shuffles implemented as allgather-then-select (the
                     "generic data-sharing/object-store" pattern §III-B2 —
                     every rank receives all rows and keeps its own), i.e.
                     O(p·data) communication instead of O(data).

``chip_smoke.py`` drives the paper's Fig 9 pipeline through ``execute``.
"""

from __future__ import annotations

import dataclasses
import itertools
import warnings
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import torch

from ..dataframe.table import Table
from ..expr import Expr, OpaqueExpr, ensure_expr

_ids = itertools.count()


@dataclasses.dataclass
class Node:
    op: str
    inputs: List["Node"]
    params: Dict[str, Any]
    nid: int = dataclasses.field(default_factory=lambda: next(_ids))

    #: ops that require communication (stage boundaries)
    COMM_OPS = ("join", "groupby", "sort", "shuffle")


class Plan:
    """Chainable logical-plan constructor over named input tables."""

    def __init__(self, node: Node):
        self.node = node

    # -- sources -------------------------------------------------------- #
    @staticmethod
    def scan(name: str) -> "Plan":
        return Plan(Node("scan", [], {"name": name}))

    # -- local ops ------------------------------------------------------ #
    def add_scalar(self, value, cols: Optional[Sequence[str]] = None) -> "Plan":
        return Plan(Node("add_scalar", [self.node], {"value": value, "cols": cols}))

    def filter(self, pred: Union[Expr, Callable[[Table], torch.Tensor]],
               cols: Optional[Sequence[str]] = None) -> "Plan":
        """Keep rows where the boolean expression holds.

        ``pred`` should be a typed column expression
        (``repro_torch.expr.col("v") > 0``), which gives the optimizer exact
        column liveness (pushdown past joins, dead-column elimination) and
        the compile cache a value-based key.  Passing a callable
        ``fn(Table) -> bool array`` is **deprecated**: it is wrapped in an
        ``OpaqueExpr`` pinning the declared ``cols`` (``None`` = unknown,
        which blocks pushdown past schema-changing boundaries).
        """
        if isinstance(pred, Expr):
            if cols is not None:
                raise TypeError(
                    "cols= is only for the deprecated callable form; typed "
                    "expressions carry their own column set")
            expr = pred
        else:
            warnings.warn(
                "Plan.filter(callable) is deprecated; pass a typed "
                "expression (repro_torch.expr.col(...) > ...) so the optimizer "
                "sees exact column liveness and the compile cache gets a "
                "value-based key", DeprecationWarning, stacklevel=2)
            expr = OpaqueExpr(pred, cols)
        return Plan(Node("filter", [self.node], {"expr": expr}))

    def project(self, cols: Sequence[str]) -> "Plan":
        return Plan(Node("project", [self.node], {"cols": tuple(cols)}))

    def with_columns(self, exprs: Mapping[str, Union[Expr, Any]]) -> "Plan":
        """Add or replace columns: ``{name: expression}``.

        All expressions read the *input* table (simultaneous assignment,
        like ``pandas.DataFrame.assign``); bare scalars auto-lift to
        literals and broadcast to full columns.
        """
        return Plan(Node("with_columns", [self.node],
                         {"exprs": {name: ensure_expr(e)
                                    for name, e in exprs.items()}}))

    def map_columns(self, fn, cols: Sequence[str]) -> "Plan":
        """**Deprecated**: apply ``fn`` to each named column.  Rewritten to
        ``with_columns`` over per-column ``OpaqueExpr`` wrappers; prefer
        typed expressions (``with_columns({"v": col("v") * 2})``)."""
        warnings.warn(
            "Plan.map_columns is deprecated; use with_columns with typed "
            "expressions (repro_torch.expr.col) so the optimizer and compile "
            "cache see the computation", DeprecationWarning, stacklevel=2)
        exprs = {c: OpaqueExpr(lambda t, _f=fn, _c=c: _f(t.columns[_c]),
                               cols=(c,), label=getattr(fn, "__name__", "fn"))
                 for c in cols}
        return Plan(Node("with_columns", [self.node], {"exprs": exprs}))

    # -- communication ops ---------------------------------------------- #
    def join(self, other: "Plan", on: str, **kw) -> "Plan":
        return Plan(Node("join", [self.node, other.node], {"on": on, **kw}))

    def groupby(self, keys: Sequence[str], aggs: Mapping[str, Sequence[str]],
                **kw) -> "Plan":
        return Plan(Node("groupby", [self.node],
                         {"keys": tuple(keys), "aggs": dict(aggs), **kw}))

    def sort(self, by: Sequence[str], **kw) -> "Plan":
        return Plan(Node("sort", [self.node], {"by": tuple(by), **kw}))

    def shuffle(self, key_cols: Sequence[str], **kw) -> "Plan":
        return Plan(Node("shuffle", [self.node], {"key_cols": tuple(key_cols), **kw}))

    # -- introspection --------------------------------------------------- #
    def topo(self) -> List[Node]:
        seen, order = set(), []

        def visit(n: Node):
            if n.nid in seen:
                return
            seen.add(n.nid)
            for i in n.inputs:
                visit(i)
            order.append(n)
        visit(self.node)
        return order

    def num_stages(self) -> int:
        """1 + number of communication boundaries (unoptimized count; see
        ``planner.compile_plan(...).num_stages`` for the optimized one)."""
        return 1 + sum(1 for n in self.topo() if n.op in Node.COMM_OPS)

    def explain(self, tables: Optional[Mapping[str, Any]] = None,
                optimize: bool = True, mode: str = "bsp",
                shuffle_impl: str = "radix", a2a_chunks: int = 1,
                morsel_rows: Optional[int] = None) -> str:
        from ..planner import explain as planner_explain
        return planner_explain(self, tables, optimize_plan=optimize, mode=mode,
                               shuffle_impl=shuffle_impl,
                               a2a_chunks=a2a_chunks, morsel_rows=morsel_rows)


def execute(plan: Plan, env, tables: Dict[str, Any], mode: str = "bsp",
            optimize: bool = True, collect_stats: bool = False,
            shuffle_impl: str = "radix", a2a_chunks: int = 1,
            morsel_rows: Optional[int] = None, trace: Any = None,
            retries: Any = None, timeout: Any = None,
            overflow: Any = None, faults: Any = None,
            adaptive: Any = None, **morsel_kw):
    """Execute a plan against DistTables.  Returns a DistTable, or
    ``(DistTable, planner.ExecStats)`` with ``collect_stats=True``.

    ``env`` is a ``core.env.CylonEnv``; mode in {"bsp", "bsp_staged",
    "amt"}.  ``optimize=False`` runs the plan exactly as written.
    ``shuffle_impl`` ("radix" sort-free | "sorted" baseline) and
    ``a2a_chunks`` (all-to-all pipeline depth) are the plan-wide shuffle
    defaults; per-node params override.

    ``morsel_rows`` selects out-of-core morsel execution: ``tables`` may then
    hold host-resident data (``core.SpillTable`` / numpy dicts) larger than
    device capacity, streamed through the stage DAG in ``morsel_rows``-row
    morsels; the result is a ``SpillTable``.  Extra keywords
    (``capacity_factor``, ``samples``, ``debug_overflow``) are forwarded
    to the morsel executor; ``scan_capacity`` sets the per-rank capacity
    that host-resident (ingested) scans get in-core.

    ``trace`` turns on query tracing: ``True`` builds a fresh
    ``repro_torch.obs.Tracer``, an existing ``Tracer`` is used as-is, and
    ``None`` consults the ``REPRO_TRACE`` env var.  The finished
    ``QueryTrace`` is retrievable via ``repro_torch.obs.last_trace()``
    (or from the tracer you passed).  Tracing is host-side only — it
    never changes which stages are built.

    Fault tolerance (``repro_torch.faults``): ``retries`` (int or
    ``RetryPolicy``) replays failed dispatch units with exponential
    backoff; ``timeout`` (seconds or a ``CancellationToken``) deadlines
    the whole query; ``overflow`` (``raise | warn | degrade``, default
    ``degrade``) governs capacity-pressure row drops — ``degrade`` replays
    an in-core plan out-of-core until every row fits; ``faults`` arms a
    deterministic fault-injection plan (``None`` consults the
    ``REPRO_FAULTS`` env var).

    ``adaptive`` (None | bool | dict | ``repro_torch.adapt.
    AdaptiveConfig``) gates runtime skew mitigation — hot-key salting,
    splitter refresh, morsel autotuning.  Default on; data with no
    detected skew runs exactly the ``adaptive=False`` stages.
    """
    from ..obs.trace import resolve_tracer
    from ..planner import compile_plan, run_physical
    tracer = resolve_tracer(trace)
    pplan = compile_plan(plan, tables, optimize_plan=optimize)
    with tracer.span("query", "query", mode=mode,
                     fingerprint=pplan.fingerprint,
                     stages=pplan.num_stages, shuffles=pplan.num_shuffles):
        out = run_physical(pplan, env, tables, mode,
                           collect_stats=collect_stats,
                           shuffle_impl=shuffle_impl, a2a_chunks=a2a_chunks,
                           morsel_rows=morsel_rows, tracer=tracer,
                           retries=retries, timeout=timeout,
                           overflow=overflow, faults=faults,
                           adaptive=adaptive, **morsel_kw)
    if tracer.enabled:
        tracer.finish()
    return out
