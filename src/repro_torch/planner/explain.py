"""EXPLAIN: render a (logical or lowered) plan with stages, partitioning
properties, row estimates, and the optimizer rules that fired.

The torch counterpart of ``repro.planner.explain``; for the same plan and
tables it renders the same text.

>>> from repro_torch.core import Plan
>>> from repro_torch.planner import explain
>>> print(explain(Plan.scan("t").shuffle(["k"]).groupby(["k"], {"v": ["sum"]}),
...               {"t": (("k", "v"), 10_000)}))
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

from .logical import LogicalNode
from .physical import PhysicalPlan


def _label(n: LogicalNode) -> str:
    p = n.params
    if n.op == "scan":
        # ingested sources (repro_torch.io) carry a provenance summary:
        # ``scan[parquet: 3 files, ~1000 rows]``
        return f"scan[{p['source']}]" if p.get("source") else \
            f"scan[{p['name']}]"
    if n.op == "noop":
        return f"noop[{p.get('note', '')}]"
    if n.op == "project":
        return f"project[{','.join(p['cols'])}]"
    if n.op == "filter":
        return f"filter[{p['expr']!r}]"
    if n.op == "with_columns":
        assigns = ",".join(f"{name}={e!r}"
                           for name, e in sorted(p["exprs"].items()))
        return f"with_columns[{assigns}]"
    if n.op == "add_scalar":
        cols = p.get("cols")
        return f"add_scalar[{','.join(cols) if cols else '*'}]"
    if n.op == "recode":
        parts = ",".join(f"{c}:|D|={len(p['targets'][c])}"
                         for c in sorted(p["targets"]))
        return f"recode[{parts}]"
    if n.op == "shuffle":
        extra = "".join(f"; {k}={p[k]}" for k in ("impl", "a2a_chunks")
                        if k in p)
        return f"shuffle[{','.join(p['key_cols'])}{extra}]"
    if n.op == "join":
        notes = [s for s, f in (("left-elided", "elide_left"),
                                ("right-elided", "elide_right")) if p.get(f)]
        extra = f" ({', '.join(notes)})" if notes else ""
        return f"join[on={p['on']}]{extra}"
    if n.op == "groupby":
        aggs = ";".join(f"{c}:{','.join(a)}" for c, a in sorted(p["aggs"].items()))
        notes = []
        if p.get("elide_shuffle"):
            notes.append("shuffle-elided")
        elif p.get("pre_aggregate"):
            notes.append("pre-agg")
        extra = f" ({', '.join(notes)})" if notes else ""
        return f"groupby[{','.join(p['keys'])}; {aggs}]{extra}"
    if n.op == "sort":
        extra = " (shuffle-elided)" if p.get("elide_shuffle") else ""
        return f"sort[{','.join(p['by'])}]{extra}"
    return n.op


#: public alias — EXPLAIN ANALYZE (``repro_torch.obs.analyze``) renders the
#: same per-node labels with measured actuals appended
node_label = _label


def adapt_note(event: Mapping[str, Any]) -> str:
    """EXPLAIN ANALYZE annotation for one fired adaptive event (the dict
    form recorded in ``ExecStats.adapt_events`` — serializable, so reports
    round-trip through ``to_dict``).  Mirrors ``SaltDecision.note``."""
    if event.get("op") == "groupby":
        return f"salted[k:{event['k']}, hot:{event['hot_keys']}]"
    return (f"salted[broadcast, hot:{event['hot_keys']}, "
            f"cap:{event['hot_cap']}]")


def render(pplan: PhysicalPlan, mode: str = "bsp",
           shuffle_impl: str = "radix", a2a_chunks: int = 1,
           morsel_rows: Optional[int] = None) -> str:
    # amt executes the allgather object-store shuffle; the bucketize/chunking
    # knobs are inert there, so show what actually runs
    shuf = ("allgather" if mode == "amt"
            else f"{shuffle_impl}/c{a2a_chunks}")
    ooc = ("" if morsel_rows is None
           else f"out-of-core={morsel_rows} rows/morsel, ")
    lines = [
        f"== physical plan: {pplan.num_stages} stages, "
        f"{pplan.num_shuffles} shuffles, mode={mode}, "
        f"shuffle={shuf}, {ooc}"
        f"fingerprint={pplan.fingerprint[:12]} =="
    ]
    by_stage: Dict[int, list] = {}
    for n in pplan.order:
        by_stage.setdefault(pplan.stage_of[n.nid], []).append(n)
    for s in sorted(by_stage):
        lines.append(f"stage {s}:")
        for n in by_stage[s]:
            lines.append(
                f"  {_label(n):44s} rows~{int(n.est_rows):>9d}  "
                f"part={str(n.partitioning):12s} cols={','.join(n.schema)}")
    if pplan.fired:
        lines.append("rules fired:")
        for f in pplan.fired:
            lines.append(f"  - {f}")
    else:
        lines.append("rules fired: (none)")
    return "\n".join(lines)


def explain(plan: Any, tables: Optional[Mapping[str, Any]] = None,
            optimize_plan: bool = True, mode: str = "bsp",
            shuffle_impl: str = "radix", a2a_chunks: int = 1,
            morsel_rows: Optional[int] = None) -> str:
    """Render EXPLAIN output for a ``core.plan.Plan`` (or raw plan node /
    LogicalNode).  ``tables`` supplies scan schemas: DistTables,
    ``(cols, rows)`` pairs, or plain column sequences.  ``shuffle_impl`` /
    ``a2a_chunks`` are the plan-wide shuffle knobs shown in the header
    (per-node overrides appear in the node labels); ``morsel_rows`` marks
    out-of-core morsel execution in the header."""
    from . import compile_plan  # deferred: the package imports this module
    return render(compile_plan(plan, tables, optimize_plan=optimize_plan),
                  mode, shuffle_impl=shuffle_impl,
                  a2a_chunks=a2a_chunks, morsel_rows=morsel_rows)
