"""Dictionary resolution pass: make string semantics explicit in the plan.

The torch counterpart of ``repro.planner.dictionary`` (pure Python).  It
runs on every compile — **before** and independently of the optimizer,
because it is a *correctness* pass, not a rewrite heuristic (it fires with
``optimize=False`` too).  Three jobs, all driven by the per-node
``LogicalNode.dicts`` annotation:

1. **Recode insertion** — a join whose two inputs carry *different*
   dictionaries for the key column compares codes from different code
   spaces; a ``recode`` node (static int32 gather table,
   ``dataframe.schema.recode_mapping``) is inserted above each divergent
   input, remapping onto the sorted union of both dictionaries.  The node
   is visible in EXPLAIN (``recode[k: |D|=N]``) and runs inside the
   stage like any local operator; its table moves to the device once per
   built stage.  Equal keys then share codes gang-wide, so
   hashing/sorting/merging codes is exact.

2. **String-literal lowering** — ``filter`` / ``with_columns`` expressions
   containing string literals are rewritten into int32 code comparisons
   against the input's dictionary (``dataframe.schema.lower_expr``):
   ``col("s") < "oak"`` becomes ``s < lit(int32(k))`` via searchsorted on
   the sorted dictionary.  The lowered literal is part of the expression
   fingerprint, so different dictionaries build distinct stages.

3. **Validation** — operations with no dictionary-code semantics raise
   ``DictTypeError`` at compile time with a message naming the column:
   arithmetic on string columns, sum/mean aggregates over them, string
   vs numeric comparisons, and joins of a string key against a numeric
   key.

The pass mutates the logical DAG in place (the plan tree the user holds
is never touched — ``from_plan`` copies params) and returns EXPLAIN-style
"fired" records for every recode it inserted.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ..dataframe.schema import (DictTypeError, lower_expr, merge_dictionaries,
                                recode_mapping)
from .logical import LogicalNode, annotate, topo

__all__ = ["apply_dictionaries", "DictTypeError"]


def _insert_recode(join: LogicalNode, side: int, on: str,
                   target: Tuple[str, ...]) -> str:
    inp = join.inputs[side]
    old = inp.dicts[on]
    node = LogicalNode(
        "recode", [inp],
        {"cols": {on: recode_mapping(old, target)},
         "targets": {on: target}})
    join.inputs[side] = node
    name = "left" if side == 0 else "right"
    return (f"recode: join({on}) {name} input remapped onto the merged "
            f"dictionary (|{len(old)}| -> |{len(target)}|)")


def _resolve_joins(root: LogicalNode) -> List[str]:
    """Insert recode nodes until every join's key dictionaries agree.

    Topo order + re-annotation per pass lets merged dictionaries flow into
    downstream joins (a join chain converges in as many passes as its
    depth; the bound is a safety net, not a tuning knob).
    """
    fired: List[str] = []
    for _ in range(64):
        hits = 0
        for n in topo(root):
            if n.op != "join":
                continue
            on = n.params["on"]
            l, r = n.inputs
            ld, rd = l.dicts.get(on), r.dicts.get(on)
            if (ld is None) != (rd is None):
                side = "left" if ld is None else "right"
                raise DictTypeError(
                    f"join on {on!r} mixes a dictionary-encoded string key "
                    f"with a numeric key (the {side} input is numeric)")
            if ld is None or ld == rd:
                continue
            target = merge_dictionaries(ld, rd)
            if ld != target:
                fired.append(_insert_recode(n, 0, on, target))
            if rd != target:
                fired.append(_insert_recode(n, 1, on, target))
            hits += 1
        if not hits:
            return fired
        annotate(root)
    raise RuntimeError("recode insertion did not converge")


def _lower_exprs(root: LogicalNode) -> None:
    for n in topo(root):
        p = n.params
        dicts = n.inputs[0].dicts if n.inputs else {}
        if n.op == "filter":
            lowered, out_dict = lower_expr(p["expr"], dicts)
            if out_dict is not None:
                raise DictTypeError(
                    f"filter predicate {p['expr']!r} yields a string value, "
                    f"not a boolean mask")
            p["expr"] = lowered
        elif n.op == "with_columns":
            # copy before mutating: the exprs dict may still be shared
            # with the user's plan tree (from_plan is a shallow copy)
            exprs, assign_dicts = {}, {}
            for name, e in p["exprs"].items():
                exprs[name], d = lower_expr(e, dicts)
                if d is not None:
                    assign_dicts[name] = d
            p["exprs"] = exprs
            if assign_dicts:
                p["assign_dicts"] = assign_dicts


def _validate(root: LogicalNode) -> None:
    for n in topo(root):
        p = n.params
        dicts = n.inputs[0].dicts if n.inputs else {}
        if n.op == "groupby":
            for col, agg_names in p["aggs"].items():
                if col not in dicts:
                    continue
                bad = [a for a in agg_names
                       if a not in ("min", "max", "count")]
                if bad:
                    raise DictTypeError(
                        f"aggregate(s) {bad} are not defined on the "
                        f"dictionary-encoded string column {col!r}; "
                        f"supported: min, max, count")
        elif n.op == "add_scalar":
            touched = p.get("cols")
            touched = set(dicts if touched is None else touched)
            bad = sorted(touched & set(dicts))
            if bad:
                raise DictTypeError(
                    f"add_scalar touches dictionary-encoded string "
                    f"column(s) {bad}; arithmetic is not defined on "
                    f"strings — pass cols= to restrict it")


def apply_dictionaries(root: LogicalNode) -> List[str]:
    """Run the full pass on an annotated DAG; returns fired-recode records.

    The DAG is left re-annotated (recode nodes change downstream
    dictionaries and partitioning properties).
    """
    fired = _resolve_joins(root)
    _lower_exprs(root)
    _validate(root)
    annotate(root)
    return fired
