"""Rewrite-rule engine over the logical plan.

The torch counterpart of ``repro.planner.rules`` (pure Python; the JAX
package's ``skew_candidates`` comes with the adaptive slice of the port).

Rules mutate the DAG in place and return human-readable "fired" records
(surfaced by EXPLAIN).  ``optimize`` runs the rule list to a fixpoint,
re-annotating node properties after every pass so later rules see the
effects of earlier ones (e.g. predicate pushdown exposes a shuffle whose
input partitioning now satisfies its requirement).

Rule inventory (the paper's communication-pattern view of DDF operators,
arXiv:2209.06146, turned into rewrites):

* shuffle elision        — drop the shuffle inside join/groupby/sort (or an
                           explicit ``shuffle`` node) when the input's
                           partitioning already satisfies the operator's
                           requirement; the collective term vanishes.
* join-side selection    — when one join side is already co-partitioned on
                           the key, shuffle only the other side.
* conjunction splitting  — a filter on ``a & b`` sitting on a communication
                           boundary splits into two stacked filters so each
                           conjunct can be pushed independently (e.g. one
                           side of a join each); conjuncts that end up
                           adjacent again are re-fused after the fixpoint.
* predicate pushdown     — move filters below shuffles/sorts/with_columns
                           (and into join or groupby inputs when the
                           predicate's column set allows it) so fewer rows
                           hit the wire.  Typed expressions carry exact
                           column sets; opaque callables without declared
                           columns stay put.
* projection pushdown    — insert projections below communication boundaries
                           so dead columns never hit the wire; expression
                           inputs are pruned exactly (``Expr.columns()``)
                           and dead ``with_columns`` assignments dropped.
* pre-aggregation        — algebraic aggs (sum/count/min/max/mean) are
                           locally pre-aggregated before the groupby shuffle
                           so one row per (rank, group) moves instead of one
                           row per input row.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Set, Tuple

from ..expr import BinOp, Expr, FillNull, IsNull, Lit, UnaryOp
from .logical import COMM_OPS, LogicalNode, annotate, consumers, topo

#: params that carry optimizer decisions rather than user intent
DECISION_KEYS = ("elide_shuffle", "elide_left", "elide_right",
                 "side_selected", "pre_aggregate")


# ---------------------------------------------------------------------- #
# Shuffle elision
# ---------------------------------------------------------------------- #
def elide_shuffles(root: LogicalNode) -> List[str]:
    fired: List[str] = []
    for n in topo(root):
        p = n.params
        if n.op == "shuffle":
            # An explicit shuffle whose placement already holds is an
            # identity; turn it into a noop (keeps DAG sharing + root id).
            if (not p.get("elided")
                    and "dest" not in p and "out_capacity" not in p
                    and n.inputs[0].partitioning.matches_hash(p["key_cols"])):
                note = f"shuffle({','.join(p['key_cols'])})"
                n.op = "noop"
                n.params = {"note": f"{note} elided", "elided": True}
                fired.append(
                    f"shuffle-elision: {note} removed — input already "
                    f"{n.inputs[0].partitioning}")
        elif n.op == "groupby" and not p.get("elide_shuffle"):
            if ("out_capacity" not in p
                    and n.inputs[0].partitioning.colocates(p["keys"])):
                p["elide_shuffle"] = True
                fired.append(
                    f"shuffle-elision: groupby({','.join(p['keys'])}) runs "
                    f"local-only — input already {n.inputs[0].partitioning}")
        elif n.op == "sort" and not p.get("elide_shuffle"):
            if ("out_capacity" not in p
                    and n.inputs[0].partitioning.matches_range(p["by"][0])):
                p["elide_shuffle"] = True
                fired.append(
                    f"shuffle-elision: sort({','.join(p['by'])}) runs "
                    f"local-only — input already {n.inputs[0].partitioning}")
        elif n.op == "join":
            key = (n.params["on"],)
            for side, inp in (("left", n.inputs[0]), ("right", n.inputs[1])):
                flag = f"elide_{side}"
                if not p.get(flag) and inp.partitioning.matches_hash(key):
                    p[flag] = True
                    fired.append(
                        f"shuffle-elision: join({n.params['on']}) {side} side "
                        f"pre-partitioned — input already {inp.partitioning}")
    return fired


def select_join_sides(root: LogicalNode) -> List[str]:
    """Record the shuffle-side decision for joins with one co-partitioned
    input (the elision flags carry the decision; this surfaces it)."""
    fired: List[str] = []
    for n in topo(root):
        if n.op != "join" or n.params.get("side_selected"):
            continue
        el, er = n.params.get("elide_left"), n.params.get("elide_right")
        if bool(el) == bool(er):
            continue
        n.params["side_selected"] = True
        kept = "right" if el else "left"
        kept_rows = n.inputs[1 if el else 0].est_rows
        other_rows = n.inputs[0 if el else 1].est_rows
        fired.append(
            f"join-side-selection: join({n.params['on']}) shuffles {kept} "
            f"side only (~{int(kept_rows)} rows; other side ~"
            f"{int(other_rows)} rows already placed)")
    return fired


# ---------------------------------------------------------------------- #
# Null-check elision (provably non-null inputs need no mask work)
# ---------------------------------------------------------------------- #
def _elide_nulls(e: Expr, nulls) -> Tuple[Expr, List[str]]:
    """Rewrite ``is_null(x)`` -> ``False`` and ``fill_null(x, f)`` -> ``x``
    when ``x`` is provably non-null given the input's nullable set.
    Soundness rests on the annotation being conservative: ``nullable()``
    over-approximates, so an elision here can never drop a real null."""
    if isinstance(e, BinOp):
        l, fl = _elide_nulls(e.left, nulls)
        r, fr = _elide_nulls(e.right, nulls)
        if fl or fr:
            return BinOp(e.op, l, r), fl + fr
        return e, []
    if isinstance(e, UnaryOp):
        op, f = _elide_nulls(e.operand, nulls)
        return (UnaryOp(e.op, op), f) if f else (e, [])
    if isinstance(e, IsNull):
        op, f = _elide_nulls(e.operand, nulls)
        if not op.nullable(nulls):
            return Lit(False), f + [f"is_null({op!r}) is always false"]
        return (IsNull(op), f) if f else (e, [])
    if isinstance(e, FillNull):
        op, fo = _elide_nulls(e.operand, nulls)
        fill, ff = _elide_nulls(e.fill, nulls)
        if not op.nullable(nulls):
            return op, fo + ff + [f"fill_null({op!r}, ...) is an identity"]
        return (FillNull(op, fill), fo + ff) if fo or ff else (e, [])
    return e, []


def elide_null_checks(root: LogicalNode) -> List[str]:
    """Drop ``is_null`` / ``fill_null`` over provably non-null expressions
    (scan nullability threaded through ``LogicalNode.nulls``), so queries
    written defensively against nullable schemas compile to zero mask work
    on clean data."""
    fired: List[str] = []
    for n in topo(root):
        nulls = n.inputs[0].nulls if n.inputs else frozenset()
        if n.op == "filter":
            e, hits = _elide_nulls(n.params["expr"], nulls)
            if hits:
                n.params["expr"] = e
                fired.extend(f"null-elision: {h} (filter)" for h in hits)
        elif n.op == "with_columns":
            exprs, changed = {}, []
            for name, ex in n.params["exprs"].items():
                ne, hits = _elide_nulls(ex, nulls)
                exprs[name] = ne
                changed.extend(hits)
            if changed:
                # copy before mutating: the inner dict may be shared with
                # the user's plan tree (from_plan shallow-copies params)
                n.params = dict(n.params)
                n.params["exprs"] = exprs
                fired.extend(f"null-elision: {h} (with_columns)"
                             for h in changed)
    return fired


# ---------------------------------------------------------------------- #
# Conjunction splitting + predicate pushdown
# ---------------------------------------------------------------------- #
def _pred_cols(node: LogicalNode) -> Optional[Tuple[str, ...]]:
    """Columns the filter's expression reads; None = unknown (opaque)."""
    cols = node.params["expr"].columns()
    return None if cols is None else tuple(sorted(cols))


def split_conjunctions(root: LogicalNode) -> List[str]:
    """``filter(a & b)`` directly above a communication boundary becomes
    ``filter(a)`` over ``filter(b)`` so pushdown can route each conjunct
    independently (e.g. into different join inputs).  Sound only for
    provably boolean conjuncts (`&` on integers is bitwise).  Conjuncts
    that end up adjacent after the fixpoint are re-fused, so a split that
    enabled no pushdown costs nothing."""
    fired: List[str] = []
    for n in topo(root):
        if n.op != "filter" or n.inputs[0].op not in COMM_OPS:
            continue
        e = n.params["expr"]
        if not (isinstance(e, BinOp) and e.op == "&" and e.is_boolean()):
            continue
        inner = LogicalNode("filter", [n.inputs[0]], {"expr": e.right})
        n.params = {"expr": e.left}
        n.inputs = [inner]
        fired.append(f"split-conjunction: filter[{e!r}] split for "
                     f"independent pushdown")
    return fired


def fuse_adjacent_filters(root: LogicalNode) -> None:
    """Re-merge stacked filters into one conjunction (post-fixpoint: undoes
    conjunction splits that enabled no pushdown, saving a compaction)."""
    ncons = consumers(root)
    for n in topo(root):
        while (n.op == "filter" and n.inputs[0].op == "filter"
               and ncons.get(n.inputs[0].nid, 0) == 1):
            inner = n.inputs[0]
            n.params = {"expr": n.params["expr"] & inner.params["expr"]}
            n.inputs = [inner.inputs[0]]


def push_predicates(root: LogicalNode) -> List[str]:
    fired: List[str] = []
    ncons = consumers(root)
    for n in topo(root):
        if n.op != "filter":
            continue
        child = n.inputs[0]
        if ncons.get(child.nid, 0) != 1:
            continue  # rewiring a shared node would change its other users
        if child.op in ("shuffle", "sort"):
            # An explicit dest array is row-aligned with the pre-filter
            # table, and an explicit out_capacity makes the overflow cut
            # observable — both pin the filter above the shuffle.
            if "dest" in child.params or "out_capacity" in child.params:
                continue
            # filter(shuffle(x)) -> shuffle(filter(x)): swap the two nodes'
            # identities so parents of the filter need no rewiring.
            n.op, child.op = child.op, n.op
            n.params, child.params = child.params, n.params
            fired.append(f"predicate-pushdown: filter moved below "
                         f"{n.op}")
        elif child.op == "with_columns":
            cols = _pred_cols(n)
            if cols is None or set(cols) & set(child.params["exprs"]):
                continue  # predicate reads an assigned column
            n.op, child.op = child.op, n.op
            n.params, child.params = child.params, n.params
            fired.append("predicate-pushdown: filter moved below "
                         "with_columns")
        elif child.op == "groupby":
            cols = _pred_cols(n)
            if cols is None or not set(cols) <= set(child.params["keys"]):
                continue  # predicate reads aggregate outputs
            n.op, child.op = child.op, n.op
            n.params, child.params = child.params, n.params
            fired.append("predicate-pushdown: key-only filter moved below "
                         "groupby")
        elif child.op == "join":
            cols = _pred_cols(n)
            if cols is None:
                continue
            jp = child.params
            lschema = set(child.inputs[0].schema)
            rschema = set(child.inputs[1].schema)
            if set(cols) <= lschema:
                side = 0
            elif set(cols) <= rschema and not set(cols) & lschema:
                side = 1
            else:
                continue
            pushed = LogicalNode("filter", [child.inputs[side]],
                                 dict(n.params))
            # the filter node becomes the join; the old join node is retired
            # into the pushed position via fresh node to preserve sharing
            n.op = "join"
            n.params = jp
            n.inputs = list(child.inputs)
            n.inputs[side] = pushed
            fired.append(
                f"predicate-pushdown: filter on ({','.join(cols)}) moved "
                f"into join {'left' if side == 0 else 'right'} input")
    return fired


# ---------------------------------------------------------------------- #
# Projection pushdown (dead-column elimination at comm boundaries)
# ---------------------------------------------------------------------- #
def _required_from(node: LogicalNode, required: Set[str], i: int) -> Set[str]:
    """Columns ``node`` needs from input ``i`` to produce ``required``."""
    p = node.params
    if node.op in ("scan",):
        return set()
    if node.op in ("project", "noop"):
        return set(required)
    if node.op == "filter":
        cols = node.params["expr"].columns()
        if cols is None:
            return set(node.inputs[i].schema)  # opaque predicate: keep all
        return set(required) | set(cols)
    if node.op == "with_columns":
        # conservative: every assignment's inputs stay live until
        # prune_dead_assignments drops assignments nobody consumes
        need = set(required) - set(p["exprs"])
        for expr in p["exprs"].values():
            cols = expr.columns()
            if cols is None:
                return set(node.inputs[i].schema)
            need |= cols
        return need
    if node.op == "add_scalar":
        cols = p.get("cols")
        return set(required) | (set(cols) if cols else set())
    if node.op == "recode":
        # the remapped columns stay live (the gather table references them)
        return set(required) | set(p["cols"])
    if node.op == "shuffle":
        return set(required) | set(p["key_cols"])
    if node.op == "sort":
        return set(required) | set(p["by"])
    if node.op == "groupby":
        return set(p["keys"]) | set(p["aggs"])
    if node.op == "join":
        on = p["on"]
        left = set(node.inputs[0].schema)
        if i == 0:
            out = (required & left) | {on}
            for name in node.inputs[1].schema:
                # keep a colliding left column alive when its suffixed right
                # twin is required, so the suffix assignment stays stable
                if name != on and name in left and name + "_r" in required:
                    out.add(name)
            return out
        out: Set[str] = {on}
        for name in node.inputs[1].schema:
            if name == on:
                continue
            produced = name if name not in left else name + "_r"
            if produced in required:
                out.add(name)
        return out
    raise ValueError(node.op)


def _required_sets(root: LogicalNode) -> Tuple[List[LogicalNode],
                                               Dict[int, Set[str]]]:
    """Backward liveness: nid -> columns any consumer needs from that node."""
    order = topo(root)
    required: Dict[int, Set[str]] = {root.nid: set(root.schema)}
    for n in reversed(order):
        req = required.setdefault(n.nid, set(n.schema))
        for i, inp in enumerate(n.inputs):
            required.setdefault(inp.nid, set()).update(
                _required_from(n, req, i))
    return order, required


def prune_dead_assignments(root: LogicalNode) -> List[str]:
    """Drop ``with_columns`` assignments whose target no consumer reads, so
    their input columns stop pinning liveness (runs before projection
    pushdown in each pass; a fully-pruned node degenerates to a noop)."""
    fired: List[str] = []
    order, required = _required_sets(root)
    for n in order:
        if n.op != "with_columns":
            continue
        exprs = n.params["exprs"]
        dead = sorted(set(exprs) - required[n.nid])
        if not dead:
            continue
        # copy before mutating: from_plan shallow-copies params, so the
        # inner dict is still shared with the user's plan tree
        n.params["exprs"] = {name: e for name, e in exprs.items()
                             if name not in dead}
        fired.append(f"dead-assignment: with_columns drops unused "
                     f"[{','.join(dead)}]")
        if not n.params["exprs"]:
            n.op = "noop"
            n.params = {"note": "with_columns pruned empty"}
    return fired


def push_projections(root: LogicalNode) -> List[str]:
    fired: List[str] = []
    order, required = _required_sets(root)
    for n in order:
        if n.op not in COMM_OPS:
            continue
        for i, inp in enumerate(n.inputs):
            live = required[inp.nid] & set(inp.schema)
            if not live or live >= set(inp.schema):
                continue
            dropped = sorted(set(inp.schema) - live)
            if inp.op == "project":
                inp.params["cols"] = tuple(sorted(live))
            else:
                n.inputs[i] = LogicalNode(
                    "project", [inp], {"cols": tuple(sorted(live))})
            fired.append(
                f"projection-pushdown: drop [{','.join(dropped)}] before "
                f"{n.op}")
    return fired


# ---------------------------------------------------------------------- #
# Pre-aggregation pushdown
# ---------------------------------------------------------------------- #
def push_preaggregation(root: LogicalNode) -> List[str]:
    fired: List[str] = []
    for n in topo(root):
        p = n.params
        if (n.op != "groupby" or p.get("elide_shuffle")
                or "pre_aggregate" in p):
            continue
        # _normalize accepts only algebraic aggs, so decomposition is safe.
        p["pre_aggregate"] = True
        keys = ",".join(p["keys"])
        fired.append(
            f"pre-aggregation: groupby({keys}) aggregates locally before "
            f"its shuffle (one row per rank-group on the wire)")
    return fired


def prune_identity_projects(root: LogicalNode) -> None:
    """Unlink projections that select their input's full schema (left
    behind when later passes narrow the schemas upstream of them)."""
    for n in topo(root):
        for i, inp in enumerate(n.inputs):
            if (inp.op == "project"
                    and set(inp.params["cols"]) == set(inp.inputs[0].schema)):
                n.inputs[i] = inp.inputs[0]


# ---------------------------------------------------------------------- #
# Fixpoint loop
# ---------------------------------------------------------------------- #
RULES = (elide_null_checks, elide_shuffles, select_join_sides,
         split_conjunctions, push_predicates, prune_dead_assignments,
         push_projections, push_preaggregation)


def optimize(root: LogicalNode, catalog=None,
             max_passes: int = 8) -> Tuple[LogicalNode, List[str]]:
    """Run all rules to a fixpoint; returns (root, fired descriptions)."""
    annotate(root, catalog)
    fired: List[str] = []
    for _ in range(max_passes):
        pass_fired: List[str] = []
        for rule in RULES:
            hits = rule(root)
            if hits:
                pass_fired.extend(hits)
                annotate(root)  # refresh properties for downstream rules
        if not pass_fired:
            break
        fired.extend(pass_fired)
    fuse_adjacent_filters(root)
    prune_identity_projects(root)
    annotate(root)
    return root, fired
