"""Partitioning-aware query optimizer for the distributed dataframe layer.

The torch counterpart of ``repro.planner``:

* ``logical``  — typed logical plan with per-node properties
                 (partitioning / est_rows / live columns),
* ``rules``    — rewrite rules: shuffle elision, join-side selection,
                 predicate & projection pushdown, pre-aggregation,
* ``physical`` — lowering to a stage DAG executed through ``CylonEnv.run``
                 with a structural-fingerprint stage cache,
* ``explain``  — EXPLAIN rendering of stages, properties, and fired rules.

``core.plan.execute`` lowers every plan through here.
"""

from .logical import (COMM_OPS, LOCAL_OPS, LogicalNode, Partitioning,
                      annotate, build_catalog, copy_dag, from_plan, topo)
from .rules import optimize
from .dictionary import DictTypeError, apply_dictionaries
from .physical import (ExecStats, PhysicalPlan, attach_dictionaries,
                       eval_node, fingerprint, lower, run_physical,
                       shuffle_allgather)
from .explain import explain, render


def compile_plan(plan, tables=None, optimize_plan: bool = True) -> PhysicalPlan:
    """Plan tree (or LogicalNode) -> optimized, lowered PhysicalPlan.

    Dictionary resolution (``planner.dictionary``: recode insertion for
    mismatched join dictionaries, string-literal lowering, validation) runs
    unconditionally — it is a correctness pass, not an optimization.
    """
    catalog = build_catalog(tables)
    node = getattr(plan, "node", plan)
    if isinstance(node, LogicalNode):
        # copy: the rewrite passes below mutate in place, and the caller's
        # DAG may be recompiled against different tables/dictionaries
        root = annotate(copy_dag(node), catalog or None)
    else:
        root = from_plan(node, catalog)
    fired = apply_dictionaries(root)
    if optimize_plan:
        root, opt_fired = optimize(root, catalog)
        fired = fired + opt_fired
    return lower(root, fired)


__all__ = [
    "COMM_OPS", "LOCAL_OPS", "DictTypeError", "ExecStats", "LogicalNode",
    "Partitioning", "PhysicalPlan", "annotate", "apply_dictionaries",
    "attach_dictionaries", "build_catalog", "compile_plan", "copy_dag",
    "eval_node", "explain", "fingerprint", "from_plan", "lower", "optimize",
    "render", "run_physical", "shuffle_allgather", "topo",
]
