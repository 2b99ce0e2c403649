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
from .physical import (ExecStats, PhysicalPlan, eval_node, fingerprint,
                       lower, run_physical, shuffle_allgather)
from .explain import explain, render


def compile_plan(plan, tables=None, optimize_plan: bool = True) -> PhysicalPlan:
    """Plan tree (or LogicalNode) -> optimized, lowered PhysicalPlan.

    Tables that carry string dictionaries are refused: dictionary
    resolution (``repro.planner.dictionary``) comes with the strings slice
    of the port."""
    catalog = build_catalog(tables)
    with_dicts = sorted(name for name, entry in catalog.items() if entry[2])
    if with_dicts:
        raise NotImplementedError(
            f"tables {with_dicts} carry string dictionaries; dictionary-"
            f"encoded string columns wait for the strings slice of the port")
    node = getattr(plan, "node", plan)
    if isinstance(node, LogicalNode):
        # copy: the rewrite passes below mutate in place
        root = annotate(copy_dag(node), catalog or None)
    else:
        root = from_plan(node, catalog)
    fired = []
    if optimize_plan:
        root, fired = optimize(root, catalog)
    return lower(root, fired)


__all__ = [
    "COMM_OPS", "LOCAL_OPS", "ExecStats", "LogicalNode", "Partitioning",
    "PhysicalPlan", "annotate", "build_catalog", "compile_plan", "copy_dag",
    "eval_node", "explain", "fingerprint", "from_plan", "lower", "optimize",
    "render", "run_physical", "shuffle_allgather", "topo",
]
