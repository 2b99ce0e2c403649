"""Lowering: logical DAG -> staged physical plan -> CylonEnv execution.

The torch counterpart of ``repro.planner.physical``.  A *stage* is a
maximal set of operators executable without crossing a communication
boundary (the paper's §III-B coalescing, made explicit).  The stage cache
is keyed by a **structural fingerprint** of the plan, so two separately
built but identical plans share one cache entry per env.

Execution modes:

* ``bsp``        — the entire plan in ONE ``env.run`` dispatch,
* ``bsp_staged`` — one dispatch per stage, with a device synchronization
                   (the host round-trip) at every communication boundary,
* ``amt``        — one dispatch per operator, shuffles implemented as
                   allgather-then-select (the Dask/Ray object-store
                   pattern, O(p·data)).

``eval_node`` and everything below it keep row counts on the device: no
tensor is read back to the host until a stage has returned.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..comm import Communicator
from ..dataframe import ops_local
from ..dataframe.groupby import (_normalize, finalize_groupby,
                                 nullable_agg_cols)
from ..dataframe.groupby import groupby as df_groupby
from ..dataframe.shuffle import ShuffleStats, hash_dest
from ..dataframe.shuffle import shuffle as df_shuffle
from ..dataframe.sort import _range_dest
from ..dataframe.sort import sort as df_sort
from ..dataframe.table import Table
from ..expr import token as _token
from ..faults import CapacityOverflow, OverflowPolicy, resolve_overflow
from ..nulls import mask_name
from .logical import LogicalNode, topo

#: param keys that are operator semantics, not shuffle kwargs
_SEMANTIC = {
    "join": ("on", "out_capacity", "shuffle_out_capacity", "elide_left",
             "elide_right", "side_selected", "morsel_out_capacity"),
    "groupby": ("keys", "aggs", "elide_shuffle", "pre_aggregate"),
    "sort": ("by", "elide_shuffle"),
    "shuffle": ("key_cols",),
}


# ---------------------------------------------------------------------- #
# Structural fingerprint
# ---------------------------------------------------------------------- #
def fingerprint(root: LogicalNode) -> str:
    """Structural hash: equal for identically-shaped plans regardless of
    node identity / construction order."""
    idx: Dict[int, int] = {}
    parts: List[str] = []
    for n in topo(root):
        idx[n.nid] = len(idx)
        params = ",".join(f"{k}={_token(v)}" for k, v in sorted(n.params.items()))
        parts.append(f"{n.op}({params})<-{[idx[i.nid] for i in n.inputs]}")
    return hashlib.sha1("\n".join(parts).encode()).hexdigest()


# ---------------------------------------------------------------------- #
# Physical plan
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class PhysicalPlan:
    root: LogicalNode
    order: List[LogicalNode]              # full topological order
    stage_of: Dict[int, int]              # nid -> stage index
    num_stages: int
    num_shuffles: int
    fingerprint: str
    fired: Tuple[str, ...] = ()           # optimizer rules that fired

    @property
    def scan_names(self) -> List[str]:
        return sorted({n.params["name"] for n in self.order
                       if n.op == "scan"})

    def shuffle_labels(self) -> List[str]:
        """Static labels for every shuffle executed, in topo order."""
        return [label for n in self.order for label in node_stat_labels(n)
                if not label.endswith(":overflow")]


def lower(root: LogicalNode, fired: Sequence[str] = ()) -> PhysicalPlan:
    order = topo(root)
    stage_of: Dict[int, int] = {}
    for n in order:
        stage_of[n.nid] = max(
            (stage_of[i.nid] + (1 if i.is_comm() else 0) for i in n.inputs),
            default=0)
    num_stages = max(stage_of.values(), default=0) + 1
    num_shuffles = sum(n.shuffle_count() for n in order)
    return PhysicalPlan(root, order, stage_of, num_stages, num_shuffles,
                        fingerprint(root), tuple(fired))


# ---------------------------------------------------------------------- #
# Shuffle implementations (direct vs the AMT object-store baseline)
# ---------------------------------------------------------------------- #
def shuffle_allgather(table: Table, comm: Communicator,
                      key_cols=None, dest=None, out_capacity=None, **_):
    """Every rank receives ALL rows and keeps those routed to it.

    Models Dask partd / Ray object-store data sharing: data is published
    globally rather than routed, costing O(p·rows) bandwidth per rank.
    """
    p = comm.size()
    cap = table.capacity
    out_cap = out_capacity or cap
    valid = table.valid_mask()
    if dest is None:
        dest = hash_dest(table, key_cols, p)
    dest = torch.where(valid, dest.to(torch.int32), p)

    # every rank sees every rank's rows (all_gather gives (p, p, cap));
    # rank r keeps the rows routed to it, in (source rank, row) order.
    # One source block at a time bounds the index temporaries to (p, cap).
    rank = comm.rank(table.device)
    g_dest = comm.all_gather(dest)
    out_size = min(p * cap, out_cap)
    order = torch.zeros((p, out_size + 1), dtype=torch.int64,
                        device=table.device)
    n_keep = torch.zeros((p,), dtype=torch.int64, device=table.device)
    rows = torch.arange(cap, device=table.device)
    for src in range(p):
        keep = g_dest[:, src] == rank[:, None]
        pos = n_keep[:, None] + torch.cumsum(keep, dim=1) - 1
        pos = torch.where(keep & (pos < out_size), pos, out_size)
        order.scatter_(1, pos, (src * cap + rows).expand(p, cap))
        n_keep += keep.sum(dim=1)
    # slots past the kept rows keep index 0; mask_padding zeroes them
    order = order[:, :out_size]
    ridx = torch.arange(p, device=table.device)[:, None]
    cols = {}
    for name, col in table.columns.items():
        cols[name] = comm.all_gather(col)[ridx, order // cap, order % cap]
    sent = torch.zeros((p, p + 1), dtype=torch.int32,
                       device=table.device).scatter_add_(
        1, dest.to(torch.int64), torch.ones_like(dest))[:, :p]
    stats = ShuffleStats(sent, sent,
                         torch.zeros((p,), dtype=torch.int32,
                                     device=table.device),
                         torch.clamp(n_keep - out_cap, min=0).to(torch.int32),
                         shuffle_impl="allgather")
    return (Table(cols, torch.clamp(n_keep, max=out_cap).to(torch.int32))
            .mask_padding(), stats)


def _row_bytes(table: Table) -> int:
    return sum(v.element_size() * math.prod(v.shape[2:])
               for v in table.columns.values())


def _stat_vec(st: ShuffleStats, width: int) -> torch.Tensor:
    """(p, 3): per rank (rows sent, bytes sent, rows dropped) — the
    per-shuffle stats triple collected in the stage and summed on the
    host."""
    rows = st.sent_counts.sum(dim=1, dtype=torch.int64)
    dropped = (st.send_dropped + st.recv_dropped).to(torch.int64)
    return torch.stack([rows, rows * width, dropped], dim=1)


# ---------------------------------------------------------------------- #
# Per-shuffle stat attribution (host-side labels for the in-stage stats
# triples, reconstructed from the static plan in dispatch order)
# ---------------------------------------------------------------------- #
def node_stat_labels(node: LogicalNode) -> List[str]:
    """Stat labels ``eval_node`` appends for one node, in append order:
    one per shuffle, plus a join's ``:overflow`` entry (local join output
    capacity pressure, zero wire bytes)."""
    p = node.params
    if node.op == "shuffle":
        return [f"shuffle({','.join(p['key_cols'])})"]
    if node.op == "join":
        labels = []
        if not p.get("elide_left"):
            labels.append(f"join({p['on']}):left")
        if not p.get("elide_right"):
            labels.append(f"join({p['on']}):right")
        labels.append(f"join({p['on']}):overflow")
        return labels
    if node.op == "groupby" and not p.get("elide_shuffle"):
        return [f"groupby({','.join(p['keys'])})"]
    if node.op == "sort" and not p.get("elide_shuffle"):
        return [f"sort({','.join(p['by'])})"]
    return []


def plan_stat_labels(nodes: Sequence[LogicalNode]) -> List[str]:
    return [label for n in nodes for label in node_stat_labels(n)]


def pair_stat_labels(labels: Sequence[str], arrays: Sequence[Any]
                     ) -> List[Tuple[str, Any]]:
    """Zip host-side labels with the in-stage stat arrays; falls back
    to positional labels on a mismatch rather than mis-attributing."""
    if len(labels) != len(arrays):
        labels = [f"stats[{i}]" for i in range(len(arrays))]
    return list(zip(labels, arrays))


@dataclasses.dataclass
class ShuffleRecord:
    """Aggregated per-label shuffle accounting with per-rank attribution."""

    label: str
    rows: int
    bytes: int
    dropped: int
    per_rank_rows: Tuple[int, ...]
    per_rank_dropped: Tuple[int, ...]


def build_shuffle_records(pairs: Sequence[Tuple[str, Any]]
                          ) -> List[ShuffleRecord]:
    """Aggregate labeled (p, 3) stat arrays by label."""
    agg: Dict[str, np.ndarray] = {}
    for label, a in pairs:
        a = np.asarray(a.cpu()).reshape(-1, 3).astype(np.int64)
        agg[label] = agg[label] + a if label in agg else a.copy()
    return [ShuffleRecord(label, int(a[:, 0].sum()), int(a[:, 1].sum()),
                          int(a[:, 2].sum()), tuple(int(x) for x in a[:, 0]),
                          tuple(int(x) for x in a[:, 2]))
            for label, a in agg.items()]


def describe_drops(records: Sequence[ShuffleRecord], limit: int = 6) -> str:
    """Name the op labels and ranks where capacity pressure dropped rows."""
    offenders = [(r.label, rank, d)
                 for r in records
                 for rank, d in enumerate(r.per_rank_dropped) if d]
    parts = [f"{label} @ rank {rank}: {d} rows"
             for label, rank, d in offenders[:limit]]
    if len(offenders) > limit:
        parts.append(f"... {len(offenders) - limit} more")
    return "; ".join(parts)


# ---------------------------------------------------------------------- #
# Node evaluation (batched over ranks; shared by all modes)
# ---------------------------------------------------------------------- #
def _shuffle_kw(node: LogicalNode) -> Dict[str, Any]:
    keep = _SEMANTIC.get(node.op, ())
    return {k: v for k, v in node.params.items()
            if k not in keep and k not in ("elided", "note", "expr", "exprs")}


def _recode_tables(node: LogicalNode, device: torch.device,
                   consts: Optional[Dict[int, Dict[str, torch.Tensor]]]
                   ) -> Dict[str, torch.Tensor]:
    """A ``recode`` node's gather tables on ``device``.  ``consts`` lives
    as long as the built stage callable, so each table moves to the device
    once per stage, not once per call."""
    if consts is None:
        consts = {}
    if node.nid not in consts:
        consts[node.nid] = {
            c: torch.as_tensor(np.asarray(m), dtype=torch.int32,
                               device=device)
            for c, m in node.params["cols"].items()}
    return consts[node.nid]


def eval_node(node: LogicalNode, comm: Communicator,
              values: Dict[int, Table], tables: Dict[str, Table],
              shuffle_mode: str,
              stats_out: Optional[List[Tuple[str, torch.Tensor]]] = None,
              shuffle_impl: str = "radix", a2a_chunks: int = 1,
              consts: Optional[Dict[int, Dict[str, torch.Tensor]]] = None
              ) -> Table:
    p = node.params
    ins = [values[i.nid] for i in node.inputs]
    shuffle_fn = df_shuffle if shuffle_mode == "direct" else shuffle_allgather

    def run_shuffle(label: str, table: Table, **kw) -> Table:
        out, st = shuffle_fn(table, comm, label=label, **kw)
        if stats_out is not None:
            stats_out.append((label, _stat_vec(st, _row_bytes(table))))
        return out

    if node.op == "scan":
        return tables[p["name"]]
    if node.op == "noop":
        return ins[0]
    if node.op == "project":
        # masks ride along with their base columns (never named explicitly)
        cols = list(p["cols"])
        cols += [mask_name(c) for c in p["cols"]
                 if mask_name(c) in ins[0].columns]
        return ins[0].select(cols)
    if node.op == "filter":
        return ops_local.filter_expr(ins[0], p["expr"])
    if node.op == "with_columns":
        return ops_local.with_columns(ins[0], p["exprs"])
    if node.op == "add_scalar":
        return ops_local.add_scalar(ins[0], p["value"], p.get("cols"))
    if node.op == "recode":
        return ops_local.recode(
            ins[0], _recode_tables(node, ins[0].device, consts))

    kw = _shuffle_kw(node)
    if shuffle_mode == "direct":
        # plan-level defaults; per-node params (Plan.shuffle(impl=...,
        # a2a_chunks=...)) take precedence
        kw.setdefault("impl", shuffle_impl)
        kw.setdefault("a2a_chunks", a2a_chunks)
    else:
        kw.pop("impl", None)
        kw.pop("a2a_chunks", None)
        kw.pop("debug_overflow", None)
    if node.op == "shuffle":
        out_cap = kw.pop("out_capacity", None)
        return run_shuffle(f"shuffle({','.join(p['key_cols'])})", ins[0],
                           key_cols=p["key_cols"], out_capacity=out_cap, **kw)

    if node.op == "join":
        on = p["on"]
        l, r = ins
        jkw = {k: v for k, v in kw.items() if k != "out_capacity"}
        if "shuffle_out_capacity" in p:  # receive headroom for skewed keys
            jkw["out_capacity"] = p["shuffle_out_capacity"]
        if not p.get("elide_left"):
            l = run_shuffle(f"join({on}):left", l, key_cols=[on], **jkw)
        if not p.get("elide_right"):
            r = run_shuffle(f"join({on}):right", r, key_cols=[on], **jkw)
        if stats_out is not None:
            out, ov = ops_local.join_local(l, r, on,
                                           out_capacity=p.get("out_capacity"),
                                           with_overflow=True)
            z = torch.zeros_like(ov, dtype=torch.int64)
            stats_out.append((f"join({on}):overflow",
                              torch.stack([z, z, ov.to(torch.int64)], dim=1)))
            return out
        return ops_local.join_local(l, r, on,
                                    out_capacity=p.get("out_capacity"))

    if node.op == "groupby":
        keys, aggs = p["keys"], p["aggs"]
        physical, post = _normalize(aggs)
        nullable = nullable_agg_cols(ins[0], physical)
        if p.get("elide_shuffle"):
            # input already co-partitioned on the keys: local-only groupby
            final = ops_local.groupby_local(ins[0], keys, physical)
            return finalize_groupby(final, keys, post, nullable)
        if shuffle_mode == "direct":
            pre = bool(p.get("pre_aggregate", False))
            out, st = df_groupby(ins[0], comm, keys, aggs,
                                 pre_aggregate=pre,
                                 label=f"groupby({','.join(keys)})", **kw)
            if stats_out is not None:
                if pre:
                    # the wire carries keys + stage-1 partial-agg columns
                    width = sum(ins[0].columns[k].element_size()
                                for k in keys)
                    for col, names in physical.items():
                        width += sum(4 if a == "count"
                                     else ins[0].columns[col].element_size()
                                     for a in names)
                else:
                    width = _row_bytes(ins[0])
                stats_out.append((f"groupby({','.join(keys)})",
                                  _stat_vec(st, width)))
            return out
        # AMT path: ship raw rows (Dask-style task granularity, no pre-agg)
        shuffled = run_shuffle(f"groupby({','.join(keys)})", ins[0],
                               key_cols=list(keys),
                               **{k: v for k, v in kw.items()
                                  if k != "pre_aggregate"})
        final = ops_local.groupby_local(shuffled, keys, physical)
        return finalize_groupby(final, keys, post, nullable)

    if node.op == "sort":
        by = p["by"]
        if p.get("elide_shuffle"):
            return ops_local.sort_local(ins[0], by)
        if shuffle_mode == "direct":
            out, st = df_sort(ins[0], comm, by,
                              label=f"sort({','.join(by)})", **kw)
            if stats_out is not None:
                stats_out.append((f"sort({','.join(by)})",
                                  _stat_vec(st, _row_bytes(ins[0]))))
            return out
        dest = _range_dest(ins[0], by[0], comm, kw.pop("samples", 64))
        shuffled = run_shuffle(f"sort({','.join(by)})", ins[0], dest=dest,
                               **kw)
        return ops_local.sort_local(shuffled, by)

    raise ValueError(node.op)


# ---------------------------------------------------------------------- #
# Host-side execution
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class ExecStats:
    """Host-side observability for one plan execution."""

    mode: str
    num_stages: int
    num_shuffles: int
    dispatches: int
    rows_shuffled: int
    bytes_shuffled: int
    shuffle_labels: List[str]
    fired: Tuple[str, ...]
    shuffle_impl: str = "radix"   # bucketize path: radix | sorted | allgather
    a2a_chunks: int = 1           # all-to-all pipeline depth
    #: rows lost to capacity pressure anywhere in the plan (send buckets,
    #: receive tables, join output); 0 for a correctly-capacitated run
    rows_dropped: int = 0
    #: stage-cache traffic during this execution (CylonEnv counters delta)
    cache_hits: int = 0
    cache_misses: int = 0
    rows_read: int = 0        # rows entering the plan through its scans
    #: end-to-end wall time, the device synchronized at the end
    wall_time_s: float = 0.0
    #: per-dispatch-unit wall times: (unit label, seconds) — one per stage
    #: in bsp_staged, per operator in amt, one "program" entry in bsp
    stage_times: List[Tuple[str, float]] = \
        dataclasses.field(default_factory=list)
    #: per-shuffle-label accounting with per-rank attribution
    shuffle_records: List[ShuffleRecord] = \
        dataclasses.field(default_factory=list)


def check_scan_dictionaries(order: Sequence[LogicalNode],
                            tables: Dict[str, Any]) -> None:
    """Reject runtime tables whose dictionaries differ from compile time.

    Recode gather tables and lowered string literals are baked into the
    lowered plan from the *compile-time* catalog; running that plan
    against a table with a different dictionary would silently decode
    fabricated strings.
    """
    for n in order:
        if n.op != "scan":
            continue
        t = tables.get(n.params["name"])
        got = getattr(t, "dictionaries", None)
        if got is None:
            continue
        want = {c: d for c, d in n.dicts.items() if c in n.schema}
        if dict(got) != want:
            diff = sorted(set(got) ^ set(want)
                          | {c for c in set(got) & set(want)
                             if tuple(got[c]) != want[c]})
            raise ValueError(
                f"scan {n.params['name']!r}: table dictionaries for "
                f"{diff} differ from the ones this plan was compiled "
                f"against — re-run compile_plan/execute with the current "
                f"tables (recode tables and lowered string literals are "
                f"baked in at compile time)")


def attach_dictionaries(out, root: LogicalNode):
    """Re-attach host-side dictionaries to an execution result.

    Stages move int32 codes only; the annotated root knows which output
    columns are dictionary-encoded and by what dictionary
    (``LogicalNode.dicts``), so the host restores the metadata here.
    """
    if root.dicts and hasattr(out, "dictionaries"):
        live = set(getattr(out, "column_names", ()) or root.dicts)
        out.dictionaries = {c: d for c, d in root.dicts.items() if c in live}
    return out


def _sum_stats(collected) -> Tuple[int, int, int]:
    """``collected``: (p, 3) tensors -> (rows sent, bytes sent, dropped)."""
    tot = np.zeros((3,), np.int64)
    for a in collected:
        tot += np.asarray(a.cpu()).reshape(-1, 3).sum(axis=0)
    return int(tot[0]), int(tot[1]), int(tot[2])


def run_physical(pplan: PhysicalPlan, env, tables: Dict[str, Any],
                 mode: str = "bsp", collect_stats: bool = False,
                 shuffle_impl: str = "radix", a2a_chunks: int = 1,
                 overflow: Optional[str] = None):
    """Execute a lowered plan against DistTables on a ``CylonEnv``.

    Returns a DistTable, or ``(DistTable, ExecStats)`` with
    ``collect_stats=True``.  ``shuffle_impl`` / ``a2a_chunks`` set the
    plan-wide shuffle defaults (per-node params override); both are part
    of the stage-cache key.  ``overflow`` (``raise | warn | degrade``)
    applies when stats show dropped rows; ``degrade`` needs the
    out-of-core executor, not ported yet, so it raises
    ``CapacityOverflow``.
    """
    ovf = resolve_overflow(overflow)
    names = pplan.scan_names
    missing = [n for n in names if n not in tables]
    if missing:
        raise KeyError(f"plan scans missing from tables: {missing}")
    check_scan_dictionaries(pplan.order, tables)
    root = pplan.root
    order = pplan.order
    fp = pplan.fingerprint
    shuffle_mode = "allgather" if mode == "amt" else "direct"
    # recode tables on the device, filled by the first call of each built
    # stage callable and kept with it
    consts: Dict[int, Dict[str, torch.Tensor]] = {}
    eval_kw = dict(shuffle_impl=shuffle_impl, a2a_chunks=a2a_chunks,
                   consts=consts)
    hits0, misses0 = env.cache_hits, env.cache_misses
    stage_times: List[Tuple[str, float]] = []
    t_query0 = time.perf_counter()

    def mk_stats(dispatches: int, pairs) -> ExecStats:
        env.synchronize()
        wall = time.perf_counter() - t_query0
        rows, byts, dropped = _sum_stats([pr[1] for pr in pairs])
        return ExecStats(mode, pplan.num_stages, pplan.num_shuffles,
                         dispatches, rows, byts, pplan.shuffle_labels(),
                         pplan.fired,
                         shuffle_impl=("allgather" if mode == "amt"
                                       else shuffle_impl),
                         a2a_chunks=a2a_chunks, rows_dropped=dropped,
                         cache_hits=env.cache_hits - hits0,
                         cache_misses=env.cache_misses - misses0,
                         rows_read=sum(tables[n].total_rows()
                                       for n in names),
                         wall_time_s=wall, stage_times=stage_times,
                         shuffle_records=build_shuffle_records(pairs))

    def finish(result, stats: ExecStats):
        """Apply the overflow policy to a finished stats run."""
        if not stats.rows_dropped:
            return result, stats
        where = describe_drops(stats.shuffle_records)
        if ovf == OverflowPolicy.WARN:
            warnings.warn(
                f"capacity pressure dropped {stats.rows_dropped} rows "
                f"({where}) — raise capacities", RuntimeWarning,
                stacklevel=3)
            return result, stats
        if ovf == OverflowPolicy.RAISE:
            raise CapacityOverflow(
                f"capacity pressure dropped {stats.rows_dropped} rows "
                f"({where}); raise bucket/out capacities")
        raise CapacityOverflow(
            f"capacity pressure dropped {stats.rows_dropped} rows ({where}); "
            f"overflow='degrade' re-executes out-of-core, and the "
            f"out-of-core executor is not ported yet — raise bucket/out "
            f"capacities, or pass overflow='warn' to keep the truncated "
            f"result")

    if mode == "bsp":
        def prog(ctx, *local_tables):
            tmap = dict(zip(names, local_tables))
            values: Dict[int, Table] = {}
            stats: List[Tuple[str, torch.Tensor]] = []
            for node in order:
                values[node.nid] = eval_node(
                    node, ctx.comm, values, tmap, "direct",
                    stats if collect_stats else None, **eval_kw)
            out = values[root.nid]
            if collect_stats:
                return out, tuple(a for _, a in stats)
            return out

        t0 = time.perf_counter()
        res = env.run(prog, *[tables[n] for n in names],
                      key=("bsp", fp, collect_stats, shuffle_impl,
                           a2a_chunks))
        if not collect_stats:
            return attach_dictionaries(res, root)
        env.synchronize()
        stage_times.append(("program", time.perf_counter() - t0))
        pairs = pair_stat_labels(plan_stat_labels(order), res[1])
        return finish(attach_dictionaries(res[0], root), mk_stats(1, pairs))

    if mode not in ("bsp_staged", "amt"):
        raise ValueError(f"unknown mode {mode!r}")

    values: Dict[int, Any] = {}
    collected: List[Tuple[str, Any]] = []
    if mode == "bsp_staged":
        groups: Dict[int, List[LogicalNode]] = {}
        for node in order:
            groups.setdefault(pplan.stage_of[node.nid], []).append(node)
        units = [groups[s] for s in sorted(groups)]
        unit_names = [f"stage:{s}" for s in sorted(groups)]
    else:
        units = [[node] for node in order]
        unit_names = [f"op:{i}:{n.op}" for i, n in enumerate(order)]

    for uidx, unit in enumerate(units):
        unit_ids = {n.nid for n in unit}
        ext: List[LogicalNode] = []
        for n in unit:
            for i in n.inputs:
                if i.nid not in unit_ids and i.nid not in {e.nid for e in ext}:
                    ext.append(i)
        scans = [n for n in unit if n.op == "scan"]
        later = set()
        for other in order:
            if other.nid not in unit_ids:
                later.update(i.nid for i in other.inputs)
        outs = [n for n in unit if n.nid == root.nid or n.nid in later]

        def prog(ctx, *local_ins, _unit=unit, _ext=ext, _scans=scans,
                 _outs=outs):
            vals = {e.nid: t for e, t in zip(_ext, local_ins)}
            tmap = dict(zip([s.params["name"] for s in _scans],
                            local_ins[len(_ext):]))
            stats: List[Tuple[str, torch.Tensor]] = []
            for node in _unit:
                vals[node.nid] = eval_node(
                    node, ctx.comm, vals, tmap, shuffle_mode,
                    stats if collect_stats else None, **eval_kw)
            out = tuple(vals[n.nid] for n in _outs)
            if collect_stats:
                return out, tuple(a for _, a in stats)
            return out

        args = [values[e.nid] for e in ext] + \
               [tables[s.params["name"]] for s in scans]
        t0 = time.perf_counter()
        res = env.run(prog, *args,
                      key=(mode, fp, uidx, collect_stats, shuffle_impl,
                           a2a_chunks))
        if collect_stats:
            out_tuple, unit_stats = res
            collected.extend(pair_stat_labels(plan_stat_labels(unit),
                                              unit_stats))
        else:
            out_tuple = res
        for n, val in zip(outs, out_tuple):
            values[n.nid] = val
        env.synchronize()  # completion barrier: the host round-trip
        stage_times.append((unit_names[uidx], time.perf_counter() - t0))

    result = attach_dictionaries(values[root.nid], root)
    if collect_stats:
        return finish(result, mk_stats(len(units), collected))
    return result
