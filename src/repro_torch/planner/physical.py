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

Faults (``repro_torch.faults``) and hot-key salting (``repro_torch.adapt``)
are host-side: injection sites are visited before each dispatch, a failed
dispatch is replayed from the host-held inputs, and a salting decision
changes the stages only where it fired — its ``salt_cache_token`` then
joins the stage-cache key, which a run where nothing fired leaves as it
was.
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
from ..dataframe.groupby import (_normalize, finalize_groupby, hot_mask,
                                 nullable_agg_cols)
from ..dataframe.groupby import groupby as df_groupby
from ..dataframe.ops_local import hash_columns
from ..dataframe.shuffle import (ShuffleStats, _round_up, hash_dest,
                                 reset_overflow_warnings)
from ..dataframe.shuffle import shuffle as df_shuffle
from ..dataframe.sort import _range_dest
from ..dataframe.sort import sort as df_sort
from ..dataframe.table import Table
from ..expr import token as _token
from ..faults import (CapacityOverflow, OverflowPolicy, over_group,
                      resolve_faults, resolve_overflow, resolve_retry,
                      resolve_token, run_with_retries)
from ..nulls import mask_name
from ..obs.metrics import record_exec
from ..obs.trace import NULL_TRACER
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
    p, h = comm.size(), comm.ranks_held()
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
    order = torch.zeros((h, out_size + 1), dtype=torch.int64,
                        device=table.device)
    n_keep = torch.zeros((h,), dtype=torch.int64, device=table.device)
    rows = torch.arange(cap, device=table.device)
    for src in range(p):
        keep = g_dest[:, src] == rank[:, None]
        pos = n_keep[:, None] + torch.cumsum(keep, dim=1) - 1
        pos = torch.where(keep & (pos < out_size), pos, out_size)
        order.scatter_(1, pos, (src * cap + rows).expand(h, cap))
        n_keep += keep.sum(dim=1)
    # slots past the kept rows keep index 0; mask_padding zeroes them
    order = order[:, :out_size]
    ridx = torch.arange(h, device=table.device)[:, None]
    cols = {}
    for name, col in table.columns.items():
        cols[name] = comm.all_gather(col)[ridx, order // cap, order % cap]
    sent = torch.zeros((h, p + 1), dtype=torch.int32,
                       device=table.device).scatter_add_(
        1, dest.to(torch.int64), torch.ones_like(dest))[:, :p]
    stats = ShuffleStats(sent, sent,
                         torch.zeros((h,), dtype=torch.int32,
                                     device=table.device),
                         torch.clamp(n_keep - out_cap, min=0).to(torch.int32),
                         shuffle_impl="allgather")
    return (Table(cols, torch.clamp(n_keep, max=out_cap).to(torch.int32))
            .mask_padding(), stats)


def _row_bytes(table: Table) -> int:
    return sum(v.element_size() * math.prod(v.shape[2:])
               for v in table.columns.values())


def _stat_vec(st: ShuffleStats, width: int) -> torch.Tensor:
    """(h, 3): per held rank (rows sent, bytes sent, rows dropped) — the
    per-shuffle stats triple collected in the stage and summed on the
    host."""
    rows = st.sent_counts.sum(dim=1, dtype=torch.int64)
    dropped = (st.send_dropped + st.recv_dropped).to(torch.int64)
    return torch.stack([rows, rows * width, dropped], dim=1)


# ---------------------------------------------------------------------- #
# Per-shuffle stat attribution (host-side labels for the in-stage stats
# triples, reconstructed from the static plan in dispatch order)
# ---------------------------------------------------------------------- #
def node_stat_labels(node: LogicalNode, salt=None) -> List[str]:
    """Stat labels ``eval_node`` appends for one node, in append order:
    one per shuffle, plus a join's ``:overflow`` entry (local join output
    capacity pressure, zero wire bytes).  With a fired salting decision
    (``salt`` maps nid -> SaltDecision) a groupby additionally appends its
    ``:remerge`` partial shuffle and a join its ``:broadcast`` hot-row
    replication (before ``:overflow``)."""
    p = node.params
    salted = salt is not None and node.nid in salt
    if node.op == "shuffle":
        return [f"shuffle({','.join(p['key_cols'])})"]
    if node.op == "join":
        labels = []
        if not p.get("elide_left"):
            labels.append(f"join({p['on']}):left")
        if not p.get("elide_right"):
            labels.append(f"join({p['on']}):right")
        if salted:
            labels.append(f"join({p['on']}):broadcast")
        labels.append(f"join({p['on']}):overflow")
        return labels
    if node.op == "groupby" and not p.get("elide_shuffle"):
        label = f"groupby({','.join(p['keys'])})"
        return [label, f"{label}:remerge"] if salted else [label]
    if node.op == "sort" and not p.get("elide_shuffle"):
        return [f"sort({','.join(p['by'])})"]
    return []


def plan_stat_labels(nodes: Sequence[LogicalNode], salt=None) -> List[str]:
    return [label for n in nodes for label in node_stat_labels(n, salt)]


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
    #: morsel-executor segment index (None for in-core executions)
    segment: Optional[int] = None


def build_shuffle_records(pairs: Sequence[Tuple]) -> List[ShuffleRecord]:
    """Aggregate labeled (p, 3) stat tensors by (label, segment) — summing
    across repeated executions of the same plan node, e.g. one per morsel.
    ``pairs`` entries are ``(label, tensor)`` (in-core; segment None) or
    ``(label, tensor, segment)`` (morsel executor)."""
    agg: Dict[Tuple[str, Optional[int]], np.ndarray] = {}
    for pair in pairs:
        key = (pair[0], pair[2] if len(pair) > 2 else None)
        a = np.asarray(pair[1].cpu()).reshape(-1, 3).astype(np.int64)
        agg[key] = agg[key] + a if key in agg else a.copy()
    return [ShuffleRecord(label, int(a[:, 0].sum()), int(a[:, 1].sum()),
                          int(a[:, 2].sum()), tuple(int(x) for x in a[:, 0]),
                          tuple(int(x) for x in a[:, 2]), segment=seg)
            for (label, seg), a in agg.items()]


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


def emit_shuffle_events(tracer, pairs: Sequence[Tuple[str, Any]],
                        a2a_chunks: int) -> None:
    """Per-shuffle (and per all-to-all chunk) events under the currently
    open stage span.  The stage span times the device work; these carry
    data volumes, not durations."""
    for pair in pairs:
        label, a = pair[0], pair[1]
        a = np.asarray(a.cpu()).reshape(-1, 3)
        rows, byts, dropped = (int(a[:, 0].sum()), int(a[:, 1].sum()),
                               int(a[:, 2].sum()))
        with tracer.span(f"shuffle:{label}", "shuffle", rows=rows,
                         bytes=byts, dropped=dropped):
            if not label.endswith(":overflow"):
                for c in range(max(1, a2a_chunks)):
                    tracer.instant(f"a2a:{label}[chunk {c}]", "chunk",
                                   chunk=c, chunks=a2a_chunks,
                                   bytes=byts // max(1, a2a_chunks))


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
              consts: Optional[Dict[int, Dict[str, torch.Tensor]]] = None,
              salt=None) -> Table:
    p = node.params
    ins = [values[i.nid] for i in node.inputs]
    shuffle_fn = df_shuffle if shuffle_mode == "direct" else shuffle_allgather
    decision = salt.get(node.nid) if (salt and shuffle_mode == "direct") \
        else None

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
        if decision is not None and not p.get("elide_left") \
                and not p.get("elide_right"):
            return _eval_join_salted(node, comm, l, r, decision, jkw,
                                     stats_out)
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
        if (decision is not None and shuffle_mode == "direct"
                and not p.get("pre_aggregate")):
            return _eval_groupby_salted(node, comm, ins[0], decision, kw,
                                        stats_out)
        if shuffle_mode == "direct":
            pre = bool(p.get("pre_aggregate", False))
            out, st = df_groupby(ins[0], comm, keys, aggs,
                                 pre_aggregate=pre,
                                 label=f"groupby({','.join(keys)})", **kw)
            if stats_out is not None:
                # with pre-aggregation the wire carries keys + stage-1
                # partial-agg columns
                width = (_partial_width(ins[0], keys, physical) if pre
                         else _row_bytes(ins[0]))
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
# Salted evaluation (repro_torch.adapt; in-core, batched over ranks)
# ---------------------------------------------------------------------- #
def _partial_width(table: Table, keys, physical) -> int:
    """Bytes per row of a stage-1 partial: keys + partial-agg columns."""
    width = sum(table.columns[k].element_size() for k in keys)
    for col, names in physical.items():
        width += sum(4 if a == "count" else table.columns[col].element_size()
                     for a in names)
    return width


def _eval_groupby_salted(node: LogicalNode, comm: Communicator,
                         table: Table, decision, kw, stats_out) -> Table:
    """Two-shuffle salted groupby: salted row shuffle + stage-1 partials,
    then a tiny unsalted partial re-merge on each key's home rank.

    Both shuffles get full-table bucket/out capacities: the whole point of
    the decision is that one rank would otherwise receive ~everything, so
    per-destination "balanced share" sizing is exactly what we can't
    assume until the salt has done its job."""
    from ..dataframe.groupby import groupby_salted
    p = node.params
    keys = list(p["keys"])
    cap = table.capacity
    label = f"groupby({','.join(keys)})"
    skw = dict(kw, bucket_capacity=cap, label=label)
    skw["out_capacity"] = skw.get("out_capacity") or cap
    rkw = dict(kw, bucket_capacity=cap, out_capacity=cap,
               label=f"{label}:remerge")
    out, st1, st2 = groupby_salted(table, comm, keys, p["aggs"],
                                   decision.hot_hashes, decision.k,
                                   shuffle_kw=skw, remerge_kw=rkw)
    if stats_out is not None:
        physical, _ = _normalize(p["aggs"])
        stats_out.append((label, _stat_vec(st1, _row_bytes(table))))
        stats_out.append((f"{label}:remerge",
                          _stat_vec(st2, _partial_width(table, keys,
                                                        physical))))
    return out


def _eval_join_salted(node: LogicalNode, comm: Communicator,
                      l: Table, r: Table, decision, jkw, stats_out) -> Table:
    """Skew-mitigated hash join: hot probe rows stay on their source rank,
    hot build rows skip the hash shuffle (overflow bin, uncounted) and are
    broadcast-appended to every rank's build table instead — so each hot
    probe row meets every build row of its key locally, exactly once."""
    from ..dataframe.shuffle import replicate_hot_rows
    p = node.params
    on = p["on"]
    psize = comm.size()
    rank = comm.rank(l.device)[:, None]

    h_l, h_r = hash_columns(l, [on]), hash_columns(r, [on])
    hot_l = hot_mask(h_l, decision.hot_hashes)
    hot_r = hot_mask(h_r, decision.hot_hashes)
    dest_l = torch.where(hot_l, rank, (h_l % psize).to(torch.int32))
    dest_r = torch.where(hot_r, psize,
                         (h_r % psize).to(torch.int32))  # excluded

    # probe: the self-bucket must hold every hot row this rank keeps, and
    # the output every kept-hot + received-cold row
    lkw = dict(jkw, bucket_capacity=l.capacity)
    lkw["out_capacity"] = (lkw.get("out_capacity")
                           or _round_up(2 * l.capacity, 8))
    rkw = dict(jkw)
    rkw["out_capacity"] = rkw.get("out_capacity") or r.capacity

    l2, st_l = df_shuffle(l, comm, dest=dest_l,
                          label=f"join({on}):left", **lkw)
    r2, st_r = df_shuffle(r, comm, dest=dest_r,
                          label=f"join({on}):right", **rkw)
    r2, st_b = replicate_hot_rows(r, comm, hot_r, decision.hot_cap, r2)
    if stats_out is not None:
        stats_out.append((f"join({on}):left", _stat_vec(st_l, _row_bytes(l))))
        stats_out.append((f"join({on}):right",
                          _stat_vec(st_r, _row_bytes(r))))
        stats_out.append((f"join({on}):broadcast",
                          _stat_vec(st_b, _row_bytes(r))))
        out, ov = ops_local.join_local(l2, r2, on,
                                       out_capacity=p.get("out_capacity"),
                                       with_overflow=True)
        z = torch.zeros_like(ov, dtype=torch.int64)
        stats_out.append((f"join({on}):overflow",
                          torch.stack([z, z, ov.to(torch.int64)], dim=1)))
        return out
    return ops_local.join_local(l2, r2, on,
                                out_capacity=p.get("out_capacity"))


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
    #: source bytes of the scans' ingest provenance (Parquet/CSV files)
    bytes_read: int = 0
    # -- out-of-core morsel execution only -------------------------------- #
    morsel_rows: Optional[int] = None  # per-rank morsel capacity, None=in-core
    morsels: int = 0                   # morsel stage dispatches
    spill_bytes: int = 0               # valid rows written to host spill
    h2d_bytes: int = 0                 # host->device transfer bytes
    d2h_bytes: int = 0                 # device->host spill transfer bytes
    #: the bytes the port's D2H copies move: counts plus each rank's rows up
    #: to the fullest rank (``d2h_bytes`` counts whole columns, as the JAX
    #: package does)
    d2h_copied_bytes: int = 0
    #: end-to-end wall time, the device synchronized at the end
    wall_time_s: float = 0.0
    #: per-dispatch-unit wall times: (unit label, seconds) — one per stage
    #: in bsp_staged, per operator in amt, one "program" entry in bsp, per
    #: segment (plus resident builds) out-of-core
    stage_times: List[Tuple[str, float]] = \
        dataclasses.field(default_factory=list)
    #: per-shuffle-label accounting with per-rank attribution (summed over
    #: morsels)
    shuffle_records: List[ShuffleRecord] = \
        dataclasses.field(default_factory=list)
    # -- fault tolerance (repro_torch.faults) ----------------------------- #
    retries: int = 0           # dispatch units replayed after a fault
    degraded: int = 0          # capacity-degrade re-executions (overflow)
    faults_injected: int = 0   # faults the active FaultPlan fired this query
    # -- runtime skew mitigation (repro_torch.adapt) ---------------------- #
    adaptive: bool = False         # was the adaptive layer enabled
    salted_shuffles: int = 0       # shuffle boundaries that got salted
    splitter_refreshes: int = 0    # sort splitter re-samples that fired
    autotune_steps: int = 0        # tuner-chosen degrade replans
    #: one dict per fired mitigation ({"kind": "salted" | ...}) — the
    #: machine-readable trail EXPLAIN ANALYZE renders as annotations
    adapt_events: List[Dict[str, Any]] = \
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


def scan_read_stats(names: Sequence[str], tables: Dict[str, Any]
                    ) -> Tuple[int, int]:
    """(rows_read, bytes_read) across a plan's scan tables.

    Rows come from the holder's ``total_rows`` (host column dicts count
    none, as in the JAX package); bytes from the ``repro_torch.io``
    ingest provenance (``IngestInfo.bytes_read``) when the table was read
    from Parquet/CSV, 0 for tables built in memory."""
    rows = byts = 0
    for n in names:
        t = tables.get(n)
        if t is None:
            continue
        if callable(getattr(t, "total_rows", None)):
            rows += int(t.total_rows())
        prov = getattr(t, "provenance", None)
        if prov is not None:
            byts += int(prov.bytes_read)
    return rows, byts


def _world_stats(comm: Communicator, stats) -> Tuple[torch.Tensor, ...]:
    """A stage's (h, 3) stat triples as (p, 3), every rank's on each
    process (one gather for all of them): the records, drop counts and
    overflow decisions a process reads are then the same on every
    process of a group, and the stacked run's."""
    stats = tuple(stats)
    if not stats or comm.ranks_held() == comm.size():
        return stats
    return tuple(comm.world(torch.stack(stats, dim=1)).unbind(1))


def _sum_stats(collected) -> Tuple[int, int, int]:
    """``collected``: (p, 3) tensors -> (rows sent, bytes sent, dropped)."""
    tot = np.zeros((3,), np.int64)
    for a in collected:
        tot += np.asarray(a.cpu()).reshape(-1, 3).sum(axis=0)
    return int(tot[0]), int(tot[1]), int(tot[2])


def run_physical(pplan: PhysicalPlan, env, tables: Dict[str, Any],
                 mode: str = "bsp", collect_stats: bool = False,
                 shuffle_impl: str = "radix", a2a_chunks: int = 1,
                 morsel_rows: Optional[int] = None, tracer=None,
                 retries=None, timeout=None, overflow=None, faults=None,
                 scan_capacity: Optional[int] = None, adaptive=None,
                 **morsel_kw):
    """Execute a lowered plan against DistTables on a ``CylonEnv``.

    Returns a DistTable, or ``(DistTable, ExecStats)`` with
    ``collect_stats=True``.  ``shuffle_impl`` / ``a2a_chunks`` set the
    plan-wide shuffle defaults (per-node params override); both are part
    of the stage-cache key.

    ``tracer`` (a ``repro_torch.obs.Tracer``) records per-dispatch stage
    spans — each ends after the env's device is synchronized, so it
    covers the device work — plus per-shuffle data-volume events when
    stats are collected.  Tracing is host-side only: it is NOT part of
    any stage-cache key.  With ``collect_stats=True`` the execution is
    also folded into the process-global ``repro_torch.obs.METRICS``.

    ``morsel_rows`` switches to the out-of-core morsel executor
    (``planner.morsel.run_morsel``): the input is streamed through the
    stage DAG in fixed-capacity morsels and the result is returned as a
    host-resident ``core.store.SpillTable``.  Extra ``morsel_kw``
    (``capacity_factor``, ``samples``, ``debug_overflow``) are forwarded.
    In-core, ``SpillTable`` scans (``repro_torch.io`` ingest) are
    scattered onto the env's ranks with 2x headroom over a balanced split,
    or ``scan_capacity`` rows per rank; their provenance rides along for
    the scan read stats.  Over a process group each process builds the
    ranks it holds (``core.store.rescatter``), and every fault site visit
    ends in one agreement over the group (``faults.GroupFaults``).

    Fault tolerance (``repro_torch.faults``): ``retries`` (None | int |
    ``RetryPolicy``) replays failed dispatch units with exponential
    backoff; ``timeout`` (seconds or a ``CancellationToken``) fences every
    dispatch and backoff sleep; ``overflow`` (``raise | warn | degrade``,
    default ``degrade``) decides what to do when capacity pressure drops
    rows (observable in-core with ``collect_stats=True``; the morsel
    executor always counts): ``degrade`` replays the plan out-of-core
    until every row fits and re-scatters the result to a ``DistTable``.
    ``faults`` arms a deterministic ``FaultPlan`` (None consults
    ``REPRO_FAULTS``).  All of this is host-side: with injection
    disabled, stage-cache keys are identical to a run without it.

    ``adaptive`` (None | bool | dict | ``AdaptiveConfig``) gates runtime
    skew mitigation (``repro_torch.adapt``): hot-key salting at shuffle
    boundaries here, splitter refresh + morsel autotuning in the
    out-of-core executor.  Default on; a run where no mitigation fires
    uses exactly the ``adaptive=False`` stage-cache keys.
    """
    if morsel_rows is not None:
        from .morsel import run_morsel
        return run_morsel(pplan, env, tables, morsel_rows, mode=mode,
                          collect_stats=collect_stats,
                          shuffle_impl=shuffle_impl, a2a_chunks=a2a_chunks,
                          tracer=tracer, retries=retries, timeout=timeout,
                          overflow=overflow, faults=faults,
                          adaptive=adaptive, **morsel_kw)
    if morsel_kw:
        raise TypeError(f"unexpected kwargs without morsel_rows: "
                        f"{sorted(morsel_kw)}")
    reset_overflow_warnings()
    fr = resolve_faults(faults)
    policy = resolve_retry(retries)
    token = resolve_token(timeout)
    ovf = resolve_overflow(overflow)
    group = env.comm if env.ranks_held < env.parallelism else None
    fr, token = over_group(fr, token, group)
    counters = {"retries": 0}

    def _count_retry(attempt, exc):
        counters["retries"] += 1

    tr = tracer if tracer is not None else NULL_TRACER
    names = pplan.scan_names
    missing = [n for n in names if n not in tables]
    if missing:
        raise KeyError(f"plan scans missing from tables: {missing}")
    check_scan_dictionaries(pplan.order, tables)
    from ..core.store import SpillTable, _round8, rescatter
    spills = {n: tables[n] for n in names
              if isinstance(tables[n], SpillTable)}
    if spills:
        def _cap(s):
            if scan_capacity is not None:
                return scan_capacity
            return _round8(2 * -(-max(s.total_rows(), 1) // env.parallelism))
        tables = {**tables, **{
            n: rescatter(s, env.parallelism, device=env.device,
                         capacity=_cap(s), comm=group)
            for n, s in spills.items()}}
    root = pplan.root
    order = pplan.order
    fp = pplan.fingerprint
    shuffle_mode = "allgather" if mode == "amt" else "direct"
    # -- runtime skew detection (repro_torch.adapt) -- host-side sampling
    # of the (now device-resident) scan tables; an empty decision set
    # leaves every stage-cache key below exactly as adaptive=False would.
    # AMT shuffles are allgather-based (every rank sees all rows), which
    # is skew-immune by construction, so salting is direct-mode only.
    from ..adapt import resolve_adaptive
    from ..adapt.hotkeys import plan_salt_decisions, salt_cache_token
    acfg = resolve_adaptive(adaptive)
    adapt_events: List[Dict[str, Any]] = []
    salt = (plan_salt_decisions(order, tables, env.parallelism, acfg,
                                adapt_events)
            if shuffle_mode == "direct" else {})
    # recode tables on the device, filled by the first call of each built
    # stage callable and kept with it
    consts: Dict[int, Dict[str, torch.Tensor]] = {}
    eval_kw = dict(shuffle_impl=shuffle_impl, a2a_chunks=a2a_chunks,
                   consts=consts, salt=salt)
    hits0, misses0 = env.cache_hits, env.cache_misses
    timing = collect_stats or tr.enabled
    stage_times: List[Tuple[str, float]] = []
    t_query0 = time.perf_counter()

    def mk_stats(dispatches: int, pairs) -> ExecStats:
        env.synchronize()
        wall = time.perf_counter() - t_query0
        rows, byts, dropped = _sum_stats([pr[1] for pr in pairs])
        rows_read, bytes_read = scan_read_stats(names, tables)
        stats = ExecStats(mode, pplan.num_stages, pplan.num_shuffles,
                          dispatches, rows, byts, pplan.shuffle_labels(),
                          pplan.fired,
                          shuffle_impl=("allgather" if mode == "amt"
                                        else shuffle_impl),
                          a2a_chunks=a2a_chunks, rows_dropped=dropped,
                          cache_hits=env.cache_hits - hits0,
                          cache_misses=env.cache_misses - misses0,
                          rows_read=rows_read, bytes_read=bytes_read,
                          wall_time_s=wall, stage_times=stage_times,
                          shuffle_records=build_shuffle_records(pairs),
                          retries=counters["retries"],
                          faults_injected=(
                              fr.injected if group is None else int(
                                  group.gather_ints([fr.injected]).sum())),
                          adaptive=acfg.enabled,
                          salted_shuffles=len(salt),
                          adapt_events=list(adapt_events))
        record_exec(stats, fp, stats.wall_time_s)
        return stats

    def finish(result, stats: ExecStats):
        """Apply the overflow policy to a finished stats run: raise, warn
        once (attributed), or degrade — replay the whole plan out-of-core
        (drops are counted unconditionally there, and the morsel executor's
        own degrade loop shrinks morsels until everything fits), then
        re-scatter the spill back to a ``DistTable``."""
        if not stats.rows_dropped:
            return result, stats
        where = describe_drops(stats.shuffle_records)
        if ovf == OverflowPolicy.WARN:
            warnings.warn(
                f"capacity pressure dropped {stats.rows_dropped} rows "
                f"({where}) — raise capacities or use overflow='degrade'",
                RuntimeWarning, stacklevel=3)
            return result, stats
        if ovf == OverflowPolicy.RAISE:
            raise CapacityOverflow(
                f"capacity pressure dropped {stats.rows_dropped} rows "
                f"({where}); raise bucket/out capacities or use "
                f"overflow='degrade'")
        # degrade: the in-core capacities were wrong, so in-core replay
        # cannot help — stream the plan out-of-core instead, starting at
        # the scan tables' own per-rank capacity
        from .morsel import run_morsel
        caps = [t.capacity for t in (tables[n] for n in names)
                if hasattr(t, "capacity")]
        try:
            spill, d_stats = run_morsel(
                pplan, env, tables, max(caps) if caps else 128, mode="bsp",
                collect_stats=True, shuffle_impl=shuffle_impl,
                a2a_chunks=a2a_chunks, tracer=tr, retries=policy,
                timeout=token, overflow=OverflowPolicy.DEGRADE, faults=fr,
                adaptive=acfg)
        except ValueError as e:
            raise CapacityOverflow(
                f"capacity pressure dropped {stats.rows_dropped} rows "
                f"({where}) and the plan cannot degrade to out-of-core "
                f"execution ({e}); raise capacities or handle "
                f"overflow='raise'") from e
        out = attach_dictionaries(
            rescatter(spill, env.parallelism, device=env.device), root)
        d_stats.degraded += 1
        d_stats.retries += stats.retries
        d_stats.dispatches += stats.dispatches
        return out, d_stats

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
                return out, _world_stats(ctx.comm, (a for _, a in stats))
            return out

        with tr.span("stage:program", "stage", mode=mode,
                     stages=pplan.num_stages, dispatch=0) as sp:
            t0 = time.perf_counter()

            def dispatch():
                token.check("stage:program")
                fr.check("stage:launch", token=token, stage=0)
                if pplan.num_shuffles:
                    for c in range(max(1, a2a_chunks)):
                        fr.check("a2a:chunk", token=token, stage=0, chunk=c)
                return env.run(prog, *[tables[n] for n in names],
                               key=("bsp", fp, env.communicator_name,
                                    collect_stats, shuffle_impl, a2a_chunks)
                               + salt_cache_token(salt))

            res = run_with_retries(dispatch, policy=policy, token=token,
                                   tracer=tr, label="stage:program",
                                   on_retry=_count_retry)
            sp.set(compiled=env.cache_misses > misses0)
            if timing:
                env.synchronize()
                stage_times.append(("program", time.perf_counter() - t0))
            if not collect_stats:
                return attach_dictionaries(res, root)
            pairs = pair_stat_labels(plan_stat_labels(order, salt),
                                     res[1])
            if tr.enabled:
                emit_shuffle_events(tr, pairs, a2a_chunks)
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
                return out, _world_stats(ctx.comm, (a for _, a in stats))
            return out

        args = [values[e.nid] for e in ext] + \
               [tables[s.params["name"]] for s in scans]
        with tr.span(unit_names[uidx], "stage", mode=mode, dispatch=uidx,
                     ops=",".join(n.op for n in unit)) as sp:
            t0 = time.perf_counter()
            m0 = env.cache_misses
            has_comm = any(n.is_comm() for n in unit)
            unit_salt = salt_cache_token(salt, [n.nid for n in unit])

            def dispatch(_uidx=uidx, _args=args, _prog=prog,
                         _has_comm=has_comm, _usalt=unit_salt):
                token.check(unit_names[_uidx])
                fr.check("stage:launch", token=token, stage=_uidx)
                if _has_comm:
                    for c in range(max(1, a2a_chunks)):
                        fr.check("a2a:chunk", token=token, stage=_uidx,
                                 chunk=c)
                return env.run(_prog, *_args,
                               key=(mode, fp, _uidx, env.communicator_name,
                                    collect_stats, shuffle_impl, a2a_chunks)
                               + _usalt)

            res = run_with_retries(dispatch, policy=policy, token=token,
                                   tracer=tr, label=unit_names[uidx],
                                   on_retry=_count_retry)
            sp.set(compiled=env.cache_misses > m0)
            if collect_stats:
                out_tuple, unit_stats = res
                unit_pairs = pair_stat_labels(plan_stat_labels(unit, salt),
                                              unit_stats)
                collected.extend(unit_pairs)
            else:
                out_tuple = res
            for n, val in zip(outs, out_tuple):
                values[n.nid] = val
            env.synchronize()  # completion barrier: the host round-trip
            stage_times.append((unit_names[uidx], time.perf_counter() - t0))
            if collect_stats and tr.enabled:
                emit_shuffle_events(tr, unit_pairs, a2a_chunks)

    result = attach_dictionaries(values[root.nid], root)
    if collect_stats:
        return finish(result, mk_stats(len(units), collected))
    return result
