"""Out-of-core morsel execution: stream datasets larger than device
capacity through the stage DAG.

The torch counterpart of ``repro.planner.morsel``.  The in-core executor
(``run_physical``) requires every partition to fit a fixed per-rank device
capacity.  ``run_morsel`` removes that bound: the streamed input lives in a
host-resident ``core.store.SpillTable`` and is driven through the plan in
fixed-capacity *morsels* — one built stage per plan segment, a cache hit
for every morsel after the first — with double-buffered host->device
transfer (``core.env.MorselSource``: pinned staging buffers and a copy
stream on a card) and device->host spill of each morsel's output.

Communication boundaries become external state transitions:

* **shuffle** — hash placement is row-wise, so each morsel's shuffle lands
  rows on their *final* rank; the host appends every rank's received rows
  to that rank's spill bucket.  No cross-morsel fixup is needed.
* **groupby** — each morsel emits mergeable partials (``{col}_{agg}``; mean
  stays sum+count) that are hash-placed like the rows they summarize, so
  all partials of a key share a rank.  The cross-morsel combiner
  sub-buckets each rank's spilled partials by key hash (the host numpy
  mirror of the device hash) so every key's partials meet exactly once on
  the device, then re-aggregates + finalizes per sub-bucket.
* **sort** — splitters are sampled ONCE from the segment's input spill and
  broadcast to every morsel, so all morsels agree on the rank->key-range
  map; morsels only *route* rows, and the host runs one stable vectorized
  sort per rank over the spilled range partition.  Cross-rank tie order
  follows the ``by`` columns only, exactly like the in-core sample sort.
* **join** — the build (right) side is evaluated once, shuffled to its
  final placement, and kept device-resident; the probe (left) side streams
  against it morsel by morsel.

Supported plan shape: a streamed operator chain from one scan to the root
(``inputs[0]`` edges), with tree-shaped build sides hanging off joins.
Explicit-``dest`` shuffles are row-aligned with the full table and cannot
stream.

Device memory is bounded by the *working capacity* ``W = capacity_factor x
morsel_rows`` (shuffle receive / join output headroom), the resident build
sides, and the groupby combine sub-bucket size — never by the streamed
input.  Capacity pressure drops are ALWAYS counted and what happens next is
the ``overflow=`` policy (``faults.OverflowPolicy``): the default
``degrade`` re-executes the overflowing segment with halved morsel size
(then grown working capacity) until every row fits; ``warn`` keeps the
truncated result and raises one ``RuntimeWarning`` attributing the drops;
``raise`` fails the query with ``CapacityOverflow``.

Retries, timeouts and fault injection (``repro_torch.faults``) replay a
faulted segment from its input checkpoint; adaptive skew handling
(``repro_torch.adapt``: hot-key salting, splitter refresh, morsel
autotuning) is on by default, as in the JAX package.  Its spans
(``tracer``) and ``debug_overflow`` warnings are the JAX package's.

Over a ``torch.distributed`` process group each process streams the
ranks it holds (``SpillTable.comm``) and ends with exactly what rank r
holds in the stacked run.  Every count a collective depends on is agreed
over the group before it is used: morsels per segment (the group's
widest rank), the combine's sub-buckets and their capacity, the splitter
samples (pooled from every rank), every drop count and degrade step (the
stages gather their stat triples, as in-core), the retry of a faulted
unit (``faults.GroupFaults``).  Partials routed to another process's
rank go through the communicator's host exchange.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..adapt import MorselTuner, SplitterEstimator, resolve_adaptive
from ..adapt.hotkeys import plan_salt_decisions, salt_cache_token
from ..core.env import DistTable, MorselSource
from ..core.store import (Checkpoint, D2HStaging, SpillTable, _round8,
                          fetch_valid, rescatter, respill, respill_routed)
from ..dataframe import ops_local
from ..dataframe.groupby import (_normalize, combine_groupby_partials,
                                 groupby_partial, hot_mask)
from ..dataframe.ops_local import hash_columns, hash_columns_np
from ..dataframe.shuffle import replicate_hot_rows, reset_overflow_warnings
from ..dataframe.shuffle import shuffle as df_shuffle
from ..dataframe.table import Table
from ..dtypes import numpy_dtype, order_view, to_x32
from ..expr import token as _token
from ..faults import (CapacityOverflow, OverflowPolicy, default_degrade_step,
                      over_group, resolve_faults, resolve_overflow,
                      resolve_retry, resolve_token, run_with_retries)
from ..nulls import mask_name
from ..obs.metrics import record_exec
from ..obs.trace import NULL_TRACER
from .logical import LogicalNode, topo
from .physical import (ExecStats, PhysicalPlan, _partial_width,
                       _recode_tables, _row_bytes, _shuffle_kw, _stat_vec,
                       _sum_stats, _world_stats,
                       attach_dictionaries, build_shuffle_records,
                       check_scan_dictionaries, describe_drops,
                       emit_shuffle_events, eval_node, fingerprint,
                       pair_stat_labels, plan_stat_labels, scan_read_stats)


@dataclasses.dataclass
class _Acc:
    """Host-side transfer/dispatch accounting for one morsel run."""

    morsels: int = 0
    dispatches: int = 0
    spill_bytes: int = 0
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    d2h_copied_bytes: int = 0
    #: pinned landing buffers reused by every morsel output's D2H copy
    staging: D2HStaging = dataclasses.field(default_factory=D2HStaging)


# ---------------------------------------------------------------------- #
# Plan-shape analysis
# ---------------------------------------------------------------------- #
def spine(pplan: PhysicalPlan) -> List[LogicalNode]:
    """The streamed operator chain: scan -> ... -> root along inputs[0]."""
    chain: List[LogicalNode] = []
    n = pplan.root
    while True:
        chain.append(n)
        if not n.inputs:
            break
        n = n.inputs[0]
    chain.reverse()
    if chain[0].op != "scan":
        raise ValueError(
            "out-of-core execution streams along inputs[0] edges and needs "
            f"a scan at the head; found {chain[0].op!r}")
    spine_ids = {c.nid for c in chain}
    covered = set(spine_ids)
    for c in chain:
        if c.op == "shuffle" and "dest" in c.params:
            raise ValueError(
                "explicit-dest shuffles are row-aligned with the full table "
                "and cannot stream; use key_cols")
        if c.op == "join":
            sub_ids = {s.nid for s in topo(c.inputs[1])}
            if sub_ids & spine_ids:
                raise ValueError(
                    "out-of-core execution needs tree-shaped build sides "
                    "(the join build side shares nodes with the streamed "
                    "chain)")
            covered |= sub_ids
    extra = sorted(n.op for n in pplan.order if n.nid not in covered)
    if extra:
        raise ValueError(
            f"nodes unreachable from the streamed chain: {extra}")
    return chain


def segments(chain_tail: Sequence[LogicalNode]
             ) -> List[Tuple[List[LogicalNode], str]]:
    """Split the post-scan chain into morsel-program segments.

    A segment runs per-morsel with no cross-morsel interaction except its
    terminal combiner: ``groupby`` ends its segment (partials -> combine),
    ``sort`` forms its own segment (its input spill must be materialized so
    splitters can be sampled once; outputs are merged).  Everything else
    streams straight through (``stream`` terminal).
    """
    segs: List[Tuple[List[LogicalNode], str]] = []
    cur: List[LogicalNode] = []
    for n in chain_tail:
        if n.op == "sort":
            if cur:
                segs.append((cur, "stream"))
                cur = []
            segs.append(([n], "sort"))
        elif n.op == "groupby":
            cur.append(n)
            segs.append((cur, "groupby"))
            cur = []
        else:
            cur.append(n)
    if cur:
        segs.append((cur, "stream"))
    return segs


# ---------------------------------------------------------------------- #
# Host-side helpers
# ---------------------------------------------------------------------- #
def _group(env):
    """The env's communicator when it holds only some ranks (a process
    group), else None."""
    return env.comm if env.ranks_held < env.parallelism else None


def _as_spill(source: Any, env, tracer=NULL_TRACER) -> SpillTable:
    """The streamed input as a spill of the env's ranks (over a process
    group: the ranks this process holds; a dict or a whole spill is the
    whole input on every process)."""
    if isinstance(source, DistTable):
        source = SpillTable.from_dist(source)
    elif isinstance(source, dict):
        source = SpillTable.from_numpy(source, env.parallelism,
                                       comm=_group(env))
    elif not isinstance(source, SpillTable):
        raise TypeError(f"cannot stream a {type(source).__name__}")
    # a spill bucketed for a different gang would silently lose every rank
    # beyond this env's ranks — re-bucket on the host
    return respill(source, env.parallelism,
                   tracer=tracer).select(_group(env))


def _to_dist(source: Any, env) -> DistTable:
    """Build-side inputs must be device-resident (they are assumed to fit)."""
    if isinstance(source, DistTable):
        return source
    if isinstance(source, dict):
        source = SpillTable.from_numpy(source, env.parallelism)
    # handles any spill gang size
    return rescatter(source, env.parallelism, device=env.device,
                     comm=_group(env))


def _schema_of(dist: DistTable) -> Dict[str, Tuple[np.dtype, Tuple[int, ...]]]:
    return {k: (numpy_dtype(v.dtype), tuple(v.shape[2:]))
            for k, v in dist.columns.items()}


def _append_out(out_spill: SpillTable, dist: DistTable,
                acc: _Acc) -> np.ndarray:
    """Spill one morsel-output DistTable to per-rank host buckets (D2H):
    the row counts first, then the valid prefixes (``fetch_valid``).
    Returns the per-rank row counts."""
    counts, rows, copied = fetch_valid(dist, acc.staging)
    # counted as the JAX package counts it: the counts and whole columns
    acc.d2h_bytes += counts.nbytes + sum(
        v.numel() * v.element_size() for v in dist.columns.values())
    acc.d2h_copied_bytes += copied
    for r, chunk in enumerate(rows):
        if counts[r]:
            acc.spill_bytes += out_spill.append(r, chunk)
    return counts


def _host_splitters(spill: SpillTable, col: str, p: int,
                    samples: int) -> np.ndarray:
    """Fixed global splitters for an out-of-core sample sort: per-rank
    evenly-spaced samples pooled into p-1 global quantiles (the host twin
    of ``dataframe.sort._sample_splitters``).  Over a process group every
    rank's samples are pooled, in rank order, on every process."""
    pool = []
    for r in range(spill.parallelism):
        cols_r = spill.rank_concat(r)
        keys = cols_r[col]
        m = cols_r.get(mask_name(col))
        if m is not None:
            # null keys are routed straight to the last rank (nulls-last);
            # their canonical-zero values must not skew the quantiles
            keys = keys[np.asarray(m).astype(bool)]
        n = len(keys)
        if n:
            k = np.sort(keys)
            take = min(samples, n)
            idx = (np.arange(take) * n) // take
            pool.append(k[idx])
    if spill.comm is not None:
        pool = [a for part in spill.comm.gather_object(pool) for a in part]
    if not pool:
        dtype, _ = spill.schema[col]
        return np.zeros((max(p - 1, 0),), dtype)
    pooled = np.sort(np.concatenate(pool))
    qpos = (np.arange(1, p) * len(pooled)) // p
    return pooled[qpos]


def _host_sort_ranks(spill: SpillTable, by: Sequence[str]) -> SpillTable:
    """Cross-morsel sort combiner: one stable vectorized host sort per rank
    over the range-partitioned rows.  The morsel stages only *route* rows
    (a vectorized lexsort over the concatenation beats a per-row k-way
    merge, and stability preserves arrival order for ties)."""
    out = SpillTable(spill.parallelism, schema=spill.schema,
                     dictionaries=spill.dictionaries, comm=spill.comm)
    for r in range(spill.parallelism):
        cols = spill.rank_concat(r)
        n = len(next(iter(cols.values()))) if cols else 0
        if n:
            # minor -> major; per column the null flag outranks the value
            # (nulls-last, matching ops_local._order_keys)
            lex: List[np.ndarray] = []
            for b in reversed(tuple(by)):
                lex.append(cols[b])
                m = cols.get(mask_name(b))
                if m is not None:
                    lex.append((~np.asarray(m).astype(bool)).astype(np.int8))
            order = np.lexsort(tuple(lex))
            out.append(r, {k: v[order] for k, v in cols.items()})
    return out


# ---------------------------------------------------------------------- #
# Morsel-stage node evaluation (batched over ranks)
# ---------------------------------------------------------------------- #
def _morsel_shuffle_kw(node: LogicalNode, W: int, shuffle_impl: str,
                       a2a_chunks: int, debug_overflow: bool
                       ) -> Dict[str, Any]:
    """Shuffle kwargs for a morsel stage: plan-level capacities (sized for
    in-core tables) are replaced by the working capacity ``W``."""
    kw = _shuffle_kw(node)
    for k in ("bucket_capacity", "out_capacity", "samples"):
        kw.pop(k, None)
    kw["bucket_capacity"] = W
    kw.setdefault("impl", shuffle_impl)
    kw.setdefault("a2a_chunks", a2a_chunks)
    if debug_overflow:
        kw.setdefault("debug_overflow", True)
    return kw


def _eval_stream_node(node: LogicalNode, ctx, cur: Table,
                      residents: Dict[int, Table], W: int,
                      shuffle_impl: str, a2a_chunks: int,
                      stats_out, consts, debug_overflow: bool,
                      salt=None) -> Table:
    p_ = node.params
    dec = salt.get(node.nid) if salt else None
    if node.op == "noop":
        return cur
    if node.op == "project":
        # masks ride along with their base columns (never named explicitly)
        cols = list(p_["cols"])
        cols += [mask_name(c) for c in p_["cols"]
                 if mask_name(c) in cur.columns]
        return cur.select(cols)
    if node.op == "filter":
        return ops_local.filter_expr(cur, p_["expr"])
    if node.op == "with_columns":
        return ops_local.with_columns(cur, p_["exprs"])
    if node.op == "add_scalar":
        return ops_local.add_scalar(cur, p_["value"], p_.get("cols"))
    if node.op == "recode":
        return ops_local.recode(cur, _recode_tables(node, ctx.device, consts))

    # communication ops: capacities are re-derived from the morsel working
    # capacity W — plan-level bucket/out capacities describe in-core tables.
    # bucket_capacity = W lets a single destination absorb a whole morsel
    # (already-placed inputs route every row to the self bucket).
    kw = _morsel_shuffle_kw(node, W, shuffle_impl, a2a_chunks,
                            debug_overflow)

    if node.op == "shuffle":
        lbl = f"shuffle({','.join(p_['key_cols'])})"
        out, st = df_shuffle(cur, ctx.comm, key_cols=p_["key_cols"],
                             out_capacity=W, label=lbl, **kw)
        stats_out.append((lbl, _stat_vec(st, _row_bytes(cur))))
        return out

    if node.op == "join":
        on = p_["on"]
        l, r = cur, residents[node.nid]
        if not p_.get("elide_left"):
            if dec is not None:
                # salted probe (repro_torch.adapt): hot rows stay on their
                # source rank — the resident build side broadcast-appended
                # every hot build row, so the local hash join still finds
                # them
                h = hash_columns(l, [on])
                dest = torch.where(hot_mask(h, dec.hot_hashes),
                                   ctx.comm.rank(l.device)[:, None],
                                   (h % ctx.comm.size()).to(torch.int32))
                l, st = df_shuffle(l, ctx.comm, dest=dest, out_capacity=W,
                                   label=f"join({on}):left", **kw)
            else:
                l, st = df_shuffle(l, ctx.comm, key_cols=[on],
                                   out_capacity=W,
                                   label=f"join({on}):left", **kw)
            stats_out.append((f"join({on}):left",
                              _stat_vec(st, _row_bytes(cur))))
        out_cap = p_.get("morsel_out_capacity") or W
        out, ov = ops_local.join_local(l, r, on, out_capacity=out_cap,
                                       with_overflow=True)
        ov = ov.to(torch.int64)
        z = torch.zeros_like(ov)
        stats_out.append((f"join({on}):overflow",
                          torch.stack([z, z, ov], dim=1)))
        return out

    if node.op == "groupby":
        keys = list(p_["keys"])
        physical, _post = _normalize(p_["aggs"])
        pre = bool(p_.get("pre_aggregate", False))
        gsalt = ((dec.hot_hashes, dec.k)
                 if dec is not None and not pre else None)
        out, st = groupby_partial(cur, ctx.comm, keys, physical,
                                  pre_aggregate=pre,
                                  elide_shuffle=bool(p_.get("elide_shuffle")),
                                  salt=gsalt, out_capacity=W,
                                  label=f"groupby({','.join(keys)})", **kw)
        if st is not None:
            stats_out.append(
                (f"groupby({','.join(keys)})",
                 _stat_vec(st, _partial_width(cur, keys, physical) if pre
                           else _row_bytes(cur))))
        return out

    raise ValueError(f"op {node.op!r} cannot run in a morsel segment")


def _seg_stat_labels(seg_nodes: Sequence[LogicalNode]) -> List[str]:
    """Host-side stat labels for one stream segment, in the exact order
    ``_eval_stream_node`` appends them (the stage returns bare tensors;
    attribution is reconstructed from the static plan)."""
    labels: List[str] = []
    for n in seg_nodes:
        p_ = n.params
        if n.op == "shuffle":
            labels.append(f"shuffle({','.join(p_['key_cols'])})")
        elif n.op == "join":
            if not p_.get("elide_left"):
                labels.append(f"join({p_['on']}):left")
            labels.append(f"join({p_['on']}):overflow")
        elif n.op == "groupby" and not p_.get("elide_shuffle"):
            labels.append(f"groupby({','.join(p_['keys'])})")
    return labels


# ---------------------------------------------------------------------- #
# Morsel stages (each built once per segment, reused per morsel).
# Every stage returns (table, stat triples) — overflow accounting is
# unconditional so capacity-pressure drops are never silent.
# ---------------------------------------------------------------------- #
def _make_stream_prog(seg_nodes, join_nids, W, shuffle_impl, a2a_chunks,
                      debug_overflow, salt=None):
    # recode tables go to the device once per built stage
    consts: Dict[int, Dict[str, torch.Tensor]] = {}

    def prog(ctx, morsel, *extras):
        residents = dict(zip(join_nids, extras))
        stats: List[Tuple[str, Any]] = []
        cur = morsel
        for node in seg_nodes:
            cur = _eval_stream_node(node, ctx, cur, residents, W,
                                    shuffle_impl, a2a_chunks, stats,
                                    consts, debug_overflow, salt=salt)
        return cur, _world_stats(ctx.comm, (a for _, a in stats))
    return prog


def _make_sort_prog(node, W, shuffle_impl, a2a_chunks, debug_overflow):
    """Range-route one morsel by the broadcast splitters.  No device-side
    sort: the host combiner (``_host_sort_ranks``) orders each rank."""
    by = tuple(node.params["by"])
    kw = _morsel_shuffle_kw(node, W, shuffle_impl, a2a_chunks,
                            debug_overflow)

    def prog(ctx, morsel, splitters):
        # unsigned keys compare widened (dtypes.order_view)
        key = order_view(morsel.columns[by[0]]).contiguous()
        dest = torch.searchsorted(order_view(splitters), key,
                                  side="right").to(torch.int32)
        m = morsel.columns.get(mask_name(by[0]))
        if m is not None:  # nulls-last: null keys land on the final rank
            dest = torch.where(m, dest, ctx.comm.size() - 1)
        shuffled, st = df_shuffle(morsel, ctx.comm, dest=dest,
                                  out_capacity=W,
                                  label=f"sort({','.join(by)})", **kw)
        return shuffled, _world_stats(ctx.comm,
                                      (_stat_vec(st, _row_bytes(morsel)),))
    return prog


# ---------------------------------------------------------------------- #
# Resident build sides (join right inputs; assumed to fit on the device)
# ---------------------------------------------------------------------- #
def _build_resident(env, jnode: LogicalNode, tables, shuffle_impl,
                    a2a_chunks, collected, acc: _Acc,
                    capacity_factor: float, tracer=NULL_TRACER,
                    salt=None) -> DistTable:
    rroot = jnode.inputs[1]
    sub_order = topo(rroot)
    scan_names = [s.params["name"] for s in sub_order if s.op == "scan"]
    on = jnode.params["on"]
    elide = bool(jnode.params.get("elide_right"))
    dec = salt.get(jnode.nid) if (salt and not elide) else None
    jkw = {k: v for k, v in _shuffle_kw(jnode).items()
           if k != "out_capacity"}
    jkw.setdefault("impl", shuffle_impl)
    jkw.setdefault("a2a_chunks", a2a_chunks)
    if "shuffle_out_capacity" in jnode.params:
        jkw["out_capacity"] = jnode.params["shuffle_out_capacity"]
    consts: Dict[int, Dict[str, torch.Tensor]] = {}

    def prog(ctx, *local_tables):
        tmap = dict(zip(scan_names, local_tables))
        values: Dict[int, Table] = {}
        stats: List[Tuple[str, Any]] = []
        for node in sub_order:
            values[node.nid] = eval_node(
                node, ctx.comm, values, tmap, "direct", stats,
                shuffle_impl=shuffle_impl, a2a_chunks=a2a_chunks,
                consts=consts)
        r = values[rroot.nid]
        if not elide:
            width = _row_bytes(r)
            # receive headroom: hash placement is only balanced in
            # expectation, so a capacity-tight build table would drop rows
            kw = dict(jkw)
            kw.setdefault("out_capacity",
                          _round8(int(r.capacity * capacity_factor)))
            kw.setdefault("bucket_capacity",
                          _round8(int(r.capacity * capacity_factor)))
            if dec is not None:
                # salted build (repro_torch.adapt): hot rows skip the hash
                # shuffle (overflow bin, uncounted) and are broadcast-
                # appended so every rank's probe morsels find them locally
                h = hash_columns(r, [on])
                hot = hot_mask(h, dec.hot_hashes)
                dest = torch.where(hot, ctx.comm.size(),
                                   (h % ctx.comm.size()).to(torch.int32))
                r2, st = df_shuffle(r, ctx.comm, dest=dest,
                                    label=f"join({on}):right", **kw)
                stats.append((f"join({on}):right", _stat_vec(st, width)))
                r2, bst = replicate_hot_rows(r, ctx.comm, hot,
                                             dec.hot_cap, r2)
                stats.append((f"join({on}):broadcast",
                              _stat_vec(bst, width)))
                r = r2
            else:
                r, st = df_shuffle(r, ctx.comm, key_cols=[on],
                                   label=f"join({on}):right", **kw)
                stats.append((f"join({on}):right", _stat_vec(st, width)))
        return r, _world_stats(ctx.comm, (a for _, a in stats))

    args = [_to_dist(tables[n], env) for n in scan_names]
    labels = plan_stat_labels(sub_order)
    if not elide:
        labels.append(f"join({on}):right")
    if dec is not None:
        labels.append(f"join({on}):broadcast")
    with tracer.span(f"build:join({on})", "stage", ops="resident-build"):
        resident, stats = env.run(
            prog, *args,
            key=("morsel-resident", fingerprint(rroot),
                 # the subtree fingerprint does not cover the join node's
                 # own params (shuffle kwargs, capacities)
                 _token(dict(jnode.params)),
                 env.communicator_name, shuffle_impl, a2a_chunks,
                 capacity_factor,
                 tuple(env._arg_sig(a) for a in args))
            + salt_cache_token(salt or {}, [jnode.nid]))
        acc.dispatches += 1
        pairs = pair_stat_labels(labels, stats)
        collected.extend(pairs)
        if tracer.enabled:
            env.synchronize()
            emit_shuffle_events(tracer, pairs, a2a_chunks)
    return resident


# ---------------------------------------------------------------------- #
# Cross-morsel groupby combine (hash sub-buckets, rank-local)
# ---------------------------------------------------------------------- #
def _combine_groupby(env, part_spill: SpillTable, gnode: LogicalNode,
                     M: int, acc: _Acc, fp: str, si: int,
                     faults=None, token=None) -> SpillTable:
    keys = list(gnode.params["keys"])
    physical, post = _normalize(gnode.params["aggs"])
    # the partials carry no mask for sum/count, so mean nullability is not
    # recoverable from them — the planner's annotation of the groupby
    # *input* supplies it (conservative in the nullable direction)
    nullable = tuple(sorted(set(gnode.inputs[0].nulls) & set(physical)))
    # p: the gang's ranks (the hash placement); held: the ranks held here
    p, held = part_spill.size, part_spill.parallelism
    widest = int(part_spill.world_rows().max())
    B = max(1, -(-widest // M))

    # host sub-bucketing: (hash // p) decorrelates from the rank placement
    # (hash % p), so buckets stay balanced on hash-placed ranks.  One
    # stable argsort groups each rank's rows by bucket; bucket ids narrow
    # to 16 bits where they fit, which numpy sorts stably by radix in one
    # linear pass (the same order as a stable sort of the wide ids)
    narrow = np.uint16 if B <= 1 << 16 else np.int64
    rank_sorted: List[Dict[str, np.ndarray]] = []
    rank_offsets: List[np.ndarray] = []
    max_bucket = 1
    for r in range(held):
        cols_r = part_spill.rank_concat(r)
        n = len(next(iter(cols_r.values())))
        if n:
            h = hash_columns_np(cols_r, keys)
            sub = ((h // np.uint32(p)) % np.uint32(B)).astype(np.int64)
            counts_r = np.bincount(sub, minlength=B)
            order = np.argsort(sub.astype(narrow), kind="stable")
            cols_r = {k: v[order] for k, v in cols_r.items()}
        else:
            counts_r = np.zeros((B,), np.int64)
        max_bucket = max(max_bucket, int(counts_r.max()))
        rank_sorted.append(cols_r)
        rank_offsets.append(np.concatenate([[0], np.cumsum(counts_r)]))
    if part_spill.comm is not None:
        # one capacity over the group: every process runs the same stage
        max_bucket = int(part_spill.comm.gather_ints([max_bucket]).max())
    cap_b = _round8(max_bucket)

    def prog(ctx, partials):
        return combine_groupby_partials(partials, keys, physical, post,
                                        nullable_cols=nullable)

    out_spill: Optional[SpillTable] = None
    for b in range(B):
        counts = np.zeros((held,), np.int32)
        cols: Dict[str, torch.Tensor] = {}
        for name, (dtype, trail) in part_spill.schema.items():
            buf = np.zeros((held, cap_b) + trail, dtype)
            for r in range(held):
                lo, hi = rank_offsets[r][b], rank_offsets[r][b + 1]
                sel = rank_sorted[r][name][lo:hi]
                buf[r, :len(sel)] = sel
                counts[r] = len(sel)
            buf = to_x32(buf)
            acc.h2d_bytes += buf.nbytes
            cols[name] = torch.from_numpy(buf).to(env.device)
        acc.h2d_bytes += counts.nbytes
        if faults is not None:
            faults.check("spill:combine", token=token, segment=si, bucket=b)
        dist = DistTable(cols, torch.from_numpy(counts).to(env.device),
                         cap_b)
        out = env.run(prog, dist,
                      key=("morsel-combine", fp, si, cap_b, nullable,
                           env.communicator_name, env._arg_sig(dist)))
        acc.dispatches += 1
        if out_spill is None:
            out_spill = SpillTable(held, schema=_schema_of(out),
                                   comm=part_spill.comm)
        _append_out(out_spill, out, acc)
    return out_spill


# ---------------------------------------------------------------------- #
# Entry point
# ---------------------------------------------------------------------- #
#: bound on capacity-degrade re-executions: halving morsel_rows from any
#: sane starting point down to 8 plus a few working-capacity doublings
#: fits comfortably; past this the overflow is not capacity-shaped.
_MAX_DEGRADE_BUILD = 8
_MAX_DEGRADE_SEG = 24


def run_morsel(pplan: PhysicalPlan, env, tables: Dict[str, Any],
               morsel_rows: int, mode: str = "bsp",
               collect_stats: bool = False, shuffle_impl: str = "radix",
               a2a_chunks: int = 1, capacity_factor: float = 2.0,
               samples: int = 64, debug_overflow: bool = False,
               tracer=None, retries=None, timeout=None, overflow=None,
               faults=None, adaptive=None):
    """Stream a plan over morsels of ``morsel_rows`` rows per rank.

    Returns a host-resident ``SpillTable`` (or ``(SpillTable, ExecStats)``
    with ``collect_stats=True``).  Device memory is bounded by the working
    capacity ``W = capacity_factor * morsel_rows`` plus resident build
    sides, independent of the streamed input size.  Every device stage
    runs on the env's device.

    ``tracer`` (``repro_torch.obs.Tracer``) records build/segment/combine
    spans, per-morsel dispatch spans with spill-append volumes, the
    morsels' H2D instants, per-shuffle data events and a ``retry:`` instant
    for each replay — host-side only, never part of a stage-cache key.
    ``debug_overflow`` makes every morsel shuffle warn once per (op label,
    rank) per query where it drops rows.

    Fault tolerance (``repro_torch.faults``): each segment's input spill
    is a schema-stamped ``core.store.Checkpoint``; a segment attempt that
    faults (``retries`` replays with backoff, fenced by ``timeout``) is
    replayed from that checkpoint verbatim, and its partial output spill
    is discarded — committed results come only from the attempt that
    succeeded, so recovered runs are bit-identical to fault-free ones.
    ``overflow`` (default ``degrade``) re-executes an overflowing segment
    with a smaller ``morsel_rows`` (then grown working capacity) until no
    row is dropped, and an overflowing build side with a doubled
    ``capacity_factor``; ``faults`` arms a deterministic ``FaultPlan``
    (None consults ``REPRO_FAULTS``).

    ``adaptive`` (None | bool | dict | ``repro_torch.adapt.
    AdaptiveConfig``) gates runtime skew mitigation: hot-key salting of
    streamed joins/groupbys (with the partial spill host-re-routed to key
    home ranks ahead of the combine), sample-refreshed sort splitters when
    the observed per-rank routing imbalance exceeds a bound, and a
    degrade controller that picks the replay morsel size from the
    observed overflow peak instead of blind halving.  A run where no
    mitigation fires uses exactly the ``adaptive=False`` stage-cache keys.
    """
    if mode == "amt":
        raise ValueError(
            "out-of-core morsel execution requires direct shuffles; the "
            "amt allgather baseline is inherently in-core")
    tr = tracer if tracer is not None else NULL_TRACER
    reset_overflow_warnings()
    fr = resolve_faults(faults)
    policy = resolve_retry(retries)
    token = resolve_token(timeout)
    ovf = resolve_overflow(overflow)
    gcomm = _group(env)
    fr, token = over_group(fr, token, gcomm)
    counters = {"retries": 0, "degraded": 0}

    def _count_retry(attempt, exc):
        counters["retries"] += 1

    p = env.parallelism
    chain = spine(pplan)
    src_name = chain[0].params["name"]
    if src_name not in tables:
        raise KeyError(f"plan scans missing from tables: [{src_name!r}]")
    check_scan_dictionaries(pplan.order, tables)
    # runtime skew mitigation (repro_torch.adapt): decisions are sampled
    # from the host-resident sources before any spill conversion; an empty
    # decision set leaves every stage-cache key exactly as adaptive=False
    # would
    acfg = resolve_adaptive(adaptive)
    adapt_events: List[Dict[str, Any]] = []
    salt = plan_salt_decisions(pplan.order, tables, p, acfg, adapt_events)
    tuner = MorselTuner(acfg, capacity_factor=capacity_factor,
                        events=adapt_events)
    M = _round8(morsel_rows)
    W = max(M, _round8(int(M * capacity_factor)))
    fp = pplan.fingerprint
    acc = _Acc()
    collected: List[Tuple[Any, ...]] = []
    hits0, misses0 = env.cache_hits, env.cache_misses
    timing = collect_stats or tr.enabled
    stage_times: List[Tuple[str, float]] = []
    t_query0 = time.perf_counter()

    residents: Dict[int, DistTable] = {}
    for node in chain:
        if node.op != "join":
            continue
        t0 = time.perf_counter()
        jname = f"build:join({node.params['on']})"
        cf = capacity_factor
        for _ in range(_MAX_DEGRADE_BUILD):
            def _build_once(_node=node, _cf=cf, _jname=jname):
                token.check(_jname)
                # corrupt-capacity scales the build headroom (part of the
                # stage-cache key, so a corrupted build is built apart and
                # cannot poison the clean cache entry)
                scale = fr.capacity("build:resident", 256, token=token,
                                    join=_node.nid) / 256.0
                pairs: List[Tuple[str, Any]] = []
                dist = _build_resident(env, _node, tables, shuffle_impl,
                                       a2a_chunks, pairs, acc, _cf * scale,
                                       tracer=tr, salt=salt)
                return dist, pairs

            dist, pairs = run_with_retries(
                _build_once, policy=policy, token=token, tracer=tr,
                label=jname, on_retry=_count_retry)
            _, _, b_drop = _sum_stats([a for _, a in pairs])
            if b_drop and ovf == OverflowPolicy.DEGRADE:
                counters["degraded"] += 1
                cf *= 2.0
                continue
            if b_drop and ovf == OverflowPolicy.RAISE:
                raise CapacityOverflow(
                    f"{jname} dropped {b_drop} rows at "
                    f"capacity_factor={cf} (overflow='raise')")
            break
        else:
            raise CapacityOverflow(
                f"{jname} still dropping rows after "
                f"{_MAX_DEGRADE_BUILD} capacity doublings "
                f"(capacity_factor={cf})")
        residents[node.nid] = dist
        collected.extend(pairs)
        if timing:
            env.synchronize()
            stage_times.append((jname, time.perf_counter() - t0))

    def _respill():
        token.check("spill:respill")
        fr.check("spill:respill", token=token)
        return _as_spill(tables[src_name], env, tracer=tr)

    spill = run_with_retries(_respill, policy=policy, token=token,
                             tracer=tr, label="spill:respill",
                             on_retry=_count_retry)

    live_ckpts: List[Checkpoint] = []
    try:
        for si, (nodes, terminal) in enumerate(segments(chain[1:])):
            t0 = time.perf_counter()
            seg_name = f"segment:{si}:{terminal}"
            with tr.span(seg_name, "stage",
                         ops=",".join(n.op for n in nodes)) as seg_sp:
                if terminal == "sort" and \
                        nodes[0].params.get("elide_shuffle"):
                    # range-partitioned already: no device work, just order
                    token.check(seg_name)
                    spill = _host_sort_ranks(spill, nodes[0].params["by"])
                    if timing:
                        stage_times.append(
                            (seg_name, time.perf_counter() - t0))
                    continue

                # the segment's input spill is its replay checkpoint:
                # validated before every attempt, released only on commit
                ckpt = Checkpoint(spill)
                live_ckpts.append(ckpt)
                M_seg, W_seg = tuner.initial_morsel(M), W

                def _segment_attempt(_nodes=nodes, _terminal=terminal,
                                     _si=si, _seg_name=seg_name):
                    seg_in = ckpt.validate()
                    token.check(_seg_name)
                    W_a = fr.capacity("segment:launch", W_seg, token=token,
                                      segment=_si)
                    est: Optional[SplitterEstimator] = None
                    if _terminal == "sort":
                        node = _nodes[0]
                        by = node.params["by"]
                        n_samp = node.params.get("samples", samples)
                        spl = to_x32(_host_splitters(seg_in, by[0], p,
                                                     n_samp))
                        # refreshable splitters: if the one-shot sample
                        # routes too many rows to one rank, re-sample with
                        # a boosted budget and re-route what already landed
                        est = SplitterEstimator(
                            spl,
                            lambda s, _in=seg_in, _b=by[0]: to_x32(
                                _host_splitters(_in, _b, p, s)),
                            n_samp, acfg, events=adapt_events,
                            label=f"sort({','.join(by)})", comm=gcomm)
                        extras: Tuple[Any, ...] = (
                            torch.from_numpy(spl).to(env.device),)
                        acc.h2d_bytes += spl.nbytes
                        prog = _make_sort_prog(node, W_a, shuffle_impl,
                                               a2a_chunks, debug_overflow)
                        seg_labels = [f"sort({','.join(by)})"]
                    else:
                        join_nodes = [n for n in _nodes if n.op == "join"]
                        extras = tuple(residents[n.nid] for n in join_nodes)
                        prog = _make_stream_prog(
                            _nodes, [n.nid for n in join_nodes], W_a,
                            shuffle_impl, a2a_chunks, debug_overflow,
                            salt=salt)
                        seg_labels = _seg_stat_labels(_nodes)
                    key = ("morsel-seg", fp, _si, M_seg, W_a,
                           shuffle_impl, a2a_chunks, env.communicator_name,
                           debug_overflow,
                           tuple(env._arg_sig(e) for e in extras)) \
                        + salt_cache_token(salt, [n.nid for n in _nodes])
                    source = MorselSource(seg_in, M_seg, env, tracer=tr,
                                          faults=fr, token=token)
                    out_spill: Optional[SpillTable] = None
                    pairs: List[Tuple[str, Any]] = []
                    for mi, morsel in enumerate(source):
                        with tr.span(f"morsel[{mi}]", "morsel",
                                     segment=_si):
                            if mi == 0:
                                fr.check("morsel:compile", token=token,
                                         segment=_si)
                            fr.check("morsel:execute", token=token,
                                     segment=_si, morsel=mi)
                            out, unit_stats = env.run(prog, morsel,
                                                      *extras, key=key)
                            acc.dispatches += 1
                            acc.morsels += 1
                            unit_pairs = pair_stat_labels(seg_labels,
                                                          unit_stats)
                            pairs.extend(unit_pairs)
                            if out_spill is None:
                                out_spill = SpillTable(
                                    env.ranks_held, schema=_schema_of(out),
                                    comm=gcomm)
                            b0 = acc.spill_bytes
                            fr.check("transfer:d2h", token=token,
                                     segment=_si, morsel=mi)
                            routed = _append_out(out_spill, out, acc)
                            fr.check("spill:append", token=token,
                                     segment=_si, morsel=mi)
                            tr.instant(f"spill:morsel[{mi}]", "spill",
                                       segment=_si,
                                       bytes=acc.spill_bytes - b0)
                            if tr.enabled:
                                emit_shuffle_events(tr, unit_pairs,
                                                    a2a_chunks)
                            if est is not None and est.observe(routed):
                                # same shapes/dtypes -> same stage; only
                                # the splitter VALUES change, so the swap
                                # never rebuilds it
                                extras = (torch.from_numpy(
                                    est.splitters).to(env.device),)
                                acc.h2d_bytes += est.splitters.nbytes
                    acc.h2d_bytes += source.h2d_bytes
                    res = out_spill
                    if _terminal == "groupby":
                        gdec = salt.get(_nodes[-1].nid) if salt else None
                        if gdec is not None and res is not None:
                            # salted partials live on k salt ranks; route
                            # every partial to its key's home rank so the
                            # rank-local combiner sees each key exactly once
                            gkeys = list(_nodes[-1].params["keys"])
                            res = respill_routed(
                                res,
                                lambda cols, _k=gkeys:
                                    (hash_columns_np(cols, _k)
                                     % np.uint32(p)).astype(np.int64),
                                tracer=tr)
                        # the combiner runs inside the attempt: a fault
                        # mid-combine replays the whole segment from its
                        # input checkpoint (partials are discarded)
                        with tr.span(f"combine:groupby[{_si}]", "stage"):
                            res = _combine_groupby(env, res, _nodes[-1],
                                                   M_seg, acc, fp, _si,
                                                   faults=fr, token=token)
                    elif _terminal == "sort":
                        if est is not None and est.refreshes and \
                                res is not None:
                            # a refresh breaks range disjointness between
                            # early and late morsels — re-route the spilled
                            # rows by the final splitters before ordering
                            fin = est.splitters

                            def _dest(cols, _f=fin, _b=by[0]):
                                d = np.searchsorted(
                                    _f, cols[_b],
                                    side="right").astype(np.int64)
                                m = cols.get(mask_name(_b))
                                if m is not None:  # nulls-last
                                    d = np.where(
                                        np.asarray(m).astype(bool),
                                        d, p - 1)
                                return d
                            res = respill_routed(res, _dest, tracer=tr)
                        with tr.span(f"host_sort({','.join(by)})",
                                     "stage"):
                            res = _host_sort_ranks(res, by)
                    return (res, pairs, source.num_morsels,
                            source.h2d_bytes)

                for _ in range(_MAX_DEGRADE_SEG):
                    out_spill, attempt_pairs, seg_morsels, seg_h2d = \
                        run_with_retries(_segment_attempt, policy=policy,
                                         token=token, tracer=tr,
                                         label=seg_name,
                                         on_retry=_count_retry)
                    _, _, seg_drop = _sum_stats(
                        [a for _, a in attempt_pairs])
                    if seg_drop and ovf == OverflowPolicy.DEGRADE:
                        # never drop a row: replay with a morsel size that
                        # fits.  The tuner jumps straight to the size the
                        # observed overflow peak implies (and never splits
                        # a salted segment — its routing is already
                        # balanced, so it grows W instead); with autotune
                        # off, the blind halving applies.
                        counters["degraded"] += 1
                        if tuner.enabled:
                            M_seg, W_seg = tuner.degrade(
                                M_seg, W_seg,
                                [pr[1].cpu().numpy()
                                 for pr in attempt_pairs],
                                salted=any(n.nid in salt for n in nodes),
                                label=seg_name)
                        else:
                            M_seg, W_seg = default_degrade_step(M_seg,
                                                                W_seg)
                        continue
                    if seg_drop and ovf == OverflowPolicy.RAISE:
                        raise CapacityOverflow(
                            f"{seg_name} dropped {seg_drop} rows "
                            f"(overflow='raise'); raise capacity_factor "
                            f"or use overflow='degrade'")
                    break
                else:
                    raise CapacityOverflow(
                        f"{seg_name} still dropping rows after "
                        f"{_MAX_DEGRADE_SEG} degrade steps "
                        f"(morsel_rows={M_seg}, working_capacity={W_seg})")

                # commit: only the successful attempt's stats are
                # recorded, keyed by (label, segment) so per-label
                # histograms never mix morsel counts from different
                # segments
                if tuner.enabled:
                    tuner.observe_expansion(
                        spill.total_rows(),
                        out_spill.total_rows()
                        if out_spill is not None else 0)
                collected.extend(
                    (lbl, arr, si) for lbl, arr in attempt_pairs)
                ckpt.release()
                seg_sp.set(morsels=seg_morsels, h2d_bytes=seg_h2d)
                spill = out_spill
            if timing:
                stage_times.append((seg_name, time.perf_counter() - t0))
    finally:
        # a cancelled/failed query releases its checkpoints (the spills
        # they guard belong to the run and are dropped with it)
        for c in live_ckpts:
            if not c.released:
                c.release()

    spill = attach_dictionaries(spill, pplan.root)
    rows, byts, dropped = _sum_stats([pr[1] for pr in collected])
    records = build_shuffle_records(collected)
    if dropped and ovf == OverflowPolicy.WARN:
        where = describe_drops(records)
        warnings.warn(
            f"out-of-core execution dropped {dropped} rows to capacity "
            f"pressure ({where or 'unattributed'}) — raise capacity_factor "
            f"(currently {capacity_factor}) or morsel_rows, or use "
            f"overflow='degrade' to trade speed for completeness",
            RuntimeWarning, stacklevel=2)
    if not collect_stats:
        return spill
    rows_read, bytes_read = scan_read_stats(pplan.scan_names, tables)
    injected = fr.injected
    if gcomm is not None:
        # each process's transfers and faults, summed over the group
        (acc.h2d_bytes, acc.d2h_bytes, acc.d2h_copied_bytes,
         acc.spill_bytes, injected) = (int(v) for v in gcomm.gather_ints(
            [acc.h2d_bytes, acc.d2h_bytes, acc.d2h_copied_bytes,
             acc.spill_bytes, injected]).sum(axis=0))
    stats = ExecStats(
        "morsel", pplan.num_stages, pplan.num_shuffles, acc.dispatches,
        rows, byts, pplan.shuffle_labels(), pplan.fired,
        rows_read=rows_read, bytes_read=bytes_read,
        shuffle_impl=shuffle_impl, a2a_chunks=a2a_chunks,
        rows_dropped=dropped,
        cache_hits=env.cache_hits - hits0,
        cache_misses=env.cache_misses - misses0,
        morsel_rows=M, morsels=acc.morsels, spill_bytes=acc.spill_bytes,
        h2d_bytes=acc.h2d_bytes, d2h_bytes=acc.d2h_bytes,
        d2h_copied_bytes=acc.d2h_copied_bytes,
        wall_time_s=time.perf_counter() - t_query0,
        stage_times=stage_times, shuffle_records=records,
        retries=counters["retries"], degraded=counters["degraded"],
        faults_injected=injected,
        adaptive=acfg.enabled, salted_shuffles=len(salt),
        splitter_refreshes=sum(1 for e in adapt_events
                               if e.get("kind") == "splitter_refresh"),
        autotune_steps=tuner.steps, adapt_events=list(adapt_events))
    record_exec(stats, fp, stats.wall_time_s)
    return spill, stats
