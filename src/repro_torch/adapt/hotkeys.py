"""Hot-key detection + salting decisions (host-side).

The torch counterpart of ``repro.adapt.hotkeys``.  Detection runs on
the host: the host samples the key columns of a
shuffle boundary's input (evenly spaced over valid rows, nulls excluded
— they are dropped or never match anyway), hashes the sample with
``hash_columns_np`` (the bit-identical numpy twin of the device hash, so
a "hot hash" here is exactly a hot destination there), and declares a
key *hot* when its sampled frequency exceeds ``hot_key_factor / p`` —
``factor``x its fair share of one rank's rows.

A fired decision is a :class:`SaltDecision`:

* ``groupby`` — hot rows are spread over ``k`` consecutive ranks
  (``(hash % p + arange % k) % p``); partials for a hot key then live on
  ``k`` ranks and are re-merged on the key's home rank (a second, tiny
  shuffle in-core; a host re-route of the partial spill out-of-core);
* ``join`` — hot *build* rows are excluded from the hash shuffle and
  broadcast to every rank (``replicate_hot_rows``); hot *probe* rows
  skip the wire entirely and stay on their source rank.

Decisions are plan-structural facts plus data-dependent constants; the
executors append ``SaltDecision.cache_token()`` to their stage-cache
keys **only when a decision fired**, so ``adaptive=True`` on well-behaved
data builds the exact same stages as ``adaptive=False``.  The port's
stage cache holds the Python callable built for a key, with the hot
hashes it closes over, so the token in the key is what keeps a later
query from running an earlier query's salted stage.

The input of a boundary is not materialized before execution, so
sampling *chases* the boundary's streamed input back to a scan through
ops that preserve the key columns' row multiset
(``planner.logical.preserves_rows_and_columns``); a chase that fails
(filter, recode, another boundary, ...) simply disables salting for that
node — the degrade path still guarantees no row is ever lost.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dataframe.ops_local import hash_columns_np
from ..dtypes import signed_view
from ..nulls import mask_name
from .config import AdaptiveConfig

#: never salt from a sample smaller than this (frequencies too noisy)
_MIN_SAMPLE = 32
#: build sides larger than this are counted from a sample (x2 slack)
#: instead of an exact host hash pass
_EXACT_COUNT_LIMIT = 2_000_000


@dataclasses.dataclass(frozen=True)
class SaltDecision:
    """One fired salting decision at one shuffle boundary."""

    kind: str                     # "groupby" | "join"
    keys: Tuple[str, ...]         # key columns the boundary hashes on
    hot_hashes: Tuple[int, ...]   # uint32 hash values declared hot
    k: int = 1                    # groupby: sub-partitions per hot key
    hot_cap: int = 0              # join: broadcast buffer rows per rank
    node_index: int = -1          # topo index (node-identity independent)

    def cache_token(self) -> Tuple:
        """What the stage-cache key carries for this decision.  Uses the
        topo index, not the nid, so two identically-shaped plans share
        built salted stages."""
        return (self.node_index, self.kind, self.keys, self.hot_hashes,
                self.k, self.hot_cap)

    def note(self) -> str:
        """The EXPLAIN ANALYZE annotation."""
        if self.kind == "groupby":
            return f"salted[k:{self.k}, hot:{len(self.hot_hashes)}]"
        return (f"salted[broadcast, hot:{len(self.hot_hashes)}, "
                f"cap:{self.hot_cap}]")


# ---------------------------------------------------------------------- #
# Host-side sampling over any table-ish execute() input
# ---------------------------------------------------------------------- #
def _sample_index(n: int, limit: Optional[int]) -> np.ndarray:
    """Evenly spaced positions of the rows a pass reads out of ``n``:
    all of them without ``limit``, else ``min(n, limit)``."""
    take = n if limit is None else min(n, limit)
    return (np.arange(take) * n) // max(take, 1)


def _dist_rows(table: Any, want: Sequence[str], limit: Optional[int]
               ) -> Dict[str, List[np.ndarray]]:
    """A ``DistTable``'s sampled rows: the JAX package's positions
    ``(arange(take) * n) // take`` within each rank's valid prefix,
    computed on the host from the row counts, gathered on the table's
    device (padded to the longest sample of any rank), and only those
    rows copied to the host.  Over a process group (``table.comm``) each
    process samples the ranks it holds and every rank's sample is
    gathered, so each process reads the rows of the stacked table, in
    rank order."""
    comm = getattr(table, "comm", None)
    counts = table.row_counts if comm is None else comm.world(table.row_counts)
    counts = counts.cpu().numpy()
    held = range(len(counts)) if comm is None else comm.rank().tolist()
    lens = [len(_sample_index(int(n), limit)) for n in counts]
    width = max(lens, default=0)
    out: Dict[str, List[np.ndarray]] = {c: [] for c in want}
    if not width:
        return out
    cap = table.capacity
    idx = np.zeros((table.parallelism, width), np.int64)
    for j, r in enumerate(held):
        idx[j, :lens[r]] = j * cap + _sample_index(int(counts[r]), limit)
    at = torch.from_numpy(idx.reshape(-1)).to(table.device)
    for c in want:
        v = table.columns[c]
        flat = signed_view(v).reshape((-1,) + tuple(v.shape[2:]))
        got = flat.index_select(0, at).reshape(idx.shape + tuple(v.shape[2:]))
        every = (got if comm is None else comm.world(got)).view(v.dtype)
        every = every.cpu().numpy()
        out[c] = [np.concatenate([every[r, :n] for r, n in enumerate(lens)])]
    return out


def _spill_rows(table: Any, want: Sequence[str], limit: Optional[int]
                ) -> Dict[str, List[np.ndarray]]:
    """A ``SpillTable``'s sampled rows, read out of each rank's chunks in
    place (the positions of ``rank_concat``'s rows, without building
    it).  Over a process group (``table.comm``) each process samples the
    ranks it holds and every rank's sample is gathered, in rank order."""
    out: Dict[str, List[np.ndarray]] = {c: [] for c in want}
    for r in range(table.parallelism):
        chunks = table.rank_chunks(r)
        lens = [len(next(iter(ch.values()))) if ch else 0 for ch in chunks]
        bounds = np.cumsum([0] + lens)
        idx = _sample_index(int(bounds[-1]), limit)
        if not len(idx):
            continue
        which = np.searchsorted(bounds, idx, side="right") - 1
        for i in np.unique(which):
            local = idx[which == i] - bounds[i]
            for c in want:
                out[c].append(np.asarray(chunks[i][c])[local])
    if getattr(table, "comm", None) is not None:
        parts = table.comm.gather_object(out)
        out = {c: [a for part in parts for a in part[c]] for c in want}
    return out


def _host_key_rows(table: Any, cols: Sequence[str],
                   limit: Optional[int]) -> Optional[Dict[str, np.ndarray]]:
    """Valid, non-null-key rows of ``cols`` as host numpy arrays.

    Accepts a ``DistTable`` (valid per-rank prefixes), a ``SpillTable``
    (rank chunks), or a raw numpy column mapping; returns ``None`` when a
    column is missing.  ``limit`` bounds the rows *pulled per rank* so a
    detection pass never transfers more than it needs.  The rows are the
    JAX package's, row for row."""
    want = list(cols) + [mask_name(c) for c in cols]

    def finish(parts: Dict[str, List[np.ndarray]]) -> Dict[str, np.ndarray]:
        out = {c: (np.concatenate(parts[c]) if parts[c]
                   else np.zeros((0,), np.int32)) for c in parts}
        keep = None
        for c in cols:
            m = out.get(mask_name(c))
            if m is not None:
                m = m.astype(bool)
                keep = m if keep is None else (keep & m)
        if keep is not None:
            out = {c: v[keep] for c, v in out.items()}
        return {c: out[c] for c in cols}

    if hasattr(table, "row_counts") and hasattr(table, "capacity"):
        if any(c not in table.columns for c in cols):
            return None
        return finish(_dist_rows(
            table, [c for c in want if c in table.columns], limit))

    if hasattr(table, "rank_chunks"):  # SpillTable
        if any(c not in table.column_names for c in cols):
            return None
        return finish(_spill_rows(
            table, [c for c in want if c in table.column_names], limit))

    if isinstance(table, Mapping):
        if any(c not in table for c in cols):
            return None
        parts = {}
        for c in want:
            if c in table:
                arr = np.asarray(table[c])
                parts[c] = [arr[_sample_index(len(arr), limit)]]
        return finish(parts)
    return None


def sample_key_columns(table: Any, cols: Sequence[str],
                       cfg: AdaptiveConfig
                       ) -> Optional[Dict[str, np.ndarray]]:
    """Evenly-spaced detection sample of ``cols`` (nulls excluded)."""
    return _host_key_rows(table, cols, limit=max(1, cfg.sample_rows))


# ---------------------------------------------------------------------- #
# Detection
# ---------------------------------------------------------------------- #
def detect_hot_keys(sampled: Optional[Mapping[str, np.ndarray]],
                    key_cols: Sequence[str], p: int,
                    cfg: AdaptiveConfig) -> Tuple[int, ...]:
    """Hot key *hashes* in a sample: frequency above ``factor/p`` (capped
    at 50% so small gangs can still fire), top ``max_hot_keys`` by count.

    Working on hashes rather than values keeps detection dtype-agnostic
    and exactly aligned with the device routing; a hash collision at
    worst salts one extra (cold) key, which stays correct."""
    if sampled is None or p <= 1 or not cfg.salting:
        return ()
    h = hash_columns_np(dict(sampled), list(key_cols))
    n = len(h)
    if n < _MIN_SAMPLE:
        return ()
    frac = min(0.5, cfg.hot_key_factor / p)
    thresh = max(4, int(np.ceil(n * frac)))
    vals, counts = np.unique(h, return_counts=True)
    order = np.argsort(counts)[::-1][:cfg.max_hot_keys]
    return tuple(sorted(int(vals[i]) for i in order
                        if counts[i] >= thresh))


def _count_hot_rows(table: Any, key_cols: Sequence[str],
                    hot: Tuple[int, ...], total_rows: int) -> Optional[int]:
    """How many of ``table``'s rows carry a hot key hash.

    Exact (full host hash pass) for modest tables; estimated from a
    bounded sample with 2x slack beyond ``_EXACT_COUNT_LIMIT`` rows."""
    exact = total_rows <= _EXACT_COUNT_LIMIT
    rows = _host_key_rows(table, key_cols,
                          limit=None if exact else 65536)
    if rows is None:
        return None
    h = hash_columns_np(dict(rows), list(key_cols))
    if not len(h):
        return 0
    got = int(np.isin(h, np.asarray(sorted(hot), h.dtype)).sum())
    if exact:
        return got
    return int(np.ceil(2.0 * got * total_rows / len(h)))


def _table_rows(table: Any) -> int:
    if hasattr(table, "total_rows"):
        try:
            return int(table.total_rows())
        except TypeError:
            pass
    if isinstance(table, Mapping) and table:
        return len(np.asarray(next(iter(table.values()))))
    return 0


def _chase_scan(node, cols: Sequence[str]):
    """Walk ``inputs[0]`` to a scan through key-preserving ops (or None)."""
    from ..planner.logical import preserves_rows_and_columns
    n = node
    while n.op != "scan":
        if not preserves_rows_and_columns(n, cols):
            return None
        n = n.inputs[0]
    return n


def _round8(x: int) -> int:
    return max(8, -(-int(x) // 8) * 8)


# ---------------------------------------------------------------------- #
# Per-plan decision pass (shared by the in-core and morsel executors)
# ---------------------------------------------------------------------- #
def plan_salt_decisions(order: Sequence[Any], tables: Mapping[str, Any],
                        p: int, cfg: AdaptiveConfig,
                        events: Optional[List[Dict[str, Any]]] = None
                        ) -> Dict[int, SaltDecision]:
    """Detect skew at every salting candidate of a lowered plan.

    ``order`` is the plan's topo order; returns ``{nid: SaltDecision}``
    for the candidates where detection fired.  Purely host-side: an
    empty result leaves execution (and every stage-cache key) exactly
    as ``adaptive=False`` would."""
    from ..planner.rules import skew_candidates
    out: Dict[int, SaltDecision] = {}
    if p <= 1 or not (cfg.enabled and cfg.salting):
        return out
    index = {n.nid: i for i, n in enumerate(order)}
    for node in skew_candidates(order):
        keys = (list(node.params["keys"]) if node.op == "groupby"
                else [node.params["on"]])
        scan = _chase_scan(node.inputs[0], keys)
        if scan is None:
            continue
        src = tables.get(scan.params["name"])
        if src is None or _table_rows(src) < cfg.min_table_rows:
            continue
        hot = detect_hot_keys(sample_key_columns(src, keys, cfg),
                              keys, p, cfg)
        if not hot:
            continue
        if node.op == "groupby":
            d = SaltDecision("groupby", tuple(keys), hot,
                             k=min(p, cfg.salt_k or p),
                             node_index=index[node.nid])
        else:
            bscan = _chase_scan(node.inputs[1], keys)
            if bscan is None:
                continue
            build = tables.get(bscan.params["name"])
            if build is None:
                continue
            n_hot = _count_hot_rows(build, keys, hot, _table_rows(build))
            if n_hot is None or n_hot > cfg.max_broadcast_rows:
                continue
            d = SaltDecision("join", tuple(keys), hot,
                             hot_cap=_round8(n_hot + 8),
                             node_index=index[node.nid])
        out[node.nid] = d
        if events is not None:
            events.append({"kind": "salted", "op": node.op,
                           "node_index": d.node_index,
                           "keys": list(d.keys),
                           "hot_keys": len(d.hot_hashes), "k": d.k,
                           "hot_cap": d.hot_cap})
    return out


def salt_cache_token(salt: Mapping[int, SaltDecision],
                     nids: Optional[Sequence[int]] = None) -> Tuple:
    """Stage-cache key suffix for the decisions covering ``nids`` (all
    when None).  Empty tuple when nothing fired — the no-new-keys case."""
    picked = sorted((d.cache_token() for nid, d in salt.items()
                     if nids is None or nid in set(nids)))
    return ("salt",) + tuple(picked) if picked else ()
