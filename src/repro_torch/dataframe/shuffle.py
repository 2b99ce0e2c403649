"""Distributed shuffle: capacity-based all-to-all (the paper's core comm op).

The torch counterpart of ``repro.dataframe.shuffle``, batched over the
ranks this process holds (all ``p`` when stacked, one over a process
group: ``Communicator.ranks_held``).  The MoE-capacity idiom:

  1. hash keys -> destination rank (or take explicit destinations),
  2. counts exchange (tiny all_to_all) for the receive counts,
  3. rows are bucketed into a ``(p, bucket_capacity)`` send buffer
     (overflow rows are dropped and *counted* —
     ``ShuffleStats.send_dropped``),
  4. one data all_to_all of the packed buffer (4-byte columns are bitcast
     into one ``(p, cap, ncols)`` 32-bit buffer), optionally *chunked*
     along the capacity axis (``a2a_chunks``),
  5. receive-side compaction back to a fixed-capacity ``Table``.

Two bucketize/compaction implementations (``impl``):

* ``"radix"`` (default) — sort-free.  The ``kernels.radix_partition``
  (rank-in-bucket, histogram) pair drives a direct scatter of the packed
  rows; on the receive side exclusive prefix sums over ``recv_counts``
  give every received row its output slot.  On a CUDA tensor the
  bucketize is the hand-written Hopper kernel.
* ``"sorted"`` — the two-sort baseline, kept as the parity oracle.

Both produce the same rows in the same slots as each other and as the JAX
package.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..comm import Communicator
from ..dtypes import bits_as, signed_view
from ..kernels import radix_partition
from .ops_local import hash_columns
from .table import Table, gather_rows, scatter_rows, stable_partition_order


@dataclasses.dataclass
class ShuffleStats:
    """Per-rank observability for one shuffle (tensors + static tags), for
    the ``h`` ranks held here."""

    sent_counts: torch.Tensor   # (h, p) rows sent to each rank
    recv_counts: torch.Tensor   # (h, p) rows received from each rank
    send_dropped: torch.Tensor  # (h,) rows dropped by send-bucket capacity
    recv_dropped: torch.Tensor  # (h,) rows dropped by receive capacity
    shuffle_impl: str = "radix"   # static: which bucketize path ran
    a2a_chunks: int = 1           # static: all-to-all pipeline depth


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def default_bucket_capacity(capacity: int, p: int,
                            factor: float = 2.0) -> int:
    """Per-destination bucket size: balanced share × skew headroom
    ``factor``, 8-aligned."""
    return max(8, _round_up(int(-(-capacity // p) * factor), 8))


#: column dtypes that travel in the packed 32-bit buffer
PACKABLE = (torch.float32, torch.int32, torch.bool)


def _pack_u32(cols: Dict[str, torch.Tensor], names) -> torch.Tensor:
    """Bitcast 4-byte columns to 32 bits and stack: (p, cap) xN ->
    (p, cap, N) int32 (bool masks widen to a 32-bit lane)."""
    parts = []
    for n in names:
        v = cols[n]
        if v.dtype == torch.float32:
            v = v.view(torch.int32)
        elif v.dtype == torch.bool:
            v = v.to(torch.int32)
        elif v.dtype != torch.int32:
            raise TypeError(n)
        parts.append(v)
    return torch.stack(parts, dim=-1)


def _unpack_u32(buf: torch.Tensor, names, dtypes) -> Dict[str, torch.Tensor]:
    out = {}
    for i, n in enumerate(names):
        v = buf[..., i]
        if dtypes[n] == torch.float32:
            v = v.contiguous().view(torch.float32)
        else:
            v = v.to(dtypes[n])
        out[n] = v
    return out


#: (label, rank) pairs that already warned since the last query start —
#: the morsel executor runs one shuffle PER MORSEL, so without dedupe a
#: streaming run spams identical warnings.  The executors reset this at
#: query start; totals stay exactly attributed via the end-of-query
#: ``describe_drops`` summary.
_warned_overflow: set = set()


def reset_overflow_warnings() -> None:
    """Start a fresh warn-once-per-(op label, rank) window (called by the
    executors at query start)."""
    _warned_overflow.clear()


def _overflow_warn(send_dropped: torch.Tensor, recv_dropped: torch.Tensor,
                   label: str = "") -> None:
    """Host-side overflow check (``debug_overflow=True``): warn, don't
    drop silently — and say *which* op and rank overflowed.  Reads the
    ``(p,)`` drop counters to the host (one synchronization per shuffle,
    only when asked for); deduplicated to once per (op label, rank) per
    query."""
    sent = send_dropped.cpu().tolist()
    recv = recv_dropped.cpu().tolist()
    for rank, (sd, rd) in enumerate(zip(sent, recv)):
        if not (sd or rd):
            continue
        key = (label or "shuffle", rank)
        if key in _warned_overflow:
            continue
        _warned_overflow.add(key)
        warnings.warn(
            f"{key[0]} @ rank {key[1]} dropped rows: send_dropped={sd} "
            f"recv_dropped={rd} (raise bucket_capacity / out_capacity or "
            f"capacity_factor; per-query totals are attributed in the "
            f"end-of-query summary)", RuntimeWarning, stacklevel=3)


def hash_dest(table: Table, key_cols: Sequence[str], p: int) -> torch.Tensor:
    """(p, cap) int32 destination rank ``hash(keys) % p`` of every row."""
    return (hash_columns(table, key_cols) % p).to(torch.int32)


def shuffle(
    table: Table,
    comm: Communicator,
    key_cols: Optional[Sequence[str]] = None,
    dest: Optional[torch.Tensor] = None,
    bucket_capacity: Optional[int] = None,
    out_capacity: Optional[int] = None,
    capacity_factor: float = 2.0,
    pack: bool = True,
    impl: str = "radix",
    a2a_chunks: int = 1,
    debug_overflow: bool = False,
    label: str = "",
) -> Tuple[Table, ShuffleStats]:
    """Repartition rows across ranks by key hash or explicit ``dest``.

    Without ``bucket_capacity`` each destination bucket holds the balanced
    share times ``capacity_factor``.  ``pack`` sends the 1-D 4-byte columns
    as one packed 32-bit buffer (``pack=False``: one collective per
    column); other columns, vector columns included, travel on their own
    either way.  ``impl`` selects the sort-free ``"radix"`` path or the ``"sorted"``
    baseline; ``a2a_chunks`` splits the data collective into k pieces.
    Dropped rows are always counted in the stats.  ``debug_overflow``
    additionally warns, once per (``label``, rank) per query, naming the
    op and the rank that dropped rows.
    """
    if impl not in ("radix", "sorted"):
        raise ValueError(f"unknown shuffle impl {impl!r}")
    p, h = comm.size(), comm.ranks_held()
    cap = table.capacity
    dev = table.device
    bucket_cap = bucket_capacity or default_bucket_capacity(
        cap, p, capacity_factor)
    out_cap = out_capacity or cap
    # the output keeps the capacity the requested buckets give it
    out_size = min(p * bucket_cap, out_cap)
    if impl == "radix":
        # a rank never sends more rows than it holds, so a bucket past
        # ``cap`` rows only pads the send and receive buffers (p*p*bucket
        # slots on one device): the same rows land in the same slots
        bucket_cap = min(bucket_cap, cap)
    valid = table.valid_mask()

    if dest is None:
        if not key_cols:
            raise ValueError("need key_cols or dest")
        dest = hash_dest(table, key_cols, p)
    dest = torch.where(valid, dest.to(torch.int32), p)  # invalid -> bin p

    # --- bucketize: per-row send-buffer slot ----------------------------- #
    order = None
    if impl == "radix":
        row_rank, hist = radix_partition(dest, p + 1)
        raw_counts = hist[:, :p]
        row_dest = dest
    else:
        srt = torch.sort(dest, dim=1, stable=True)
        order, row_dest = srt.indices, srt.values
        pos = torch.arange(cap, device=dev)
        row_rank = pos - torch.searchsorted(row_dest, row_dest, side="left")
        raw_counts = torch.zeros((h, p + 1), dtype=torch.int32,
                                 device=dev).scatter_add_(
            1, dest.to(torch.int64), torch.ones_like(dest))[:, :p]

    sent_counts = torch.clamp(raw_counts, max=bucket_cap)
    send_dropped = (raw_counts - sent_counts).sum(dim=1, dtype=torch.int32)

    in_bucket = (row_dest < p) & (row_rank < bucket_cap)
    slot = torch.where(in_bucket, row_dest.to(torch.int64) * bucket_cap
                       + row_rank, p * bucket_cap)

    names = table.column_names
    dtypes = {n: table.columns[n].dtype for n in names}
    packables = [n for n in names if dtypes[n] in PACKABLE
                 and table.columns[n].dim() == 2] if pack else []
    singles = [n for n in names if n not in packables]

    def _send(col: torch.Tensor) -> torch.Tensor:
        # radix: direct scatter by original row; sorted: rows were gathered
        # into destination order first
        if order is not None:
            col = gather_rows(col, order)
        buf = scatter_rows(p * bucket_cap, slot, col)
        buf = buf.reshape((h, p, bucket_cap) + col.shape[2:])
        got = comm.all_to_all_chunked(buf, chunks=a2a_chunks)
        return got.reshape((h, p * bucket_cap) + col.shape[2:])

    recv_cols: Dict[str, torch.Tensor] = {}
    if packables:
        recv_cols.update(_unpack_u32(
            _send(_pack_u32(table.columns, packables)), packables, dtypes))
    for n in singles:
        # unsigned columns travel as bits (dtypes.signed_view)
        recv_cols[n] = bits_as(_send(signed_view(table.columns[n])),
                               dtypes[n])

    recv_counts = comm.exchange_counts(sent_counts)
    total_recv = recv_counts.sum(dim=1, dtype=torch.int32)
    new_count = torch.clamp(total_recv, max=out_cap)

    # --- receive-side compaction ----------------------------------------- #
    ridx = torch.arange(p * bucket_cap, device=dev)
    blk, q = ridx // bucket_cap, ridx % bucket_cap
    r_valid = q[None, :] < recv_counts[:, blk]
    if impl == "radix":
        # slot of a valid row (blk, q) is its rank in the (source-rank,
        # slot) enumeration = exclusive prefix over recv_counts
        offsets = torch.cumsum(recv_counts, dim=1) - recv_counts
        out_pos = offsets[:, blk].to(torch.int64) + q[None, :]
        out_pos = torch.where(r_valid & (out_pos < out_size), out_pos,
                              out_size)
        out_cols = {n: scatter_rows(out_size, out_pos, v)
                    for n, v in recv_cols.items()}
    else:
        order2 = torch.sort((~r_valid).to(torch.int32), dim=1,
                            stable=True).indices[:, :out_cap]
        out_cols = {n: gather_rows(v, order2) for n, v in recv_cols.items()}

    recv_dropped = torch.clamp(total_recv - out_cap, min=0)
    if debug_overflow:
        _overflow_warn(comm.world(send_dropped), comm.world(recv_dropped),
                       label)
    out = Table(out_cols, new_count).mask_padding()
    stats = ShuffleStats(sent_counts, recv_counts, send_dropped,
                         recv_dropped, shuffle_impl=impl,
                         a2a_chunks=a2a_chunks)
    return out, stats


def replicate_hot_rows(
    table: Table,
    comm: Communicator,
    is_hot: torch.Tensor,
    hot_cap: int,
    base: Table,
) -> Tuple[Table, ShuffleStats]:
    """Broadcast each rank's ``is_hot`` rows to every rank, appended to
    ``base`` (the skew-mitigated build side of a broadcast join).

    The salted join path excludes hot build rows from the hash shuffle
    (they route to the overflow bin ``p``, uncounted) and replicates them
    here instead: a stable compaction into ``hot_cap`` slots per rank, one
    packed ``all_gather``, then a prefix-sum append onto ``base`` past its
    ``row_count``.  Output capacity is ``base.capacity + p * hot_cap``;
    rows beyond ``hot_cap`` on one rank ARE counted as ``send_dropped``
    (the decision layer sizes ``hot_cap`` from an exact host count
    precisely so this stays zero).
    """
    p, h = comm.size(), comm.ranks_held()
    cap = table.capacity
    dev = table.device
    k = min(int(hot_cap), cap)  # per-rank slots, the same on every rank
    hot = is_hot & table.valid_mask()
    n_hot = hot.sum(dim=1, dtype=torch.int32)
    sent = torch.clamp(n_hot, max=k)
    dropped = n_hot - sent

    order = stable_partition_order(hot)[:, :k]
    counts = comm.all_gather(sent)                      # (h, p) everywhere
    offsets = torch.cumsum(counts, dim=1) - counts      # exclusive
    total = counts.sum(dim=1, dtype=torch.int32)

    base_cap = base.capacity
    new_cap = base_cap + p * k
    start = base.row_count
    # start <= base_cap and total <= p*k, so the append never overflows
    idx = torch.arange(p * k, device=dev)
    blk, q = idx // k, idx % k
    g_valid = q[None, :] < counts[:, blk]
    pos = torch.where(g_valid, (start[:, None] + offsets[:, blk]).to(
        torch.int64) + q[None, :], new_cap)

    names = base.column_names
    dtypes = {n: table.columns[n].dtype for n in names}
    packables = [n for n in names if dtypes[n] in PACKABLE
                 and table.columns[n].dim() == 2]
    singles = [n for n in names if n not in packables]

    def _gather(col: torch.Tensor) -> torch.Tensor:
        got = comm.all_gather(gather_rows(col, order))  # (h, p, k, ...)
        return got.reshape((h, p * k) + col.shape[2:])

    def _append(n: str, flat: torch.Tensor) -> torch.Tensor:
        # base rows first, then the gathered hot rows past row_count; slot
        # new_cap is the trash slot of JAX's mode="drop"
        b = signed_view(base.columns[n])
        out = torch.zeros((h, new_cap + 1) + b.shape[2:], dtype=b.dtype,
                          device=dev)
        out[:, :base_cap] = b
        at = pos.reshape(pos.shape + (1,) * (flat.dim() - 2)).expand(
            flat.shape)
        out.scatter_(1, at, flat.to(b.dtype))
        return out[:, :new_cap].view(dtypes[n])

    out_cols: Dict[str, torch.Tensor] = {}
    if packables:
        got = _gather(_pack_u32(table.columns, packables))
        for n, v in _unpack_u32(got, packables, dtypes).items():
            out_cols[n] = _append(n, signed_view(v))
    for n in singles:
        out_cols[n] = _append(n, _gather(signed_view(table.columns[n])))

    new_count = (start + total).to(torch.int32)
    out = Table(out_cols, new_count).mask_padding()
    # this rank sends its ``sent`` hot rows to every rank and receives
    # each rank's contribution once — the honest wire accounting
    stats = ShuffleStats(sent[:, None].expand(h, p).contiguous(), counts,
                         dropped, torch.zeros((h,), dtype=torch.int32,
                                              device=dev))
    return out, stats
