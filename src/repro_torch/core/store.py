"""CylonStore + host-resident spill tables (paper §IV-C, extended for
out-of-core execution).

The torch counterpart of ``repro.core.store``.  Two pieces live here:

* ``SpillTable`` — the host-resident representation of a distributed table:
  per-rank lists of contiguous numpy chunks (the spill format of the morsel
  executor).  Shuffle output rows accumulate into these per-destination
  buckets as morsels stream through a plan; the same structure backs
  ``repartition`` as a *bucketed rescatter* (no full-table host gather).
* ``CylonStore`` — keyed store of distributed tables shared with downstream
  applications.  ``get`` with a different target parallelism (or capacity)
  triggers the repartition routine the paper calls out.

Host chunks keep their host dtypes, as in the JAX package; 64-bit columns
narrow (``dtypes.to_x32``) only where rows go up to the device, which is
where ``jnp.asarray`` narrows them there.  Rows that come down from a card
land in reusable pinned staging buffers and are copied out into pageable
chunks (``fetch_valid``).

Over a ``torch.distributed`` process group a ``SpillTable`` holds only
the ranks its process holds (``comm``, as ``DistTable.comm``): the rows
rank r holds when every rank is stacked.  What needs every rank's rows
counts them over the group (``num_morsels``, ``total_rows``), and rows
routed to another process's rank (``respill_routed``, ``rescatter``)
travel through the communicator's host exchange, so every process ends
with exactly the rows, in the order, that rank r gets when stacked.

Between gangs of processes (``CylonStore(pool=DevicePool(process_group=
...))``, the §IV-C hand-off from a preprocessing gang to a training
gang): ``rescatter`` with ``onto=Handoff(...)`` moves a table held by
gang A's processes to ``q`` ranks held by another gang's, through a
communicator over every process of both (the world's).  Every process
of that world calls it; a target process ends with exactly rank r of the
stacked re-split, any other with ``None``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..dataframe.schema import decode_columns, encode_columns
from ..dtypes import to_x32, x32_dtype
from ..nulls import apply_null_columns, extract_null_columns
from ..obs.trace import NULL_TRACER
from .env import DevicePool, DistTable, resolve_device


def _round8(x: int) -> int:
    return max(8, -(-int(x) // 8) * 8)


class D2HStaging:
    """Reusable page-locked landing buffers for device-to-host copies.

    One buffer per column name, grown when a copy needs more rows.  Rows
    are copied out of a buffer into pageable numpy arrays before the
    buffer is reused, so no spilled chunk keeps page-locked memory alive
    and the pinned footprint stays one morsel output wide."""

    def __init__(self):
        self._bufs: Dict[str, torch.Tensor] = {}

    def land(self, name: str, src: torch.Tensor) -> torch.Tensor:
        """Enqueue an asynchronous copy of ``src`` into ``name``'s buffer
        and return the landing view (valid once the stream is synced)."""
        buf = self._bufs.get(name)
        if (buf is None or buf.dtype != src.dtype
                or buf.numel() < src.numel()):
            buf = torch.empty(src.numel(), dtype=src.dtype, pin_memory=True)
            self._bufs[name] = buf
        dst = buf[:src.numel()].view(src.shape)
        dst.copy_(src, non_blocking=True)
        return dst

    def buffers(self) -> List[torch.Tensor]:
        return list(self._bufs.values())


def fetch_valid(table: DistTable, staging: Optional[D2HStaging] = None
                ) -> Tuple[np.ndarray, List[Dict[str, np.ndarray]], int]:
    """Copy a ``DistTable``'s valid rows to the host.

    The row counts come first (one synchronization), then every column's
    rows up to the fullest rank's count; on a card they land in
    ``staging``'s pinned buffers with asynchronous copies (one more
    synchronization for all of them).  Each rank's valid rows are then
    copied into pageable numpy arrays of their own, which share memory
    with neither the staging buffers nor the table's tensors.  Returns
    ``(counts, [per-rank {name: rows}], bytes copied off the device)``."""
    counts = table.row_counts.cpu().numpy()
    widest = int(counts.max()) if len(counts) else 0
    on_card = table.device.type == "cuda"
    if on_card and staging is None:
        staging = D2HStaging()
    copied = counts.nbytes
    host: Dict[str, torch.Tensor] = {}
    try:
        for name, v in table.columns.items():
            src = v[:, :widest]
            host[name] = staging.land(name, src) if on_card else src
            copied += src.numel() * src.element_size()
    finally:
        # also on an exception: no landing copy may still be in flight
        # when the buffers are reused (the ``transfer:d2h`` fault site is
        # visited before this call, so a replay starts with them idle)
        if on_card:
            torch.cuda.current_stream(table.device).synchronize()
    arrays = {n: t.numpy() for n, t in host.items()}
    rows = [{n: np.array(a[r, :int(c)]) for n, a in arrays.items()}
            for r, c in enumerate(counts)]
    return counts, rows, copied


# ---------------------------------------------------------------------- #
# Host-resident spill table
# ---------------------------------------------------------------------- #
class SpillTable:
    """Host-resident spill of a distributed table: per-rank chunk lists.

    Each chunk is a dict of equal-length contiguous numpy arrays (one
    morsel's worth of rows for that rank).  Rank placement is semantic —
    chunk rows belong to that rank exactly as a ``DistTable`` rank's rows
    do — so a ``SpillTable`` is the out-of-core twin of ``DistTable`` and
    can hold arbitrarily many rows per rank at zero device memory.

    ``schema`` (name -> (dtype, trailing shape)) is fixed at construction or
    by the first ``append``, so empty ranks and zero-row tables keep their
    columns and dtypes.  ``dictionaries`` carries the sorted per-column
    dictionaries of string columns (chunks hold int32 codes), exactly like
    ``DistTable.dictionaries``; spill/respill/rescatter preserve it.
    """

    def __init__(self, parallelism: int,
                 schema: Optional[Mapping[str, Tuple[np.dtype, Tuple[int, ...]]]]
                 = None,
                 dictionaries: Optional[Mapping[str, Tuple[str, ...]]] = None,
                 comm: Optional[Any] = None):
        if parallelism < 1:
            raise ValueError(f"parallelism must be >= 1, got {parallelism}")
        #: the ranks held here (every rank, or those of ``comm``)
        self.parallelism = parallelism
        #: a process-group communicator when this process holds only some
        #: of the table's ranks (``comm.rank()``); None when it holds all
        self.comm = comm
        self.dictionaries: Dict[str, Tuple[str, ...]] = \
            dict(dictionaries or {})
        #: ``repro_torch.io.IngestInfo`` when read from Parquet/CSV, else None
        self.provenance = None
        self._chunks: List[List[Dict[str, np.ndarray]]] = \
            [[] for _ in range(parallelism)]
        self._schema: Optional[Dict[str, Tuple[np.dtype, Tuple[int, ...]]]] = (
            {k: (np.dtype(d), tuple(s)) for k, (d, s) in schema.items()}
            if schema is not None else None)

    # -- schema --------------------------------------------------------- #
    @property
    def column_names(self) -> Tuple[str, ...]:
        return tuple(sorted(self._schema)) if self._schema else ()

    @property
    def schema(self):
        return dict(self._schema) if self._schema else {}

    def _check_schema(self, columns: Dict[str, np.ndarray]) -> None:
        got = {k: (v.dtype, v.shape[1:]) for k, v in columns.items()}
        if self._schema is None:
            self._schema = got
            return
        if got != self._schema:
            raise ValueError(
                f"chunk schema {got} != spill schema {self._schema}")

    # -- writing -------------------------------------------------------- #
    def append(self, rank: int, columns: Mapping[str, np.ndarray]) -> int:
        """Append one chunk of rows to ``rank``'s bucket; returns its bytes."""
        cols = {k: np.ascontiguousarray(v) for k, v in columns.items()}
        if not cols:
            raise ValueError("cannot append a chunk with no columns")
        n = len(next(iter(cols.values())))
        for k, v in cols.items():
            if len(v) != n:
                raise ValueError(f"column {k!r} length {len(v)} != {n}")
        self._check_schema(cols)
        if n == 0:
            return 0
        self._chunks[rank].append(cols)
        return sum(v.nbytes for v in cols.values())

    # -- ranks ---------------------------------------------------------- #
    @property
    def size(self) -> int:
        """Ranks in all (the group's size over a process group)."""
        return self.comm.size() if self.comm is not None else self.parallelism

    def held(self) -> List[int]:
        """The global index of each rank held here."""
        if self.comm is None:
            return list(range(self.parallelism))
        return [int(r) for r in self.comm.rank().tolist()]

    def world_rows(self) -> np.ndarray:
        """(size,) rows of every rank; over a process group a collective
        every process must call."""
        mine = [self.rank_rows(r) for r in range(self.parallelism)]
        if self.comm is None:
            return np.asarray(mine, np.int64)
        return self.comm.gather_ints(mine).reshape(-1)

    def select(self, comm: Any) -> "SpillTable":
        """The ranks ``comm`` holds of this whole table (every process of
        a group given the same table keeps its own ranks)."""
        if self.comm is not None or comm is None or \
                comm.ranks_held() == comm.size():
            return self
        if comm.size() != self.parallelism:
            raise ValueError(f"a spill of {self.parallelism} ranks for a "
                             f"group of {comm.size()}")
        held = [int(r) for r in comm.rank().tolist()]
        out = SpillTable(len(held), schema=self.schema or None,
                         dictionaries=self.dictionaries, comm=comm)
        out.provenance = self.provenance
        out._chunks = [list(self._chunks[r]) for r in held]
        return out

    # -- reading -------------------------------------------------------- #
    def rank_chunks(self, rank: int) -> Tuple[Dict[str, np.ndarray], ...]:
        return tuple(self._chunks[rank])

    def rank_rows(self, rank: int) -> int:
        return sum(len(next(iter(c.values()))) for c in self._chunks[rank])

    def total_rows(self) -> int:
        """Every rank's rows (over a process group: a collective)."""
        if self.comm is not None:
            return int(self.world_rows().sum())
        return sum(self.rank_rows(r) for r in range(self.parallelism))

    def nbytes(self) -> int:
        return sum(v.nbytes for chunks in self._chunks
                   for c in chunks for v in c.values())

    def _empty_cols(self) -> Dict[str, np.ndarray]:
        return {k: np.zeros((0,) + s, d)
                for k, (d, s) in (self._schema or {}).items()}

    def rank_concat(self, rank: int) -> Dict[str, np.ndarray]:
        chunks = self._chunks[rank]
        if not chunks:
            return self._empty_cols()
        return {k: np.concatenate([c[k] for c in chunks], axis=0)
                for k in chunks[0]}

    def to_numpy(self, decode: bool = True, nulls: str = "pandas"
                 ) -> Dict[str, np.ndarray]:
        """Gather valid rows from every rank in rank order (host side).

        ``decode=True`` (default) maps dictionary-encoded columns back to
        numpy string arrays; ``decode=False`` returns the raw codes.
        ``nulls="pandas"`` (default) re-materializes ``__m_*`` validity
        masks as NaN / ``None``; ``nulls="mask"`` returns the raw physical
        layout (canonical-zero data + bool masks) for bit-identity checks.
        Over a process group: the ranks this process holds
        (``gather_numpy`` gives every rank's)."""
        if nulls not in ("pandas", "mask"):
            raise ValueError(f"nulls must be 'pandas' or 'mask', got {nulls!r}")
        parts = [self.rank_concat(r) for r in range(self.parallelism)]
        names = self.column_names
        if not names:
            return {}
        out = {k: np.concatenate([p[k] for p in parts], axis=0)
               for k in names}
        if decode and self.dictionaries:
            out = decode_columns(out, self.dictionaries)
        if nulls == "pandas":
            out = apply_null_columns(out)
        return out

    def gather_numpy(self, decode: bool = True, nulls: str = "pandas"
                     ) -> Dict[str, np.ndarray]:
        """``to_numpy`` of every rank, on every process of the group (a
        collective): what ``to_numpy`` gives when the ranks are stacked."""
        if self.comm is None:
            return self.to_numpy(decode=decode, nulls=nulls)
        whole = SpillTable(self.size, schema=self.schema or None,
                           dictionaries=self.dictionaries)
        for r, part in enumerate(self.comm.gather_object(
                self.to_numpy(decode=False, nulls="mask"))):
            if part and len(next(iter(part.values()))):
                whole.append(r, part)
        return whole.to_numpy(decode=decode, nulls=nulls)

    def num_morsels(self, morsel_rows: int) -> int:
        """Morsels needed to stream the widest rank at ``morsel_rows`` each
        (over a process group the widest rank of the group, so every
        process streams the same number)."""
        widest = int(self.world_rows().max())
        return max(1, -(-widest // max(1, morsel_rows)))

    # -- constructors ---------------------------------------------------- #
    @classmethod
    def from_numpy(cls, data: Mapping[str, np.ndarray], parallelism: int,
                   chunk_rows: Optional[int] = None,
                   comm: Optional[Any] = None) -> "SpillTable":
        """Block-distribute host rows over ``parallelism`` rank buckets,
        optionally pre-chunked into ``chunk_rows``-row pieces.  String
        columns are dictionary-encoded (chunks hold int32 codes); every
        other column keeps its host dtype.  With ``comm``, a process-group
        communicator, only the ranks this process holds are kept (``data``
        is the whole table on every process)."""
        data = {k: np.asarray(v) for k, v in data.items()}
        if not data:
            raise ValueError("need at least one column")
        data = extract_null_columns(data)
        data, dicts = encode_columns(data)
        n = len(next(iter(data.values())))
        per = -(-n // parallelism) if n else 0
        out = cls(parallelism,
                  schema={k: (v.dtype, v.shape[1:]) for k, v in data.items()},
                  dictionaries=dicts)
        for r in range(parallelism):
            block = {k: v[r * per:(r + 1) * per] for k, v in data.items()}
            rows = len(next(iter(block.values())))
            step = chunk_rows or max(rows, 1)
            for s in range(0, rows, step):
                out.append(r, {k: v[s:s + step] for k, v in block.items()})
        return out.select(comm)

    @classmethod
    def from_dist(cls, table: DistTable) -> "SpillTable":
        """Spill a device-resident DistTable: one host chunk per rank."""
        counts, rows, _ = fetch_valid(table)
        out = cls(table.parallelism,
                  schema={k: (v.dtype, v.shape[1:])
                          for k, v in rows[0].items()},
                  dictionaries=table.dictionaries, comm=table.comm)
        out.provenance = table.provenance
        for r, chunk in enumerate(rows):
            if counts[r]:
                out.append(r, chunk)
        return out


# ---------------------------------------------------------------------- #
# Checkpoints: spill buckets as durable replay points
# ---------------------------------------------------------------------- #
class Checkpoint:
    """A schema-stamped, reference-counted guard over a ``SpillTable``.

    Comm-boundary spills are the natural checkpoints of the morsel executor:
    a segment's input spill is read-only while the segment streams, so a
    failed segment attempt can replay from it verbatim.  The checkpoint
    makes that contract explicit:

    * ``stamp`` — a cheap content stamp (schema, dictionaries, per-rank
      row counts, total bytes) taken at creation; ``validate()`` recomputes
      it before every replay and refuses a mutated or truncated spill.
    * reference counting — ``retain``/``release`` keep the checkpoint (and
      the spill it guards) alive across failed attempts; it is only
      considered consumed when the owning segment commits.  ``released``
      checkpoints refuse further validation, so a stale replay is an error
      rather than silent corruption.
    """

    def __init__(self, spill: SpillTable):
        self.spill = spill
        self._refs = 1
        self.stamp = self._stamp(spill)

    @staticmethod
    def _stamp(spill: SpillTable) -> Tuple:
        return (
            tuple(sorted((k, str(d), tuple(s))
                         for k, (d, s) in spill.schema.items())),
            tuple(sorted((k, tuple(v))
                         for k, v in spill.dictionaries.items())),
            tuple(spill.rank_rows(r) for r in range(spill.parallelism)),
            spill.nbytes(),
        )

    @property
    def refs(self) -> int:
        return self._refs

    @property
    def released(self) -> bool:
        return self._refs <= 0

    def retain(self) -> "Checkpoint":
        if self.released:
            raise RuntimeError("cannot retain a released checkpoint")
        self._refs += 1
        return self

    def release(self) -> None:
        """Drop one reference; at zero the checkpoint is consumed (the
        spill itself is NOT freed — it may be the caller's input data)."""
        if self._refs > 0:
            self._refs -= 1

    def validate(self) -> SpillTable:
        """Re-stamp the spill and return it for replay; raises on drift."""
        if self.released:
            raise RuntimeError(
                "checkpoint was released (segment already committed); "
                "replaying from it would read consumed state")
        now = self._stamp(self.spill)
        if now != self.stamp:
            raise RuntimeError(
                f"checkpoint validation failed: spill changed since the "
                f"checkpoint was taken (rows {self.stamp[2]} -> {now[2]}, "
                f"bytes {self.stamp[3]} -> {now[3]})")
        return self.spill


def _route_chunks(spill: SpillTable, parallelism: int, rows: np.ndarray
                  ) -> List[List[Dict[str, np.ndarray]]]:
    """Block-route every held chunk's rows to per-destination bucket lists
    by global offset (each chunk slices across at most a few
    destinations); ``rows`` is every rank's row count
    (``spill.world_rows()``), so a held rank's rows start after every
    earlier rank's.  The single routing loop behind both ``respill`` and
    ``rescatter``."""
    per = -(-max(int(rows.sum()), 1) // parallelism)
    buckets: List[List[Dict[str, np.ndarray]]] = [[] for _ in range(parallelism)]
    for r, rank in enumerate(spill.held()):
        g = int(rows[:rank].sum())
        for chunk in spill.rank_chunks(r):
            m = len(next(iter(chunk.values())))
            start = 0
            while start < m:
                dest = min((g + start) // per, parallelism - 1)
                take = min(m - start, (dest + 1) * per - (g + start))
                buckets[dest].append(
                    {k: v[start:start + take] for k, v in chunk.items()})
                start += take
            g += m
    return buckets


@dataclasses.dataclass
class GangRecord:
    """Where a table held by a gang of processes lives, as every process
    of the world records it (``CylonStore.put`` agrees it): the world
    ranks holding its ranks 0..p-1, each rank's rows, the schema of its
    host rows, its dictionaries and its capacity (None for a spill)."""

    ranks: Tuple[int, ...]
    counts: Tuple[int, ...]
    schema: Dict[str, Tuple[np.dtype, Tuple[int, ...]]]
    dictionaries: Dict[str, Tuple[str, ...]]
    capacity: Optional[int]


@dataclasses.dataclass
class Handoff:
    """A move of the table ``source`` describes to ``len(ranks)`` ranks
    held by world ranks ``ranks``, through ``world`` (a process-group
    communicator over every process of both gangs); ``comm`` is this
    process's communicator over the target gang, None off it.  With
    ``keep`` (as many target ranks as source ranks) target rank r gets
    source rank r's rows, as the stacked ``CylonStore.get`` at the same
    size keeps the table."""

    world: Any
    source: GangRecord
    ranks: Tuple[int, ...]
    comm: Optional[Any] = None
    keep: bool = False


def _hand_off(spill: Optional[SpillTable], h: Handoff
              ) -> Optional[List[Dict[str, np.ndarray]]]:
    """Route this process's rows of ``h.source`` (``spill``: its rank,
    None off the source gang) by global block index to the target ranks,
    in one host exchange over ``h.world``; the chunks this process's
    target rank receives, by source rank, or None off the target gang."""
    counts = np.asarray(h.source.counts, np.int64)
    pieces: List[Optional[Dict[str, np.ndarray]]] = [None] * h.world.size()
    if spill is not None and h.keep:
        r = spill.held()[0]
        if counts[r]:
            pieces[h.ranks[r]] = spill.rank_concat(0)
    elif spill is not None:
        for t, parts in enumerate(_route_chunks(spill, len(h.ranks),
                                                counts)):
            if parts:
                pieces[h.ranks[t]] = {
                    k: np.concatenate([c[k] for c in parts], axis=0)
                    for k in h.source.schema}
    got = h.world.exchange_rows(pieces, h.source.schema)
    if h.world.me not in h.ranks:
        return None
    return [got[w] for w in h.source.ranks
            if len(next(iter(got[w].values())))]


def respill(spill: SpillTable, parallelism: int,
            tracer=NULL_TRACER) -> SpillTable:
    """Re-bucket a SpillTable to a different gang size, chunk by chunk.

    Host-only (no device materialization — the spill may not fit a
    ``DistTable``).  ``tracer`` records a span with rows/bytes moved.  A
    spill over a process group keeps its gang size: ``rescatter(onto=)``
    (``CylonStore.get``) moves it to another gang of processes."""
    if parallelism == spill.size:
        return spill
    if spill.comm is not None:
        raise ValueError(f"a spill over a process group of {spill.size} "
                         f"ranks cannot be re-bucketed to {parallelism}; "
                         f"rescatter(onto=Handoff(...)) moves it to "
                         f"another gang")
    with tracer.span("respill", "spill", from_p=spill.parallelism,
                     to_p=parallelism, rows=spill.total_rows(),
                     bytes=spill.nbytes()):
        out = SpillTable(parallelism, schema=spill.schema or None,
                         dictionaries=spill.dictionaries)
        out.provenance = spill.provenance
        for dest, pieces in enumerate(
                _route_chunks(spill, parallelism, spill.world_rows())):
            for piece in pieces:
                out.append(dest, piece)
    return out


def respill_routed(spill: SpillTable, dest_of,
                   tracer=NULL_TRACER) -> SpillTable:
    """Re-route a SpillTable's rows by an arbitrary per-row rule.

    ``dest_of(cols: Dict[str, np.ndarray]) -> np.ndarray[int]`` maps one
    chunk's columns to destination ranks; the routing itself stays a
    host-only chunk-by-chunk pass like ``respill`` (peak extra memory is
    one chunk).  ``tracer`` records a span with rows/bytes moved.  Over a
    process group the rows bound for another process's rank go through
    the communicator's host exchange; each rank receives its rows in the
    stacked order (by source rank, then chunk)."""
    with tracer.span("respill-routed", "spill", p=spill.size,
                     rows=spill.total_rows(), bytes=spill.nbytes()):
        out = SpillTable(spill.parallelism, schema=spill.schema or None,
                         dictionaries=spill.dictionaries, comm=spill.comm)
        out.provenance = spill.provenance
        pieces: List[List[Dict[str, np.ndarray]]] = \
            [[] for _ in range(spill.size)]
        for r in range(spill.parallelism):
            for chunk in spill.rank_chunks(r):
                dest = np.asarray(dest_of(chunk))
                if dest.ndim != 1 or \
                        len(dest) != len(next(iter(chunk.values()))):
                    raise ValueError("dest_of must return one rank per row")
                for d in np.unique(dest):
                    sel = dest == d
                    pieces[int(d)].append(
                        {k: v[sel] for k, v in chunk.items()})
        if spill.comm is None:
            for d, parts in enumerate(pieces):
                for piece in parts:
                    out.append(d, piece)
        else:
            for piece in _exchange(spill, pieces):
                out.append(0, piece)
    return out


def _exchange(spill: SpillTable,
              pieces: Sequence[Sequence[Dict[str, np.ndarray]]]
              ) -> List[Dict[str, np.ndarray]]:
    """Send ``pieces[d]`` (chunks, in order) to rank ``d`` over the
    spill's process group; returns the chunks this process's rank
    receives, in source-rank order."""
    schema = spill.schema
    if not schema:      # no columns anywhere: nothing to move
        return []
    got = spill.comm.exchange_rows(
        [{k: np.concatenate([c[k] for c in parts], axis=0) for k in schema}
         if parts else None for parts in pieces], schema)
    return [g for g in got if len(next(iter(g.values())))]


# ---------------------------------------------------------------------- #
# Bucketed rescatter (replaces the host-gather repartition)
# ---------------------------------------------------------------------- #
def rescatter(spill: Optional[SpillTable], parallelism: int,
              capacity: Optional[int] = None, device=None,
              tracer=NULL_TRACER, comm: Optional[Any] = None, *,
              onto: Optional[Handoff] = None) -> Optional[DistTable]:
    """SpillTable -> DistTable over a (possibly different) gang size, on
    ``device`` (``None``: the card).

    Rows are routed chunk-by-chunk into per-destination host buckets by
    their global block index — no rank's data is ever concatenated into a
    single full-table host array, so peak extra host memory is one
    destination rank, not the whole table.  64-bit columns narrow on the
    way up (``dtypes.to_x32``).  ``tracer`` records the H2D volume as an
    instant event.

    Over a process group only the ranks this process holds are built: of
    a spill over the group (``spill.comm``) whose rows are routed through
    the communicator's host exchange, or of a whole spill given to every
    process (``comm``: the group's communicator).  With ``onto``
    (``Handoff``) a spill held by one gang of processes lands on another
    gang's ``parallelism`` ranks: every process of the world calls it
    (``spill`` None off the source gang); a target process gets its rank,
    any other ``None``.
    """
    if onto is not None:
        if parallelism != len(onto.ranks):
            raise ValueError(f"{parallelism} ranks onto world ranks "
                             f"{list(onto.ranks)}")
        rows = np.asarray(onto.source.counts, np.int64)
        schema, dicts = onto.source.schema, onto.source.dictionaries
        provenance = None
    else:
        if spill.comm is not None and parallelism != spill.size:
            raise ValueError(f"a spill over a process group of "
                             f"{spill.size} ranks moves to {parallelism} "
                             f"through onto=Handoff(...)")
        rows = spill.world_rows()
        schema, dicts = spill.schema, spill.dictionaries
        provenance = spill.provenance
    dev = resolve_device(device)
    n = int(rows.sum())
    tracer.instant("rescatter", "transfer", to_p=parallelism, rows=n,
                   bytes=spill.nbytes() if spill is not None else 0)
    per = -(-max(n, 1) // parallelism)
    if onto is not None and onto.keep:
        per = int(rows.max())
        if capacity is None:
            capacity = onto.source.capacity
    cap = capacity if capacity is not None else _round8(per)
    if per > cap and n > 0:
        raise ValueError(f"rows/shard {per} exceeds capacity {cap}")
    if onto is not None:
        got = _hand_off(spill, onto)
        if got is None:
            return None
        comm = onto.comm if parallelism > 1 else None
        buckets = [got]
    else:
        buckets = _route_chunks(spill, parallelism, rows)
        if spill.comm is not None:
            comm = spill.comm
            buckets = [_exchange(spill, buckets)]
        elif comm is not None and comm.ranks_held() < comm.size():
            buckets = [buckets[r] for r in comm.rank().tolist()]
        else:
            comm = None
    cols: Dict[str, torch.Tensor] = {}
    counts = np.zeros((len(buckets),), np.int32)
    for name, (dtype, trail) in schema.items():
        buf = np.zeros((len(buckets), cap) + trail, x32_dtype(dtype))
        for d, pieces in enumerate(buckets):
            pos = 0
            for piece in pieces:
                v = to_x32(piece[name])
                buf[d, pos:pos + len(v)] = v
                pos += len(v)
            counts[d] = pos
        cols[name] = torch.from_numpy(buf).to(dev)
    return DistTable(cols, torch.from_numpy(counts).to(dev), cap,
                     dict(dicts), provenance=provenance, comm=comm)


def repartition(table: Union[DistTable, SpillTable], parallelism: int,
                capacity: Optional[int] = None, device=None) -> DistTable:
    """Re-split a distributed table across a different gang size.

    Host-staged via the per-destination spill buckets (``rescatter``), used
    at application boundaries where the paper stages through NFS / the
    object store anyway.  An explicit ``capacity`` — including ``0`` — is
    honored verbatim (and validated), never silently replaced.  The result
    lands on ``device``, by default a ``DistTable``'s own device and the
    card for a ``SpillTable``.
    """
    if isinstance(table, DistTable):
        device = table.device if device is None else device
        table = SpillTable.from_dist(table)
    return rescatter(table, parallelism, capacity, device)


class CylonStore:
    """Keyed store of distributed tables shared between applications.

    In one process (the default) ``put`` keeps the table and ``get``
    blocks until the key is there, then re-splits it to
    ``target_parallelism`` ranks (``repartition``) where that differs.

    ``CylonStore(pool=DevicePool(process_group=...))`` hands tables
    between the gangs of processes that pool carves.  Every process calls
    ``put`` and ``get``, in the same order: ``put(key, table)`` takes the
    member's table of the gang that made it (a ``DistTable`` or ``SpillTable`` over the gang's sub-group;
    ``None`` on any other process), and every process records the key
    with its schema, dictionaries and per-rank rows, agreed with one
    ``gather_object``.  ``get(key, target_parallelism=q)`` hands the table
    to the first ``q`` ranks of the group (the pool's lowest-first
    carving; ``lease=`` names another gang): a target process receives
    exactly rank r of the stacked ``get``, over the target gang's
    communicator, any other process ``None``.  At the table's own size
    (another gang of as many processes) each rank's rows move whole, as
    the stacked ``get`` keeps the table.  The rows go through one host
    exchange over the group (``rescatter(onto=Handoff(...))``).
    """

    def __init__(self, pool: Optional[DevicePool] = None):
        self._data: Dict[str, Any] = {}
        self._cv = threading.Condition()
        self.pool = pool
        #: a communicator over the pool's process group (None in one
        #: process), through which tables move between its gangs
        self.world = None
        if pool is not None and pool.process_group is not None:
            from ..comm.process_group import ProcessGroupCommunicator
            self.world = ProcessGroupCommunicator(pool.process_group)

    def put(self, key: str, table: Union[DistTable, SpillTable, None]
            ) -> None:
        if self.world is None:
            with self._cv:
                self._data[key] = table
                self._cv.notify_all()
            return
        mine = None
        if table is not None:
            r = int(table.comm.rank()[0]) if table.comm is not None else 0
            if isinstance(table, DistTable):
                rows = int(table.row_counts.sum())
                schema = {n: (torch.empty(0, dtype=v.dtype).numpy().dtype,
                              tuple(v.shape[2:]))
                          for n, v in table.columns.items()}
                cap = table.capacity
            else:
                rows = sum(table.rank_rows(j)
                           for j in range(table.parallelism))
                schema, cap = table.schema, None
            mine = (r, rows, schema, dict(table.dictionaries), cap)
        every = [(m, w) for w, m in enumerate(self.world.gather_object(mine))
                 if m is not None]
        if not every:
            raise ValueError(f"CylonStore.put({key!r}): no process holds "
                             f"a part of the table")
        every.sort(key=lambda mw: mw[0][0])
        _, _, schema, dicts, cap = every[0][0]
        rec = GangRecord(tuple(w for _, w in every),
                         tuple(m[1] for m, _ in every), schema, dicts, cap)
        with self._cv:
            self._data[key] = (table, rec)
            self._cv.notify_all()

    def get(self, key: str, target_parallelism: Optional[int] = None,
            capacity: Optional[int] = None, timeout: Optional[float] = None,
            device=None, lease: Any = None
            ) -> Union[DistTable, SpillTable, None]:
        """Fetch (blocking, like the paper's example) + repartition if
        needed (onto ``device``, as ``repartition`` places it).  Over a
        process group every process calls it (see the class)."""
        if self.world is not None:
            return self._get_over_group(key, target_parallelism, capacity,
                                        device, lease)
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while key not in self._data:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(f"CylonStore.get({key!r}) timed out")
                self._cv.wait(timeout=remaining)
            table = self._data[key]
        same_p = (target_parallelism is None
                  or target_parallelism == table.parallelism)
        same_cap = (capacity is None
                    or (isinstance(table, DistTable)
                        and capacity == table.capacity))
        if same_p and same_cap:
            return table
        return repartition(
            table,
            table.parallelism if target_parallelism is None
            else target_parallelism,
            capacity, device)

    def _get_over_group(self, key, target_parallelism, capacity, device,
                        lease):
        if key not in self._data:
            raise KeyError(f"CylonStore.get({key!r}): no such key")
        part, rec = self._data[key]
        if lease is not None:
            targets = tuple(lease.indices)
        else:
            targets = tuple(range(target_parallelism or len(rec.ranks)))
        keep = len(targets) == len(rec.ranks) and \
            capacity in (None, rec.capacity)
        if keep and targets == rec.ranks:
            return part
        me = self.pool.rank
        self.pool.gang_group(targets)       # every process, in order
        onto = Handoff(self.world, rec, targets,
                       self.pool.gang_communicator(targets)
                       if me in targets and len(targets) > 1 else None,
                       keep=keep)
        spill = (SpillTable.from_dist(part) if isinstance(part, DistTable)
                 else part)
        return rescatter(spill, len(targets), capacity,
                         device if device is not None else self.pool.device,
                         onto=onto)

    def keys(self):
        return sorted(self._data)

    def delete(self, key: str) -> None:
        with self._cv:
            self._data.pop(key, None)
