"""Stateful pseudo-BSP execution environment (the paper's §IV-A).

The torch counterpart of ``repro.core.env``.  ``CylonEnv`` holds the
communicator across operators and caches the stage callables it has built
so repeated submissions reuse them, with the JAX package's cache key and
``cache_hits`` / ``cache_misses`` counters.  PyTorch runs eagerly, so a
"built program" is the Python stage callable itself.

Ranks are stacked: a ``DistTable`` holds ``(p, capacity, ...)`` columns
and ``(p,)`` row counts on one device, and the callable a stage runs sees
them as one batched ``dataframe.Table``.  Over a ``torch.distributed``
process group (``CylonEnv(process_group=...)``) each process holds one
rank: its tables hold ``(1, capacity, ...)`` columns, the rows that rank
holds when stacked, and the communicator moves rows between processes.
Every path runs over a group: in-core plans, out-of-core morsels (each
process streams the ranks it holds, ``MorselSource``), spill scans and
file ingest, retries and deadlines (every fault site visit ends in one
agreement over the group, ``faults.GroupFaults``).  Entry points run on
``cuda`` unless the caller asks for the CPU; with no card they raise
rather than fall back.

Serving (``DevicePool``, ``Lease``): a pool slot is one *rank slot* on a
device (``RankSlot``).  A gang of ``g`` slots leased from the pool is a
``CylonEnv`` of ``g`` stacked ranks on that device; the query scheduler
runs each gang's work on a CUDA stream of its own, so gangs on one card
overlap where the card has room.  Over the process group of the world
(``DevicePool(process_group=dist.group.WORLD)``) a slot is one rank, one
process: a gang is a sub-group of its member processes
(``Lease.group()``), and ``CylonEnv(devices=lease)`` on a member holds
that member's rank of it.
"""

from __future__ import annotations

import dataclasses
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..comm import Communicator, get_communicator
from ..dataframe.schema import decode_columns, encode_columns
from ..dataframe.table import Table
from ..dtypes import to_x32, torch_dtype, x32_dtype
from ..nulls import apply_null_columns, extract_null_columns
from ..obs.trace import NULL_TRACER


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; asking for a card that is not there
    raises instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


# ---------------------------------------------------------------------- #
# Host-side distributed table
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class DistTable:
    """The ranks of a distributed table this process holds: (h, cap, ...)
    columns + (h,) counts on one device; ``h`` is every rank when they
    are stacked, one over a process group."""

    columns: Dict[str, torch.Tensor]
    row_counts: torch.Tensor  # (p,) int32
    capacity: int             # per-rank capacity
    #: each dictionary-encoded string column's sorted dictionary
    #: (``dataframe.schema``); those columns hold int32 codes.  Host-side
    #: metadata only: stage callables never see it.
    dictionaries: Dict[str, Tuple[str, ...]] = \
        dataclasses.field(default_factory=dict)
    #: ``repro_torch.io.IngestInfo`` when this table was read from
    #: Parquet/CSV (files, rows, source bytes); None for tables built in
    #: memory.  Host-side only — EXPLAIN ANALYZE attributes scan work
    #: from it.
    provenance: Optional[Any] = None
    #: the process group's communicator when this process holds only some
    #: of the table's ranks (``comm.rank()``); None when it holds all.
    #: ``total_rows`` then counts every rank's rows, a collective every
    #: process of the group must call.
    comm: Optional[Communicator] = None

    @property
    def parallelism(self) -> int:
        """The ranks held here (the leading axis)."""
        return self.row_counts.shape[0]

    @property
    def device(self) -> torch.device:
        return self.row_counts.device

    @property
    def column_names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.columns))

    def to_table(self) -> Table:
        return Table(dict(self.columns), self.row_counts)

    @classmethod
    def from_table(cls, t: Table, comm: Optional[Communicator] = None
                   ) -> "DistTable":
        return cls(dict(t.columns), t.row_count, t.capacity, comm=comm)

    def select(self, comm: Optional[Communicator]) -> "DistTable":
        """The ranks ``comm`` holds of this whole table (as
        ``SpillTable.select``): every process of a group given the same
        table keeps a view of its own rank.  Unchanged when the table is
        already over a group or ``comm`` holds every rank."""
        if self.comm is not None or comm is None or \
                comm.ranks_held() == comm.size():
            return self
        if comm.size() != self.parallelism:
            raise ValueError(f"a table of {self.parallelism} ranks for a "
                             f"group of {comm.size()}")
        r = int(comm.rank()[0])
        return DistTable({n: v[r:r + 1] for n, v in self.columns.items()},
                         self.row_counts[r:r + 1], self.capacity,
                         dict(self.dictionaries), self.provenance, comm)

    @classmethod
    def from_numpy(cls, data: Dict[str, np.ndarray], parallelism: int,
                   capacity: Optional[int] = None,
                   device=None, comm: Optional[Communicator] = None
                   ) -> "DistTable":
        """Block-distribute host rows over ``parallelism`` ranks.

        With ``comm``, a process-group communicator, only the ranks this
        process holds (``comm.rank()``) are built: each holds the block
        it holds when every rank is stacked, so ``data`` is the whole
        table on every process.

        String columns (object / unicode numpy arrays) are dictionary-
        encoded on the host: the device gets int32 codes, the sorted
        dictionary lands in ``dictionaries``.  NaN / ``None`` values (or
        explicit ``__m_*`` companions) become validity-mask columns with
        canonical-zero data slots.  64-bit columns then narrow to 32 bits
        as the JAX package's ``jnp.asarray`` narrows them with x64 off
        (``dtypes.to_x32``: int64 wraps to int32, float64 rounds to
        float32).  An explicit ``capacity`` — including ``0`` — is
        honored and validated against the per-rank row count."""
        dev = resolve_device(device)
        data = extract_null_columns({k: np.asarray(v)
                                     for k, v in data.items()})
        data, dicts = encode_columns(data)
        data = {k: to_x32(v) for k, v in data.items()}
        n = len(next(iter(data.values())))
        per = -(-n // parallelism)
        if capacity is None:
            capacity = max(8, -(-per // 8) * 8)
        if per > capacity:
            raise ValueError(f"rows/shard {per} exceeds capacity {capacity}")
        held = list(range(parallelism))
        if comm is not None:
            if comm.size() != parallelism:
                raise ValueError(f"a communicator over {comm.size()} ranks "
                                 f"for {parallelism}")
            held = comm.rank().tolist()
            comm = comm if len(held) < parallelism else None
        counts = np.clip(n - np.asarray(held) * per, 0,
                         per).astype(np.int32)
        cols = {}
        for name, arr in data.items():
            buf = np.zeros((len(held), capacity) + arr.shape[1:], arr.dtype)
            for j, r in enumerate(held):
                chunk = arr[r * per:(r + 1) * per]
                buf[j, :len(chunk)] = chunk
            cols[name] = torch.from_numpy(buf).to(dev)
        return cls(cols, torch.from_numpy(counts).to(dev), capacity, dicts,
                   comm=comm)

    @classmethod
    def from_reference(cls, columns: Dict[str, np.ndarray],
                       row_counts: np.ndarray, capacity: int,
                       device=None) -> "DistTable":
        """Build from a JAX ``repro.core.DistTable``'s arrays, passed as
        numpy: flat ``(p * capacity, ...)`` columns and ``(p,)`` counts.
        Both packages then hold the same state, slot for slot."""
        dev = resolve_device(device)
        counts = np.asarray(row_counts, np.int32)
        p = counts.shape[0]
        cols = {n: torch.from_numpy(np.ascontiguousarray(
                    np.asarray(a).reshape((p, capacity) + a.shape[1:])))
                .to(dev) for n, a in columns.items()}
        return cls(cols, torch.from_numpy(counts.copy()).to(dev), capacity)

    def to_reference(self) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
        """(flat ``(p * capacity, ...)`` numpy columns, ``(p,)`` counts):
        the JAX ``DistTable`` layout, for slot-for-slot comparison."""
        p, cap = self.parallelism, self.capacity
        cols = {n: v.cpu().numpy().reshape((p * cap,) + tuple(v.shape[2:]))
                for n, v in self.columns.items()}
        return cols, self.row_counts.cpu().numpy()

    def to_numpy(self, decode: bool = True, nulls: str = "pandas"
                 ) -> Dict[str, np.ndarray]:
        """Gather valid rows from every rank (host side).

        ``decode=True`` maps dictionary-encoded columns back to numpy
        string arrays; ``decode=False`` returns the raw int32 codes.
        ``nulls="pandas"`` re-materializes validity masks as NaN / ``None``;
        ``nulls="mask"`` returns the raw physical layout."""
        if nulls not in ("pandas", "mask"):
            raise ValueError(f"nulls must be 'pandas' or 'mask', got {nulls!r}")
        counts = self.row_counts.cpu().numpy()
        out = {}
        for name, v in self.columns.items():
            a = v.cpu().numpy()
            out[name] = np.concatenate(
                [a[r, :counts[r]] for r in range(self.parallelism)], axis=0)
        if decode and self.dictionaries:
            out = decode_columns(out, self.dictionaries)
        if nulls == "pandas":
            out = apply_null_columns(out)
        return out

    def total_rows(self) -> int:
        """Every rank's rows (over a process group: a collective)."""
        counts = self.row_counts
        if self.comm is not None:
            counts = self.comm.world(counts)
        return int(counts.sum())

    def gather_numpy(self, decode: bool = True, nulls: str = "pandas"
                     ) -> Dict[str, np.ndarray]:
        """``to_numpy`` of every rank, on every process of the group (a
        collective): what ``to_numpy`` gives when the ranks are stacked.
        For checks and for what every process needs whole (the trainer
        gang's batches); ``to_numpy`` alone gives this process's rows."""
        if self.comm is None:
            return self.to_numpy(decode=decode, nulls=nulls)
        # each process's valid rows on the host, gathered there: no
        # padding, and no round trip through a staged device collective
        parts = self.comm.gather_object(self.to_numpy(decode=False,
                                                      nulls="mask"))
        out = {n: np.concatenate([p[n] for p in parts], axis=0)
               for n in parts[0]}
        if decode and self.dictionaries:
            out = decode_columns(out, self.dictionaries)
        if nulls == "pandas":
            out = apply_null_columns(out)
        return out


# ---------------------------------------------------------------------- #
# Morsel streaming: host spill -> fixed-capacity device batches
# ---------------------------------------------------------------------- #
class MorselSource:
    """Streams a host-resident table as fixed-capacity ``DistTable``
    morsels on the env's device (the out-of-core input path).

    ``source`` may be a ``core.store.SpillTable``, a ``DistTable`` (spilled
    first), or a dict of host numpy columns (block-distributed over
    ``parallelism`` ranks).  Every yielded morsel has the same per-rank
    capacity (``morsel_rows`` rounded up to 8), so one built stage — a
    single cache entry — processes every morsel.  64-bit columns narrow
    on the way up (``dtypes.to_x32``).

    Over a process group (an env whose communicator holds one rank, or a
    spill over the group) the source streams the ranks this process
    holds, and yields the group's number of morsels: that of the group's
    widest rank, with empty morsels where this process has run out of
    rows, so every process makes the same collectives.

    On a card the transfers are **double-buffered**: two sets of pinned
    host staging buffers, and a copy stream that uploads them with
    asynchronous copies.  Morsel ``m+1``'s upload is enqueued before
    morsel ``m`` is handed to the consumer, and the consumer's stream
    waits on an event recorded after the copy, so the upload of one
    morsel overlaps the compute of the one before it.  A staging set is
    refilled only after the event of the copy that last read it.
    ``h2d_bytes`` accumulates the bytes shipped to the device.  ``tracer``
    (``repro_torch.obs.Tracer``) gets an ``h2d:morsel[m]`` instant with
    the bytes of each morsel when its upload is enqueued; the copy's event
    marks its end.

    The staging of each morsel is the ``transfer:h2d`` fault site
    (``repro_torch.faults``; ``faults`` and ``token`` default to no-ops).
    A fault unwinds the iteration while earlier uploads may still read
    the pinned staging sets, so the iterator waits on their events before
    it lets go of them: a replay's new source never refills memory a copy
    is still reading.
    """

    def __init__(self, source, morsel_rows: int,
                 env: Optional["CylonEnv"] = None,
                 parallelism: Optional[int] = None, device=None,
                 tracer=None, faults=None, token=None):
        from .store import SpillTable  # deferred: store imports env
        comm = env.comm if env is not None else None
        if isinstance(source, DistTable):
            source = SpillTable.from_dist(source)
        elif isinstance(source, dict):
            p = parallelism or (env.parallelism if env is not None else 1)
            source = SpillTable.from_numpy(source, p, comm=comm)
        else:
            source = source.select(comm)
        self.spill = source
        self.parallelism = source.parallelism
        if morsel_rows < 1:
            raise ValueError(f"morsel_rows must be >= 1, got {morsel_rows}")
        self.capacity = max(8, -(-int(morsel_rows) // 8) * 8)
        self.num_morsels = source.num_morsels(self.capacity)
        self.device = env.device if env is not None else resolve_device(device)
        self.h2d_bytes = 0
        # one host-contiguous view per rank
        self._rank_cols = [source.rank_concat(r)
                           for r in range(self.parallelism)]
        #: column -> (device dtype, trailing shape)
        self._layout = {n: (x32_dtype(d), s)
                        for n, (d, s) in sorted(source.schema.items())}
        self._tracer = tracer if tracer is not None else NULL_TRACER
        if faults is None:
            from ..faults import NULL_FAULTS
            faults = NULL_FAULTS
        self._faults = faults
        self._token = token

    def _host_buffers(self, pin: bool) -> Tuple[Dict[str, torch.Tensor],
                                                torch.Tensor]:
        """One set of host buffers for a morsel (pinned memory when
        ``pin``) and its counts buffer."""
        p, cap = self.parallelism, self.capacity
        return ({n: torch.empty((p, cap) + s, dtype=torch_dtype(d),
                                pin_memory=pin)
                 for n, (d, s) in self._layout.items()},
                torch.empty((p,), dtype=torch.int32, pin_memory=pin))

    def _fill(self, m: int, bufs: Dict[str, torch.Tensor],
              counts: torch.Tensor) -> None:
        """Write morsel ``m``'s rows into ``bufs`` (padding zeroed)."""
        self._faults.check("transfer:h2d", token=self._token, morsel=m)
        b0 = self.h2d_bytes
        lo, hi = m * self.capacity, (m + 1) * self.capacity
        cnt = counts.numpy()
        for name, t in bufs.items():
            buf = t.numpy()
            for r in range(self.parallelism):
                piece = to_x32(self._rank_cols[r][name][lo:hi])
                buf[r, :len(piece)] = piece
                buf[r, len(piece):] = 0
                cnt[r] = len(piece)
            self.h2d_bytes += buf.nbytes
        self.h2d_bytes += cnt.nbytes
        self._tracer.instant(f"h2d:morsel[{m}]", "transfer", morsel=m,
                             bytes=self.h2d_bytes - b0)

    def _table(self, cols, counts) -> DistTable:
        return DistTable(cols, counts, self.capacity,
                         dict(self.spill.dictionaries))

    def __iter__(self):
        if self.device.type != "cuda":
            # morsel m+1 is built before m is handed over, as on a card
            # (and as in the JAX package, so traces record the same order)
            def build(m: int) -> DistTable:
                bufs, counts = self._host_buffers(pin=False)
                self._fill(m, bufs, counts)
                return self._table(bufs, counts)

            nxt = build(0) if self.num_morsels else None
            for m in range(1, self.num_morsels + 1):
                cur = nxt
                nxt = build(m) if m < self.num_morsels else None
                yield cur
            return
        yield from self._iter_card()

    def _iter_card(self):
        dev = self.device
        compute = torch.cuda.current_stream(dev)
        copy = torch.cuda.Stream(dev)
        staging = [self._host_buffers(pin=True) for _ in range(2)]
        last_read: List[Optional[torch.cuda.Event]] = [None, None]

        def enqueue(m: int):
            s = m % 2
            if last_read[s] is not None:
                last_read[s].synchronize()   # copy m-2 has read set s
            bufs, counts = staging[s]
            self._fill(m, bufs, counts)
            # allocated on the compute stream: the copy stream first waits
            # for the work queued there, which may still use reused blocks
            cols = {n: torch.empty(b.shape, dtype=b.dtype, device=dev)
                    for n, b in bufs.items()}
            cnt = torch.empty(counts.shape, dtype=counts.dtype, device=dev)
            copy.wait_stream(compute)
            with torch.cuda.stream(copy):
                for n, b in bufs.items():
                    cols[n].copy_(b, non_blocking=True)
                cnt.copy_(counts, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(copy)
            last_read[s] = ev
            return self._table(cols, cnt), ev

        try:
            nxt = enqueue(0)
            for m in range(1, self.num_morsels + 1):
                cur, ev = nxt
                # prefetch: morsel m's upload goes out before m-1 is used
                nxt = enqueue(m) if m < self.num_morsels else None
                compute.wait_event(ev)
                yield cur
        except BaseException:
            # a fault (or a consumer that stops early) unwinds while
            # uploads may still read the pinned staging sets: wait for
            # them before the sets are let go
            for ev in last_read:
                if ev is not None:
                    ev.synchronize()
            raise
        finally:
            # a consumer that stops early must not free blocks a copy is
            # still writing
            compute.wait_stream(copy)


# ---------------------------------------------------------------------- #
# The stateful environment
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class EnvContext:
    """What a stage callable sees (the Cylon_env argument)."""

    comm: Communicator
    device: torch.device

    def rank(self) -> torch.Tensor:
        return self.comm.rank(self.device)

    def size(self) -> int:
        return self.comm.size()


class CylonEnv:
    """A pseudo-BSP environment of ``parallelism`` ranks stacked on one
    device, or of one rank per process of a process group, joined by a
    communicator from the registry.

    Parameters
    ----------
    parallelism:   ranks stacked on the device (default 1).
    device:        ``None`` means ``cuda`` and raises without a card; pass
                   ``device="cpu"`` for the plain PyTorch path.
    devices:       a ``Lease`` (or a list of ``RankSlot``) from a
                   ``DevicePool``: sets the parallelism (one rank per slot)
                   and the device (the slots', which must agree).  A
                   lease of a pool over a process group is a gang of
                   processes: on a member the env holds its rank of the
                   gang's sub-group (``Lease.group()``) on its own
                   device, with the communicator the pool keeps for that
                   gang; on any other process it is an error.
    communicator:  registry name (``"xla"`` | ``"ring"`` | ``"bruck"``).
    program_cache: a ``repro_torch.serve.cache.ProgramCache`` to share
                   built stages with other envs (the serving scheduler
                   passes one per process, so a freshly carved gang reuses
                   every stage an earlier gang over the same slots built).
                   Default: a private cache.
    process_group: a ``torch.distributed`` process group (e.g.
                   ``dist.group.WORLD``): the env holds the one rank
                   ``group.rank()`` of ``group.size()`` ranks, on the
                   process's card ``cuda:LOCAL_RANK`` unless ``device`` is
                   given (``device="cpu"`` for a gloo group on the CPU).
                   The communicator runs its schedule over the group
                   (``comm.process_group``): NCCL or gloo, as the group
                   was created.  Tables come from ``env.from_numpy`` (or
                   ``DistTable.from_numpy(comm=env.comm)``).

    Thread safety: ``run`` may be called from many threads.  Stage
    lookups and builds go through the (locked, single-flight) program
    cache, so two threads racing the same key build once; the per-env
    hit/miss counters are updated under a lock.
    """

    def __init__(self, parallelism: int = 1, device=None, *,
                 devices: Optional[Sequence["RankSlot"]] = None,
                 communicator: str = "xla",
                 program_cache: Optional[Any] = None,
                 process_group: Any = None):
        # deferred import: serve.cache stands alone, but the serve package
        # must not be entered while core.env is still importing
        from ..serve.cache import ProgramCache
        gang_comm = None
        if process_group is not None:
            import torch.distributed as dist
            if devices is not None or parallelism != 1:
                raise TypeError("process_group= sets the parallelism (the "
                                "group's size); pass neither parallelism= "
                                "nor devices= beside it")
            parallelism = dist.get_world_size(process_group)
            if device is None:
                device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            slot_ids = (dist.get_rank(process_group),)
        elif isinstance(devices, Lease) and devices.over_processes:
            if device is not None or parallelism != 1:
                raise TypeError("devices= sets the parallelism and the "
                                "device; pass neither beside it")
            if not devices.is_member:
                raise ValueError(
                    f"this process (rank {devices.pool.rank}) is not in the "
                    f"gang of ranks {list(devices.indices)}")
            gang_comm = devices.communicator(communicator)
            process_group = gang_comm.group
            parallelism, device = len(devices), devices.pool.device
            slot_ids = tuple(devices.indices)
            slots = devices
        elif devices is not None:
            slots = list(devices)
            devs = {str(resolve_device(d.device)) for d in slots}
            if len(devs) != 1:
                raise ValueError(f"a gang's rank slots must share one "
                                 f"device (its ranks are stacked on it); "
                                 f"got slots on {sorted(devs)}")
            if device is not None or parallelism != 1:
                raise TypeError("devices= sets the parallelism and the "
                                "device; pass neither beside it")
            parallelism, device = len(slots), slots[0].device
            slot_ids = tuple(d.id for d in slots)
        else:
            slot_ids = tuple(range(parallelism))
        if parallelism < 1:
            raise ValueError(f"parallelism must be >= 1, got {parallelism}")
        self.device = resolve_device(device)
        if process_group is not None and gang_comm is None:
            # as DevicePool(process_group=) lists the group's ranks
            slots = [RankSlot(i, self.device if i == slot_ids[0] else None)
                     for i in range(parallelism)]
        elif devices is None:
            slots = [RankSlot(i, self.device) for i in slot_ids]
        #: the env's rank slots, as the JAX package's env lists its
        #: devices: those it was given (a lease over processes as it is),
        #: else one ``RankSlot`` a stacked rank or, over ``process_group=``,
        #: a rank of the group.  Except over ``process_group=``,
        #: ``CylonEnv(devices=env.devices)`` is an env on the same slots.
        self.devices = slots
        self.comm: Communicator = gang_comm or get_communicator(
            communicator, parallelism, group=process_group)
        if self.device.type == "cuda" and process_group is not None:
            # NCCL and the pinned staging of gloo run on the process's card
            torch.cuda.set_device(self.device)
        self.communicator_name = communicator
        self.slot_ids = slot_ids
        self.programs = (program_cache if program_cache is not None
                         else ProgramCache())
        #: a built stage holds its communicator and device, so the
        #: shared-cache key pins the gang's placement: device + rank-slot
        #: ids + communicator.  ``CylonEnv(2)`` is slots (0, 1); the
        #: ``DevicePool`` free-list hands out lowest ids first, so a
        #: released-and-recarved gang hits these entries.
        self._gang_key = (str(self.device), slot_ids, communicator)
        #: env-local memo in front of the shared cache (``set(env._cache)``
        #: is the introspection surface, as in the JAX package)
        self._cache: Dict[Any, Callable] = {}
        self._lock = threading.Lock()
        #: a miss builds a stage callable, a hit reuses one — whether this
        #: env built it or found it in a shared program cache
        self.cache_hits = 0
        self.cache_misses = 0

    @property
    def parallelism(self) -> int:
        """Ranks in all (the group's size over a process group)."""
        return self.comm.size()

    @property
    def ranks_held(self) -> int:
        """Ranks this process holds: the tables' leading axis."""
        return self.comm.ranks_held()

    def from_numpy(self, data: Dict[str, np.ndarray],
                   capacity: Optional[int] = None) -> DistTable:
        """``DistTable.from_numpy`` onto this env's ranks and device (over
        a process group, the ranks this process holds)."""
        return DistTable.from_numpy(data, self.parallelism, capacity,
                                    device=self.device, comm=self.comm)

    def close(self) -> None:
        """Drop this env's local stage memo (shared ``programs`` entries
        persist for the next gang carved over these slots)."""
        with self._lock:
            self._cache.clear()

    def synchronize(self) -> None:
        """Wait for the work queued on the current stream of the env's
        device (a no-op on the CPU).  Only this stream: gangs that run on
        streams of their own do not wait for each other's work."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    # ------------------------------------------------------------------ #
    # Submission API (the paper's run_cylon / execute_cylon)
    # ------------------------------------------------------------------ #
    def run(self, fn: Callable, *args, static_kwargs: Optional[dict] = None,
            key: Any = None):
        """Run ``fn(ctx, *local_args, **static_kwargs)`` over all ranks.

        ``fn`` receives the communicator-bearing context and batched
        ``Table`` views of any ``DistTable`` args; it may return Tables,
        tensors, or tuples / lists / dicts of them.  Returned Tables
        become ``DistTable``.  The stage callable is cached by ``key``
        (default: ``fn``, the static kwarg names and the argument
        signatures)."""
        static_kwargs = static_kwargs or {}
        for a in args:
            if isinstance(a, DistTable) and (
                    a.device != self.device
                    or a.parallelism != self.ranks_held):
                raise ValueError(
                    f"table on {a.device} with {a.parallelism} ranks given "
                    f"to an env on {self.device} with {self.ranks_held}")
        cache_key = key if key is not None else (
            fn, tuple(sorted(static_kwargs)),
            tuple(self._arg_sig(a) for a in args))
        with self._lock:
            stage = self._cache.get(cache_key)
            if stage is not None:
                self.cache_hits += 1
        if stage is None:
            # shared-cache path: a single-flight build keyed by (stage,
            # gang placement).  A hit here — an earlier env over the same
            # slots built it, or a racing thread did — counts as a hit, so
            # a freshly carved gang that reuses every stage reports
            # cache_misses == 0
            stage, built = self.programs.get_or_build(
                (cache_key, self._gang_key),
                lambda: self._build(fn, static_kwargs))
            with self._lock:
                self._cache[cache_key] = stage
                if built:
                    self.cache_misses += 1
                else:
                    self.cache_hits += 1
        return stage(*args)

    @staticmethod
    def _arg_sig(a):
        if isinstance(a, DistTable):
            return ("T", a.capacity,
                    tuple((n, str(a.columns[n].dtype),
                           tuple(a.columns[n].shape[2:]))
                          for n in a.column_names))
        x = torch.as_tensor(a)
        return ("A", str(x.dtype), tuple(x.shape))

    def _build(self, fn: Callable, static_kwargs: dict) -> Callable:
        ctx = EnvContext(self.comm, self.device)
        comm = (self.comm if self.comm.ranks_held() < self.comm.size()
                else None)

        def conv(x):
            if isinstance(x, Table):
                return DistTable.from_table(x, comm)
            if isinstance(x, (tuple, list)):
                return type(x)(conv(v) for v in x)
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            return x

        def stage(*args):
            local = [a.to_table() if isinstance(a, DistTable) else a
                     for a in args]
            return conv(fn(ctx, *local, **static_kwargs))

        return stage


# ---------------------------------------------------------------------- #
# Device pool: resource partitioning for independent applications (§IV-A)
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class RankSlot:
    """One rank slot of a ``DevicePool``: a rank that a gang stacks on
    ``device``.  ``id`` is the slot's index in the pool, and what
    ``QueryHandle.stats["devices"]`` lists.  In a pool over a process
    group a slot is the group's rank ``id``: this process's own slot
    carries its device, every other slot ``None``."""

    id: int
    device: Optional[torch.device]


class PoolExhausted(RuntimeError):
    """``DevicePool.reserve`` could not satisfy the request."""


class Lease(Sequence):
    """A disjoint slot partition handed out by ``DevicePool.reserve``.

    Behaves as a sequence of slots (so ``CylonEnv(devices=lease)`` and
    ``pool.reserve(n)[0]``-style code work) and carries its own
    ``release()``; it is also a context manager::

        with pool.reserve(2) as gang:
            env = CylonEnv(devices=gang)
            ...
        # slots returned to the free list here
    """

    __slots__ = ("_pool", "_indices", "devices", "_released")

    def __init__(self, pool: "DevicePool", indices: Tuple[int, ...],
                 devices: Tuple[Any, ...]):
        self._pool = pool
        self._indices = indices
        self.devices = devices
        self._released = False

    @property
    def indices(self) -> Tuple[int, ...]:
        return self._indices

    @property
    def released(self) -> bool:
        return self._released

    def release(self) -> None:
        """Return the partition to the pool (idempotent)."""
        self._pool.release(self)

    # -- a gang of processes (a pool over a process group) --------------- #
    @property
    def pool(self) -> "DevicePool":
        return self._pool

    @property
    def over_processes(self) -> bool:
        """True when the slots are the ranks of a process group."""
        return self._pool.process_group is not None

    @property
    def is_member(self) -> bool:
        """Whether this process holds one of the leased slots (always
        True for a pool of rank slots stacked in one process)."""
        return not self.over_processes or self._pool.rank in self._indices

    def group(self):
        """The gang's sub-group of the pool's process group, made when
        the lease was reserved (None off the gang;
        ``DevicePool.gang_group``)."""
        return self._pool.gang_group(self._indices)

    def communicator(self, name: str = "xla"):
        """The gang's ``name`` communicator over ``group()`` (members
        only; one per gang and name, ``DevicePool.gang_communicator``)."""
        return self._pool.gang_communicator(self._indices, name)

    def __len__(self) -> int:
        return len(self.devices)

    def __getitem__(self, i):
        return self.devices[i]

    def __iter__(self):
        return iter(self.devices)

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        state = "released" if self._released else "held"
        return f"<Lease devices={[d.id for d in self.devices]} {state}>"


#: the sub-groups of gangs of processes and their communicators, by the
#: ranks a gang spans: one group per rank set in a process, whichever
#: pool carved it (None where the process is not a member), kept for the
#: world group in ``"world"`` and emptied when that is another (a world
#: destroyed and made again).  Every process of the world makes each
#: group, in the same order: a group made by its members alone
#: (``use_local_synchronization``) is named after its ranks and the
#: number of groups the process already holds, so members that had made
#: different gangs before would name it differently and wait for each
#: other forever.
_GANGS: Dict[str, Any] = {"world": None, "groups": {}, "comms": {}}
_GANG_LOCK = threading.Lock()


def _gangs_of_world() -> Dict[str, Any]:
    """``_GANGS`` for the current world group (caller holds the lock)."""
    import torch.distributed as dist
    if _GANGS["world"] is not dist.group.WORLD:
        _GANGS.update(world=dist.group.WORLD, groups={}, comms={})
    return _GANGS


class DevicePool:
    """Carves a list of rank slots into disjoint partitions (gang
    scheduling), as the JAX package's pool carves its device list.

    ``DevicePool(devices)`` takes an explicit slot list (``RankSlot``s, or
    any objects with ``.id``; ``CylonEnv`` needs ``.device`` too);
    ``DevicePool(slots=n, device=d)`` makes ``n`` slots on ``d`` (default
    1 slot; ``device=None`` means the card and raises without one, as
    ``resolve_device`` does).

    A locked free-list hands out the ``n`` lowest-indexed free slots as a
    ``Lease`` that can be returned individually (``lease.release()`` /
    ``pool.release(lease)``): two threads are never handed overlapping
    partitions, and released partitions are re-carved lowest ids first,
    so a re-carved gang matches its predecessor's placement (which is
    what lets the shared ``ProgramCache`` skip rebuilding).
    ``release_all`` is kept for tests and whole-epoch resets.

    ``reserve(n, block=True)`` waits (optionally fenced by a
    ``CancellationToken``) until ``n`` slots free up — the serving
    scheduler's admission path.

    ``DevicePool(process_group=dist.group.WORLD)`` is a pool over the
    ``torch.distributed`` world (no other group: gangs' sub-groups and
    the serving control channel are made over the world): slot ``i`` is
    rank ``i``, one process, and this process's own slot carries its device (``device``,
    default ``cuda:LOCAL_RANK``).  Every process holds its own copy of
    the free list; calls made in the same order on every process (as an
    SPMD program makes them) keep the copies alike, so every process
    computes the same leases without a coordinator.  A lease's gang is
    the sub-group of its members (``Lease.group()``): every process makes
    it when the lease is reserved (``gang_group``, in the order of the
    reservations, so the group's name agrees), and it is kept for the
    rank set, so a re-carved gang reuses its group.
    """

    def __init__(self, devices: Optional[Sequence[Any]] = None, *,
                 slots: Optional[int] = None, device=None,
                 process_group: Any = None):
        #: the process group whose ranks are the slots, and this
        #: process's rank of it (None for slots stacked in one process)
        self.process_group = process_group
        self.rank: Optional[int] = None
        self._own: Optional[torch.device] = None
        if process_group is not None:
            import torch.distributed as dist
            if devices is not None or slots is not None:
                raise TypeError("process_group= makes one slot per rank of "
                                "the group; pass neither devices= nor "
                                "slots= beside it")
            if process_group is not dist.group.WORLD:
                raise TypeError("a pool over processes takes the world "
                                "group (dist.group.WORLD): its gangs' "
                                "sub-groups are made over the world")
            n = dist.get_world_size()
            self.rank = dist.get_rank()
            if device is None:
                device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            self._own = resolve_device(device)
            self._devices = [RankSlot(i, self._own if i == self.rank
                                      else None) for i in range(n)]
        elif devices is not None:
            if slots is not None or device is not None:
                raise TypeError("pass either devices= or slots= / device=, "
                                "not both")
            self._devices = list(devices)
        else:
            dev = resolve_device(device)
            n = 1 if slots is None else int(slots)
            if n < 1:
                raise ValueError(f"a pool needs slots >= 1, got {n}")
            self._devices = [RankSlot(i, dev) for i in range(n)]
        self._cond = threading.Condition(threading.Lock())
        self._free = list(range(len(self._devices)))  # kept sorted
        self._leases: Dict[int, Lease] = {}           # id(lease) -> lease

    @property
    def size(self) -> int:
        return len(self._devices)

    @property
    def available(self) -> int:
        with self._cond:
            return len(self._free)

    @property
    def devices(self) -> List[Any]:
        return list(self._devices)

    @property
    def device(self) -> Optional[torch.device]:
        """The device every slot stacks its rank on, or None when the
        slots carry none (fake slots) or disagree; over a process group,
        this process's device."""
        if self.process_group is not None:
            return self._own
        devs = {getattr(d, "device", None) for d in self._devices}
        if len(devs) != 1 or None in devs:
            return None
        return resolve_device(devs.pop())

    def _try_reserve_locked(self, n: int) -> Optional[Lease]:
        if n > len(self._free):
            return None
        take = tuple(self._free[:n])
        del self._free[:n]
        lease = Lease(self, take, tuple(self._devices[i] for i in take))
        self._leases[id(lease)] = lease
        return lease

    def reserve(self, n: int, *, block: bool = False, token: Any = None,
                poll_s: float = 0.05) -> Lease:
        """Reserve the ``n`` lowest-indexed free slots.

        Non-blocking by default: raises ``PoolExhausted`` when fewer than
        ``n`` slots are free.  ``block=True`` waits for releases, polling
        ``token.check()`` (a ``repro_torch.faults.CancellationToken``) so
        a queued reservation honors deadlines and cancellation.
        """
        if n < 1:
            raise ValueError(f"reserve needs n >= 1, got {n}")
        if n > len(self._devices):
            raise PoolExhausted(
                f"pool exhausted: want {n}, pool only has "
                f"{len(self._devices)} slots")
        with self._cond:
            while True:
                lease = self._try_reserve_locked(n)
                if lease is not None:
                    break
                if not block:
                    raise PoolExhausted(
                        f"pool exhausted: want {n}, have {len(self._free)} "
                        f"free of {len(self._devices)}")
                self._cond.wait(timeout=poll_s)
                if token is not None:
                    token.check("DevicePool.reserve")
        if self.process_group is not None:
            self.gang_group(lease.indices)
        return lease

    def free_slots(self) -> List[int]:
        """The free slots' indices, lowest first (what ``reserve`` hands
        out first)."""
        with self._cond:
            return list(self._free)

    def try_reserve(self, n: int) -> Optional[Lease]:
        """``reserve`` that returns None instead of raising on exhaustion."""
        with self._cond:
            lease = self._try_reserve_locked(n) if n >= 1 else None
        if lease is not None and self.process_group is not None:
            self.gang_group(lease.indices)
        return lease

    def release(self, lease: Lease) -> None:
        """Return one lease's slots to the free list (idempotent)."""
        with self._cond:
            if lease._released or id(lease) not in self._leases:
                return
            lease._released = True
            del self._leases[id(lease)]
            self._free = sorted(self._free + list(lease._indices))
            self._cond.notify_all()

    def _gang_key(self, indices: Sequence[int]) -> Tuple[int, ...]:
        if self.process_group is None:
            raise TypeError("a pool of rank slots in one process has no "
                            "process sub-groups")
        return tuple(sorted(indices))

    def gang_group(self, indices: Sequence[int]):
        """The sub-group of the processes holding slots ``indices`` (None
        on any other process), made once per rank set.  The first call
        for a rank set makes it, so every process of the world calls it
        for each new rank set in the same order (``reserve`` does, and so
        does every collective path that names a gang without a lease);
        only the members connect, the others return at once."""
        import torch.distributed as dist
        key = self._gang_key(indices)
        with _GANG_LOCK:
            groups = _gangs_of_world()["groups"]
            if key in groups:
                return groups[key]
        group = dist.new_group(list(key))
        if group is dist.GroupMember.NON_GROUP_MEMBER:
            group = None
        with _GANG_LOCK:
            return _gangs_of_world()["groups"].setdefault(key, group)

    def gang_communicator(self, indices: Sequence[int], name: str = "xla"
                          ) -> Communicator:
        """The ``name`` communicator over ``gang_group(indices)``, one per
        gang and name: envs carved over the same gang share it (and the
        stages built over it, and its ``stats``)."""
        if self.rank not in indices:
            raise ValueError(f"this process (rank {self.rank}) is not in "
                             f"the gang of ranks {list(indices)}")
        key = self._gang_key(indices) + (name,)
        with _GANG_LOCK:
            comm = _gangs_of_world()["comms"].get(key)
        if comm is None:
            comm = get_communicator(name, len(indices),
                                    group=self.gang_group(indices))
            with _GANG_LOCK:
                comm = _gangs_of_world()["comms"].setdefault(key, comm)
        return comm

    def release_all(self) -> None:
        """Reclaim every outstanding lease (tests / epoch reset)."""
        with self._cond:
            for lease in list(self._leases.values()):
                lease._released = True
            self._leases.clear()
            self._free = list(range(len(self._devices)))
            self._cond.notify_all()
