"""Shared ingest machinery behind ``read_parquet`` / ``read_csv``.

The torch counterpart of ``repro.io.ingest``.  The file readers
(``repro_torch.io.parquet`` / ``repro_torch.io.csv``) are thin loops:
they open a source, pull one *batch* of rows at a time (a Parquet row-group
slice, a CSV block), and hand each batch to the ``TableBuilder`` here.  The
builder owns everything format-independent:

* **round-robin partitioning** — batch ``i`` lands in rank ``i % p``'s
  bucket, so a multi-file dataset spreads evenly over the gang without a
  shuffle and without ever concatenating the whole table on the host;
* **incremental dictionary encoding** — string columns are encoded against
  a *running* sorted dictionary that grows as new values appear.  Each
  chunk records which dictionary snapshot it was encoded under; at
  ``finalize`` the (few) chunks encoded under a stale snapshot are recoded
  onto the final dictionary with a static gather table
  (``schema.recode_mapping`` — order-preserving, so codes stay sorted);
* **validity masks** — readers report per-batch null masks; the builder
  canonicalizes null slots to the column's zero value and attaches
  ``__m_*`` companions (``repro_torch.nulls``) on every chunk of a column that
  was ever null, so chunk schemas stay uniform;
* **numeric widening** — a column that arrives int64 in one batch and
  float64 in another (CSV fallback lane) is unified to float64 at
  ``finalize``.

``DictionaryCache`` is the process-level cache keyed by the *source
signature* (paths + sizes + mtimes): a second read of an unchanged source
starts from its final dictionaries, so every chunk is encoded against the
complete dictionary up front and ``finalize`` performs **zero recodes**
(``IngestInfo.recodes == 0`` — asserted by the multi-device parity script).

Over a ``torch.distributed`` process group (``comm``) every process is
given the same files and keeps the batches ``i % p`` of the rank it
holds: a CSV reader parses every block and converts only its own, a
Parquet reader gets its own from the processes that decoded their row
groups (``parquet._shared_batches``).  A sorted
dictionary is the sorted set of every value, so ``finalize`` takes the
union of the processes' dictionaries (and their column types and null
masks) and recodes its chunks onto it: every process ends with the
stacked read's dictionaries and codes, and its rank's rows.  The
``IngestInfo`` counts are the group's (rows, batches and recodes summed).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.store import SpillTable
from ..dataframe.schema import (CODE_DTYPE, Dictionary, _as_str_array,
                                recode_mapping)
from ..nulls import check_reserved_names, mask_name

__all__ = ["IngestInfo", "DictionaryCache", "DICT_CACHE", "TableBuilder",
           "source_key", "expand_paths", "have_pyarrow"]


def have_pyarrow() -> bool:
    """True when the pyarrow lane is usable: the package imports and the
    ``REPRO_NO_PYARROW`` escape hatch (the no-arrow lane) is not set."""
    if os.environ.get("REPRO_NO_PYARROW", "") not in ("", "0"):
        return False
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        return False
    return True


def expand_paths(source: Union[str, "os.PathLike", Sequence]
                 ) -> Tuple[str, ...]:
    """Normalize a source spec to a sorted tuple of existing file paths.

    Accepts a single path, a glob pattern, or a list of either; globs
    expand sorted so multi-file datasets ingest in a deterministic order.
    """
    import glob as _glob
    if isinstance(source, (str, os.PathLike)):
        source = [source]
    files: List[str] = []
    for s in source:
        s = os.fspath(s)
        if any(ch in s for ch in "*?["):
            hits = sorted(_glob.glob(s))
            if not hits:
                raise FileNotFoundError(f"glob {s!r} matched no files")
            files.extend(hits)
        else:
            if not os.path.exists(s):
                raise FileNotFoundError(f"no such file: {s!r}")
            files.append(s)
    if not files:
        raise FileNotFoundError("empty source list")
    return tuple(files)


def source_key(files: Sequence[str]) -> Tuple:
    """Content signature of a file set: (path, size, mtime_ns) per file.

    A rewritten file changes its size or mtime, so a stale cache entry can
    never be replayed against changed data.
    """
    return tuple((os.path.abspath(f), os.path.getsize(f),
                  os.stat(f).st_mtime_ns) for f in files)


@dataclasses.dataclass(frozen=True)
class IngestInfo:
    """Provenance of an ingested ``SpillTable`` (``spill.provenance``).

    ``scan_read_stats`` (planner) reads ``bytes_read`` to attribute ingest
    volume to the query's scan stage; EXPLAIN renders ``summary()``.
    """

    format: str                   # "parquet" | "csv"
    files: Tuple[str, ...]
    rows: int
    bytes_read: int               # total source bytes consumed
    batches: int                  # chunks streamed through the builder
    recodes: int                  # stale-dictionary chunk recodes at finalize
    dict_cache_hit: bool = False

    def summary(self) -> str:
        return (f"{self.format}: {len(self.files)} "
                f"file{'s' if len(self.files) != 1 else ''}, "
                f"~{self.rows} rows")

    def __str__(self) -> str:
        return self.summary()


class DictionaryCache:
    """Process-level LRU of final ingest dictionaries, keyed by source.

    ``get``/``put`` are thread-safe; ``hits``/``misses`` feed tests and the
    ingest benchmark.  Capped (LRU) so long-lived services do not leak one
    entry per dataset ever read.
    """

    def __init__(self, max_entries: int = 64):
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self._lock = threading.Lock()
        self._entries: "OrderedDict[Tuple, Dict[str, Dictionary]]" = \
            OrderedDict()

    def get(self, key: Tuple) -> Optional[Dict[str, Dictionary]]:
        with self._lock:
            dicts = self._entries.get(key)
            if dicts is None:
                self.misses += 1
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return dict(dicts)

    def put(self, key: Tuple, dicts: Dict[str, Dictionary]) -> None:
        with self._lock:
            self._entries[key] = dict(dicts)
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.hits = self.misses = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)


#: the process-level cache ``read_parquet`` / ``read_csv`` use by default
DICT_CACHE = DictionaryCache()


def arrow_batch_columns(batch) -> Tuple[Dict[str, np.ndarray],
                                        Dict[str, np.ndarray]]:
    """Convert a ``pyarrow.RecordBatch`` to ``(cols, valids)`` for
    ``TableBuilder.add_batch``.

    Numeric/bool columns keep their dtype (nulls filled with the canonical
    zero via Arrow's validity bitmap, never a float widen); string columns
    come out as object arrays with null slots holding a placeholder ``""``
    (the builder excludes them from the dictionary and zeroes their codes).
    """
    import pyarrow as pa
    cols: Dict[str, np.ndarray] = {}
    valids: Dict[str, np.ndarray] = {}
    for name, col in zip(batch.schema.names, batch.columns):
        t = col.type
        nulls = col.null_count
        valid = None
        if nulls:
            valid = np.invert(np.asarray(col.is_null()))
        if pa.types.is_string(t) or pa.types.is_large_string(t):
            # Arrow's own conversion to Python strings (None at nulls):
            # the values ``to_pylist`` gives, without its Python loop
            arr = np.array(col.to_numpy(zero_copy_only=False), dtype=object)
            if valid is not None:
                arr[~valid] = ""
        elif pa.types.is_null(t):
            # a column Arrow could not type (e.g. all-empty CSV fields):
            # all-null string, same convention as the catalog
            arr = np.asarray([""] * len(col), dtype=object)
            valid = np.zeros((len(col),), bool)
        elif (pa.types.is_integer(t) or pa.types.is_floating(t)
              or pa.types.is_boolean(t)):
            filled = col if not nulls else pa.compute.fill_null(
                col, pa.scalar(False if pa.types.is_boolean(t) else 0,
                               type=t))
            arr = filled.to_numpy(zero_copy_only=False)
        else:
            raise TypeError(
                f"column {name!r} has unsupported Arrow type {t}; "
                f"supported: integer, floating, boolean, string")
        cols[name] = arr
        if valid is not None:
            valids[name] = valid
    return cols, valids


class _Chunk:
    """One streamed batch, held until finalize (schema may still evolve)."""

    __slots__ = ("cols", "valid", "dictver")

    def __init__(self, cols: Dict[str, np.ndarray],
                 valid: Dict[str, np.ndarray],
                 dictver: Dict[str, int]):
        self.cols = cols          # name -> data (codes for string columns)
        self.valid = valid        # name -> bool mask, only if batch had nulls
        self.dictver = dictver    # string col -> dictionary snapshot index


class TableBuilder:
    """Accumulate streamed batches into a round-robin ``SpillTable``.

    Call ``add_batch`` once per streamed batch, then ``finalize`` once.
    ``cached_dicts`` seeds the running dictionaries (DictionaryCache hit);
    when the seed already covers every value, no chunk is ever recoded.
    """

    def __init__(self, parallelism: int,
                 cached_dicts: Optional[Dict[str, Dictionary]] = None,
                 comm=None):
        if parallelism < 1:
            raise ValueError(f"parallelism must be >= 1, got {parallelism}")
        self.parallelism = parallelism
        #: a process-group communicator when this process holds only some
        #: ranks: it keeps their batches alone
        self.comm = (comm if comm is not None
                     and comm.ranks_held() < comm.size() else None)
        self._held = (None if self.comm is None
                      else [int(r) for r in self.comm.rank().tolist()])
        #: rows and batches kept here (the group's, after ``finalize``)
        self.rows = 0
        self.batches = 0
        self.recodes = 0
        self._next = 0          # the next batch's index in file order
        self._chunks: List[Tuple[int, _Chunk]] = []
        self._names: Optional[Tuple[str, ...]] = None
        self._string_cols: set = set()
        self._nullable: set = set()
        # running dictionary per string column + its snapshot history
        self._dicts: Dict[str, np.ndarray] = {
            k: np.asarray(v, dtype=str)
            for k, v in (cached_dicts or {}).items()}
        self._snapshots: Dict[str, List[Tuple[str, ...]]] = {
            k: [tuple(v)] for k, v in (cached_dicts or {}).items()}

    # -- streaming ------------------------------------------------------- #
    def _encode_strings(self, name: str, arr: np.ndarray,
                        valid: Optional[np.ndarray]) -> np.ndarray:
        """Encode one batch against the running dictionary, growing it by
        the batch's new values (null slots never enter the dictionary)."""
        arr = _as_str_array(arr, name=repr(name))
        vals = arr if valid is None else arr[valid]
        d = self._dicts.get(name)
        if d is None:
            d = np.zeros((0,), dtype=str)
        if len(vals):
            uniq = np.unique(vals)
            if len(d):
                pos = np.searchsorted(d, uniq)
                pos = np.minimum(pos, len(d) - 1)
                novel = uniq[d[pos] != uniq]
            else:
                novel = uniq
            if len(novel):
                d = np.union1d(d, novel)
                self._dicts[name] = d
                self._snapshots.setdefault(name, []).append(
                    tuple(d.tolist()))
        if name not in self._snapshots:
            # first batch and it was all-null: snapshot the empty dict so
            # the chunk still records a version
            self._snapshots[name] = [tuple(d.tolist())]
            self._dicts[name] = d
        if len(d) == 0:
            return np.zeros((len(arr),), CODE_DTYPE)
        codes = np.searchsorted(d, arr)
        codes = np.minimum(codes, len(d) - 1).astype(CODE_DTYPE)
        if valid is not None:
            codes[~valid] = 0     # canonical zero for null slots
        return codes

    def wants_next(self) -> bool:
        """Whether the next batch in file order goes to a rank held here
        (always, unless over a process group).  A reader converts it and
        calls ``add_batch``, or calls ``skip_batch``."""
        return (self._held is None
                or self._next % self.parallelism in self._held)

    def skip_batch(self) -> None:
        """Pass over a batch another process keeps."""
        self._next += 1

    def add_batch(self, cols: Dict[str, np.ndarray],
                  valids: Optional[Dict[str, np.ndarray]] = None) -> None:
        """Ingest one batch.  ``cols`` maps names to 1-D arrays (string
        columns as str/object arrays); ``valids`` maps a *subset* of names
        to boolean validity masks (absent = batch has no nulls there).
        Null slots of masked columns may hold arbitrary placeholder values
        — the builder canonicalizes them.
        """
        index = self._next
        self._next += 1
        valids = dict(valids or {})
        names = tuple(cols)
        check_reserved_names(names)
        if self._names is None:
            self._names = names
            from ..dataframe.schema import is_string_array
            self._string_cols = {n for n, a in cols.items()
                                 if is_string_array(np.asarray(a))}
        elif set(names) != set(self._names):
            raise ValueError(
                f"batch schema {sorted(names)} != ingest schema "
                f"{sorted(self._names)} (all files of one read must agree)")
        n = len(next(iter(cols.values())))
        out_cols: Dict[str, np.ndarray] = {}
        out_valid: Dict[str, np.ndarray] = {}
        dictver: Dict[str, int] = {}
        for name in self._names:
            arr = np.asarray(cols[name])
            if len(arr) != n:
                raise ValueError(
                    f"column {name!r} length {len(arr)} != {n}")
            valid = valids.get(name)
            if valid is not None:
                valid = np.asarray(valid).astype(bool)
                if valid.all():
                    valid = None
            if name in self._string_cols:
                out_cols[name] = self._encode_strings(name, arr, valid)
                dictver[name] = len(self._snapshots[name]) - 1
            else:
                if valid is not None:
                    arr = arr.copy()
                    arr[~valid] = 0   # canonical zero (0 / 0.0 / False)
                out_cols[name] = arr
            if valid is not None:
                out_valid[name] = valid
                self._nullable.add(name)
        self.rows += n
        self.batches += 1
        self._chunks.append((index, _Chunk(out_cols, out_valid, dictver)))

    # -- finalize -------------------------------------------------------- #
    def final_dictionaries(self) -> Dict[str, Dictionary]:
        out: Dict[str, Dictionary] = {}
        for name in self._string_cols:
            d = self._dicts.get(name)
            vals = tuple(d.tolist()) if d is not None else ()
            # an all-null string column still needs a non-empty dictionary
            # for code 0 to decode (mirrors build_catalog's convention)
            out[name] = vals if vals else ("",)
        return out

    def _unified_dtypes(self) -> Dict[str, np.dtype]:
        """Per-column dtype across all chunks; int/float mixes widen to
        float64 (CSV fallback lane type promotion)."""
        dtypes: Dict[str, np.dtype] = {}
        for _, ch in self._chunks:
            for name, arr in ch.cols.items():
                _widen(dtypes, name, arr.dtype)
        return dtypes

    def _agree(self, dtypes: Dict[str, np.dtype]) -> Dict[str, np.dtype]:
        """Over a process group: adopt the group's column names, string
        columns, nullable columns, column types, dictionaries and counts
        (every process's, merged as the stacked read merges its batches).
        Returns the group's column types."""
        mine = (self._names, sorted(self._string_cols),
                sorted(self._nullable),
                {n: d.str for n, d in dtypes.items()},
                {n: tuple(d.tolist()) for n, d in self._dicts.items()},
                self.rows, self.batches)
        parts = self.comm.gather_object(mine)
        names = next((pt[0] for pt in parts if pt[0] is not None), None)
        for pt in parts:
            if pt[0] is not None and set(pt[0]) != set(names):
                raise ValueError(
                    f"batch schema {sorted(pt[0])} != ingest schema "
                    f"{sorted(names)} (all files of one read must agree)")
        self._names = names
        self._string_cols = {n for pt in parts for n in pt[1]}
        self._nullable = {n for pt in parts for n in pt[2]}
        out: Dict[str, np.dtype] = {}
        for pt in parts:
            for n, d in pt[3].items():
                _widen(out, n, np.dtype(d))
        for name in self._string_cols:
            vals = [np.asarray(pt[4][name], dtype=str) for pt in parts
                    if name in pt[4]]
            if vals:
                self._dicts[name] = np.unique(np.concatenate(vals))
        self.rows = sum(pt[5] for pt in parts)
        self.batches = sum(pt[6] for pt in parts)
        return out

    def finalize(self) -> SpillTable:
        """Recode stale chunks onto the final dictionaries, materialize
        validity masks, and append everything round-robin into a
        ``SpillTable``.  The builder is spent afterwards.  Over a process
        group this is a collective: the dictionaries, types and counts
        become the group's, and the spill holds this process's ranks."""
        dtypes = self._unified_dtypes()
        if self.comm is not None:
            dtypes = self._agree(dtypes)
        dicts = self.final_dictionaries()
        held = self._held if self._held is not None \
            else list(range(self.parallelism))
        schema = None
        if self.comm is not None and self._names is not None:
            # a process may hold no batch: it takes the group's schema
            schema = {n: ((np.dtype(CODE_DTYPE),) if n in self._string_cols
                          else (dtypes[n],)) + ((),) for n in self._names}
            schema.update({mask_name(n): (np.dtype(bool), ())
                           for n in self._nullable})
        spill = SpillTable(len(held), schema=schema, dictionaries=dicts,
                           comm=self.comm)
        # a process with no chunk still joins the recodes' all-gather below
        final = {n: tuple(d.tolist()) for n, d in self._dicts.items()}
        local_recodes = 0
        for i, ch in self._chunks:
            cols: Dict[str, np.ndarray] = {}
            for name in self._names:
                arr = ch.cols[name]
                if name in self._string_cols:
                    ver = ch.dictver.get(name, 0)
                    old = self._snapshots[name][ver]
                    if old != final.get(name, ()):
                        if old:   # empty snapshot = all-null chunk, codes 0
                            arr = recode_mapping(old, dicts[name])[arr]
                            valid = ch.valid.get(name)
                            if valid is not None:
                                arr[~valid] = 0   # remap moved the null fill
                            local_recodes += 1
                    arr = arr.astype(CODE_DTYPE, copy=False)
                elif arr.dtype != dtypes[name]:
                    arr = arr.astype(dtypes[name])
                cols[name] = arr
            n = len(next(iter(cols.values())))
            for name in sorted(self._nullable):
                valid = ch.valid.get(name)
                cols[mask_name(name)] = (np.ones((n,), bool)
                                         if valid is None else valid)
            spill.append(held.index(i % self.parallelism), cols)
        self.recodes = local_recodes
        if self.comm is not None:
            self.recodes = int(self.comm.gather_ints([local_recodes]).sum())
        self._chunks = []
        return spill


def _widen(dtypes: Dict[str, np.dtype], name: str, dt: np.dtype) -> None:
    """Fold one batch's type of ``name`` into ``dtypes``: int/float mixes
    widen; any other change raises."""
    d = dtypes.get(name)
    if d is None:
        dtypes[name] = dt
    elif d != dt:
        if np.issubdtype(d, np.number) and np.issubdtype(dt, np.number):
            dtypes[name] = np.result_type(d, dt)
        else:
            raise TypeError(
                f"column {name!r} changes type across batches ({d} vs "
                f"{dt}); files of one read must share a schema")
