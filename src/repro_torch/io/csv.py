"""Chunked CSV ingest: streamed blocks -> round-robin ``SpillTable``.

The torch counterpart of ``repro.io.csv``.  Two lanes share the
``TableBuilder`` (so partitioning, dictionary growth, and null handling
are byte-identical):

* **pyarrow lane** (default when pyarrow is importable and
  ``REPRO_NO_PYARROW`` is unset): ``pyarrow.csv.open_csv`` streams
  ``block_bytes``-sized record batches with Arrow's type inference;
  ``strings_can_be_null=True`` so an empty field is null in *every* column
  type, matching the fallback lane.
* **pure-python lane**: the stdlib ``csv`` module, ``batch_rows`` rows at
  a time.  Column kinds (numeric vs string) are inferred from the first
  block that has data; int64 quietly widens to float64 across blocks
  (``TableBuilder`` unifies at finalize).  Empty field = null.

The fallback keeps CSV ingest working in minimal environments; the tests
run both lanes.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from ..core.store import SpillTable
from .ingest import (DICT_CACHE, DictionaryCache, IngestInfo, TableBuilder,
                     arrow_batch_columns, expand_paths, have_pyarrow,
                     source_key)

__all__ = ["read_csv"]

#: fallback lane: rows per streamed block
DEFAULT_BATCH_ROWS = 65536
#: pyarrow lane: bytes per streamed block
DEFAULT_BLOCK_BYTES = 1 << 20


# ---------------------------------------------------------------------- #
# pure-python fallback lane
# ---------------------------------------------------------------------- #
def _infer_kinds(header: Sequence[str], rows: Sequence[Sequence[str]]
                 ) -> Dict[str, Optional[str]]:
    """Column kind from the first block: "num" if every non-empty value
    parses as a number, "str" otherwise, None if the column was all-empty
    (decided by a later block, or all-null string at finalize)."""
    kinds: Dict[str, Optional[str]] = {}
    for j, name in enumerate(header):
        kind: Optional[str] = None
        for r in rows:
            v = r[j]
            if v == "":
                continue
            try:
                float(v)
                kind = kind or "num"
            except ValueError:
                kind = "str"
                break
        kinds[name] = kind
    return kinds


def _settle_kinds(header: Sequence[str], rows: List[Sequence[str]],
                  kinds: Dict[str, Optional[str]]) -> None:
    """Decide still-undecided column kinds from this block if it has data
    (every block passes through here, also those another process keeps)."""
    for j, name in enumerate(header):
        if kinds[name] is None:
            kinds[name] = _infer_kinds([name], [(r[j],) for r in rows])[name]


def _convert_block(header: Sequence[str], rows: List[Sequence[str]],
                   kinds: Dict[str, Optional[str]]
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """One parsed block -> (cols, valids) for the builder.  Numeric
    columns parse int-first (so integer CSVs stay int64); any float value
    makes the block float64 and the builder widens the rest at finalize."""
    cols: Dict[str, np.ndarray] = {}
    valids: Dict[str, np.ndarray] = {}
    n = len(rows)
    _settle_kinds(header, rows, kinds)
    for j, name in enumerate(header):
        kind = kinds[name]
        raw = [r[j] for r in rows]
        valid = np.fromiter((v != "" for v in raw), dtype=bool, count=n)
        if kind == "str" or kind is None:
            arr = np.asarray(raw, dtype=object)
        else:
            vals: List = []
            for v in raw:
                if v == "":
                    vals.append(0)
                    continue
                try:
                    vals.append(int(v))
                except ValueError:
                    try:
                        vals.append(float(v))
                    except ValueError:
                        raise TypeError(
                            f"column {name!r} mixes numbers with {v!r}; "
                            f"CSV columns must keep one type (the pyarrow "
                            f"lane reports the offending row)") from None
            arr = np.asarray(vals)
            if arr.dtype.kind not in "if":
                arr = arr.astype(np.float64)
        cols[name] = arr
        if not valid.all():
            valids[name] = valid
    return cols, valids


def _add_block(builder: TableBuilder, header: Sequence[str],
               block: List[Sequence[str]],
               kinds: Dict[str, Optional[str]]) -> None:
    if builder.wants_next():
        builder.add_batch(*_convert_block(header, block, kinds))
    else:
        _settle_kinds(header, block, kinds)
        builder.skip_batch()


def _read_csv_python(files: Sequence[str], builder: TableBuilder,
                     batch_rows: int) -> None:
    """Stream files through the stdlib csv reader."""
    import csv as _csv
    header: Optional[List[str]] = None
    kinds: Optional[Dict[str, Optional[str]]] = None
    for f in files:
        with open(f, newline="") as fh:
            rdr = _csv.reader(fh)
            h = next(rdr, None)
            if h is None:
                continue
            if header is None:
                header = list(h)
            elif list(h) != header:
                raise ValueError(
                    f"{f!r} header {h} != first file's header {header}")
            block: List[Sequence[str]] = []
            for row in rdr:
                if len(row) != len(header):
                    raise ValueError(
                        f"{f!r}: row with {len(row)} fields, expected "
                        f"{len(header)}")
                block.append(row)
                if len(block) >= batch_rows:
                    if kinds is None:
                        kinds = _infer_kinds(header, block)
                    _add_block(builder, header, block, kinds)
                    block = []
            if block:
                if kinds is None:
                    kinds = _infer_kinds(header, block)
                _add_block(builder, header, block, kinds)


# ---------------------------------------------------------------------- #
# pyarrow lane
# ---------------------------------------------------------------------- #
def _read_csv_arrow(files: Sequence[str], builder: TableBuilder,
                    block_bytes: int) -> None:
    import pyarrow.csv as pacsv
    ropts = pacsv.ReadOptions(block_size=max(1 << 10, block_bytes))
    copts = pacsv.ConvertOptions(strings_can_be_null=True)
    for f in files:
        with pacsv.open_csv(f, read_options=ropts,
                            convert_options=copts) as reader:
            for batch in reader:
                if batch.num_rows == 0:
                    continue
                if builder.wants_next():
                    builder.add_batch(*arrow_batch_columns(batch))
                else:
                    builder.skip_batch()


def read_csv(source: Union[str, os.PathLike, Sequence],
             parallelism: int, *,
             batch_rows: int = DEFAULT_BATCH_ROWS,
             block_bytes: int = DEFAULT_BLOCK_BYTES,
             dict_cache: Optional[DictionaryCache] = DICT_CACHE,
             comm=None) -> SpillTable:
    """Read CSV file(s) (with a header row) into a round-robin
    ``SpillTable``.

    ``source`` is a path, a glob, or a list of either (expanded sorted);
    all files must share the header.  Empty fields are null in every
    column type (``__m_*`` masks, canonical-zero slots).  The pyarrow
    streaming reader is used when available (``block_bytes`` per batch);
    otherwise a pure-python lane streams ``batch_rows`` rows at a time.
    ``dict_cache`` and ``comm`` work as in ``read_parquet``.
    """
    files = expand_paths(source)
    key = None
    cached = None
    if dict_cache is not None:
        key = source_key(files)
        cached = dict_cache.get(key)
    builder = TableBuilder(parallelism, cached_dicts=cached, comm=comm)
    if have_pyarrow():
        _read_csv_arrow(files, builder, block_bytes)
    else:
        _read_csv_python(files, builder, batch_rows)
    spill = builder.finalize()
    if dict_cache is not None and builder._string_cols:
        dict_cache.put(key, spill.dictionaries)
    spill.provenance = IngestInfo(
        format="csv", files=files, rows=builder.rows,
        bytes_read=sum(os.path.getsize(f) for f in files),
        batches=builder.batches,
        recodes=builder.recodes, dict_cache_hit=cached is not None)
    return spill
