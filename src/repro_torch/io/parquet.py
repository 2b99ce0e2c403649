"""Chunked Parquet ingest: row-group batches -> round-robin ``SpillTable``.

The torch counterpart of ``repro.io.parquet``.  ``read_parquet`` streams each file's row groups through
``pyarrow.parquet.ParquetFile.iter_batches`` — one batch of at most
``batch_rows`` rows is resident at a time, so a multi-file dataset larger
than device memory ingests straight into the out-of-core spill format
and runs under ``collect(morsel_rows=...)``.

Requires pyarrow (``requirements-dev.txt`` optional extra); ``read_csv``
has a dependency-free fallback lane, Parquet does not.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Union

from ..core.store import SpillTable
from .ingest import (DICT_CACHE, DictionaryCache, IngestInfo, TableBuilder,
                     arrow_batch_columns, expand_paths, have_pyarrow,
                     source_key)

__all__ = ["read_parquet"]

#: default rows per streamed batch (and thus per spill chunk)
DEFAULT_BATCH_ROWS = 65536


def _require_pyarrow():
    if not have_pyarrow():
        raise ImportError(
            "read_parquet requires pyarrow (optional extra; see "
            "requirements-dev.txt). CSV ingest works without it: "
            "repro_torch.io.read_csv falls back to a pure-python reader.")
    import pyarrow.parquet as pq
    return pq


def _empty_table(pq, files, parallelism: int,
                 columns: Optional[Sequence[str]]) -> SpillTable:
    """Zero-row dataset: keep the file schema (string cols as int32 codes
    over the ``("",)`` convention dictionary) so downstream plans compile."""
    import numpy as np
    import pyarrow as pa
    sch = pq.ParquetFile(files[0]).schema_arrow
    schema = {}
    dicts = {}
    for field in sch:
        if columns is not None and field.name not in columns:
            continue
        if pa.types.is_string(field.type) or \
                pa.types.is_large_string(field.type):
            schema[field.name] = (np.dtype(np.int32), ())
            dicts[field.name] = ("",)
        else:
            schema[field.name] = (np.dtype(field.type.to_pandas_dtype()), ())
    return SpillTable(parallelism, schema=schema, dictionaries=dicts)


def read_parquet(source: Union[str, os.PathLike, Sequence],
                 parallelism: int, *,
                 batch_rows: int = DEFAULT_BATCH_ROWS,
                 columns: Optional[Sequence[str]] = None,
                 dict_cache: Optional[DictionaryCache] = DICT_CACHE
                 ) -> SpillTable:
    """Read Parquet file(s) into a round-robin ``SpillTable``.

    ``source`` is a path, a glob, or a list of either (expanded sorted).
    ``columns`` projects at the reader (only those columns are decoded
    from the file).  ``dict_cache`` seeds string dictionaries from a prior
    read of the same unchanged source (pass ``None`` to disable); the
    returned table's ``provenance`` is an ``IngestInfo`` whose ``recodes``
    counts stale-dictionary chunk recodes (0 on a cache hit).

    Nulls become ``__m_*`` validity masks with canonical-zero data slots
    (``repro_torch.nulls``); int/bool columns keep their dtype (no float
    widen at ingest).
    """
    pq = _require_pyarrow()
    files = expand_paths(source)
    key = None
    cached = None
    if dict_cache is not None:
        key = source_key(files)
        cached = dict_cache.get(key)
    builder = TableBuilder(parallelism, cached_dicts=cached)
    batches = 0
    bytes_read = 0
    for f in files:
        pf = pq.ParquetFile(f)
        for batch in pf.iter_batches(batch_size=max(1, batch_rows),
                                     columns=list(columns) if columns
                                     else None):
            if batch.num_rows == 0:
                continue
            cols, valids = arrow_batch_columns(batch)
            builder.add_batch(cols, valids)
            batches += 1
        bytes_read += os.path.getsize(f)
    spill = builder.finalize()
    if builder.rows == 0:
        spill = _empty_table(pq, files, parallelism, columns)
    if dict_cache is not None and builder._string_cols:
        dict_cache.put(key, spill.dictionaries)
    spill.provenance = IngestInfo(
        format="parquet", files=files, rows=builder.rows,
        bytes_read=bytes_read, batches=batches, recodes=builder.recodes,
        dict_cache_hit=cached is not None)
    return spill
