"""Chunked Parquet ingest: row-group batches -> round-robin ``SpillTable``.

The torch counterpart of ``repro.io.parquet``.  ``read_parquet`` streams each file's row groups through
``pyarrow.parquet.ParquetFile.iter_batches`` — one batch of at most
``batch_rows`` rows is resident at a time, so a multi-file dataset larger
than device memory ingests straight into the out-of-core spill format
and runs under ``collect(morsel_rows=...)``.

Over a ``torch.distributed`` process group each row group is decoded by
one process, which sends each batch's part of it to the process whose
rank keeps that batch (``_shared_batches``): the group decodes every file
once, not once a process.

Requires pyarrow (``requirements-dev.txt`` optional extra); ``read_csv``
has a dependency-free fallback lane, Parquet does not.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Sequence, Union

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
                 columns: Optional[Sequence[str]], comm=None) -> SpillTable:
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
    return SpillTable(parallelism, schema=schema,
                      dictionaries=dicts).select(comm)


def _shared_batches(pq, files: List[str], batch_rows: int,
                    columns: Optional[List[str]], comm) -> Iterator:
    """Over a process group: every batch of the read in file order, cut as
    ``iter_batches`` cuts them (``batch_rows`` rows from the start of each
    file, across row-group boundaries), those of this process's rank as
    record batches and the others as None.  Row group ``t`` of the read
    is decoded by process ``t % p`` alone, which sends every batch's part
    of it, as an Arrow IPC stream, to the process that keeps that batch:
    one all-to-all of the streams and one of their tags (batch, offset in
    the batch, bytes)."""
    import numpy as np
    import pyarrow as pa
    p, me = comm.size(), int(comm.rank()[0])
    groups, first, nb = [], [], 0   # groups: (file, row group, first row, rows)
    for fi, f in enumerate(files):
        first.append(nb)
        md, at = pq.ParquetFile(f).metadata, 0
        for g in range(md.num_row_groups):
            groups.append((fi, g, at, md.row_group(g).num_rows))
            at += md.row_group(g).num_rows
        nb += -(-at // batch_rows)
    blobs: List[list] = [[] for _ in range(p)]
    tags: List[list] = [[] for _ in range(p)]
    pf, open_fi = None, -1
    for fi, g, s, k in groups[me::p]:
        if k == 0:
            continue
        if fi != open_fi:
            pf, open_fi = pq.ParquetFile(files[fi]), fi
        tbl = pf.read_row_group(g, columns=columns)
        for j in range(s // batch_rows, -(-(s + k) // batch_rows)):
            lo = max(s, j * batch_rows)
            hi = min(s + k, (j + 1) * batch_rows)
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, tbl.schema) as w:
                w.write_table(tbl.slice(lo - s, hi - lo))
            i = first[fi] + j
            blobs[i % p].append(np.frombuffer(sink.getvalue(), np.uint8))
            tags[i % p].append((i, lo - j * batch_rows, blobs[i % p][-1].size))
    u8, i64 = (np.dtype(np.uint8), ()), (np.dtype(np.int64), ())
    got = comm.exchange_rows(
        [{"b": np.concatenate(b)} if b else None for b in blobs], {"b": u8})
    got_tags = comm.exchange_rows(
        [{n: np.asarray([t[c] for t in ts], np.int64)
          for c, n in enumerate(("i", "o", "n"))} if ts else None
         for ts in tags], {"i": i64, "o": i64, "n": i64})
    parts: dict = {}
    for blob, tg in zip(got, got_tags):
        buf, at = pa.py_buffer(blob["b"]), 0
        for i, o, n in zip(*(tg[c].tolist() for c in ("i", "o", "n"))):
            parts.setdefault(i, []).append(
                (o, pa.ipc.open_stream(buf.slice(at, n)).read_all()))
            at += n
    for i in range(nb):
        if i % p != me:
            yield None
            continue
        frags = [t for _, t in sorted(parts.pop(i), key=lambda ot: ot[0])]
        yield pa.concat_tables(frags).combine_chunks().to_batches()[0]


def read_parquet(source: Union[str, os.PathLike, Sequence],
                 parallelism: int, *,
                 batch_rows: int = DEFAULT_BATCH_ROWS,
                 columns: Optional[Sequence[str]] = None,
                 dict_cache: Optional[DictionaryCache] = DICT_CACHE,
                 comm=None) -> SpillTable:
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

    ``comm``, a process-group communicator: every process is given the
    same files and keeps the batches of the rank it holds (a collective;
    ``TableBuilder``); the group decodes each row group once
    (``_shared_batches``).
    """
    pq = _require_pyarrow()
    files = expand_paths(source)
    key = None
    cached = None
    if dict_cache is not None:
        key = source_key(files)
        cached = dict_cache.get(key)
    builder = TableBuilder(parallelism, cached_dicts=cached, comm=comm)
    cols = list(columns) if columns else None
    if builder.comm is not None:
        for batch in _shared_batches(pq, files, max(1, batch_rows), cols,
                                     builder.comm):
            if batch is None:
                builder.skip_batch()
            else:
                builder.add_batch(*arrow_batch_columns(batch))
    else:
        for f in files:
            for batch in pq.ParquetFile(f).iter_batches(
                    batch_size=max(1, batch_rows), columns=cols):
                if batch.num_rows:
                    builder.add_batch(*arrow_batch_columns(batch))
    bytes_read = sum(os.path.getsize(f) for f in files)
    spill = builder.finalize()
    if builder.rows == 0:
        spill = _empty_table(pq, files, parallelism, columns, comm)
    if dict_cache is not None and builder._string_cols:
        dict_cache.put(key, spill.dictionaries)
    spill.provenance = IngestInfo(
        format="parquet", files=files, rows=builder.rows,
        bytes_read=bytes_read, batches=builder.batches,
        recodes=builder.recodes,
        dict_cache_hit=cached is not None)
    return spill
