"""``repro_torch.io`` — Arrow-native file ingest into the engine's spill
format (the torch counterpart of ``repro.io``).

``read_parquet`` / ``read_csv`` stream file batches (Parquet row groups,
CSV blocks) straight into a round-robin-partitioned ``SpillTable`` — the
out-of-core representation of a distributed table — so datasets larger
than device memory ingest without ever materializing a whole file, and
feed ``collect(morsel_rows=...)`` morsel pipelines directly.  String
columns go through the dictionary encoder with incremental dictionary
growth; a process-level ``DictionaryCache`` (keyed by source paths +
sizes + mtimes) makes a repeat read of an unchanged source recode-free.
Missing values become ``__m_*`` validity masks (``repro_torch.nulls``).

Frontend sugar lives in ``repro_torch.df`` (``rdf.read_parquet(...)``
returns a lazy DataFrame); this package is the table-level API.  Ingest is
host code (numpy and pyarrow): the chunks keep their host dtypes, and
64-bit columns narrow only where rows go up to the device
(``dtypes.to_x32``), as in the JAX package.
"""

from .csv import read_csv
from .ingest import (DICT_CACHE, DictionaryCache, IngestInfo, TableBuilder,
                     have_pyarrow)
from .parquet import read_parquet

__all__ = ["read_parquet", "read_csv", "IngestInfo", "DictionaryCache",
           "DICT_CACHE", "TableBuilder", "have_pyarrow"]
