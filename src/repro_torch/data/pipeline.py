"""DDF-powered training-data pipeline (the paper's §IV-C, end to end;
ports ``repro/data/pipeline.py``).

The paper's motivating workflow is *data preprocessing applications
feeding a distributed deep-learning application*, stitched together
through the ``CylonStore``:

  1. a synthetic sharded corpus (document id, quality score, dup-group
     hash, fixed-width token payload) materialised as a ``DistTable`` of
     stacked ranks;
  2. a **DDF preprocessing application** run on a ``CylonExecutor`` gang:
       dedup   -- distributed groupby on the dup-group hash (keep min id),
                  joined back to recover the payloads,
       filter  -- quality threshold (local),
       join    -- against a per-source weights table (distributed join),
       balance -- sample-based repartition on document length (§VI skew
                  mitigation: straggler-proof shard sizes);
  3. the result is ``put`` into a ``CylonStore``; the training
     application ``get``s it (re-split to its own gang size if that
     differs) and packs token payloads into (B, S) batches.

Over a process group the preprocessing gang is a gang of processes
(``CylonExecutor(p, pool=DevicePool(process_group=...))``): its members
build the ranks they hold of the corpus (``comm=``), run the application,
and every process ``put``s into a ``CylonStore(pool=...)`` over the same
pool; the training processes ``get`` the table at their own gang size,
and ``batches_from_table`` gathers it over their gang, so every trainer
process draws the batches the stacked run draws.

The token payload is a vector column, ``(p, capacity, W)`` int32: the
table machinery moves its rows whole.  ``synth_corpus`` and
``batches_from_table`` draw from numpy's ``default_rng(seed)`` in the
reference's order, so both packages see the same corpus and batches.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from ..core import CylonExecutor, CylonStore, DistTable
from ..dataframe import (Table, filter_rows, groupby, join,
                         repartition_balanced)


@dataclasses.dataclass
class CorpusConfig:
    num_docs: int = 4096
    payload_tokens: int = 128     # tokens carried per document row
    vocab_size: int = 50304
    dup_rate: float = 0.3         # fraction of docs that are duplicates
    num_sources: int = 8
    seed: int = 0


def synth_corpus(cfg: CorpusConfig, parallelism: int,
                 capacity: Optional[int] = None, device=None,
                 comm=None) -> DistTable:
    """Synthetic sharded corpus on ``device`` (None: the card); with
    ``comm`` (a gang of processes' communicator) the ranks it holds.

    Shards get 2x capacity headroom by default: hash redistribution moves
    a Poisson-ish share to each rank, and a table filled to exactly its
    capacity is statistically bound to overflow some destination bucket.
    """
    rng = np.random.default_rng(cfg.seed)
    n = cfg.num_docs
    if capacity is None:
        per = -(-n // parallelism)
        capacity = max(8, -(-2 * per // 8) * 8)
    uniq = int(n * (1 - cfg.dup_rate))
    dup_group = rng.integers(0, max(uniq, 1), n).astype(np.int32)
    data = {
        "doc_id": np.arange(n, dtype=np.int32),
        "dup_group": dup_group,
        "source": rng.integers(0, cfg.num_sources, n).astype(np.int32),
        "quality": rng.random(n).astype(np.float32),
        "length": rng.integers(cfg.payload_tokens // 2, cfg.payload_tokens,
                               n).astype(np.int32),
        "tokens": rng.integers(0, cfg.vocab_size,
                               (n, cfg.payload_tokens)).astype(np.int32),
    }
    return DistTable.from_numpy(data, parallelism, capacity=capacity,
                                device=device, comm=comm)


def source_weights(num_sources: int, parallelism: int,
                   device=None, comm=None) -> DistTable:
    data = {
        "source": np.arange(num_sources, dtype=np.int32),
        "weight": np.linspace(0.5, 1.5, num_sources).astype(np.float32),
    }
    return DistTable.from_numpy(data, parallelism,
                                capacity=max(8, num_sources), device=device,
                                comm=comm)


def _app(ctx, docs: Table, wts: Table, quality_min: float) -> Table:
    """The preprocessing application, over all of the gang's ranks."""
    comm = ctx.comm
    # 1. dedup: min doc_id per dup_group; join the winners back to recover
    #    the payloads
    winners, _ = groupby(docs.select(["dup_group", "doc_id"]), comm,
                         keys=["dup_group"], aggs={"doc_id": ["min"]})
    winners = winners.rename({"doc_id_min": "doc_id"})
    docs2, _, _ = join(docs, winners.select(["doc_id"]), comm,
                       on="doc_id", out_capacity=docs.capacity)
    # 2. quality filter (local)
    docs3 = filter_rows(docs2, lambda t: t.col("quality") >= quality_min)
    # 3. join with the per-source weights (a broadcast-sized right side)
    docs4, _, _ = join(docs3, wts, comm, on="source",
                       out_capacity=docs.capacity)
    # 4. sample-based balance on length (§VI).  A handful of distinct
    #    lengths would tie at the splitters and overflow one destination,
    #    so the key gets a unique tie-breaker suffix (doc_id)
    docs4 = docs4.with_column(
        "balance_key",
        docs4.col("length") * 65536 + docs4.col("doc_id") % 65536)
    docs5, _ = repartition_balanced(docs4, comm, key_col="balance_key",
                                    capacity_factor=4.0)
    return docs5.select([n for n in docs5.column_names
                         if n != "balance_key"])


def preprocess(executor: CylonExecutor, corpus: Optional[DistTable],
               weights: Optional[DistTable], quality_min: float = 0.2,
               store: Optional[CylonStore] = None,
               store_key: str = "train_corpus") -> Optional[DistTable]:
    """The DDF preprocessing application, run on the executor's gang; the
    result is also ``put`` into ``store`` under ``store_key``.  Over a
    gang of processes every process calls it: the members run the
    application (``corpus`` / ``weights`` None, or anything, elsewhere),
    every process ``put``s, and a non-member gets ``None``."""
    def app(ctx, docs: Table, wts: Table) -> Table:
        return _app(ctx, docs, wts, quality_min)

    out = executor.run_cylon(app, corpus, weights)
    if store is not None:
        store.put(store_key, out)
    return out


def batches_from_table(table: DistTable, batch: int, seq_len: int,
                       seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Pack document payloads into (B, S) token / label batches (host
    side, numpy; the train step moves them to its device).  A table over
    a gang of processes is gathered over the gang at the first batch
    (every member calls it): each draws the stacked run's batches."""
    data = (table.gather_numpy() if table.comm is not None
            else table.to_numpy())             # over a gang: a collective
    toks = data["tokens"]                      # (N, payload)
    rng = np.random.default_rng(seed)
    flat = toks.reshape(-1)
    need = batch * (seq_len + 1)
    while True:
        start = rng.integers(0, max(len(flat) - need, 1))
        window = flat[start:start + need]
        if len(window) < need:
            window = np.concatenate([window, flat[:need - len(window)]])
        arr = window.reshape(batch, seq_len + 1)
        yield {"tokens": arr[:, :-1].astype(np.int32),
               "labels": arr[:, 1:].astype(np.int32)}
