"""Distributed sort: sample sort (splitter-based range partition + local sort).

The torch counterpart of ``repro.dataframe.sort``.  Splitters are sampled
quantiles gathered from every rank, so output partitions stay balanced on
skewed keys (the paper's §VI sample-based repartitioning).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..comm import Communicator
from ..nulls import mask_name
from .ops_local import sort_local
from .shuffle import ShuffleStats, shuffle
from ..dtypes import order_view
from .table import Table, _sentinel_for


def _range_dest(table: Table, key_col: str, comm: Communicator,
                samples: int) -> torch.Tensor:
    """(p, cap) destination ranks for a range partition on ``key_col``.

    Nulls-last: null keys are left out of the splitter sample and routed
    to the last rank, where the local sort puts them at the tail."""
    p = comm.size()
    key = order_view(table.columns[key_col])
    m = table.columns.get(mask_name(key_col))
    valid = table.valid_mask()
    part = valid if m is None else (valid & m)
    splitters = _sample_splitters(key, part, comm, samples)
    dest = torch.searchsorted(splitters, key.contiguous(),
                              side="right").to(torch.int32)
    if m is None:
        return dest
    return torch.where(m, dest, p - 1)


def _sample_splitters(key: torch.Tensor, valid: torch.Tensor,
                      comm: Communicator, samples: int) -> torch.Tensor:
    """Gather per-rank key samples; returns (p, p-1) global splitters
    (identical on every rank)."""
    p = comm.size()
    dev = key.device
    sentinel = _sentinel_for(key.dtype)
    n_valid = valid.sum(dim=1)
    skey = torch.sort(torch.where(valid, key, sentinel), dim=1).values
    # evenly spaced positions within the sorted valid prefix
    n_local = torch.clamp(n_valid, max=samples)
    ar = torch.arange(samples, device=dev)
    idx = (ar[None, :] * torch.clamp(n_valid, min=1)[:, None]) \
        // max(samples, 1)
    idx = torch.minimum(idx, torch.clamp(n_valid - 1, min=0)[:, None])
    local = torch.where(ar[None, :] < n_local[:, None],
                        torch.gather(skey, 1, idx), sentinel)
    allsamp = comm.all_gather(local).reshape(comm.ranks_held(), p * samples)
    total_valid = comm.all_reduce(n_local)
    ssorted = torch.sort(allsamp, dim=1).values
    qpos = (torch.arange(1, p, device=dev)[None, :]
            * total_valid[:, None]) // p
    qpos = torch.clamp(qpos, max=p * samples - 1)
    return torch.gather(ssorted, 1, qpos).contiguous()   # (p, p-1)


def sort(
    table: Table,
    comm: Communicator,
    by: Sequence[str],
    samples: int = 64,
    **shuffle_kw,
) -> Tuple[Table, ShuffleStats]:
    """Globally sort by ``by[0]`` across ranks (full lexsort within rank):
    rank r holds the r-th contiguous key range."""
    dest = _range_dest(table, by[0], comm, samples)
    shuffled, stats = shuffle(table, comm, dest=dest, **shuffle_kw)
    return sort_local(shuffled, by), stats


def repartition_balanced(
    table: Table,
    comm: Communicator,
    key_col: str,
    samples: int = 64,
    **shuffle_kw,
) -> Tuple[Table, ShuffleStats]:
    """Sample-based repartition (paper §VI): balance rows across ranks.

    Range-partitions on sampled quantiles of ``key_col`` without the final
    local sort — used for skew/straggler mitigation in long pipelines.
    """
    dest = _range_dest(table, key_col, comm, samples)
    return shuffle(table, comm, dest=dest, **shuffle_kw)
