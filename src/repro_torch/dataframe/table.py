"""Columnar table with static capacity, batched over stacked ranks.

The torch counterpart of ``repro.dataframe.table``.  A partition is a set
of fixed-capacity columns plus a ``row_count``; rows ``[0, row_count)`` are
valid and **compacted to the front** (every operator maintains this).

Where the JAX package runs ``p`` ranks as ``p`` devices under
``shard_map`` and a ``Table`` is one rank's view, here all ranks are
stacked on one device: every column is ``(p, capacity, ...)`` and
``row_count`` is ``(p,)`` int32.  Every local operator is written batched
over that leading rank axis, so one launch covers all ranks.

A column may carry trailing dims: a *vector column* is ``(p, capacity,
W)`` (the training corpus's token payload is one), and every structural
op below (``take``, ``mask_padding``, ``gather_rows`` / ``scatter_rows``,
``concat_tables``) moves its rows whole.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from ..dtypes import bits_as, signed_view


def _sentinel_for(dtype: torch.dtype):
    """Ordering value that sorts after every valid value of ``dtype``."""
    if dtype.is_floating_point:
        return float("inf")
    return torch.iinfo(dtype).max


def gather_rows(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-rank row gather: ``out[r, i] = v[r, idx[r, i]]`` (trailing dims
    of ``v`` ride along)."""
    s = signed_view(v)
    if s is not v:
        return gather_rows(s, idx).view(v.dtype)
    if v.dim() > 2:
        idx = idx.reshape(idx.shape + (1,) * (v.dim() - 2)).expand(
            idx.shape + v.shape[2:])
    return torch.gather(v, 1, idx)


def scatter_rows(size: int, pos: torch.Tensor, v: torch.Tensor
                 ) -> torch.Tensor:
    """Per-rank scatter with JAX's ``.at[pos].set(v, mode="drop")``:
    positions equal to ``size`` land in one extra trash slot that is
    sliced off.  ``pos`` must lie in ``[0, size]``."""
    s = signed_view(v)
    if s is not v:
        return scatter_rows(size, pos, s).view(v.dtype)
    out = torch.zeros((v.shape[0], size + 1) + v.shape[2:], dtype=v.dtype,
                      device=v.device)
    if v.dim() > 2:
        pos = pos.reshape(pos.shape + (1,) * (v.dim() - 2)).expand(v.shape)
    out.scatter_(1, pos, v)
    return out[:, :size]


def stable_partition_order(keep: torch.Tensor) -> torch.Tensor:
    """The permutation a stable argsort of ``where(keep, 0, 1)`` gives:
    kept rows in order, then the rest in order — computed in O(n) with
    one prefix sum instead of a sort.  ``keep``: (p, n) bool -> (p, n)
    int64."""
    kept_before = torch.cumsum(keep, dim=1)            # kept rows in [0, i]
    n_keep = kept_before[:, -1:]
    i = torch.arange(keep.shape[1], device=keep.device)
    pos = torch.where(keep, kept_before - 1, n_keep + i - kept_before)
    return torch.empty_like(pos).scatter_(1, pos, i.expand_as(pos))


@dataclasses.dataclass
class Table:
    """All ranks' partitions: dict of (p, capacity)-shaped columns plus a
    (p,) int32 valid row count."""

    columns: Dict[str, torch.Tensor]
    row_count: torch.Tensor  # (p,) int32

    # ------------------------------------------------------------------ #
    # constructors
    # ------------------------------------------------------------------ #
    @classmethod
    def from_arrays(cls, data: Mapping[str, object],
                    capacity: Optional[int] = None,
                    row_count=None, device=None) -> "Table":
        """Build a table from equal-length dense ``(p, n, ...)`` arrays
        (numpy or tensors; the reference takes one rank's ``(n, ...)``),
        padding axis 1 to ``capacity``.  ``row_count``: ``(p,)`` or one
        count for every rank (default ``n``).  Numpy input lands on
        ``device`` (None: the card); tensors stay where they are unless
        ``device`` is given."""
        for k, v in data.items():
            if isinstance(v, np.ndarray) and v.dtype.kind in ("O", "U", "S"):
                raise TypeError(
                    f"column {k!r} holds strings; device Tables carry int32 "
                    f"dictionary codes: encode driver-side with "
                    f"dataframe.schema.encode_strings (or ingest through "
                    f"DistTable.from_numpy / repro_torch.df)")
        if device is not None or any(isinstance(v, np.ndarray)
                                     for v in data.values()):
            from ..core.env import resolve_device
            device = resolve_device(device)
        cols = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
        p, n = next(iter(cols.values())).shape[:2]
        for k, v in cols.items():
            if tuple(v.shape[:2]) != (p, n):
                raise ValueError(
                    f"column {k!r} shape {tuple(v.shape[:2])} != {(p, n)}")
        capacity = capacity or n
        if capacity < n:
            raise ValueError(f"capacity {capacity} < rows {n}")
        for k, v in cols.items():
            if capacity > n:
                pad = torch.zeros((p, capacity - n) + v.shape[2:],
                                  dtype=v.dtype, device=v.device)
                cols[k] = torch.cat([v, pad], dim=1)
        dev = next(iter(cols.values())).device
        rc = torch.as_tensor(n if row_count is None else row_count,
                             dtype=torch.int32, device=dev)
        return cls(cols, rc.expand(p).clone() if rc.dim() == 0 else rc)

    @classmethod
    def empty_like(cls, other: "Table", capacity: Optional[int] = None
                   ) -> "Table":
        """No rows, ``other``'s columns (and ranks) at ``capacity``."""
        cap = capacity or other.capacity
        p = other.parallelism
        cols = {k: torch.zeros((p, cap) + v.shape[2:], dtype=v.dtype,
                               device=v.device)
                for k, v in other.columns.items()}
        return cls(cols, torch.zeros((p,), dtype=torch.int32,
                                     device=other.device))

    @property
    def parallelism(self) -> int:
        return self.row_count.shape[0]

    @property
    def capacity(self) -> int:
        return next(iter(self.columns.values())).shape[1]

    @property
    def device(self) -> torch.device:
        return self.row_count.device

    @property
    def column_names(self) -> Tuple[str, ...]:
        return tuple(sorted(self.columns))

    def valid_mask(self) -> torch.Tensor:
        """(p, capacity) bool: True on each rank's valid prefix."""
        idx = torch.arange(self.capacity, dtype=torch.int32,
                           device=self.device)
        return idx[None, :] < self.row_count[:, None]

    def col(self, name: str) -> torch.Tensor:
        return self.columns[name]

    # ------------------------------------------------------------------ #
    # structural ops (no communication)
    # ------------------------------------------------------------------ #
    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self.columns[n] for n in names}, self.row_count)

    def with_column(self, name: str, values: torch.Tensor) -> "Table":
        cols = dict(self.columns)
        cols[name] = values
        return Table(cols, self.row_count)

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        cols = {mapping.get(k, k): v for k, v in self.columns.items()}
        return Table(cols, self.row_count)

    def take(self, idx: torch.Tensor, new_count: torch.Tensor) -> "Table":
        """Gather rows by per-rank index ``idx`` (p, m); invalid slots may
        point anywhere in range."""
        cols = {k: gather_rows(v, idx) for k, v in self.columns.items()}
        return Table(cols, new_count.to(torch.int32))

    def mask_padding(self) -> "Table":
        """Zero out the padding region (canonicalises sentinel garbage)."""
        m = self.valid_mask()
        cols = {}
        for k, v in self.columns.items():
            mm = m.reshape(m.shape + (1,) * (v.dim() - 2))
            # as bits: CUDA has no torch.where for uint16/32
            sv = signed_view(v)
            cols[k] = bits_as(torch.where(mm, sv, torch.zeros(
                (), dtype=sv.dtype, device=v.device)), v.dtype)
        return Table(cols, self.row_count)

    # ------------------------------------------------------------------ #
    # host-side conversion
    # ------------------------------------------------------------------ #
    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Each rank's valid rows, rank after rank (the reference's
        ``to_numpy`` of one rank, concatenated over the stacked ranks)."""
        counts = self.row_count.cpu().tolist()
        out = {}
        for k, v in self.columns.items():
            a = v.cpu().numpy()
            out[k] = np.concatenate([a[r, :n] for r, n in enumerate(counts)])
        return out


def concat_tables(tables: Sequence[Table], capacity: Optional[int] = None
                  ) -> Table:
    """Concatenate tables rank by rank (compacted), padding to
    ``capacity`` (default: the sum of the capacities).  Rows past
    ``capacity`` are dropped; the row count is the full total, as in the
    JAX package."""
    names = tables[0].column_names
    capacity = capacity or sum(t.capacity for t in tables)
    counts = torch.stack([t.row_count for t in tables], dim=1)   # (p, T)
    offsets = (torch.cumsum(counts, dim=1) - counts).to(torch.int64)
    pos = []
    for i, t in enumerate(tables):
        at = offsets[:, i:i + 1] + torch.arange(t.capacity, device=t.device)
        pos.append(torch.where(t.valid_mask() & (at < capacity), at,
                               capacity))
    pos = torch.cat(pos, dim=1)
    cols = {n: scatter_rows(capacity, pos, torch.cat(
                [signed_view(t.columns[n]) for t in tables], dim=1)
            ).view(tables[0].columns[n].dtype) for n in names}
    return Table(cols, counts.sum(dim=1, dtype=torch.int32))
