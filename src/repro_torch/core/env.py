"""Stateful pseudo-BSP execution environment (the paper's §IV-A).

The torch counterpart of ``repro.core.env``.  ``CylonEnv`` holds the
communicator across operators and caches the stage callables it has built
so repeated submissions reuse them, with the JAX package's cache key and
``cache_hits`` / ``cache_misses`` counters.  PyTorch runs eagerly, so a
"built program" is the Python stage callable itself.

Ranks are stacked: a ``DistTable`` holds ``(p, capacity, ...)`` columns
and ``(p,)`` row counts on one device, and the callable a stage runs sees
them as one batched ``dataframe.Table``.  Entry points run on ``cuda``
unless the caller asks for the CPU; with no card they raise rather than
fall back.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..comm import Communicator, StackedCommunicator
from ..dataframe.schema import decode_columns, encode_columns
from ..dataframe.table import Table
from ..nulls import apply_null_columns, extract_null_columns


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
    """All ranks of a distributed table: (p, cap, ...) columns + (p,)
    counts, on one device."""

    columns: Dict[str, torch.Tensor]
    row_counts: torch.Tensor  # (p,) int32
    capacity: int             # per-rank capacity
    #: each dictionary-encoded string column's sorted dictionary
    #: (``dataframe.schema``); those columns hold int32 codes.  Host-side
    #: metadata only: stage callables never see it.
    dictionaries: Dict[str, Tuple[str, ...]] = \
        dataclasses.field(default_factory=dict)

    @property
    def parallelism(self) -> int:
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
    def from_table(cls, t: Table) -> "DistTable":
        return cls(dict(t.columns), t.row_count, t.capacity)

    @classmethod
    def from_numpy(cls, data: Dict[str, np.ndarray], parallelism: int,
                   capacity: Optional[int] = None,
                   device=None) -> "DistTable":
        """Block-distribute host rows over ``parallelism`` ranks.

        String columns (object / unicode numpy arrays) are dictionary-
        encoded on the host: the device gets int32 codes, the sorted
        dictionary lands in ``dictionaries``.  NaN / ``None`` values (or
        explicit ``__m_*`` companions) become validity-mask columns with
        canonical-zero data slots.  An explicit ``capacity`` — including
        ``0`` — is honored and validated against the per-rank row
        count."""
        dev = resolve_device(device)
        data = extract_null_columns({k: np.asarray(v)
                                     for k, v in data.items()})
        data, dicts = encode_columns(data)
        n = len(next(iter(data.values())))
        per = -(-n // parallelism)
        if capacity is None:
            capacity = max(8, -(-per // 8) * 8)
        if per > capacity:
            raise ValueError(f"rows/shard {per} exceeds capacity {capacity}")
        counts = np.clip(n - np.arange(parallelism) * per, 0,
                         per).astype(np.int32)
        cols = {}
        for name, arr in data.items():
            buf = np.zeros((parallelism, capacity) + arr.shape[1:], arr.dtype)
            for r in range(parallelism):
                chunk = arr[r * per:(r + 1) * per]
                buf[r, :len(chunk)] = chunk
            cols[name] = torch.from_numpy(buf).to(dev)
        return cls(cols, torch.from_numpy(counts).to(dev), capacity, dicts)

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
        return int(self.row_counts.sum())


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
    device, joined by a ``StackedCommunicator``.

    ``device=None`` means ``cuda`` and raises without a card; pass
    ``device="cpu"`` for the plain PyTorch path.
    """

    def __init__(self, parallelism: int = 1, device=None):
        if parallelism < 1:
            raise ValueError(f"parallelism must be >= 1, got {parallelism}")
        self.device = resolve_device(device)
        self.comm: Communicator = StackedCommunicator(parallelism)
        #: built stage callables by cache key (``set(env._cache)`` is the
        #: introspection surface, as in the JAX package)
        self._cache: Dict[Any, Callable] = {}
        #: a miss builds a stage callable, a hit reuses one
        self.cache_hits = 0
        self.cache_misses = 0

    @property
    def parallelism(self) -> int:
        return self.comm.size()

    def close(self) -> None:
        self._cache.clear()

    def synchronize(self) -> None:
        """Wait for the device (a no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

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
                    or a.parallelism != self.parallelism):
                raise ValueError(
                    f"table on {a.device} with {a.parallelism} ranks given "
                    f"to an env on {self.device} with {self.parallelism}")
        cache_key = key if key is not None else (
            fn, tuple(sorted(static_kwargs)),
            tuple(self._arg_sig(a) for a in args))
        stage = self._cache.get(cache_key)
        if stage is None:
            stage = self._build(fn, static_kwargs)
            self._cache[cache_key] = stage
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

        def conv(x):
            if isinstance(x, Table):
                return DistTable.from_table(x)
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
