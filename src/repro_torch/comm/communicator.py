"""Modular communicator abstraction (the paper's §IV-B).

The torch counterpart of ``repro.comm.communicator``.  DDF communication
routines are written against this interface; backends plug in below it.

Layout convention.  Every tensor a communicator takes or returns carries
a leading axis over the ranks the calling process holds
(``ranks_held()``; ``rank(device)`` gives their global indices).  The
stacked communicator (``comm.stacked``) holds all ``p`` ranks on one
device, so that axis has length ``p``; a process-group communicator
(``comm.process_group``) holds one rank per process, so it has length 1.
Operators take ``p = size()`` for buckets and destinations and
``ranks_held()`` for the leading axis.  Below, shapes are written per
rank, after that axis:

Block-major ``all_to_all``: rank ``i`` passes ``(p, m, ...)`` where block
``j`` is destined to rank ``j``; output block ``j`` is the block received
from rank ``j`` (MPI semantics).

The swappable dimension is the collective *schedule*, as in the JAX
package: a registry maps names to communicator classes
(``register_communicator`` / ``get_communicator``):

  * ``xla``   — one tensor reshuffle per collective (``comm.stacked``;
                the name keeps the JAX package's default);
  * ``ring``  — (p-1)-step ring schedules of rolls of the rank axis
                (``comm.ring``);
  * ``bruck`` — ceil(log2 p)-step Bruck all-to-all, recursive doubling
                for the rest when p is a power of two (``comm.bruck``).

``get_communicator(name, p, group=...)`` gives the same schedule over the
processes of a ``torch.distributed`` process group instead.
"""

from __future__ import annotations

import abc
from typing import Dict, List, Type

import torch


class Communicator(abc.ABC):
    """Abstract DDF communicator over ``parallelism`` ranks."""

    #: registry key, set by subclasses
    name: str = "abstract"

    def __init__(self, parallelism: int):
        self.parallelism = parallelism

    # ------------------------------------------------------------------ #
    # Introspection
    # ------------------------------------------------------------------ #
    def size(self) -> int:
        return self.parallelism

    def ranks_held(self) -> int:
        """How many ranks the calling process holds: the length of the
        leading axis of every tensor it passes."""
        return self.parallelism

    def world(self, x: torch.Tensor) -> torch.Tensor:
        """(ranks held, ...) -> (p, ...): every rank's ``x`` on each
        process, for host-side reads every process must agree on (stats,
        drop counts, detection samples).  ``x`` itself when this process
        holds every rank."""
        return x

    @abc.abstractmethod
    def rank(self, device=None) -> torch.Tensor:
        """(ranks held,) int32: each held rank's index."""

    # ------------------------------------------------------------------ #
    # Collective routines (the set identified in the paper §III-B2)
    # ------------------------------------------------------------------ #
    @abc.abstractmethod
    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """x: (p, m, ...) block-major per rank -> (p, m, ...);
        out[j] = block from rank j."""

    @abc.abstractmethod
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """x: (m, ...) per rank -> (p, m, ...) stacked by rank."""

    @abc.abstractmethod
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """Sum across ranks."""

    @abc.abstractmethod
    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise max across ranks."""

    @abc.abstractmethod
    def all_reduce_min(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise min across ranks."""

    @abc.abstractmethod
    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """x: (p, m, ...) block-major per rank -> (m, ...): sum over ranks
        of block[rank]."""

    @abc.abstractmethod
    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        """Send rank ``src``'s value to ``dst`` for each (src, dst) pair;
        ranks that receive nothing get zeros."""

    # Non-abstract conveniences -----------------------------------------#
    def all_to_all_chunked(self, x: torch.Tensor, chunks: int = 1
                           ) -> torch.Tensor:
        """All-to-all issued as ``chunks`` smaller collectives along the
        capacity axis (per rank, axis 1), padded to a multiple of
        ``chunks`` and sliced back.  Invalid ``chunks`` raise
        ``ValueError`` up front."""
        x, m, csz = self._chunk_split(x, chunks)
        if csz is None:
            return self.all_to_all(x)
        outs = [self.all_to_all(x[:, :, c * csz:(c + 1) * csz])
                for c in range(chunks)]
        return torch.cat(outs, dim=2)[:, :, :m]

    def _chunk_split(self, x: torch.Tensor, chunks: int):
        """Pad the capacity axis to a multiple of ``chunks``; returns
        (x, orig_m, chunk_size), chunk_size None for one collective."""
        local = tuple(x.shape[1:])
        if len(local) < 2:
            raise ValueError(
                f"all_to_all_chunked needs a (p, m, ...) block-major array "
                f"with a capacity axis to chunk; got shape {local}")
        m = local[1]
        if not isinstance(chunks, int) or isinstance(chunks, bool) \
                or chunks < 1:
            raise ValueError(
                f"all_to_all_chunked: chunks must be a positive int, got "
                f"{chunks!r} (capacity axis 1 has {m} rows)")
        if chunks > max(m, 1):
            raise ValueError(
                f"all_to_all_chunked: cannot split the capacity axis "
                f"(axis 1, {m} rows) into {chunks} chunks — chunks must "
                f"be <= rows; rows not divisible by chunks are padded")
        if chunks <= 1:
            return x, m, None
        mp = -(-m // chunks) * chunks
        if mp != m:
            pad = torch.zeros(x.shape[:2] + (mp - m,) + x.shape[3:],
                              dtype=x.dtype, device=x.device)
            x = torch.cat([x, pad], dim=2)
        return x, m, mp // chunks

    def broadcast(self, x: torch.Tensor, root: int = 0) -> torch.Tensor:
        """Rank ``root``'s value on every rank."""
        sel = (self.rank(x.device) == root).to(x.dtype)
        return self.all_reduce(x * sel.reshape((-1,) + (1,) * (x.dim() - 1)))

    def exchange_counts(self, counts: torch.Tensor) -> torch.Tensor:
        """All-to-all of per-destination row counts (the AllToAllv counts
        round): counts[j] = rows this rank sends to rank j -> recv[j] =
        rows rank j sends to this rank."""
        return self.all_to_all(counts[..., None])[..., 0]


# ---------------------------------------------------------------------- #
# Registry
# ---------------------------------------------------------------------- #
_REGISTRY: Dict[str, Type[Communicator]] = {}


def register_communicator(cls: Type[Communicator]) -> Type[Communicator]:
    _REGISTRY[cls.name] = cls
    return cls


def get_communicator(name: str, parallelism: int,
                     group=None) -> Communicator:
    """Instantiate a communicator by registry name over ``parallelism``
    ranks: stacked on one device, or, with a ``torch.distributed``
    process ``group``, one rank per process of it."""
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown communicator {name!r}; available: {sorted(_REGISTRY)}")
    if group is None:
        return _REGISTRY[name](parallelism)
    from .process_group import process_group_communicator
    comm = process_group_communicator(name, group)
    if comm.size() != parallelism:
        raise ValueError(f"the process group has {comm.size()} ranks, "
                         f"not {parallelism}")
    return comm


def available_communicators() -> List[str]:
    return sorted(_REGISTRY)
