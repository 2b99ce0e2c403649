"""Stacked-ranks communicator: all ``p`` ranks on one device.

Rank ``r`` is slice ``r`` of a leading ``(p, ...)`` axis, so every
collective is a tensor reshuffle on the device: ``all_to_all`` transposes
the two rank axes, ``all_gather`` broadcasts, ``all_reduce`` sums over
axis 0.  This is what lets an 8-rank plan run on one H100 (and on the CPU
in the tests) with the JAX package's collective semantics.  It is the
registry's ``xla`` communicator: one reshuffle per collective, as XLA's
native collectives are one HLO op each.  ``ring`` and ``bruck`` subclass
it and replace the reshuffles with their step schedules.

The step primitives below serve those schedules for any number of ranks
held: ``_per_rank``, ``_reorder`` and ``_rel`` index the ranks this
process holds (all ``p`` here), so the process-group communicators
(``comm.process_group``) reuse them and replace only ``_shift`` and
``_xor``, the steps that cross ranks.
"""

from __future__ import annotations

import torch

from .communicator import Communicator, register_communicator


@register_communicator
class StackedCommunicator(Communicator):
    name = "xla"

    def rank(self, device=None) -> torch.Tensor:
        return torch.arange(self.parallelism, dtype=torch.int32,
                            device=device)

    def _check(self, x: torch.Tensor, block_major: bool = False) -> None:
        p, h = self.parallelism, self.ranks_held()
        if x.shape[0] != h or (block_major and (x.dim() < 2
                                                or x.shape[1] != p)):
            want = f"({h}, {p}, ...)" if block_major else f"({h}, ...)"
            raise ValueError(f"{self.name} communicator over {p} ranks "
                             f"({h} held here) needs {want}, got "
                             f"{tuple(x.shape)}")

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, block_major=True)
        return x.transpose(0, 1).contiguous()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.unsqueeze(0).expand((self.parallelism,) + tuple(x.shape))

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.sum(dim=0, keepdim=True, dtype=x.dtype).expand_as(x)

    def all_reduce_max(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.amax(dim=0, keepdim=True).expand_as(x)

    def all_reduce_min(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        return x.amin(dim=0, keepdim=True).expand_as(x)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, block_major=True)
        return x.sum(dim=0, dtype=x.dtype)

    def ppermute(self, x: torch.Tensor, perm) -> torch.Tensor:
        self._check(x)
        out = torch.zeros_like(x)
        for src, dst in perm:
            out[dst] = x[src]
        return out

    # step primitives of the ring and Bruck schedules ------------------ #
    @staticmethod
    def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
        """Every rank sends to rank + k: rank d receives rank d - k's
        value (``ppermute`` over the full shift permutation)."""
        return torch.roll(x, shifts=k, dims=0)

    def _xor(self, x: torch.Tensor, dist: int) -> torch.Tensor:
        """Rank d receives rank (d ^ dist)'s value (recursive doubling's
        pairwise exchange)."""
        idx = torch.arange(self.parallelism, device=x.device) ^ dist
        return x.index_select(0, idx)

    def _ranks(self, device) -> torch.Tensor:
        """(ranks held,) int64: the held ranks' global indices."""
        return self.rank(device).to(torch.int64)

    def _per_rank(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        """``out[r] = x[r, idx[r]]``: each held rank picks one block of
        its own (p, ...) buffer, ``idx`` (ranks held,) int64."""
        return x[torch.arange(self.ranks_held(), device=x.device), idx]

    def _reorder(self, stacked: torch.Tensor, idx: torch.Tensor
                 ) -> torch.Tensor:
        """``out[r, j] = stacked[r, idx[r, j]]`` over the block axis 1,
        ``idx`` (ranks held, p) int64."""
        h, p = self.ranks_held(), self.parallelism
        rows = torch.arange(h, device=stacked.device)[:, None].expand(h, p)
        return stacked[rows, idx]

    def _rel(self, device, sign: int) -> torch.Tensor:
        """(ranks held, p) int64: ``(r + sign * j) % p`` at [r, j], ``r``
        a held rank's global index."""
        j = torch.arange(self.parallelism, device=device)
        return (self._ranks(device)[:, None] + sign * j[None, :]) \
            % self.parallelism
