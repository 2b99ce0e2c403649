"""Bruck / recursive-doubling schedules on the stacked rank axis (the UCC
analogue).

The torch counterpart of ``repro.comm.bruck``, with the same schedules:
``all_to_all`` is the Bruck algorithm (ceil(log2 p) rounds, each moving
the blocks whose relative destination has that bit set, one roll of the
rank axis per round) [Bruck et al., IEEE TPDS'97]; ``all_gather`` /
``all_reduce`` use recursive doubling (pairwise exchanges with rank
``r ^ 2**k``) when p is a power of two and fall back to the ring
schedules otherwise.

On one card these schedules have no links to use: each round's roll and
copy is one more pass over device memory, so ``bruck`` is slower than
``xla`` and has no performance role here.  It exists so that
``communicator=`` and the stage-cache keys match the JAX package.  Over a
process group (``comm.process_group``) each round is one send and one
receive per process.
"""

from __future__ import annotations

import math

import torch

from .communicator import register_communicator
from .ring import RingCommunicator
from .stacked import StackedCommunicator


def _pow2(p: int) -> bool:
    return p & (p - 1) == 0


@register_communicator
class BruckCommunicator(StackedCommunicator):
    name = "bruck"

    def __init__(self, parallelism: int):
        super().__init__(parallelism)
        self._ring = RingCommunicator(parallelism)

    # ------------------------------------------------------------------ #
    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x, block_major=True)
        p = self.parallelism
        if p == 1:
            return x
        # phase 1, local rotation: slot i holds the block destined to rank
        # (r + i) % p ("relative destination i")
        b = self._reorder(x, self._rel(x.device, 1))
        # phase 2, log rounds: slot-i blocks travel distance i; round k
        # moves the slots with bit k set by 2**k
        for k in range(max(1, math.ceil(math.log2(p)))):
            dist = 1 << k
            sel = torch.tensor([i for i in range(p) if (i >> k) & 1],
                               device=x.device)
            b = b.index_copy(1, sel, self._shift(b[:, sel], dist))
        # phase 3: slot i now holds the block from rank (r - i) % p;
        # reorder to rank-major
        return self._reorder(b, self._rel(x.device, -1))

    # ------------------------------------------------------------------ #
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        p = self.parallelism
        if not _pow2(p):
            return self._ring.all_gather(x)
        self._check(x)
        buf = x[:, None]
        dist = 1
        while dist < p:
            # buf[r, m] = block of rank r ^ m
            buf = torch.cat([buf, self._xor(buf, dist)], dim=1)
            dist <<= 1
        j = torch.arange(p, device=x.device)
        return self._reorder(buf, self._ranks(x.device)[:, None] ^ j[None, :])

    # ------------------------------------------------------------------ #
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        p = self.parallelism
        if not _pow2(p):
            return self._ring.all_reduce(x)
        self._check(x)
        dist = 1
        while dist < p:
            x = x + self._xor(x, dist)
            dist <<= 1
        return x

    # ------------------------------------------------------------------ #
    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        # small-payload regime: all-reduce, then each rank keeps its block
        self._check(x, block_major=True)
        p = self.parallelism
        if p == 1:
            return x[:, 0]
        full = self.all_reduce(x)
        return self._per_rank(full, self._ranks(x.device))
