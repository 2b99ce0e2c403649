"""Ring collective schedules on the stacked rank axis (the Gloo analogue).

The torch counterpart of ``repro.comm.ring``, with the same schedules:
every step is a neighbour exchange on the ring, here a roll of the
leading rank axis (``StackedCommunicator._shift``), so ``all_to_all``
takes ``p - 1`` rolls, ``reduce_scatter`` and ``all_gather`` ``p - 1``
each.  Data-movement collectives give exactly the ``xla`` result;
reductions add in ring order, so float sums may differ from ``xla``'s in
the last bits, as in the JAX package.

On one card these schedules have no links to use: each roll is one more
pass over device memory, so ``ring`` is slower than ``xla`` and has no
performance role here.  It exists so that ``communicator=`` and the
stage-cache keys match the JAX package.  Over a process group
(``comm.process_group``) every roll is a send to the next process and a
receive from the one before: the schedule on real links.
"""

from __future__ import annotations

import torch

from .communicator import register_communicator
from .stacked import StackedCommunicator


@register_communicator
class RingCommunicator(StackedCommunicator):
    name = "ring"

    # ------------------------------------------------------------------ #
    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        p = self.parallelism
        if p == 1:
            return x[:, None]
        # rel[k][d] = block originating at rank (d - k) % p
        rel, cur = [x], x
        for _ in range(1, p):
            cur = self._shift(cur, 1)
            rel.append(cur)
        # out[d, j] = block from rank j = rel[(d - j) % p][d]
        return self._reorder(torch.stack(rel, 1), self._rel(x.device, -1))

    # ------------------------------------------------------------------ #
    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        # x: (p, m, ...) block-major per rank; rank r ends with
        # sum_i x_i[r]
        self._check(x, block_major=True)
        p = self.parallelism
        if p == 1:
            return x[:, 0]
        r = self._ranks(x.device)
        # the token for chunk j starts at rank (j + 1) % p and travels the
        # whole ring, adding each rank's contribution to chunk j
        v = self._per_rank(x, (r - 1) % p)
        for t in range(1, p):
            v = self._shift(v, 1) + self._per_rank(x, (r - 1 - t) % p)
        return v

    # ------------------------------------------------------------------ #
    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        self._check(x)
        p = self.parallelism
        if p == 1:
            return x
        h = x.shape[0]
        flat = x.reshape(h, -1)
        n = flat.shape[1]
        chunk = -(-n // p)
        pad = chunk * p - n
        if pad:
            flat = torch.cat([flat, flat.new_zeros((h, pad))], dim=1)
        mine = self.reduce_scatter(flat.reshape(h, p, chunk))  # (h, chunk)
        full = self.all_gather(mine).reshape(h, p * chunk)
        return full[:, :n].reshape(x.shape)

    # ------------------------------------------------------------------ #
    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        # pairwise exchange: at step k every rank sends its block
        # (r + k) % p straight to rank (r + k) % p; p - 1 steps
        self._check(x, block_major=True)
        p = self.parallelism
        if p == 1:
            return x
        r = self._ranks(x.device)
        rel = [self._per_rank(x, r)]  # rel[k][d] = block from (d - k) % p
        for k in range(1, p):
            rel.append(self._shift(self._per_rank(x, (r + k) % p), k))
        return self._reorder(torch.stack(rel, 1), self._rel(x.device, -1))

    # ------------------------------------------------------------------ #
    def all_to_all_chunked(self, x: torch.Tensor, chunks: int = 1
                           ) -> torch.Tensor:
        # step-major, as the JAX package's ring: step k of every chunk is
        # issued before step k + 1 of any, so consecutive exchanges carry
        # independent buffers
        self._check(x, block_major=True)
        p = self.parallelism
        x, m, csz = self._chunk_split(x, chunks)
        if csz is None or p == 1:
            return self.all_to_all(x[:, :, :m])
        r = self._ranks(x.device)
        xs = [x[:, :, c * csz:(c + 1) * csz] for c in range(chunks)]
        rel = [[self._per_rank(xc, r)] for xc in xs]
        for k in range(1, p):
            for c, xc in enumerate(xs):
                rel[c].append(self._shift(self._per_rank(xc, (r + k) % p),
                                          k))
        idx = self._rel(x.device, -1)
        outs = [self._reorder(torch.stack(rc, 1), idx) for rc in rel]
        return torch.cat(outs, dim=2)[:, :, :m]
