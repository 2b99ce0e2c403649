"""Plain PyTorch radix partition: the CPU path and the kernel's oracle.

Ports ``repro/kernels/radix_partition/xla.py`` (the sort-free segment
cumsum the JAX package runs off the TPU), batched over stacked ranks.
The stable rank of row ``i`` is the running count of earlier rows of its
rank with the same destination: an exclusive prefix sum over the one-hot
destination matrix.  Two regimes, the same as the JAX file:

* **dense** (few one-hot cells): one exclusive cumsum over the whole
  ``(p, n, nb)`` one-hot matrix;
* **blocked**: a loop over row blocks carrying the running per-bucket
  histogram, with memory O(p · block_rows · nb).  Rows padding the last
  block take bucket ``nb``, past every real bucket, so they are never
  counted.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

#: switch to the blocked loop above this many one-hot cells
_DENSE_CELLS = 1 << 22


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _onehot_ranks(d: torch.Tensor, num_buckets: int):
    """(exclusive in-block ranks, one-hot) for a (p, r) block."""
    iota = torch.arange(num_buckets, dtype=d.dtype, device=d.device)
    onehot = (d[..., None] == iota).to(torch.int32)          # (p, r, nb)
    excl = torch.cumsum(onehot, dim=1, dtype=torch.int32) - onehot
    safe = torch.clamp(d, 0, num_buckets - 1).to(torch.int64)
    return torch.gather(excl, 2, safe[..., None])[..., 0], onehot, safe


def radix_partition_dense(dest: torch.Tensor, num_buckets: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    ranks, onehot, _ = _onehot_ranks(dest, num_buckets)
    return ranks, onehot.sum(dim=1, dtype=torch.int32)


def radix_partition_blocked(dest: torch.Tensor, num_buckets: int,
                            block_rows: int = 4096
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    p, n = dest.shape
    n_pad = _round_up(max(n, block_rows), block_rows)
    d = dest
    if n_pad != n:
        d = torch.cat([d, torch.full((p, n_pad - n), num_buckets,
                                     dtype=dest.dtype, device=dest.device)],
                      dim=1)
    running = torch.zeros((p, num_buckets), dtype=torch.int32,
                          device=dest.device)
    parts = []
    for b0 in range(0, n_pad, block_rows):
        in_block, onehot, safe = _onehot_ranks(d[:, b0:b0 + block_rows],
                                               num_buckets)
        parts.append(torch.gather(running, 1, safe) + in_block)
        running = running + onehot.sum(dim=1, dtype=torch.int32)
    return torch.cat(parts, dim=1)[:, :n], running


def radix_partition_ref(dest: torch.Tensor, num_buckets: int,
                        block_rows: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable within-bucket ranks (p, n) int32 and the bucket histogram
    (p, num_buckets) int32 of ``dest`` (p, n) int32 in [0, num_buckets).
    ``block_rows`` forces the blocked regime; ``None`` picks dense or
    blocked from the one-hot cell count."""
    p, n = dest.shape
    if block_rows is None:
        if p * n * num_buckets <= _DENSE_CELLS:
            return radix_partition_dense(dest, num_buckets)
        block_rows = 4096
    return radix_partition_blocked(dest, num_buckets, block_rows)
