"""Radix-partition dispatcher: the kernel on the card, the plain version
on the CPU.

The choice follows the tensor alone: a CUDA tensor goes to the
hand-written kernel (``cuda.py``), which raises if it cannot build or
launch, and a CPU tensor to the plain version (``ref.py``).  There is no
silent fallback between them.

Padding rule (``repro/kernels/radix_partition/ops.py:43-51``): rows that
only pad a block take a bucket past ``num_buckets``, so they never land in
a real bucket.  The CUDA kernel applies it to the ragged edge of its last
tile; the blocked plain version pads with bucket ``num_buckets``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .cuda import radix_partition_cuda
from .ref import radix_partition_ref
from ..common import refuse_dtensor


def radix_partition(dest: torch.Tensor, num_buckets: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ranks, hist) of ``dest`` (p, n) int32 in [0, num_buckets): each
    row's stable rank within its bucket, and each rank's histogram."""
    refuse_dtensor("radix_partition", dest)
    if dest.is_cuda:
        return radix_partition_cuda(dest.contiguous(), num_buckets)
    if dest.device.type != "cpu":
        raise ValueError(f"radix_partition runs on cuda or cpu, got "
                         f"{dest.device}")
    return radix_partition_ref(dest, num_buckets)
