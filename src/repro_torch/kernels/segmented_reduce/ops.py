"""Segmented-sum dispatcher: the kernel on the card, the plain version on
the CPU.

The choice follows the tensors alone: CUDA tensors go to the hand-written
kernel (``cuda.py``), which raises if it cannot build or launch or does
not take the dtype, and CPU tensors to the plain version (``ref.py``).
There is no silent fallback between them.

The JAX wrapper (``repro/kernels/segmented_reduce/ops.py``) pads rows with
zeros and segments up to its block sizes; the CUDA kernel masks its ragged
last tile itself and writes exactly ``num_segments`` sums, so nothing is
padded here.
"""

from __future__ import annotations

import torch

from .cuda import segmented_sum_cuda
from .ref import segmented_sum_ref


def segmented_sum(seg_ids: torch.Tensor, values: torch.Tensor,
                  num_segments: int) -> torch.Tensor:
    """Per-rank segment sums: ``seg_ids`` (p, n) int32, ``values`` (p, n)
    or (p, n, C) -> (p, num_segments) or (p, num_segments, C); ids outside
    ``[0, num_segments)`` add nothing."""
    if seg_ids.is_cuda:
        return segmented_sum_cuda(seg_ids.contiguous(), values.contiguous(),
                                  num_segments)
    if seg_ids.device.type != "cpu" or values.device.type != "cpu":
        raise ValueError(f"segmented_sum runs on cuda or cpu, got "
                         f"{seg_ids.device} and {values.device}")
    return segmented_sum_ref(seg_ids, values, num_segments)
