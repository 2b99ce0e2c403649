"""Segmented-sum dispatcher: the kernel on the card, the plain version on
the CPU.

The choice follows the tensors alone: CUDA tensors go to the hand-written
kernel (``cuda.py``), which raises if it cannot build or launch or does
not take the dtype, and CPU tensors to the plain version (``ref.py``).
There is no silent fallback between them.  ``sorted_ids=True`` (the
groupby's ids, non-decreasing within each rank) selects the kernel's
``sorted`` route; the plain version takes the flag and ignores it.

The JAX wrapper (``repro/kernels/segmented_reduce/ops.py``) pads rows with
zeros and segments up to its block sizes; the CUDA kernel masks its ragged
last tile itself and writes exactly ``num_segments`` sums, so nothing is
padded here.
"""

from __future__ import annotations

import torch

from .cuda import segmented_sum_cuda
from ..common import refuse_dtensor
from .ref import segmented_sum_ref

#: value dtypes the kernel does not take -> the dtype they are summed in.
#: The JAX package sums in the column's own dtype (``jax.ops.segment_sum``);
#: an integer sum in int32 or int64 cast back is bit-identical to that
#: modular narrow sum, and a half sum in float32 rounds once at the end.
WIDEN = {torch.int8: torch.int32, torch.int16: torch.int32,
         torch.uint8: torch.int32, torch.uint16: torch.int32,
         torch.uint32: torch.int64, torch.float16: torch.float32,
         torch.bfloat16: torch.float32}


def widened_sum(sum_fn, seg_ids: torch.Tensor, values: torch.Tensor,
                num_segments: int, **kw) -> torch.Tensor:
    """``sum_fn(seg_ids, values, num_segments, **kw)``, with ``values`` of
    a dtype in ``WIDEN`` summed in the wider dtype and the sums cast back
    (wrapping, as the narrow sum does)."""
    wide = WIDEN.get(values.dtype)
    if wide is None:
        return sum_fn(seg_ids, values, num_segments, **kw)
    return sum_fn(seg_ids, values.to(wide), num_segments, **kw).to(
        values.dtype)


def segmented_sum(seg_ids: torch.Tensor, values: torch.Tensor,
                  num_segments: int, *, sorted_ids: bool = False
                  ) -> torch.Tensor:
    """Per-rank segment sums: ``seg_ids`` (p, n) int32, ``values`` (p, n)
    or (p, n, C) -> (p, num_segments) or (p, num_segments, C); ids outside
    ``[0, num_segments)`` add nothing.  ``sorted_ids`` states that the ids
    are non-decreasing within each rank (the card then takes the kernel's
    ``sorted`` route).  On the card, 8- and 16-bit values and uint32 are
    summed wider (``WIDEN``); bool raises, as it does in the JAX
    package."""
    refuse_dtensor("segmented_sum", seg_ids, values)
    if seg_ids.is_cuda:
        return widened_sum(segmented_sum_cuda, seg_ids.contiguous(),
                           values.contiguous(), num_segments,
                           sorted_ids=sorted_ids)
    if seg_ids.device.type != "cpu" or values.device.type != "cpu":
        raise ValueError(f"segmented_sum runs on cuda or cpu, got "
                         f"{seg_ids.device} and {values.device}")
    if values.dtype in (torch.uint16, torch.uint32):
        # torch's CPU scatter_add_ has no kernel for these; the wide sum
        # cast back is the same modular sum
        return widened_sum(segmented_sum_ref, seg_ids, values, num_segments,
                           sorted_ids=sorted_ids)
    return segmented_sum_ref(seg_ids, values, num_segments,
                             sorted_ids=sorted_ids)
