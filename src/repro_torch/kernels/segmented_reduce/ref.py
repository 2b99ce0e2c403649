"""Plain PyTorch segmented sum: the CPU path and the kernel's oracle.

Ports ``repro/kernels/segmented_reduce/ref.py`` (``jax.ops.segment_sum``
per value column), batched over stacked ranks.  JAX drops updates whose
segment id lies outside ``[0, num_segments)``; torch raises on an
out-of-range index, so those rows go to one extra trash slot that is
sliced off.
"""

from __future__ import annotations

import torch


def segmented_sum_ref(seg_ids: torch.Tensor, values: torch.Tensor,
                      num_segments: int, *, sorted_ids: bool = False
                      ) -> torch.Tensor:
    """Per-rank segment sums.  ``seg_ids`` (p, n) integer; ``values``
    (p, n) or (p, n, C) -> (p, num_segments) or (p, num_segments, C) in
    ``values``' dtype.  Empty segments hold 0.  ``sorted_ids`` (the
    kernel's route) is taken and ignored: the scatter is right for ids in
    any order."""
    if seg_ids.dim() != 2 or values.shape[:2] != seg_ids.shape \
            or values.dim() not in (2, 3):
        raise ValueError(f"segmented_sum needs seg_ids (p, n) and values "
                         f"(p, n) or (p, n, C), got {tuple(seg_ids.shape)} "
                         f"and {tuple(values.shape)}")
    squeeze = values.dim() == 2
    vals = values[..., None] if squeeze else values
    p, n, c = vals.shape
    seg = seg_ids.to(torch.int64)
    idx = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out = torch.zeros((p, num_segments + 1, c), dtype=vals.dtype,
                      device=vals.device)
    out.scatter_add_(1, idx[..., None].expand(p, n, c), vals)
    out = out[:, :num_segments]
    return out[..., 0] if squeeze else out
