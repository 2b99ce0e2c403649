"""Plain PyTorch oracle of the SSD scan: the naive recurrence, one time
step at a time (ports ``repro/kernels/ssd_scan/ref.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (BH, T, P); dt: (BH, T, 1); a: (BH, 1); b, c: (BH, T, N).

    Returns (y: (BH, T, P) in x's dtype, h_final: (BH, N, P) float32)."""
    bh, t, p = x.shape
    n = b.shape[-1]
    xf, dtf, bf, cf = (v.float() for v in (x, dt, b, c))
    af = a.float()
    h = torch.zeros((bh, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(t):
        decay = torch.exp(af * dtf[:, i])                      # (BH, 1)
        h = decay[:, :, None] * h + dtf[:, i, :, None] * (
            bf[:, i, :, None] * xf[:, i, None, :])             # (BH, N, P)
        ys.append(torch.einsum("zn,znp->zp", cf[:, i], h))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((bh, 0, p))
    return y.to(x.dtype), h
