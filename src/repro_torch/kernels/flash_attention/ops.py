"""Flash-attention dispatcher: the kernel on the card, the plain version
on the CPU.

The choice follows the tensors alone: CUDA tensors go to the hand-written
kernel (``cuda.py``), which raises if it cannot build or launch, and CPU
tensors to the plain version (``ref.py``).  There is no silent fallback
between them.

Unlike the JAX wrapper (``repro/kernels/flash_attention/ops.py``), nothing
is padded here: the kernel takes the true Sq and Sk and masks keys past
Sk itself, so non-causal attention over a ragged key length runs on the
kernel too, where the JAX wrapper falls back to ``attention_ref``.  The
tile sizes are fixed by the kernel's route (``cuda.route_for``: 128 x 128
on the bf16 tensor-core route, 64 x 64 on the f32 route), so the
reference's ``block_q`` / ``block_k`` / ``interpret`` options have no
counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from .cuda import flash_attention_cuda
from .ref import attention_ref
from ..common import refuse_dtensor


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """GQA attention. q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) ->
    (B, Hq, Sq, D), queries aligned to the end of the keys."""
    refuse_dtensor("flash_attention", q, k, v)
    if causal and q.shape[2] > k.shape[2]:
        raise ValueError(f"causal attention needs Sq <= Sk (every query "
                         f"sees a key), got Sq={q.shape[2]}, "
                         f"Sk={k.shape[2]}")
    if q.is_cuda:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            # the kernel's output has no grad_fn: autograd would fail later
            # with an error that names neither the kernel nor the gap
            raise NotImplementedError(
                "flash_attention has no backward on the card (ROADMAP item "
                "13.1, still open): train with impl='dense' or 'chunked'; "
                "impl='auto' picks flash above 2048 keys")
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return attention_ref(q, k, v, causal=causal, scale=scale)
