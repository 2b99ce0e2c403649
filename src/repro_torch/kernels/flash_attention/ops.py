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

On the card the kernel is the PyTorch operator
``torch.ops.repro_torch.flash_attention``, whose only implementation is
the CUDA wrapper (no CPU one: a CPU tensor never reaches it).  Its fake
implementation gives the output's shape and dtype and raises the
launch's ``ValueError``s, and ``flash_flops`` is its FLOP formula
(``torch.utils.flop_counter``), so a dry run over fake card tensors
(``launch/dryrun.py``) runs each call's checks and counts its work
without a card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from .cuda import check_inputs, flash_attention_cuda
from .ref import attention_ref
from ..common import refuse_dtensor


def flash_flops(sq: int, sk: int, d: int, bhq: int, causal: bool) -> float:
    """FLOPs the attention needs: 4 D per visible (query, key) pair (Q K^T
    and P V); a causal query i sees keys <= i + Sk - Sq."""
    if causal:
        vis = np.minimum(np.arange(sq) + (sk - sq) + 1, sk).sum()
    else:
        vis = sq * sk
    return 4.0 * d * bhq * float(vis)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=(),
                         device_types="cuda")
def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool, scale: Optional[float]
                       ) -> torch.Tensor:
    return flash_attention_cuda(q, k, v, causal, scale)


@flash_attention_op.register_fake
def _flash_attention_fake(q, k, v, causal, scale):
    check_inputs(q, k, v, causal)
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q, k, v, causal, scale, out_shape=None, **kw):
    b, hq, sq, d = q
    return flash_flops(sq, k[2], d, b * hq, causal)


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
                "flash_attention has no backward on the card (ROADMAP "
                "follow-up 11, 'flash_attention has no backward'): train "
                "with impl='dense' or 'chunked'; impl='auto' picks flash "
                "above 2048 keys")
        return flash_attention_op(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal, scale)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return attention_ref(q, k, v, causal=causal, scale=scale)
