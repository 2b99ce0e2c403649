"""Plain PyTorch attention: the CPU path of ``flash_attention`` and the
kernel's oracle on the card.

Ports ``repro/kernels/flash_attention/ref.py``: quadratic GQA attention
with the K/V heads repeated, scores and softmax in float32, masked with
``-inf`` above the causal diagonal; queries are aligned to the end of the
keys (query ``i`` sees keys ``<= i + Sk - Sq``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: Optional[float] = None
                  ) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D) in q's
    dtype."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    group = hq // hkv
    k = torch.repeat_interleave(k, group, dim=1)
    v = torch.repeat_interleave(v, group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
