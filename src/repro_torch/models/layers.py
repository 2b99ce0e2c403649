"""Shared neural-net building blocks (ports ``repro/models/layers.py``).

Parameters are plain tensors held by the caller (the model's
``nn.Module``s, or a dict in the tests); every block is a function of
them.  The JAX package's GSPMD sharding (``ShardingRules``, ``constrain``,
the ``*_specs`` trees) has no counterpart yet: these functions run on one
device and take no ``rules``.  The initializers draw from an explicit
``torch.Generator`` instead of a ``jax.random`` key, so the same seed
gives other numbers than the JAX package (tests carry weights across
with ``transformer.params_from_numpy`` instead).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]


# ---------------------------------------------------------------------- #
# Initializers
# ---------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape: Sequence[int], in_axis: int = 0,
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    """Normal(0, 1 / fan_in) weights, drawn in float32 and cast."""
    std = 1.0 / math.sqrt(shape[in_axis])
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=device).to(dtype)


# ---------------------------------------------------------------------- #
# RMSNorm
# ---------------------------------------------------------------------- #
def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS-normalise the last axis in float32, scale, cast back."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


# ---------------------------------------------------------------------- #
# Rotary position embedding (half-split, not interleaved)
# ---------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, D); positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)              # (D/2,)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- #
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------- #
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int,
             dtype=torch.bfloat16, device=None) -> dict:
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), 0, dtype, device),
        "w_up": dense_init(gen, (d_model, d_ff), 0, dtype, device),
        "w_down": dense_init(gen, (d_ff, d_model), 0, dtype, device),
    }


def mlp(params: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    if act == "silu":
        h = F.silu(gate.float()).to(x.dtype) * up
    elif act == "gelu":
        h = F.gelu(gate.float(), approximate="tanh").to(x.dtype) * up
    else:
        raise ValueError(act)
    return h @ params["w_down"]


# ---------------------------------------------------------------------- #
# Cross-entropy (float32 logits, optional z-loss)
# ---------------------------------------------------------------------- #
def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          z_loss: float = 1e-4) -> torch.Tensor:
    """logits (..., V) any float dtype; labels (...) integer.  Mean over
    all positions of ``lse - logit[label]`` (+ ``z_loss * lse**2``)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    loss = lse - ll
    if z_loss:
        loss = loss + z_loss * lse ** 2
    return loss.mean()
