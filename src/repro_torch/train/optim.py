"""AdamW optimizer + LR schedule + global-norm clipping, as functions on
dicts of tensors (ports ``repro/train/optim.py``).

Moments are float32 whatever the parameter dtype.  As the reference, the
schedule and the bias corrections are computed in float32 tensors (not
Python doubles), so the two packages step alike.  Which leaves take weight
decay is the caller's ``decay`` map; the default, ``ndim >= 2``, is the
reference's rule on the tree it is given (``train.step`` maps it onto the
reference's stacked tree).

On a mesh every leaf is a DTensor.  ``adamw_update`` takes each gradient
to its moment's placements; where a moment is sharded further than its
parameter (the 2-D ZeRO moments of ``train.step.state_specs``), the
update runs on the moment's shards and the new parameter is gathered
back to the parameter's placements: the reference's "one param gather
inside the update step".
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from ..models.layers import P, is_dtensor

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to ``min_lr_ratio`` (float32 scalar)."""
    step = torch.as_tensor(step).float()
    warm = _f32(cfg.lr, step) * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(_f32(math.pi, step) * frac))
    return torch.where(step < cfg.warmup_steps, warm, _f32(cfg.lr, step) * cos)


def init_opt_state(params: Params) -> Dict[str, Any]:
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in params.items()}
    dev = next(iter(params.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": zeros, "v": {n: z.clone() for n, z in zeros.items()}}


def opt_specs(param_specs: Mapping[str, P]) -> Dict[str, Any]:
    """Optimizer-state specs mirroring the parameter specs."""
    return {"step": P(), "m": dict(param_specs), "v": dict(param_specs)}


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree.values()))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Params, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {n: (g.float() * scale).to(g.dtype)
            for n, g in grads.items()}, norm


def adamw_update(params: Params, grads: Mapping[str, torch.Tensor],
                 state: Dict[str, Any], cfg: AdamWConfig,
                 decay: Optional[Mapping[str, bool]] = None
                 ) -> Tuple[Params, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (new_params, new_state, metrics); nothing
    is updated in place.  ``decay[name]`` says whether a leaf takes weight
    decay (default: ``ndim >= 2``, the reference's rule)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.float()
    bc1 = 1 - _f32(b1, stepf) ** stepf
    bc2 = 1 - _f32(b2, stepf) ** stepf
    new_p, new_m, new_v = {}, {}, {}
    for n, p in params.items():
        g, m0, pm = grads[n], state["m"][n], p
        if is_dtensor(m0):
            g = g.redistribute(m0.device_mesh, m0.placements)
            pm = p.redistribute(m0.device_mesh, m0.placements)
        g32 = g.float()
        m = b1 * m0 + (1 - b1) * g32
        v = b2 * state["v"][n] + (1 - b2) * g32 * g32
        delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if (p.dim() >= 2) if decay is None else decay[n]:
            delta = delta + cfg.weight_decay * pm.float()
        new_p[n] = (pm.float() - lr * delta).to(p.dtype)
        if is_dtensor(p):
            new_p[n] = new_p[n].redistribute(p.device_mesh, p.placements)
        new_m[n], new_v[n] = m, v
    return new_p, {"step": step, "m": new_m, "v": new_v}, \
        {"grad_norm": gnorm, "lr": lr}
