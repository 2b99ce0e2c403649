"""Train-step assembly: loss + gradient + AdamW (ports
``repro/train/step.py`` for one device).

A train state is ``{"params": {name: tensor}, "opt": {"step", "m",
"v"}}``: the parameters by ``transformer.named_params``' names and their
float32 moments under the same names.  ``make_train_step`` returns
``train_step(state, batch) -> (new_state, metrics)``; the state given is
not modified.  The reference's sharding trees (``state_specs``,
``batch_specs``, the ZeRO moment specs) wait for ROADMAP item 13.6.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from ..models import transformer
from ..models.config import ModelConfig
from .optim import AdamWConfig, adamw_update, init_opt_state

TrainState = Dict[str, Any]


def init_train_state(cfg: ModelConfig, gen: torch.Generator,
                     dtype=torch.bfloat16, device=None) -> TrainState:
    """Random parameters from ``gen`` (a generator on ``device``; None
    means the card) and zeroed moments."""
    params = transformer.named_params(
        transformer.init_params(cfg, gen, dtype, device))
    return {"params": params, "opt": init_opt_state(params)}


def weight_decay_mask(cfg: ModelConfig, params: Mapping[str, torch.Tensor]
                      ) -> Dict[str, bool]:
    """Which leaves take weight decay.  The reference decays a leaf when
    ``ndim >= 2`` on its stacked tree, where every body layer's leaf
    carries a leading ``(n_periods,)`` axis: so every body-layer leaf
    decays (norm scales, ``a_log``, ``dt_bias`` and ``d_skip`` included),
    and of the rest only the matrices."""
    n_prefix = transformer.layer_layout(cfg)[0]
    out = {}
    for name, p in params.items():
        parts = name.split(".")
        body = parts[0] == "blocks" and int(parts[1]) >= n_prefix
        out[name] = p.dim() + int(body) >= 2
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    impl: str = "auto", remat: bool = True,
                    ce_chunk: int = 512
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``train_step(state, batch)``: ``batch`` holds ``tokens`` and
    ``labels`` (B, S) ((B, S, K) for audio) and a vlm's ``patch_embeds``
    (B, P, D), numpy or tensors; they move to the parameters' device.  Metrics: ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr``
    (0-d tensors on that device)."""
    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state["params"]
        model = transformer.model_from_named(cfg, params)
        b = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        names = list(params)
        with torch.enable_grad():
            loss, parts = transformer.loss_fn(model, b, impl, remat,
                                              ce_chunk)
            mp = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, [mp[n] for n in names])
        new_params, new_opt, om = adamw_update(
            params, dict(zip(names, grads)), state["opt"], opt_cfg,
            weight_decay_mask(cfg, params))
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return {"params": new_params, "opt": new_opt}, metrics
    return train_step

