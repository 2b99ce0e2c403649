"""Train-step assembly: loss + gradient + AdamW (ports
``repro/train/step.py``).

A train state is ``{"params": {name: tensor}, "opt": {"step", "m",
"v"}}``: the parameters by ``transformer.named_params``' names and their
float32 moments under the same names.  ``make_train_step`` returns
``train_step(state, batch) -> (new_state, metrics)``; the state given is
not modified.

Sharded training: ``state_specs`` / ``batch_specs`` are the reference's
trees (flat, by name), ``place_state`` puts a state's full tensors onto a
mesh by them, and ``make_train_step(cfg, opt_cfg, rules)`` then takes
DTensor states: gradients are reduced to their parameters' placements
(the ZeRO reduce-scatter), the batch is placed by ``batch_specs``, and
the metrics come back as full tensors.

**The stack axis.**  The reference stacks its body layers along a
leading ``(n_periods,)`` axis and computes its 2-D ZeRO moment specs
(``_densify_moment_spec``) on that stacked shape, where a mesh axis can
land on the stack axis (e.g. mamba2-780m's ``a_log`` moments
``('model', 'data')``, a norm scale's ``('data', 'model')``).  The port's
leaves are per layer.  Its rule: a body leaf's moment spec is the
reference's, computed on the stacked shape, with the leading entry
dropped.  A mesh axis the reference put on the stack axis then leaves
that per-layer moment replicated over that axis: the update's math is
the same, and only small leaves (norm scales, ``a_log``, ``dt_bias``,
``d_skip``, ``conv``) hold a little more per rank.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from ..models import transformer
from ..models.config import ModelConfig
from ..models.layers import (NO_SHARDING, P, ShardingRules, distribute, full,
                             is_dtensor, set_mesh)
from .optim import AdamWConfig, adamw_update, init_opt_state, opt_specs

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


def _densify_moment_spec(spec: P, shape, rules: ShardingRules) -> P:
    """Extra ZeRO sharding for the float32 moments (the reference's
    rule): every mesh axis a weight is not sharded on goes into the
    largest still-unsharded dim it divides (2-D ZeRO)."""
    if len(shape) < 2:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a is not None:
                used.add(a)
    for axis, size in ((rules.model, rules.model_size),
                       (rules.fsdp, rules.data_size)):
        if axis is None or size <= 1 or axis in used:
            continue
        cands = [i for i, e in enumerate(entries)
                 if e is None and shape[i] % size == 0]
        if not cands:
            continue
        dim = max(cands, key=lambda i: shape[i])
        entries[dim] = axis
        used.add(axis)
    return P(*entries)


@functools.lru_cache(maxsize=None)
def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's shape, from ``init_params`` on the meta
    device."""
    model = transformer.init_params(cfg, torch.Generator(), torch.float32,
                                    "meta")
    return {n: tuple(p.shape) for n, p in model.named_parameters()}


def _is_body(cfg: ModelConfig, name: str) -> bool:
    """Whether ``name`` is a leaf the reference stacks (a body layer's)."""
    parts = name.split(".")
    return parts[0] == "blocks" and \
        int(parts[1]) >= transformer.layer_layout(cfg)[0]


def moment_spec(cfg: ModelConfig, name: str, spec: P,
                rules: ShardingRules) -> P:
    """A moment's spec: the reference's densified spec, computed on the
    stacked shape for a body leaf and with the stack axis dropped (the
    module docstring's rule)."""
    shape = param_shapes(cfg)[name]
    if not _is_body(cfg, name):
        return _densify_moment_spec(spec, shape, rules)
    n_periods = transformer.layer_layout(cfg)[2]
    stacked = _densify_moment_spec(P(None, *spec), (n_periods,) + shape,
                                   rules)
    return P(*stacked[1:])


def state_specs(cfg: ModelConfig, rules: ShardingRules) -> TrainState:
    ps = transformer.param_specs(cfg, rules)
    os_ = opt_specs(ps)
    if rules.model is not None and not rules.tp_weights:
        mom = {n: moment_spec(cfg, n, sp, rules) for n, sp in ps.items()}
        os_ = dict(os_, m=mom, v=dict(mom))
    return {"params": ps, "opt": os_}


def batch_specs(cfg: ModelConfig, rules: ShardingRules) -> Dict[str, P]:
    """Token ids replicated over ``model`` (the vocab-parallel embedding
    gathers from them with every model rank)."""
    spec: Dict[str, P] = {"tokens": rules.logical("batch", None),
                          "labels": rules.logical("batch", None)}
    if cfg.family == "audio":
        spec = {"tokens": rules.logical("batch", None, None),
                "labels": rules.logical("batch", None, None)}
    if cfg.family == "vlm":
        spec["patch_embeds"] = rules.logical("batch", "model", None)
    return spec


def place_state(state: TrainState, cfg: ModelConfig, rules: ShardingRules,
                mesh) -> TrainState:
    """A state of full tensors (the same on every rank) placed on
    ``mesh`` by ``state_specs``."""
    return transformer.place(state, state_specs(cfg, rules), mesh)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    rules: ShardingRules = NO_SHARDING, impl: str = "auto",
                    remat: bool = True, ce_chunk: int = 512
                    ) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """``train_step(state, batch)``: ``batch`` holds ``tokens`` and
    ``labels`` (B, S) ((B, S, K) for audio) and a vlm's ``patch_embeds``
    (B, P, D), numpy or tensors; they move to the parameters' device (and
    are placed by ``batch_specs`` when the state is on a mesh).  Metrics:
    ``loss``, ``ce``, ``aux``, ``grad_norm``, ``lr`` (0-d tensors on that
    device)."""
    def train_step(state: TrainState, batch: Dict[str, Any]):
        params = state["params"]
        first = next(iter(params.values()))
        mesh = first.device_mesh if is_dtensor(first) else None
        with set_mesh(mesh) if mesh is not None else \
                contextlib.nullcontext():
            model = transformer.model_from_named(cfg, params)
            b = {k: torch.as_tensor(v, device=model.device)
                 if not is_dtensor(v) else v for k, v in batch.items()}
            if mesh is not None:
                bs = batch_specs(cfg, rules)
                b = {k: v if is_dtensor(v) else distribute(v, bs[k], mesh)
                     for k, v in b.items()}
            names = list(params)
            with torch.enable_grad():
                loss, parts = transformer.loss_fn(model, b, impl, remat,
                                                  ce_chunk, rules)
                mp = dict(model.named_parameters())
                grads = torch.autograd.grad(loss, [mp[n] for n in names])
            if mesh is not None:
                # gradients onto their parameters' placements: ZeRO's
                # reduce-scatter and the data-parallel all-reduce
                grads = [g.redistribute(mesh, params[n].placements)
                         for n, g in zip(names, grads)]
            new_params, new_opt, om = adamw_update(
                params, dict(zip(names, grads)), state["opt"], opt_cfg,
                weight_decay_mask(cfg, params))
            metrics = {k: full(v.detach()) for k, v in
                       (("loss", loss), *parts.items(), *om.items())}
        return {"params": new_params, "opt": new_opt}, metrics
    return train_step

