"""Decoder stack and its serving path for the ``dense`` and ``ssm`` families
(ports the serving half of ``repro/models/transformer.py``).

The JAX package stacks the body's layer params along a leading
``(n_periods,)`` axis and runs them under ``lax.scan``; here each layer is
one ``Block`` (an ``nn.Module``) in a ``ModuleList``, run by a Python
loop.  Caches are plain tensors, one dict per layer, that ``decode_step``
updates in place: the counterpart of the JAX engine's donated buffers.
``params_from_numpy`` carries a JAX ``init_params`` tree (as numpy) into
a ``Transformer``, unstacking the body.

Mapping to the reference: ``block_init`` / ``block_apply`` /
``block_decode`` are ``block_init`` / ``Block.forward`` /
``Block.decode``; ``init_params``, ``embed_tokens``, ``forward`` (no
remat: inference only), ``init_caches``, ``prefill``, ``decode_step`` and
``_mask_pad_logits`` keep their names.  MoE, MLA and the VLM / audio
frontends raise ``NotImplementedError`` (ROADMAP queue 1, item 13);
training (``loss_fn``, ``chunked_ce_loss``) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.env import resolve_device
from .attention import gqa_attention, gqa_decode, gqa_init
from .config import ModelConfig
from .layers import embed_init, mlp, mlp_init, rmsnorm
from .mamba2 import dims as mamba_dims, mamba_decode, mamba_forward, \
    mamba_init

Cache = Dict[str, torch.Tensor]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not serve yet."""
    later = [what for what, on in (("MoE", cfg.moe is not None),
                                   ("MLA", cfg.mla is not None),
                                   (f"the {cfg.family} frontend",
                                    cfg.family in ("vlm", "audio")))
             if on]
    if later:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(later)} not ported yet (ROADMAP "
            f"queue 1, item 13); the port serves the dense and ssm families")


# ---------------------------------------------------------------------- #
# Layer layout: prefix + periodic body
# ---------------------------------------------------------------------- #
def layer_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(n_prefix, period, n_periods), as the JAX package lays out params."""
    n_prefix = 1 if (cfg.moe and cfg.moe.first_dense_d_ff) else 0
    period = len(cfg.layer_pattern)
    if cfg.moe and cfg.moe.every_k_layers > 1:
        period = math.lcm(period, cfg.moe.every_k_layers)
    body = cfg.num_layers - n_prefix
    if body % period:
        raise ValueError(
            f"{cfg.name}: body layers {body} not divisible by period {period}")
    return n_prefix, period, body // period


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------- #
# One block: (attention | mamba) + optional mlp, pre-norm residual
# ---------------------------------------------------------------------- #
def block_init(gen: torch.Generator, cfg: ModelConfig, i: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    p: Dict[str, Any] = {"norm1": torch.ones((cfg.d_model,), dtype=dtype,
                                             device=device)}
    if cfg.layer_kind(i) == "a":
        p["attn"] = gqa_init(gen, cfg, dtype, device)
    else:
        p["mixer"] = mamba_init(gen, cfg, dtype, device)
    if cfg.d_ff:  # a dense FF on every layer (MoE is not ported)
        p["norm2"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, device)
    return p


class Block(nn.Module):
    """Layer ``i``: its parameters and its full-sequence and decode steps."""

    def __init__(self, cfg: ModelConfig, i: int, params: Dict[str, Any]):
        super().__init__()
        self.cfg, self.i = cfg, i
        self.kind = cfg.layer_kind(i)
        self.norm1 = _param(params["norm1"])
        mixer = "attn" if self.kind == "a" else "mixer"
        setattr(self, mixer, nn.ParameterDict(
            {k: _param(v) for k, v in params[mixer].items()}))
        self.has_mlp = "mlp" in params
        if self.has_mlp:
            self.norm2 = _param(params["norm2"])
            self.mlp = nn.ParameterDict(
                {k: _param(v) for k, v in params["mlp"].items()})

    def _ff(self, x: torch.Tensor) -> torch.Tensor:
        if not self.has_mlp:
            return x
        h2 = rmsnorm(self.norm2, x, self.cfg.norm_eps)
        return x + mlp(self.mlp, h2, act=self.cfg.act)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                impl: str = "auto", collect_cache: bool = False,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """Full-sequence block (``block_apply``).  Returns (x, cache entry
        or None)."""
        cfg = self.cfg
        h = rmsnorm(self.norm1, x, cfg.norm_eps)
        cache = None
        if self.kind == "a":
            if collect_cache:
                a, k, v = gqa_attention(self.attn, h, cfg, positions, impl,
                                        return_kv=True)
                cache = _attn_cache_from_seq(k, v, cache_len)
            else:
                a = gqa_attention(self.attn, h, cfg, positions, impl)
        elif collect_cache:
            a, ssm, conv = mamba_forward(self.mixer, h, cfg, impl,
                                         return_state=True)
            cache = {"ssm": ssm, "conv": conv}
        else:
            a = mamba_forward(self.mixer, h, cfg, impl)
        return self._ff(x + a), cache

    def decode(self, x: torch.Tensor, cache: Cache,
               pos: torch.Tensor) -> torch.Tensor:
        """One-token block step (``block_decode``).  x: (B, 1, D); the
        cache entry is updated in place."""
        h = rmsnorm(self.norm1, x, self.cfg.norm_eps)
        if self.kind == "a":
            a = gqa_decode(self.attn, h, cache["k"], cache["v"], pos,
                           self.cfg)
        else:
            a = mamba_decode(self.mixer, h, cache["ssm"], cache["conv"],
                             self.cfg)
        return self._ff(x + a)


def _attn_cache_from_seq(k: torch.Tensor, v: torch.Tensor,
                         cache_len: int) -> Cache:
    """The KV cache of a full sequence: its rotated K and its V, (B, Hkv,
    S, hd), padded with zeros to ``cache_len`` positions.  The reference
    recomputes K and V from the block input; the block hands over the ones
    its attention just used, which are the same tensors."""
    pad = cache_len - k.shape[2]
    return {"k": F.pad(k, (0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, pad))}


def block_cache_init(cfg: ModelConfig, i: int, batch: int, cache_len: int,
                     dtype=torch.bfloat16, device=None) -> Cache:
    if cfg.layer_kind(i) == "a":
        shape = (batch, cfg.num_kv_heads, cache_len, cfg.resolved_head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    s, d_in, nh = mamba_dims(cfg)
    return {"ssm": torch.zeros((batch, nh, s.d_state, s.head_dim),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, d_in), dtype=dtype,
                                device=device)}


# ---------------------------------------------------------------------- #
# Full model
# ---------------------------------------------------------------------- #
class Transformer(nn.Module):
    """Embedding, ``blocks`` (one per layer), final norm and, unless tied,
    the LM head.  ``params`` is the port's tree: ``embed``, optional
    ``lm_head``, ``layers`` (one dict per layer) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _param(params["embed"])
        if not cfg.tie_embeddings:
            self.lm_head = _param(params["lm_head"])
        self.blocks = nn.ModuleList(
            Block(cfg, i, lp) for i, lp in enumerate(params["layers"]))
        if len(self.blocks) != cfg.num_layers:
            raise ValueError(f"{cfg.name}: {len(self.blocks)} layers given, "
                             f"config has {cfg.num_layers}")
        self.final_norm = _param(params["final_norm"])

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def unembed(self) -> torch.Tensor:
        return self.embed if self.cfg.tie_embeddings else self.lm_head


def init_params(cfg: ModelConfig, gen: torch.Generator,
                dtype=torch.bfloat16, device=None) -> Transformer:
    """A randomly initialised model, drawn from ``gen`` (a generator on
    ``device``) with the reference's initializers and shapes.  ``device``
    None means ``cuda``, which raises without a card."""
    check_supported(cfg)
    device = resolve_device(device)
    vp = cfg.padded_vocab
    params: Dict[str, Any] = {
        "embed": embed_init(gen, (vp, cfg.d_model), dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, (vp, cfg.d_model), dtype, device)
    params["layers"] = [block_init(gen, cfg, i, dtype, device)
                        for i in range(cfg.num_layers)]
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                      device=device)
    return Transformer(cfg, params)


# ---------------------------------------------------------------------- #
# Trees of the JAX package
# ---------------------------------------------------------------------- #
def unstack_layers(tree: Dict[str, Any], cfg: ModelConfig) -> List[Any]:
    """Per-layer subtrees, in layer order, of a JAX params or caches tree
    ``{"prefix": [...], "body": {"layers": [...]}}`` whose body leaves
    carry a leading ``(n_periods,)`` axis."""
    n_prefix, period, n_periods = layer_layout(cfg)

    def index(t, p):
        if isinstance(t, dict):
            return {k: index(v, p) for k, v in t.items()}
        return t[p]
    body = tree["body"]["layers"]
    return list(tree["prefix"]) + [index(body[j], p)
                                   for p in range(n_periods)
                                   for j in range(period)]


def tree_from_numpy(t, device) -> Any:
    """numpy tree -> tensor tree; a norm's ``{"scale": w}`` becomes ``w``."""
    if isinstance(t, dict):
        if set(t) == {"scale"}:
            return tree_from_numpy(t["scale"], device)
        return {k: tree_from_numpy(v, device) for k, v in t.items()}
    return torch.from_numpy(np.array(t)).to(device)


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device=None) -> Transformer:
    """Load the JAX package's ``init_params(key, cfg, dtype)`` tree, with
    every leaf converted to numpy, into a ``Transformer`` on ``device``
    (None means ``cuda``, which raises without a card)."""
    check_supported(cfg)
    device = resolve_device(device)
    params = {"embed": tree_from_numpy(tree["embed"], device),
              "layers": [tree_from_numpy(lp, device)
                         for lp in unstack_layers(tree, cfg)],
              "final_norm": tree_from_numpy(tree["final_norm"], device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = tree_from_numpy(tree["lm_head"], device)
    return Transformer(cfg, params)


# ---------------------------------------------------------------------- #
# Forward and serving
# ---------------------------------------------------------------------- #
def embed_tokens(model: Transformer, tokens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) -> (x (B, S, D), positions (B, S))."""
    b, s = tokens.shape
    x = model.embed[tokens]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    return x, positions


@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor, impl: str = "auto",
            collect_cache: bool = False, cache_len: Optional[int] = None):
    """Full-sequence forward.  Returns h (B, S, D), or (h, caches) with
    ``collect_cache``."""
    x, positions = embed_tokens(model, tokens)
    caches: List[Cache] = []
    for blk in model.blocks:
        x, cache = blk(x, positions, impl, collect_cache, cache_len)
        caches.append(cache)
    h = rmsnorm(model.final_norm, x, model.cfg.norm_eps)
    return (h, caches) if collect_cache else h


def init_caches(cfg: ModelConfig, batch_size: int, cache_len: int,
                dtype=torch.bfloat16, device=None) -> List[Cache]:
    """Zeroed caches on ``device`` (None means ``cuda``, which raises
    without a card)."""
    device = resolve_device(device)
    return [block_cache_init(cfg, i, batch_size, cache_len, dtype, device)
            for i in range(cfg.num_layers)]


def _mask_pad_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    logits[..., cfg.vocab_size:] = -1e30
    return logits


def _logits(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    """(B, D) -> masked float32 logits (B, V).  As the reference, the
    unembedding is rounded to bfloat16 and contracted in h's dtype (JAX
    promotes the bf16 x f32 product to f32)."""
    w = model.unembed().to(torch.bfloat16).to(h.dtype)
    return _mask_pad_logits((h @ w.T).float(), model.cfg)


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache_len: int,
            impl: str = "auto") -> Tuple[torch.Tensor, List[Cache]]:
    """Process a full prompt (B, S); returns (last-position logits (B, V),
    caches with ``cache_len`` positions)."""
    h, caches = forward(model, tokens, impl, collect_cache=True,
                        cache_len=cache_len)
    return _logits(model, h[:, -1]), caches


@torch.no_grad()
def decode_step(model: Transformer, caches: List[Cache],
                tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One decode step.  tokens: (B, 1); pos: (B,), the same position for
    every row.  Returns logits (B, V); ``caches`` are updated in place."""
    x = model.embed[tokens]
    for blk, cache in zip(model.blocks, caches):
        x = blk.decode(x, cache, pos)
    h = rmsnorm(model.final_norm, x, model.cfg.norm_eps)[:, 0]
    return _logits(model, h)
