"""Decoder stack, its serving path and its training loss for the
``dense``, ``ssm``, ``moe`` and ``hybrid`` families, GQA or MLA attention
(ports ``repro/models/transformer.py``).

The JAX package stacks the body's layer params along a leading
``(n_periods,)`` axis and runs them under ``lax.scan``; here each layer is
one ``Block`` (an ``nn.Module``) in a ``ModuleList``, run by a Python
loop.  Caches are plain tensors, one dict per layer, that ``decode_step``
updates in place: the counterpart of the JAX engine's donated buffers.
``params_from_numpy`` carries a JAX ``init_params`` tree (as numpy) into
a ``Transformer``, unstacking the body; ``train_state_from_numpy`` carries
a JAX train state (params and AdamW moments) the same way.

Mapping to the reference: ``block_init`` / ``block_apply`` /
``block_decode`` are ``block_init`` / ``Block.forward`` /
``Block.decode``; ``init_params``, ``embed_tokens``, ``init_caches``,
``prefill``, ``decode_step``, ``_mask_pad_logits``, ``chunked_ce_loss``
and ``loss_fn`` keep their names.  ``forward`` is the inference forward
(no autograd); ``forward_train`` is the reference's ``forward`` with
autograd on and per-layer rematerialisation (``torch.utils.checkpoint``
where the reference checkpoints its layer scan).  Parameters are
trainable; the serving entry points run under ``torch.no_grad``.  A
layer's feed-forward is a dense ``mlp`` or, on the config's MoE layers,
``moe`` (``models/moe.py``), whose load-balancing loss each block returns
and ``forward_train`` sums.  An attention layer is GQA, or MLA when the
config has ``mla`` (deepseek-v2-lite-16b), whose cache is one latent row
a token.  The frontends are the reference's: the ``vlm`` family puts
precomputed patch embeddings ``(B, P, D)`` (``patch_embeds``) ahead of
the text embeddings, and the ``audio`` family sums its K codebooks'
embeddings over tokens ``(B, S, K)`` and has K logit heads; both keep
their vision tower or codec outside the model, as the reference does.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..core.env import resolve_device
from .attention import (gqa_attention, gqa_decode, gqa_init,
                        mla_attention, mla_decode, mla_init)
from .config import ModelConfig
from .layers import embed_init, mlp, mlp_init, rmsnorm
from .mamba2 import dims as mamba_dims, mamba_decode, mamba_forward, \
    mamba_init
from .moe import moe_apply, moe_init

Cache = Dict[str, torch.Tensor]


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


def _layer_ff(cfg: ModelConfig, i: int) -> Optional[int]:
    """d_ff of the dense FF at layer ``i`` (None if the layer has no FF)."""
    if cfg.is_moe_layer(i):
        return None  # MoE instead
    if cfg.moe and cfg.moe.first_dense_d_ff and i == 0:
        return cfg.moe.first_dense_d_ff
    return cfg.d_ff if cfg.d_ff else None


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


def _param_dict(tree: Dict[str, Any]) -> nn.ParameterDict:
    """A (nested) dict of tensors as a (nested) ``nn.ParameterDict``."""
    return nn.ParameterDict({k: _param_dict(v) if isinstance(v, dict)
                             else _param(v) for k, v in tree.items()})


# ---------------------------------------------------------------------- #
# One block: (attention | mamba) + optional (mlp | moe), pre-norm residual
# ---------------------------------------------------------------------- #
def block_init(gen: torch.Generator, cfg: ModelConfig, i: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    p: Dict[str, Any] = {"norm1": torch.ones((cfg.d_model,), dtype=dtype,
                                             device=device)}
    if cfg.layer_kind(i) == "a":
        p["attn"] = (mla_init if cfg.mla else gqa_init)(gen, cfg, dtype,
                                                         device)
    else:
        p["mixer"] = mamba_init(gen, cfg, dtype, device)
    ff = _layer_ff(cfg, i)
    if cfg.is_moe_layer(i):
        p["norm2"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
        p["moe"] = moe_init(gen, cfg, dtype, device)
    elif ff:
        p["norm2"] = torch.ones((cfg.d_model,), dtype=dtype, device=device)
        p["mlp"] = mlp_init(gen, cfg.d_model, ff, dtype, device)
    return p


class Block(nn.Module):
    """Layer ``i``: its parameters and its full-sequence and decode steps."""

    def __init__(self, cfg: ModelConfig, i: int, params: Dict[str, Any]):
        super().__init__()
        self.cfg, self.i = cfg, i
        self.kind = cfg.layer_kind(i)
        self.norm1 = _param(params["norm1"])
        mixer = "attn" if self.kind == "a" else "mixer"
        setattr(self, mixer, _param_dict(params[mixer]))
        #: the layer's feed-forward: "mlp", "moe" or None
        self.ff = next((f for f in ("moe", "mlp") if f in params), None)
        if self.ff:
            self.norm2 = _param(params["norm2"])
            setattr(self, self.ff, _param_dict(params[self.ff]))

    def _ff(self, x: torch.Tensor
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The residual feed-forward: (x, the MoE aux loss, None on a
        layer without MoE)."""
        if self.ff is None:
            return x, None
        h2 = rmsnorm(self.norm2, x, self.cfg.norm_eps)
        if self.ff == "moe":
            y, aux = moe_apply(self.moe, h2, self.cfg)
            return x + y, aux
        return x + mlp(self.mlp, h2, act=self.cfg.act), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                impl: str = "auto", collect_cache: bool = False,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                           Optional[Cache]]:
        """Full-sequence block (``block_apply``).  Returns (x, the MoE aux
        loss or None, cache entry or None)."""
        cfg = self.cfg
        h = rmsnorm(self.norm1, x, cfg.norm_eps)
        cache = None
        if self.kind == "a" and cfg.mla:
            if collect_cache:
                a, latent = mla_attention(self.attn, h, cfg, positions, impl,
                                          return_latent=True)
                cache = _mla_cache_from_seq(latent, cache_len)
            else:
                a = mla_attention(self.attn, h, cfg, positions, impl)
        elif self.kind == "a":
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
        x, aux = self._ff(x + a)
        return x, aux, cache

    def decode(self, x: torch.Tensor, cache: Cache,
               pos: torch.Tensor) -> torch.Tensor:
        """One-token block step (``block_decode``).  x: (B, 1, D); the
        cache entry is updated in place.  A MoE layer dispatches the token
        with each batch row a group, as ``moe_apply`` does."""
        h = rmsnorm(self.norm1, x, self.cfg.norm_eps)
        if self.kind == "a" and self.cfg.mla:
            a = mla_decode(self.attn, h, cache["ckv"], pos, self.cfg)
        elif self.kind == "a":
            a = gqa_decode(self.attn, h, cache["k"], cache["v"], pos,
                           self.cfg)
        else:
            a = mamba_decode(self.mixer, h, cache["ssm"], cache["conv"],
                             self.cfg)
        return self._ff(x + a)[0]


def _attn_cache_from_seq(k: torch.Tensor, v: torch.Tensor,
                         cache_len: int) -> Cache:
    """The KV cache of a full sequence: its rotated K and its V, (B, Hkv,
    S, hd), padded with zeros to ``cache_len`` positions.  The reference
    recomputes K and V from the block input; the block hands over the ones
    its attention just used, which are the same tensors."""
    pad = cache_len - k.shape[2]
    return {"k": F.pad(k, (0, 0, 0, pad)), "v": F.pad(v, (0, 0, 0, pad))}


def _mla_cache_from_seq(latent: torch.Tensor, cache_len: int) -> Cache:
    """The MLA cache of a full sequence: its latent rows ``[c_kv, k_rope]``
    (B, S, lora + rope), padded with zeros to ``cache_len`` positions.  As
    for K/V, the block hands over the latent its attention just used,
    which is the one the reference recomputes from the block input."""
    return {"ckv": F.pad(latent, (0, 0, 0, cache_len - latent.shape[1]))}


def block_cache_init(cfg: ModelConfig, i: int, batch: int, cache_len: int,
                     dtype=torch.bfloat16, device=None) -> Cache:
    if cfg.layer_kind(i) == "a" and cfg.mla:
        m = cfg.mla
        return {"ckv": torch.zeros(
            (batch, cache_len, m.kv_lora_rank + m.qk_rope_head_dim),
            dtype=dtype, device=device)}
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
    ``lm_head`` (each (Vp, D), or (K, Vp, D) for the audio family's K
    codebooks), ``layers`` (one dict per layer) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
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
    device = resolve_device(device)
    table = (cfg.padded_vocab, cfg.d_model)
    if cfg.family == "audio":
        table = (cfg.num_codebooks,) + table
    params: Dict[str, Any] = {"embed": embed_init(gen, table, dtype, device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = embed_init(gen, table, dtype, device)
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
    device = resolve_device(device)
    params = {"embed": tree_from_numpy(tree["embed"], device),
              "layers": [tree_from_numpy(lp, device)
                         for lp in unstack_layers(tree, cfg)],
              "final_norm": tree_from_numpy(tree["final_norm"], device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = tree_from_numpy(tree["lm_head"], device)
    return Transformer(cfg, params)


def named_params(model: Transformer) -> Dict[str, torch.Tensor]:
    """The model's parameters by name (``blocks.3.mixer.w_in``), as plain
    tensors that share their storage."""
    return {n: p.detach() for n, p in model.named_parameters()}


def model_from_named(cfg: ModelConfig,
                     named: Dict[str, torch.Tensor]) -> Transformer:
    """The ``Transformer`` whose parameters are the tensors of ``named``
    (``named_params``' layout; storage shared, not copied)."""
    tree: Dict[str, Any] = {"layers": [{} for _ in range(cfg.num_layers)]}
    for name, t in named.items():
        parts = name.split(".")
        if parts[0] != "blocks":
            tree[name] = t
            continue
        d = tree["layers"][int(parts[1])]
        for k in parts[2:-1]:
            d = d.setdefault(k, {})
        d[parts[-1]] = t
    return Transformer(cfg, tree)


def train_state_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                           device=None) -> Dict[str, Any]:
    """Load the JAX package's train state ``{"params", "opt": {"step",
    "m", "v"}}`` (``repro.train.init_train_state``, leaves as numpy) on
    ``device``: the params and both moments unstacked as
    ``params_from_numpy`` unstacks them, by ``named_params``' names."""
    opt = tree["opt"]
    return {"params": named_params(params_from_numpy(tree["params"], cfg,
                                                     device)),
            "opt": {"step": torch.tensor(np.asarray(opt["step"]),
                                         device=resolve_device(device)),
                    "m": named_params(params_from_numpy(opt["m"], cfg,
                                                        device)),
                    "v": named_params(params_from_numpy(opt["v"], cfg,
                                                        device))}}


# ---------------------------------------------------------------------- #
# Forward and serving
# ---------------------------------------------------------------------- #
def _lookup(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Token embeddings: ``embed[tokens]`` (B, S, D), or for the audio
    family the sum over codebooks i of ``embed[i][tokens[..., i]]`` with
    tokens (B, S, K), added from codebook 0 up as the reference adds."""
    if model.cfg.family != "audio":
        return model.embed[tokens]
    x = model.embed[0][tokens[..., 0]]
    for i in range(1, model.cfg.num_codebooks):
        x = x + model.embed[i][tokens[..., i]]
    return x


def embed_tokens(model: Transformer, tokens: torch.Tensor,
                 patch_embeds: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S), or (B, S, K) for audio -> (x (B, S, D), positions
    (B, S)).  A vlm model takes ``patch_embeds`` (B, P, D), cast to the
    embedding's dtype and put ahead of the text: x is (B, P + S, D), at
    positions 0 ... P + S - 1."""
    if (patch_embeds is not None) != (model.cfg.family == "vlm"):
        raise ValueError(f"{model.cfg.name}: a vlm model takes "
                         f"patch_embeds (B, P, D), and no other family does")
    x = _lookup(model, tokens)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(model.embed.dtype), x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    return x, positions


@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor, impl: str = "auto",
            collect_cache: bool = False, cache_len: Optional[int] = None,
            patch_embeds: Optional[torch.Tensor] = None):
    """Full-sequence forward.  Returns h (B, S, D) (S counts a vlm's
    patches), or (h, caches) with ``collect_cache``."""
    x, positions = embed_tokens(model, tokens, patch_embeds)
    caches: List[Cache] = []
    for blk in model.blocks:
        x, _, cache = blk(x, positions, impl, collect_cache, cache_len)
        caches.append(cache)
    h = rmsnorm(model.final_norm, x, model.cfg.norm_eps)
    return (h, caches) if collect_cache else h


def forward_train(model: Transformer, tokens: torch.Tensor,
                  impl: str = "auto", remat: bool = True,
                  patch_embeds: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward with autograd (the reference's ``forward``
    without caches).  Returns (h (B, S, D), aux), aux the float32 MoE
    load-balancing loss summed over the layers (0 without MoE).  With
    ``remat`` each layer's activations are recomputed in the backward
    pass from its input, as the reference's ``jax.checkpoint`` over its
    layer scan."""
    x, positions = embed_tokens(model, tokens, patch_embeds)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in model.blocks:
        def run(x, blk=blk):
            return blk(x, positions, impl)[:2]
        x, a = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        if a is not None:
            aux = aux + a
    h = rmsnorm(model.final_norm, x, model.cfg.norm_eps)
    return h, aux


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


def _unembed(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (..., D) against the unembedding w: (..., V) for w (V, D), or
    (..., K, V) for the audio family's (K, V, D)."""
    if w.dim() == 3:
        return torch.einsum("...d,kvd->...kv", h, w)
    return h @ w.T


def _logits(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    """(B, D) -> masked float32 logits (B, V), or (B, K, V) for audio.  As
    the reference, the unembedding is rounded to bfloat16 and contracted
    in h's dtype (JAX promotes the bf16 x f32 product to f32)."""
    w = model.unembed().to(torch.bfloat16).to(h.dtype)
    return _mask_pad_logits(_unembed(h, w).float(), model.cfg)


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache_len: int,
            impl: str = "auto", patch_embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, List[Cache]]:
    """Process a full prompt (B, S), or (B, S, K) for audio, after a vlm's
    ``patch_embeds`` (B, P, D); returns (last-position logits (B, V) or
    (B, K, V), caches with ``cache_len`` positions, the patches' first)."""
    h, caches = forward(model, tokens, impl, collect_cache=True,
                        cache_len=cache_len, patch_embeds=patch_embeds)
    return _logits(model, h[:, -1]), caches


@torch.no_grad()
def decode_step(model: Transformer, caches: List[Cache],
                tokens: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One decode step.  tokens: (B, 1), or (B, 1, K) for audio; pos:
    (B,), the same position for every row (a vlm's counts its patches).
    Returns logits (B, V) or (B, K, V); ``caches`` are updated in
    place."""
    x = _lookup(model, tokens)
    for blk, cache in zip(model.blocks, caches):
        x = blk.decode(x, cache, pos)
    h = rmsnorm(model.final_norm, x, model.cfg.norm_eps)[:, 0]
    return _logits(model, h)


# ---------------------------------------------------------------------- #
# Training loss: chunked cross-entropy
# ---------------------------------------------------------------------- #
def _ce_chunk(hs: torch.Tensor, ls: torch.Tensor, w: torch.Tensor,
              cfg: ModelConfig, z_loss: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the token losses, count) over one chunk of positions (of
    (position, codebook) pairs for audio); w is the bfloat16 unembedding,
    contracted in h's dtype and read in float32."""
    logits = _mask_pad_logits(_unembed(hs, w.to(hs.dtype)).float(), cfg)
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    valid = ls >= 0
    ll = torch.gather(logits, -1, ls.clamp(min=0)[..., None].long())[..., 0]
    tok_loss = lse - ll + z_loss * lse ** 2
    return (torch.where(valid, tok_loss, 0.0).sum(),
            valid.sum(dtype=torch.int32))


def chunked_ce_loss(model: Transformer, h: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 512,
                    z_loss: float = 1e-4) -> torch.Tensor:
    """Mean CE (+ z-loss) over labels >= 0.  h: (B, S, D); labels (B, S),
    or (B, S, K) for audio, where each (position, codebook) counts once.

    The sequence is processed in chunks of ``chunk`` positions, each
    rematerialised, so the full (B, S, V) logits are never resident.  As
    the reference: the unembedding is rounded to bfloat16 before the
    product, padded-vocab logits are -1e30, and the max that stabilises
    the log-sum-exp carries no gradient."""
    w = model.unembed().to(torch.bfloat16)
    s = h.shape[1]
    chunk = min(chunk, s)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.int32, device=h.device)
    for s0 in range(0, s, chunk):
        part, n = checkpoint(_ce_chunk, h[:, s0:s0 + chunk],
                             labels[:, s0:s0 + chunk], w, model.cfg,
                             z_loss, use_reentrant=False)
        loss_sum = loss_sum + part
        count = count + n
    return loss_sum / torch.clamp(count, min=1).float()


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor],
            impl: str = "auto", remat: bool = True, ce_chunk: int = 512
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss = chunked CE + MoE aux; ``batch`` carries ``tokens``
    and ``labels`` (B, S) ((B, S, K) for audio) on the model's device, and
    a vlm's ``patch_embeds`` (B, P, D), whose positions take no loss.
    Returns (loss, {"ce", "aux"})."""
    patches = batch.get("patch_embeds")
    h, aux = forward_train(model, batch["tokens"], impl, remat, patches)
    if patches is not None:
        h = h[:, patches.shape[1]:]
    ce = chunked_ce_loss(model, h, batch["labels"], ce_chunk)
    return ce + aux, {"ce": ce, "aux": aux}
