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

Sharding: ``param_specs`` / ``cache_specs`` are the reference's trees as
flat ``{name: spec}`` maps (``named_params``' names; a list of per-layer
dicts for caches), without the reference's stack axis.  Every entry
point takes ``rules`` (default ``NO_SHARDING``); under rules, on a
current mesh (``layers.set_mesh``), parameters, batches and caches are
DTensors placed by the spec trees and the reference's constraints are
applied at its sites: sequence-parallel activations between blocks, the
vocab-parallel embedding (``_vp_gather``, a masked local gather reduce-
scattered onto the sequence axis), vocab-sharded logits and a CE over
the local vocab shard.
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
from .attention import (gqa_attention, gqa_decode, gqa_init, gqa_specs,
                        mla_attention, mla_decode, mla_init, mla_specs)
from .config import ModelConfig
from .layers import (NO_SHARDING, P, ShardingRules, constrain, dense,
                     distribute, embed_init, is_dtensor, local_map_on, mlp,
                     mlp_init, mlp_specs, placements, rmsnorm)
from .mamba2 import dims as mamba_dims, mamba_decode, mamba_forward, \
    mamba_init, mamba_specs
from .moe import moe_apply, moe_init, moe_specs

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


def block_specs(cfg: ModelConfig, i: int, rules: ShardingRules
                ) -> Dict[str, Any]:
    """Layer ``i``'s parameter specs, nested as its parameters."""
    s: Dict[str, Any] = {"norm1": rules.logical(None)}
    if cfg.layer_kind(i) == "a":
        s["attn"] = (mla_specs if cfg.mla else gqa_specs)(cfg, rules)
    else:
        s["mixer"] = mamba_specs(cfg, rules)
    if cfg.is_moe_layer(i):
        s["norm2"] = rules.logical(None)
        s["moe"] = moe_specs(cfg, rules)
    elif _layer_ff(cfg, i):
        s["norm2"] = rules.logical(None)
        s["mlp"] = mlp_specs(rules)
    return s


def _flat(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


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

    def _ff(self, x: torch.Tensor, rules: ShardingRules = NO_SHARDING
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The residual feed-forward: (x, the MoE aux loss, None on a
        layer without MoE)."""
        if self.ff is None:
            return x, None
        h2 = rmsnorm(self.norm2, x, self.cfg.norm_eps)
        if self.ff == "moe":
            y, aux = moe_apply(self.moe, h2, self.cfg, rules)
            return x + y, aux
        return x + mlp(self.mlp, h2, act=self.cfg.act, rules=rules), None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                impl: str = "auto", collect_cache: bool = False,
                cache_len: Optional[int] = None,
                rules: ShardingRules = NO_SHARDING
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
                                          return_latent=True, rules=rules)
                cache = _mla_cache_from_seq(latent, cache_len, rules)
            else:
                a = mla_attention(self.attn, h, cfg, positions, impl,
                                  rules=rules)
        elif self.kind == "a":
            if collect_cache:
                a, k, v = gqa_attention(self.attn, h, cfg, positions, impl,
                                        return_kv=True, rules=rules)
                cache = _attn_cache_from_seq(k, v, cache_len, rules)
            else:
                a = gqa_attention(self.attn, h, cfg, positions, impl,
                                  rules=rules)
        elif collect_cache:
            a, ssm, conv = mamba_forward(self.mixer, h, cfg, impl,
                                         return_state=True, rules=rules)
            cache = {"ssm": ssm, "conv": conv}
        else:
            a = mamba_forward(self.mixer, h, cfg, impl, rules=rules)
        x, aux = self._ff(x + a, rules)
        x = constrain(x, rules, "batch", "model", None)   # SP between blocks
        return x, aux, cache

    def decode(self, x: torch.Tensor, cache: Cache, pos: torch.Tensor,
               rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
        """One-token block step (``block_decode``).  x: (B, 1, D); the
        cache entry is updated in place.  A MoE layer dispatches the token
        with each batch row a group, as ``moe_apply`` does."""
        h = rmsnorm(self.norm1, x, self.cfg.norm_eps)
        if self.kind == "a" and self.cfg.mla:
            a = mla_decode(self.attn, h, cache["ckv"], pos, self.cfg)
        elif self.kind == "a":
            a = gqa_decode(self.attn, h, cache["k"], cache["v"], pos,
                           self.cfg, rules)
        else:
            a = mamba_decode(self.mixer, h, cache["ssm"], cache["conv"],
                             self.cfg)
        return constrain(self._ff(x + a, rules)[0], rules, "batch", None,
                         None)


def _attn_cache_from_seq(k: torch.Tensor, v: torch.Tensor,
                         cache_len: int,
                         rules: ShardingRules = NO_SHARDING) -> Cache:
    """The KV cache of a full sequence: its rotated K and its V, (B, Hkv,
    S, hd), padded with zeros to ``cache_len`` positions, sequence-
    sharded over ``model`` under rules.  The reference recomputes K and V
    from the block input; the block hands over the ones its attention
    just used, which are the same tensors."""
    return {n: constrain(_pad_positions(t, 2, cache_len, rules), rules,
                         "batch", None, "model", None)
            for n, t in (("k", k), ("v", v))}


def _mla_cache_from_seq(latent: torch.Tensor, cache_len: int,
                        rules: ShardingRules = NO_SHARDING) -> Cache:
    """The MLA cache of a full sequence: its latent rows ``[c_kv, k_rope]``
    (B, S, lora + rope), padded with zeros to ``cache_len`` positions.  As
    for K/V, the block hands over the latent its attention just used,
    which is the one the reference recomputes from the block input."""
    return {"ckv": constrain(_pad_positions(latent, 1, cache_len, rules),
                             rules, "batch", "model", None)}


def _pad_positions(t: torch.Tensor, dim: int, length: int,
                   rules: ShardingRules) -> torch.Tensor:
    """``t`` padded with zeros along ``dim`` (its positions, the last but
    one) to ``length``; a DTensor, whose positions are whole here, is
    padded under ``local_map``."""
    pads = (0, 0, 0, length - t.shape[dim])
    if not is_dtensor(t):
        return F.pad(t, pads)
    spec = rules.logical("batch", *(None,) * (t.dim() - 1))
    return local_map_on(lambda x: F.pad(x, pads), t.device_mesh, spec,
                        (spec,))(t)


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


def block_cache_specs(cfg: ModelConfig, i: int, rules: ShardingRules
                      ) -> Dict[str, P]:
    """Decode caches: KV sequence-sharded over ``model``."""
    if cfg.layer_kind(i) == "a":
        if cfg.mla:
            return {"ckv": rules.logical("batch", "model", None)}
        kv = rules.logical("batch", None, "model", None)
        return {"k": kv, "v": kv}
    return {"ssm": rules.logical("batch", "model", None, None),
            "conv": rules.logical("batch", None, "model")}


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


def param_specs(cfg: ModelConfig, rules: ShardingRules) -> Dict[str, P]:
    """``{name: spec}`` over ``named_params``' names.  The embedding and
    the LM head are vocab-parallel (vocab over ``model``)."""
    specs: Dict[str, P] = {}
    table = (rules.logical(None, "model", None) if cfg.family == "audio"
             else rules.logical("model", None))
    specs["embed"] = table
    if not cfg.tie_embeddings:
        specs["lm_head"] = table
    for i in range(cfg.num_layers):
        specs.update(_flat(block_specs(cfg, i, rules), f"blocks.{i}."))
    specs["final_norm"] = rules.logical(None)
    return specs


def cache_specs(cfg: ModelConfig, rules: ShardingRules) -> List[Dict[str, P]]:
    """The specs of ``init_caches``' per-layer dicts."""
    return [block_cache_specs(cfg, i, rules) for i in range(cfg.num_layers)]


def place(tree: Any, specs: Any, mesh) -> Any:
    """Each full tensor of ``tree`` (the same on every rank) placed on
    ``mesh`` as a DTensor by its spec in ``specs`` (a tree of the same
    dicts and lists)."""
    if isinstance(tree, dict):
        return {k: place(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(place(v, s, mesh) for v, s in zip(tree, specs))
    return distribute(tree, specs, mesh)


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


def shard_model(model: Transformer, rules: ShardingRules, mesh
                ) -> Transformer:
    """The ``Transformer`` over ``model``'s parameters placed on ``mesh``
    by ``param_specs``."""
    return model_from_named(model.cfg, place(
        named_params(model), param_specs(model.cfg, rules), mesh))


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
def _vp_gather(table: torch.Tensor, toks: torch.Tensor,
               rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
    """Embedding lookup ``table[toks]``; vocab-parallel (Megatron) under
    rules on a mesh, as the reference writes it: each model rank gathers
    from its vocab shard, rows outside it count zero, and the sum over
    the model ranks lands reduce-scattered onto the sequence axis (the
    masked gathers leave ``local_map`` as partial sums).  The table is
    never gathered.  Where the vocab or the sequence does not divide over
    the model axis, the reference's plain lookup (``F.embedding`` on a
    DTensor)."""
    if not is_dtensor(table):
        return table[toks]
    from torch.distributed.tensor import Partial, Replicate
    ms = rules.model_size
    vp = table.shape[0]
    s = toks.shape[1]
    if rules.model is None or ms <= 1 or vp % ms or s % ms:
        # a vocab-sharded table's lookup is a masked partial sum, reduced
        # here: two such partials do not add (DTensor compares their masks)
        x = F.embedding(toks, table)
        return x.redistribute(x.device_mesh, [
            Replicate() if p.is_partial() else p for p in x.placements])
    mesh = table.device_mesh

    def local(tab, tk):
        r = mesh.get_local_rank(rules.model)
        vshard = tab.shape[0]
        lo = r * vshard
        loc = torch.clamp(tk - lo, 0, vshard - 1)
        hit = ((tk >= lo) & (tk < lo + vshard))[..., None]
        return torch.where(hit, tab[loc], 0.0).to(tab.dtype)
    out = placements(rules.logical("batch", None, None), mesh)
    out[mesh.mesh_dim_names.index(rules.model)] = Partial()
    x = local_map_on(local, mesh, out,
                     (rules.logical("model", None),
                      rules.logical("batch", None)))(table, toks)
    return constrain(x, rules, "batch", "model", None)


def _lookup(model: Transformer, tokens: torch.Tensor,
            rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
    """Token embeddings: ``embed[tokens]`` (B, S, D), or for the audio
    family the sum over codebooks i of ``embed[i][tokens[..., i]]`` with
    tokens (B, S, K), added from codebook 0 up as the reference adds.
    Plain tokens for a DTensor table are placed batch-sharded first."""
    if is_dtensor(model.embed) and not is_dtensor(tokens):
        tokens = distribute(tokens, rules.logical(
            "batch", *(None,) * (tokens.dim() - 1)), model.embed.device_mesh)
    if model.cfg.family != "audio":
        return _vp_gather(model.embed, tokens, rules)
    x = _vp_gather(model.embed[0], tokens[..., 0], rules)
    for i in range(1, model.cfg.num_codebooks):
        x = x + _vp_gather(model.embed[i], tokens[..., i], rules)
    return x


def embed_tokens(model: Transformer, tokens: torch.Tensor,
                 patch_embeds: Optional[torch.Tensor] = None,
                 rules: ShardingRules = NO_SHARDING
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S), or (B, S, K) for audio -> (x (B, S, D), positions
    (B, S)).  A vlm model takes ``patch_embeds`` (B, P, D), cast to the
    embedding's dtype and put ahead of the text: x is (B, P + S, D), at
    positions 0 ... P + S - 1.  Under rules x is sequence-sharded."""
    if (patch_embeds is not None) != (model.cfg.family == "vlm"):
        raise ValueError(f"{model.cfg.name}: a vlm model takes "
                         f"patch_embeds (B, P, D), and no other family does")
    x = _lookup(model, tokens, rules)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(model.embed.dtype), x], dim=1)
    b, s = x.shape[:2]
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    return constrain(x, rules, "batch", "model", None), positions


@torch.no_grad()
def forward(model: Transformer, tokens: torch.Tensor, impl: str = "auto",
            collect_cache: bool = False, cache_len: Optional[int] = None,
            patch_embeds: Optional[torch.Tensor] = None,
            rules: ShardingRules = NO_SHARDING):
    """Full-sequence forward.  Returns h (B, S, D) (S counts a vlm's
    patches), or (h, caches) with ``collect_cache``."""
    x, positions = embed_tokens(model, tokens, patch_embeds, rules)
    caches: List[Cache] = []
    for blk in model.blocks:
        x, _, cache = blk(x, positions, impl, collect_cache, cache_len,
                          rules)
        caches.append(cache)
    h = rmsnorm(model.final_norm, x, model.cfg.norm_eps)
    if collect_cache and rules.enabled:
        caches = _place_caches(caches, model.cfg, rules)
    return (h, caches) if collect_cache else h


def _place_caches(caches: List[Cache], cfg: ModelConfig,
                  rules: ShardingRules) -> List[Cache]:
    """DTensor caches redistributed to ``cache_specs``."""
    if not any(is_dtensor(t) for c in caches for t in c.values()):
        return caches
    specs = cache_specs(cfg, rules)
    return [{n: t.redistribute(t.device_mesh, placements(specs[i][n],
                                                        t.device_mesh))
             for n, t in c.items()} for i, c in enumerate(caches)]


def forward_train(model: Transformer, tokens: torch.Tensor,
                  impl: str = "auto", remat: bool = True,
                  patch_embeds: Optional[torch.Tensor] = None,
                  rules: ShardingRules = NO_SHARDING
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward with autograd (the reference's ``forward``
    without caches).  Returns (h (B, S, D), aux), aux the float32 MoE
    load-balancing loss summed over the layers (0 without MoE).  With
    ``remat`` each layer's activations are recomputed in the backward
    pass from its input, as the reference's ``jax.checkpoint`` over its
    layer scan."""
    x, positions = embed_tokens(model, tokens, patch_embeds, rules)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk in model.blocks:
        def run(x, blk=blk):
            return blk(x, positions, impl, rules=rules)[:2]
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
    if is_dtensor(logits):      # vocab-sharded: a select, not a write
        iota = torch.arange(logits.shape[-1], device=logits.device)
        return torch.where(iota < cfg.vocab_size, logits, -1e30)
    logits[..., cfg.vocab_size:] = -1e30
    return logits


def _unembed(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (..., D) against the unembedding w: (..., V) for w (V, D), or
    (..., K, V) for the audio family's (K, V, D).  A vocab-sharded
    DTensor w takes one product a codebook: the einsum would merge K with
    the sharded V, a strided shard DTensor's matmul cannot take."""
    if w.dim() == 3 and is_dtensor(w):
        return torch.stack([dense(h, w[i].T) for i in range(w.shape[0])],
                           dim=-2)
    if w.dim() == 3:
        return torch.einsum("...d,kvd->...kv", h, w)
    return dense(h, w.T)


def _logits(model: Transformer, h: torch.Tensor,
            rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
    """(B, D) -> masked float32 logits (B, V), or (B, K, V) for audio.  As
    the reference, the unembedding is rounded to bfloat16 and contracted
    in h's dtype (JAX promotes the bf16 x f32 product to f32).  Under
    rules the vocab stays sharded over ``model``."""
    w = model.unembed().to(torch.bfloat16).to(h.dtype)
    logits = _unembed(h, w).float()
    if model.cfg.family == "audio":
        logits = constrain(logits, rules, "batch", None, "model")
    else:
        logits = constrain(logits, rules, "batch", "model")
    return _mask_pad_logits(logits, model.cfg)


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache_len: int,
            impl: str = "auto", patch_embeds: Optional[torch.Tensor] = None,
            rules: ShardingRules = NO_SHARDING
            ) -> Tuple[torch.Tensor, List[Cache]]:
    """Process a full prompt (B, S), or (B, S, K) for audio, after a vlm's
    ``patch_embeds`` (B, P, D); returns (last-position logits (B, V) or
    (B, K, V), caches with ``cache_len`` positions, the patches' first).
    Under rules the caches are placed by ``cache_specs``."""
    h, caches = forward(model, tokens, impl, collect_cache=True,
                        cache_len=cache_len, patch_embeds=patch_embeds,
                        rules=rules)
    return _logits(model, h[:, -1], rules), caches


@torch.no_grad()
def decode_step(model: Transformer, caches: List[Cache],
                tokens: torch.Tensor, pos: torch.Tensor,
                rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
    """One decode step.  tokens: (B, 1), or (B, 1, K) for audio; pos:
    (B,), the same position for every row (a vlm's counts its patches).
    Returns logits (B, V) or (B, K, V); ``caches`` are updated in
    place."""
    x = constrain(_lookup(model, tokens, rules), rules, "batch", None, None)
    for blk, cache in zip(model.blocks, caches):
        x = blk.decode(x, cache, pos, rules)
    h = rmsnorm(model.final_norm, x, model.cfg.norm_eps)[:, 0]
    return _logits(model, h, rules)


# ---------------------------------------------------------------------- #
# Training loss: chunked cross-entropy
# ---------------------------------------------------------------------- #
def _ce_chunk(hs: torch.Tensor, ls: torch.Tensor, w: torch.Tensor,
              cfg: ModelConfig, z_loss: float,
              rules: ShardingRules = NO_SHARDING
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the token losses, count) over one chunk of positions (of
    (position, codebook) pairs for audio); w is the bfloat16 unembedding,
    contracted in h's dtype and read in float32.  On a mesh the logits
    stay vocab-sharded: the label's logit is a masked sum over the local
    vocab shard, as the reference takes it."""
    logits = _unembed(hs, w.to(hs.dtype)).float()
    if is_dtensor(logits):
        logits = constrain(logits, rules, "batch", *(None,) * (
            logits.dim() - 2), "model")
    logits = _mask_pad_logits(logits, cfg)
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    valid = ls >= 0
    if is_dtensor(logits):
        iota = torch.arange(logits.shape[-1], device=logits.device)
        ll = torch.where(iota == ls[..., None], logits, 0.0).sum(dim=-1)
    else:
        ll = torch.gather(logits, -1,
                          ls.clamp(min=0)[..., None].long())[..., 0]
    tok_loss = lse - ll + z_loss * lse ** 2
    return (torch.where(valid, tok_loss, 0.0).sum(),
            valid.sum(dtype=torch.int32))


def chunked_ce_loss(model: Transformer, h: torch.Tensor,
                    labels: torch.Tensor, chunk: int = 512,
                    z_loss: float = 1e-4,
                    rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
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
    # sequence-sharded, as the reference keeps it for the backward pass
    h = constrain(h, rules, "batch", "model", None)
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.int32, device=h.device)
    for s0 in range(0, s, chunk):
        part, n = checkpoint(_ce_chunk, h[:, s0:s0 + chunk],
                             labels[:, s0:s0 + chunk], w, model.cfg,
                             z_loss, rules, use_reentrant=False)
        loss_sum = loss_sum + part
        count = count + n
    return loss_sum / torch.clamp(count, min=1).float()


def loss_fn(model: Transformer, batch: Dict[str, torch.Tensor],
            impl: str = "auto", remat: bool = True, ce_chunk: int = 512,
            rules: ShardingRules = NO_SHARDING
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Training loss = chunked CE + MoE aux; ``batch`` carries ``tokens``
    and ``labels`` (B, S) ((B, S, K) for audio) on the model's device, and
    a vlm's ``patch_embeds`` (B, P, D), whose positions take no loss.
    Returns (loss, {"ce", "aux"})."""
    patches = batch.get("patch_embeds")
    h, aux = forward_train(model, batch["tokens"], impl, remat, patches,
                           rules)
    if patches is not None:
        h = h[:, patches.shape[1]:]
    ce = chunked_ce_loss(model, h, batch["labels"], ce_chunk, rules=rules)
    return ce + aux, {"ce": ce, "aux": aux}
