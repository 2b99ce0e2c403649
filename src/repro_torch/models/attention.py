"""GQA attention (+qk-norm) and MLA: full-sequence and decode paths, impl
selection.

Ports ``repro/models/attention.py``.  Three interchangeable
implementations of full-sequence attention:

  * ``dense``   -- quadratic plain version (``kernels.attention_ref``);
  * ``chunked`` -- online softmax over key blocks in plain PyTorch,
                   O(S * block) memory, any device;
  * ``flash``   -- the flash-attention dispatcher: the CUDA kernel on the
                   card, its plain version on the CPU.

``auto`` keeps the reference's rule: ``dense`` up to 2048 keys, above
that ``flash`` on ``cuda`` (the reference's ``tpu``) and ``chunked``
elsewhere.  Decode (one query against the cache) is plain PyTorch, as in
the reference.

Under ``ShardingRules`` the tensors are DTensors and the constraints
are the reference's: queries sequence-sharded over ``model``, K and V
gathered over it.  ``dense`` and ``chunked`` then run on the DTensors:
their masks are built from global positions, so sharding propagation
computes them over the whole sequence as written.  ``flash`` runs the
kernel under ``local_map``: each rank's query slice, at global offset
``o``, gets the keys up to the end of its slice (``o + Sq_local``, end-
aligned as the kernel aligns its queries), so the kernel's causal mask
is exact for every rank without a change to the kernel.  GQA decode
with a sequence-sharded cache (serving rules) scores each model rank's
positions under ``local_map`` and combines the softmax across the model
group (the global max, then the sums), where the reference leaves that
combine to GSPMD.

MLA (DeepSeek-V2) caches one compressed latent a token, ``c_kv`` (the
kv_lora_rank values, RMS-normed) and the rotated ``k_rope``.  Its value
head dim differs from its qk head dim, so, as in the reference, it never
reaches the flash kernel: ``auto`` and ``flash`` both take ``dense`` up to
2048 keys and ``chunked`` above.  Its decode is the absorbed form,
scored in the latent space.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.flash_attention import attention_ref, flash_attention
from .config import ModelConfig
from .layers import (NO_SHARDING, P, Params, ShardingRules, apply_rope,
                     assign, constrain, dense, dense_init, is_dtensor,
                     local_map_on, rmsnorm)

#: ``auto`` takes ``dense`` up to this many keys
DENSE_MAX_KEYS = 2048


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, scale: Optional[float] = None,
                      block_k: int = 512,
                      rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k: (B, Hkv, Sk, D); v: (B, Hkv, Sk, Dv).

    As the reference: queries at positions 0..Sq-1 against keys 0..Sk-1
    (no end alignment), masked with -1e30."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    dv = v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    group = hq // hkv
    bk = min(block_k, sk)
    sk_p = -(-sk // bk) * bk
    if sk_p != sk:
        k = F.pad(k, (0, 0, 0, sk_p - sk))
        v = F.pad(v, (0, 0, 0, sk_p - sk))

    # grouped-query layout (B, Hkv, G, Sq, D): K/V are never head-repeated
    qf = q.reshape(b, hkv, group, sq, d).float()
    qpos = torch.arange(sq, device=q.device)
    # the running state starts sequence-sharded, as the reference's carry
    def _c(x):
        return constrain(x, rules, "batch", None, None, "model", None)
    m = _c(qf.new_full((b, hkv, group, sq, 1), -1e30))
    l = _c(qf.new_zeros((b, hkv, group, sq, 1)))
    acc = _c(qf.new_zeros((b, hkv, group, sq, dv)))
    for k0 in range(0, sk_p, bk):
        kc = k[:, :, k0:k0 + bk].float()
        vc = v[:, :, k0:k0 + bk].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc) * scale
        kpos = k0 + torch.arange(bk, device=q.device)
        mask = (kpos < sk)[None, :]
        if causal:
            mask = mask & (qpos[:, None] >= kpos[None, :])
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, hq, sq, dv).to(q.dtype)


def _flash_sharded(q, k, v, causal: bool, scale, rules: ShardingRules):
    """The flash kernel under ``local_map``: q (B, Hq, Sq, D) sequence-
    sharded over ``model``, K and V whole along the sequence.  A rank
    whose queries start at global offset ``o`` attends the key prefix
    ending at ``Sk - Sq + o + Sq_local``: the kernel aligns its queries to
    the end of the keys it is given, which is then each query's own
    causal horizon."""
    mesh = q.device_mesh
    sq, sk = q.shape[2], k.shape[2]
    qspec = rules.logical("batch", None, "model", None)
    kvspec = rules.logical("batch", None, None, None)

    def local(ql, kl, vl):
        end = sk
        if causal and rules.model is not None:
            r = mesh.get_local_rank(rules.model)
            end = sk - sq + r * -(-sq // rules.model_size) + ql.shape[2]
        return flash_attention(ql, kl[:, :, :end], vl[:, :, :end],
                               causal=causal, scale=scale)
    return local_map_on(local, mesh, qspec, (qspec, kvspec, kvspec))(q, k, v)


def attention_impl(q, k, v, causal: bool = True, scale=None,
                   impl: str = "auto",
                   rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
    if impl == "auto":
        if k.shape[2] <= DENSE_MAX_KEYS:
            impl = "dense"
        else:
            impl = "flash" if q.is_cuda else "chunked"
    if impl == "dense":
        return attention_ref(q, k, v, causal=causal, scale=scale)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, scale=scale,
                                 rules=rules)
    if impl == "flash":
        if is_dtensor(q):
            return _flash_sharded(q, k, v, causal, scale, rules)
        return flash_attention(q, k, v, causal=causal, scale=scale)
    raise ValueError(impl)


# ---------------------------------------------------------------------- #
# GQA block
# ---------------------------------------------------------------------- #
def gqa_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
             device=None) -> dict:
    d, hq, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, (d, hq * hd), 0, dtype, device),
        "wk": dense_init(gen, (d, hkv * hd), 0, dtype, device),
        "wv": dense_init(gen, (d, hkv * hd), 0, dtype, device),
        "wo": dense_init(gen, (hq * hd, d), 0, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def gqa_specs(cfg: ModelConfig, rules: ShardingRules) -> Dict[str, P]:
    s = {"wq": rules.logical("fsdp", "tp"),
         "wk": rules.logical("fsdp", "tp"),
         "wv": rules.logical("fsdp", "tp"),
         "wo": rules.logical("tp", "fsdp")}
    if cfg.qk_norm:
        s["q_norm"] = rules.logical(None)
        s["k_norm"] = rules.logical(None)
    return s


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd).transpose(1, 2)       # (B, H, S, hd)


def qkv(params: Params, x: torch.Tensor, cfg: ModelConfig,
        positions: torch.Tensor
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Projected, qk-normed, rotated (q, k, v), each (B, H, S, hd);
    ``positions`` broadcasts to (B, S)."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = _split_heads(dense(x, params["wq"]), hq, hd)
    k = _split_heads(dense(x, params["wk"]), hkv, hd)
    v = _split_heads(dense(x, params["wv"]), hkv, hd)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def gqa_attention(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, impl: str = "auto",
                  return_kv: bool = False,
                  rules: ShardingRules = NO_SHARDING):
    """Full-sequence causal attention. x: (B, S, D); positions: (B, S).
    With ``return_kv`` also returns the rotated K and the V it attended
    to, each (B, Hkv, S, hd)."""
    q, k, v = qkv(params, x, cfg, positions)
    # sequence-parallel attention, as the reference: q stays sequence-
    # sharded over 'model', K and V are gathered over it
    q = constrain(q, rules, "batch", None, "model", None)
    k = constrain(k, rules, "batch", None, None, None)
    v = constrain(v, rules, "batch", None, None, None)
    o = attention_impl(q, k, v, causal=True, impl=impl, rules=rules)
    o = o.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
    out = dense(o, params["wo"])
    return (out, k, v) if return_kv else out


def gqa_decode(params: Params, x: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, pos: torch.Tensor, cfg: ModelConfig,
               rules: ShardingRules = NO_SHARDING) -> torch.Tensor:
    """One-token decode. x: (B, 1, D); caches: (B, Hkv, S, hd), written
    in place at ``pos[0]`` (the same position for every row); pos: (B,).
    Returns the block output (B, 1, D)."""
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    b = x.shape[0]
    q, k_new, v_new = qkv(params, x, cfg, pos[:, None])  # (B, H, 1, hd)
    write_at(k_cache, 2, pos, k_new)
    write_at(v_cache, 2, pos, v_new)

    # grouped-query einsum: no materialised K/V head repeat
    qg = q.reshape(b, hkv, hq // hkv, hd)
    if is_dtensor(k_cache):
        o = _decode_sharded(qg, k_cache, v_cache, pos, rules)
    else:
        o = _decode_attend(qg, k_cache, v_cache, pos[0])
    return dense(o.to(x.dtype).reshape(b, 1, hq * hd), params["wo"])


def _decode_attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   pos0: torch.Tensor, offset: int = 0, group=None
                   ) -> torch.Tensor:
    """One query a row against cached keys at positions ``offset ...``:
    qg (B, Hkv, G, hd), k / v (B, Hkv, S, hd) -> (B, Hkv, G, hd) float32.
    With ``group`` (a process group over which the cache's positions are
    split, this rank holding ``offset ...``) the softmax is combined
    across it: the global max, then the sums of the exponentials and of
    their products with V."""
    hd = qg.shape[-1]
    scores = torch.einsum("bhgd,bhkd->bhgk", qg.float(),
                          k.float()) / math.sqrt(hd)
    mask = offset + torch.arange(k.shape[2], device=k.device) <= pos0
    scores = torch.where(mask, scores, -1e30)
    if group is None:
        p = torch.softmax(scores, dim=-1)
        return torch.einsum("bhgk,bhkd->bhgd", p, v.float())
    import torch.distributed as dist
    m = scores.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    e = torch.exp(scores - m)
    l = e.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgk,bhkd->bhgd", e, v.float())
    dist.all_reduce(l, group=group)
    dist.all_reduce(o, group=group)
    return o / l


def _decode_sharded(qg, k_cache, v_cache, pos, rules: ShardingRules):
    """``_decode_attend`` under ``local_map``: the queries' heads whole,
    the cache sequence-sharded over ``model`` as ``cache_specs`` places
    it; each model rank scores its positions, and the softmax combines
    across the model group (flash-decoding's combine, which the reference
    leaves to GSPMD).  A model axis of one rank takes the plain softmax."""
    mesh = k_cache.device_mesh
    split = rules.model is not None and mesh[rules.model].size() > 1
    qspec = rules.logical("batch", None, None, None)
    kv = rules.logical("batch", None, "model" if split else None, None)
    # ``Shard`` splits as ``torch.chunk`` does: every rank but the last
    # holds ceil(S / ms) positions, the last the rest
    chunk = -(-k_cache.shape[2] // mesh[rules.model].size()) if split else 0

    def local(ql, kl, vl):
        if not split:
            return _decode_attend(ql, kl, vl, pos[0])
        r = mesh.get_local_rank(rules.model)
        return _decode_attend(ql, kl, vl, pos[0], r * chunk,
                              mesh.get_group(rules.model))
    return local_map_on(local, mesh, qspec, (qspec, kv, kv))(
        qg, k_cache, v_cache)


def write_at(cache: torch.Tensor, dim: int, pos: torch.Tensor,
             new: torch.Tensor) -> None:
    """Write ``new`` (length 1 along ``dim``) into ``cache`` at position
    ``pos[0]`` along ``dim``, in place.  A DTensor cache keeps its
    placements (a select over positions, then a local copy)."""
    if not is_dtensor(cache):
        cache.index_copy_(dim, pos[:1].long(), new.to(cache.dtype))
        return
    shape = [1] * cache.dim()
    shape[dim] = cache.shape[dim]
    sel = (torch.arange(cache.shape[dim], device=cache.device)
           == pos[0]).reshape(shape)
    assign(cache, torch.where(sel, new.to(cache.dtype), cache))


# ---------------------------------------------------------------------- #
# MLA block (DeepSeek-V2): compressed-latent KV
# ---------------------------------------------------------------------- #
def mla_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.bfloat16,
             device=None) -> dict:
    m = cfg.mla
    d, hq = cfg.d_model, cfg.num_heads
    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "wq": dense_init(gen, (d, hq * qd), 0, dtype, device),
        "w_dkv": dense_init(gen, (d, m.kv_lora_rank + m.qk_rope_head_dim),
                            0, dtype, device),
        "w_uk": dense_init(gen, (m.kv_lora_rank, hq * m.qk_nope_head_dim),
                           0, dtype, device),
        "w_uv": dense_init(gen, (m.kv_lora_rank, hq * m.v_head_dim), 0,
                           dtype, device),
        "wo": dense_init(gen, (hq * m.v_head_dim, d), 0, dtype, device),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype, device=device),
    }


def mla_specs(cfg: ModelConfig, rules: ShardingRules) -> Dict[str, P]:
    return {"wq": rules.logical("fsdp", "tp"),
            "w_dkv": rules.logical("fsdp", None),
            "w_uk": rules.logical(None, "tp"),
            "w_uv": rules.logical(None, "tp"),
            "wo": rules.logical("tp", "fsdp"),
            "kv_norm": rules.logical(None)}


def mla_latent(params: Params, x: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor) -> torch.Tensor:
    """The cache entry of each position: ``[c_kv, k_rope]`` (B, S, lora +
    rope), c_kv RMS-normed and k_rope rotated.  x: (B, S, D); positions
    broadcast to (B, S)."""
    lora = cfg.mla.kv_lora_rank
    ckv = dense(x, params["w_dkv"])
    c_kv = rmsnorm(params["kv_norm"], ckv[..., :lora], cfg.norm_eps)
    k_rope = apply_rope(ckv[..., lora:], positions, cfg.rope_theta)
    return torch.cat([c_kv, k_rope], dim=-1)


def mla_attention(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, impl: str = "auto",
                  return_latent: bool = False,
                  rules: ShardingRules = NO_SHARDING):
    """Full-sequence MLA.  x: (B, S, D); positions: (B, S).  With
    ``return_latent`` also returns the latent it attended from, the
    (B, S, lora + rope) rows of the decode cache."""
    m = cfg.mla
    b, s, _ = x.shape
    hq = cfg.num_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    lora = m.kv_lora_rank

    q = dense(x, params["wq"]).reshape(b, s, hq, nope + rope_d).transpose(
        1, 2)
    q_rope = apply_rope(q[..., nope:], positions[:, None, :], cfg.rope_theta)
    latent = mla_latent(params, x, cfg, positions)
    c_kv, k_rope = latent[..., :lora], latent[..., lora:]
    k_nope = dense(c_kv, params["w_uk"]).reshape(b, s, hq, nope).transpose(
        1, 2)
    v = dense(c_kv, params["w_uv"]).reshape(b, s, hq, vd).transpose(1, 2)

    qq = torch.cat([q[..., :nope], q_rope], dim=-1)
    kk = torch.cat([k_nope, k_rope[:, None].expand(b, hq, s, rope_d)],
                   dim=-1)
    qq = constrain(qq, rules, "batch", None, "model", None)   # SP queries
    kk = constrain(kk, rules, "batch", None, None, None)      # gathered K/V
    v = constrain(v, rules, "batch", None, None, None)
    # the value head dim differs from the qk one: never the flash kernel
    if impl in ("auto", "flash"):
        impl = "chunked" if s > DENSE_MAX_KEYS else "dense"
    o = attention_impl(qq, kk, v, causal=True,
                       scale=1.0 / math.sqrt(nope + rope_d), impl=impl,
                       rules=rules)
    out = dense(o.transpose(1, 2).reshape(b, s, hq * vd), params["wo"])
    return (out, latent) if return_latent else out


def mla_decode(params: Params, x: torch.Tensor, ckv_cache: torch.Tensor,
               pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Absorbed-MLA decode: W_uk is folded into the query and W_uv applied
    after the softmax, so scores and context stay in the latent space (in
    float32).  x: (B, 1, D); ckv_cache: (B, S, lora + rope), written in
    place at ``pos[0]``; pos: (B,).  Returns the block output (B, 1, D)."""
    m = cfg.mla
    b = x.shape[0]
    hq = cfg.num_heads
    nope, rope_d, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    lora = m.kv_lora_rank

    q = dense(x, params["wq"]).reshape(b, hq, nope + rope_d)
    q_rope = apply_rope(q[..., nope:], pos[:, None], cfg.rope_theta)
    new = mla_latent(params, x, cfg, pos[:, None])          # (B, 1, .)
    write_at(ckv_cache, 1, pos, new)

    c_all = ckv_cache[..., :lora].float()                   # (B, S, lora)
    r_all = ckv_cache[..., lora:].float()                   # (B, S, rope)
    w_uk = params["w_uk"].reshape(lora, hq, nope).float()
    q_lat = torch.einsum("bhn,lhn->bhl", q[..., :nope].float(), w_uk)
    scores = torch.einsum("bhl,bsl->bhs", q_lat, c_all)
    scores = scores + torch.einsum("bhr,bsr->bhs", q_rope.float(), r_all)
    scores = scores / math.sqrt(nope + rope_d)
    mask = torch.arange(ckv_cache.shape[1], device=x.device) <= pos[0]
    p = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
    ctx = torch.einsum("bhs,bsl->bhl", p, c_all)            # (B, Hq, lora)
    w_uv = params["w_uv"].reshape(lora, hq, vd).float()
    o = torch.einsum("bhl,lhv->bhv", ctx, w_uv).to(x.dtype)
    return dense(o.reshape(b, 1, hq * vd), params["wo"])
