"""The port's MLA (DeepSeek-V2 multi-head latent attention) against the
JAX package's, and deepseek-v2-lite-16b's layer layout.

Weights come from the JAX ``mla_init`` / ``init_params`` and go to the
port as numpy (``transformer.tree_from_numpy`` / ``params_from_numpy``);
inputs are made with numpy from a seed; everything runs on the CPU in
float32 at deepseek-v2-lite-16b's SMOKE widths (16 heads of 16 + 8 rope
dims, latent rank 32).  Tolerances, float32 rounding in another
summation order: attention outputs and decode outputs 1e-4; the latent
cache 1e-5 (two matmuls, a norm and a rotation from the same input);
rotations 1e-5; the value-dim check of the chunked path 2e-3 against the
dense plain version, as the reference's own
``tests/test_models.py::test_chunked_attention_mla_value_dim``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import transformer as jt
from repro.models.layers import NO_SHARDING
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import transformer as tt

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _cfgs(heads=None):
    cj, ct = jax_smoke(ARCH), get_smoke_config(ARCH)
    if heads:
        cj = dataclasses.replace(cj, num_heads=heads, num_kv_heads=heads)
        ct = dataclasses.replace(ct, num_heads=heads, num_kv_heads=heads)
    return cj, ct


def _params(cj, seed=0):
    p = _np(ja.mla_init(jax.random.PRNGKey(seed), cj, jnp.float32))
    return p, tt.tree_from_numpy(p, "cpu")


def _positions(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()


@pytest.mark.parametrize("b,s", [(2, 40), (1, 2048), (1, 2100)])
@pytest.mark.parametrize("impl", ["auto", "flash"])
def test_mla_attention_matches_reference(b, s, impl):
    # dense up to 2048 keys, chunked above, under auto and flash alike
    cj, ct = _cfgs(heads=2 if s > 2048 else None)
    p_np, p_t = _params(cj)
    x = _rand((b, s, ct.d_model), seed=s)
    pos = _positions(b, s)
    want = ja.mla_attention(p_np, jnp.asarray(x), cj, jnp.asarray(pos),
                            NO_SHARDING, impl)
    got = ta.mla_attention(p_t, torch.from_numpy(x), ct,
                           torch.from_numpy(pos), impl)
    assert got.shape == (b, s, ct.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("impl,s,want", [
    ("auto", 2048, "dense"), ("auto", 2049, "chunked"),
    ("flash", 64, "dense"), ("flash", 2049, "chunked"),
    ("dense", 2049, "dense"), ("chunked", 64, "chunked")])
def test_mla_never_reaches_the_flash_kernel(monkeypatch, impl, s, want):
    cfg = dataclasses.replace(_cfgs()[1], num_heads=1, num_kv_heads=1)
    p_t = ta.mla_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                      "cpu")
    seen = []
    real = ta.attention_impl

    def spy(q, k, v, causal=True, scale=None, impl="auto", **kw):
        seen.append(impl)
        return real(q, k, v, causal, scale, impl, **kw)
    monkeypatch.setattr(ta, "attention_impl", spy)
    ta.mla_attention(p_t, torch.zeros((1, s, cfg.d_model)), cfg,
                     torch.from_numpy(_positions(1, s)), impl)
    assert seen == [want]


def test_mla_init_tree_matches_reference():
    cj, ct = _cfgs()
    want = _np(ja.mla_init(jax.random.PRNGKey(0), cj, jnp.bfloat16))
    got = ta.mla_init(torch.Generator().manual_seed(0), ct, torch.bfloat16,
                      "cpu")
    # the reference's norm {"scale": w} is the port's tensor w
    assert sorted(got) == sorted(want) == ["kv_norm", "w_dkv", "w_uk",
                                           "w_uv", "wo", "wq"]
    for name, w in want.items():
        w = w["scale"] if name == "kv_norm" else w
        assert tuple(got[name].shape) == w.shape, name
        assert got[name].dtype == torch.bfloat16, name


@pytest.mark.parametrize("s", [40, 2100])
def test_mla_block_cache_matches_reference_recompute(s):
    # the block hands over the latent its attention used; the reference
    # recomputes it from the block input (_attn_cache_from_seq)
    cj, ct = _cfgs(heads=2 if s > 2048 else None)
    b, cache_len = (2, s + 6) if s <= 2048 else (1, s + 3)
    params = _np(jt.init_params(jax.random.PRNGKey(1), cj, jnp.float32))
    model = tt.params_from_numpy(params, ct, "cpu")
    layer = tt.unstack_layers(params, ct)[1]           # a MoE layer
    x = _rand((b, s, ct.d_model), seed=3)
    pos = _positions(b, s)
    h = jl.rmsnorm(layer["norm1"], jnp.asarray(x), cj.norm_eps)
    want = jt._attn_cache_from_seq(layer["attn"], h, cj, jnp.asarray(pos),
                                   cache_len, NO_SHARDING)
    blk = model.blocks[1]
    with torch.no_grad():
        out, aux, cache = blk(torch.from_numpy(x), torch.from_numpy(pos),
                              "auto", collect_cache=True,
                              cache_len=cache_len)
    assert sorted(cache) == ["ckv"]
    lora_rope = ct.mla.kv_lora_rank + ct.mla.qk_rope_head_dim
    assert tuple(cache["ckv"].shape) == (b, cache_len, lora_rope)
    np.testing.assert_allclose(cache["ckv"].numpy(),
                               np.asarray(want["ckv"]), rtol=1e-5,
                               atol=1e-5)
    assert not cache["ckv"][:, s:].any()
    zero = tt.block_cache_init(ct, 1, b, cache_len, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in zero.items()} == {
        "ckv": (b, cache_len, lora_rope)}


def test_mla_decode_matches_reference_over_steps():
    # absorbed decode from a prefilled latent cache: outputs and the cache
    # after every step, the new row written at pos[0]
    cj, ct = _cfgs()
    p_np, p_t = _params(cj, seed=2)
    b, s0, steps, cache_len = 3, 20, 5, 28
    x = _rand((b, s0, ct.d_model), seed=4)
    pos = _positions(b, s0)
    cache_j = jt._attn_cache_from_seq(p_np, jnp.asarray(x), cj,
                                      jnp.asarray(pos), cache_len,
                                      NO_SHARDING)["ckv"]
    cache_t = torch.from_numpy(np.array(cache_j))
    dec_j = jax.jit(lambda xt, c, p: ja.mla_decode(p_np, xt, c, p, cj))
    for step in range(steps):
        xt = _rand((b, 1, ct.d_model), seed=10 + step)
        p = np.full((b,), s0 + step, np.int32)
        out_j, cache_j = dec_j(jnp.asarray(xt), cache_j, jnp.asarray(p))
        out_t = ta.mla_decode(p_t, torch.from_numpy(xt), cache_t,
                              torch.from_numpy(p), ct)
        assert out_t.shape == (b, 1, ct.d_model)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **TOL,
                                   err_msg=f"step {step}")
        np.testing.assert_allclose(cache_t.numpy(), np.asarray(cache_j),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"cache after step {step}")
    assert not cache_t[:, s0 + steps:].any()


def test_mla_decode_equals_full_sequence_attention():
    # the absorbed form is MLA itself: decoding token s against the cache
    # of 0..s-1 gives the last row of mla_attention over 0..s
    _, ct = _cfgs()
    _, p_t = _params(_cfgs()[0], seed=5)
    b, s = 2, 17
    x = torch.from_numpy(_rand((b, s, ct.d_model), seed=6))
    pos = torch.from_numpy(_positions(b, s))
    full = ta.mla_attention(p_t, x, ct, pos, "dense")
    cache = torch.nn.functional.pad(
        ta.mla_latent(p_t, x[:, :-1], ct, pos[:, :-1]), (0, 0, 0, 3))
    last = ta.mla_decode(p_t, x[:, -1:], cache, torch.full((b,), s - 1),
                         ct)
    torch.testing.assert_close(last, full[:, -1:], rtol=1e-4, atol=1e-4)


def test_chunked_attention_mla_value_dim():
    # Dv != D: the chunked path against the port's dense plain version and
    # against the reference's chunked path
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 4, 300, 24)).astype(np.float32)
    k = rng.standard_normal((2, 2, 300, 24)).astype(np.float32)
    v = rng.standard_normal((2, 2, 300, 16)).astype(np.float32)
    got = ta.chunked_attention(*map(torch.from_numpy, (q, k, v)),
                               causal=True, block_k=64)
    assert got.shape == (2, 4, 300, 16)
    dense = ta.attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-3)
    want = ja.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_rope_same_rotation_in_both_layouts():
    # mla_attention ropes k_rope as (B, 1, S, r), the cache as (B, S, r)
    # and decode as (B, H, r) under (B, 1) positions: one rotation
    theta = get_smoke_config(ARCH).rope_theta
    x = _rand((2, 30, 8), seed=7)
    pos = _positions(2, 30) + 5
    flat = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    head = tl.apply_rope(torch.from_numpy(x)[:, None],
                         torch.from_numpy(pos)[:, None, :], theta)
    assert torch.equal(head[:, 0], flat)
    for got, xs, ps in ((flat, x, pos), (head, x[:, None], pos[:, None])):
        want = jl.apply_rope(jnp.asarray(xs), jnp.asarray(ps), theta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    # one position a row broadcast over the heads
    q = _rand((2, 4, 8), seed=8)
    p1 = np.array([[9], [33]], np.int32)
    got = tl.apply_rope(torch.from_numpy(q), torch.from_numpy(p1), theta)
    want = jl.apply_rope(jnp.asarray(q), jnp.asarray(p1), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_deepseek_prefix_layer_unstacks_in_order():
    # layer 0 is the dense prefix (first_dense_d_ff), the body follows
    # from the stacked (n_periods,) leaves, each layer its own tensors
    cj, ct = _cfgs()
    assert tt.layer_layout(ct) == (1, 1, 2)
    tree = _np(jt.init_params(jax.random.PRNGKey(4), cj, jnp.float32))
    model = tt.params_from_numpy(tree, ct, "cpu")
    blk0 = model.blocks[0]
    assert blk0.ff == "mlp"
    assert tuple(blk0.mlp["w_up"].shape) == (ct.d_model,
                                             ct.moe.first_dense_d_ff)
    np.testing.assert_array_equal(blk0.attn["wq"].detach().numpy(),
                                  tree["prefix"][0]["attn"]["wq"])
    np.testing.assert_array_equal(blk0.attn["kv_norm"].detach().numpy(),
                                  tree["prefix"][0]["attn"]["kv_norm"][
                                      "scale"])
    body = tree["body"]["layers"][0]
    for i in (1, 2):
        blk = model.blocks[i]
        assert blk.ff == "moe" and "shared" in blk.moe
        np.testing.assert_array_equal(blk.attn["w_uk"].detach().numpy(),
                                      body["attn"]["w_uk"][i - 1])
        np.testing.assert_array_equal(
            blk.moe["shared"]["w_down"].detach().numpy(),
            body["moe"]["shared"]["w_down"][i - 1])
