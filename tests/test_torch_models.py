"""The port's model layers against the JAX package's, layer by layer.

Weights come from the JAX initializers and go to the port as numpy
(``transformer.tree_from_numpy``); inputs are made with numpy from a
seed.  Everything runs on the CPU in float32 (the ``flash`` and
``kernel`` paths through the port's plain versions, and through the JAX
Pallas kernels in interpret mode), so the tolerance is float32 rounding
in another summation order: 1e-5 for elementwise layers, 1e-4 for
attention and the SSD mixer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import attention as ja
from repro.models import layers as jl
from repro.models import mamba2 as jm
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as ta
from repro_torch.models import layers as tl
from repro_torch.models import mamba2 as tm
from repro_torch.models.transformer import tree_from_numpy

QWEN = get_smoke_config("qwen3-8b")
MAMBA = get_smoke_config("mamba2-780m")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    x = _rand((2, 5, 64))
    scale = _rand((64,), seed=1)
    got = tl.rmsnorm(torch.from_numpy(scale).to(getattr(torch, dtype)),
                     torch.from_numpy(x).to(getattr(torch, dtype)), 1e-6)
    want = jl.rmsnorm({"scale": jnp.asarray(scale, dtype)},
                      jnp.asarray(x, dtype), 1e-6)
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-5 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope(theta):
    x = _rand((2, 3, 10, 16))
    pos = np.arange(10, dtype=np.int32)[None, None].repeat(2, 0) + 7
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp(act):
    p = _np(jl.mlp_init(jax.random.PRNGKey(0), 64, 128, jnp.float32))
    x = _rand((2, 5, 64))
    got = tl.mlp(tree_from_numpy(p, "cpu"), torch.from_numpy(x), act)
    want = jl.mlp(p, jnp.asarray(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("impl,s", [("dense", 40), ("flash", 40),
                                    ("chunked", 40), ("chunked", 600)])
def test_gqa_attention(impl, s):
    cfg_j = jax_smoke("qwen3-8b")
    p = _np(ja.gqa_init(jax.random.PRNGKey(1), cfg_j, jnp.float32))
    x = _rand((2, s, QWEN.d_model), seed=2)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    got = ta.gqa_attention(tree_from_numpy(p, "cpu"), torch.from_numpy(x),
                           QWEN, torch.from_numpy(pos.copy()), impl)
    want = ja.gqa_attention(p, jnp.asarray(x), cfg_j, jnp.asarray(pos),
                            impl=impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_attention_auto_rule(monkeypatch):
    q, k = torch.zeros((1, 2, 4, 16)), torch.zeros((1, 2, 2049, 16))
    calls = []
    monkeypatch.setattr(ta, "chunked_attention",
                        lambda *a, **kw: calls.append("chunked"))
    monkeypatch.setattr(ta, "attention_ref",
                        lambda *a, **kw: calls.append("dense"))
    ta.attention_impl(q, k, k, impl="auto")
    ta.attention_impl(q, k[:, :, :2048], k[:, :, :2048], impl="auto")
    # more than 2048 keys on the CPU: chunked (on a card: flash)
    assert calls == ["chunked", "dense"]


def test_gqa_decode():
    cfg_j = jax_smoke("qwen3-8b")
    p = _np(ja.gqa_init(jax.random.PRNGKey(3), cfg_j, jnp.float32))
    b, s_max, pos = 2, 24, 11
    shape = (b, QWEN.num_kv_heads, s_max, QWEN.resolved_head_dim)
    kc, vc = _rand(shape, seed=4), _rand(shape, seed=5)
    x = _rand((b, 1, QWEN.d_model), seed=6)
    pos_np = np.full((b,), pos, np.int32)
    k_t, v_t = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = ta.gqa_decode(tree_from_numpy(p, "cpu"), torch.from_numpy(x), k_t,
                        v_t, torch.from_numpy(pos_np), QWEN)
    want, k_j, v_j = ja.gqa_decode(p, jnp.asarray(x), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(pos_np),
                                   cfg_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(k_t.numpy(), np.asarray(k_j), atol=1e-5)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)


@pytest.mark.parametrize("impl,t", [("chunked", 40), ("kernel", 40),
                                    ("kernel", 70)])
def test_mamba_forward_with_state(impl, t):
    cfg_j = jax_smoke("mamba2-780m")
    p = _np(jm.mamba_init(jax.random.PRNGKey(7), cfg_j, jnp.float32))
    u = _rand((2, t, MAMBA.d_model), seed=8)
    got = tm.mamba_forward(tree_from_numpy(p, "cpu"), torch.from_numpy(u),
                           MAMBA, impl, return_state=True)
    want = jm.mamba_forward(p, jnp.asarray(u), cfg_j, impl=impl,
                            return_state=True)
    for g, w, name in zip(got, want, ("out", "ssm_state", "conv_state")):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   err_msg=name)


def test_mamba_decode():
    cfg_j = jax_smoke("mamba2-780m")
    p = _np(jm.mamba_init(jax.random.PRNGKey(9), cfg_j, jnp.float32))
    s, d_in, nh = tm.dims(MAMBA)
    b = 2
    ssm = _rand((b, nh, s.d_state, s.head_dim), seed=10, scale=0.5)
    conv = _rand((b, s.d_conv - 1, d_in), seed=11)
    u = _rand((b, 1, MAMBA.d_model), seed=12)
    ssm_t, conv_t = torch.from_numpy(ssm.copy()), torch.from_numpy(conv.copy())
    got = tm.mamba_decode(tree_from_numpy(p, "cpu"), torch.from_numpy(u),
                          ssm_t, conv_t, MAMBA)
    want, ssm_j, conv_j = jm.mamba_decode(p, jnp.asarray(u), jnp.asarray(ssm),
                                          jnp.asarray(conv), cfg_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(ssm_t.numpy(), np.asarray(ssm_j), atol=1e-5)
    np.testing.assert_allclose(conv_t.numpy(), np.asarray(conv_j), atol=1e-6)


@pytest.mark.parametrize("arch,i", [("olmoe-1b-7b", 0),
                                    ("jamba-v0.1-52b", 1),
                                    ("jamba-v0.1-52b", 4),
                                    ("deepseek-v2-lite-16b", 0),
                                    ("deepseek-v2-lite-16b", 1)])
def test_block_with_moe(arch, i):
    # a full-sequence MoE block (attention or mamba mixer, then the MoE
    # feed-forward) and its one-token decode step against the reference's
    # block_apply / block_decode; jamba's layer 4 is its attention layer,
    # with a dense mlp; deepseek's are MLA, its layer 0 the dense prefix
    # (d_ff 96) and its layer 1 MoE with two shared experts
    from repro.models import transformer as jt
    from repro.models.layers import NO_SHARDING
    from repro_torch.models import transformer as tt
    cfg_j, cfg = jax_smoke(arch), get_smoke_config(arch)
    p = _np(jt.block_init(jax.random.PRNGKey(13), cfg_j, i, jnp.float32))
    assert ("moe" in p) == cfg.is_moe_layer(i) and ("mlp" in p) != ("moe" in p)
    blk = tt.Block(cfg, i, tree_from_numpy(p, "cpu"))
    assert blk.ff == ("moe" if cfg.is_moe_layer(i) else "mlp")
    b, s = 2, 40
    x = _rand((b, s, cfg.d_model), seed=14)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
    want, aux_j, cache_j = jt.block_apply(p, jnp.asarray(x), cfg_j, i,
                                          jnp.asarray(pos), NO_SHARDING,
                                          "chunked", collect_cache=True,
                                          cache_len=s + 1)
    with torch.no_grad():
        got, aux, cache = blk(torch.from_numpy(x),
                              torch.from_numpy(pos.copy()), "chunked",
                              collect_cache=True, cache_len=s + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    if cfg.is_moe_layer(i):
        assert float(aux) == pytest.approx(float(aux_j), rel=1e-5)
    else:
        assert aux is None and float(aux_j) == 0.0
    # decode the next token from the full-sequence cache on both sides
    x1 = _rand((b, 1, cfg.d_model), seed=15)
    pos1 = np.full((b,), s, np.int32)
    want1, _ = jt.block_decode(p, jnp.asarray(x1), cache_j, cfg_j, i,
                               jnp.asarray(pos1), NO_SHARDING)
    with torch.no_grad():
        got1 = blk.decode(torch.from_numpy(x1), cache,
                          torch.from_numpy(pos1))
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-4)
