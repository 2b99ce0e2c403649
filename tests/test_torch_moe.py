"""The port's Mixture-of-Experts layer (``repro_torch.models.moe``) against
the JAX package's (``repro.models.moe``).

Weights come from the JAX ``moe_init`` and go to the port as numpy;
inputs are made with numpy from a seed; everything runs on the CPU in
float32, where ``radix_partition`` is its plain version.  The grouped
dispatch is held to the reference's at the SMOKE configs of olmoe-1b-7b,
jamba-v0.1-52b and deepseek-v2-lite-16b (two shared experts beside the
routed ones), at their capacity factor and at 1.0 (tokens drop):
the dispatch slots exactly (the reference's ``argsort`` / ``searchsorted``
formula on its own top-k ids), y within 1e-4, aux within 1e-5.  The
shuffle dispatch fails in the reference on this jax (``ROADMAP.md`` §3),
so ``moe_apply_shuffle`` is held to ``moe_apply_grouped`` at ample
capacity, with ``tests/md_scripts/moe_shuffle_parity.py``'s config and
tolerances: forward atol 2e-4 / rtol 1e-3, aux rtol 1e-4, the gradients
of ``sum(y**2) + aux`` within 5e-3.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.transformer import tree_from_numpy

ARCHS = ["olmoe-1b-7b", "jamba-v0.1-52b", "deepseek-v2-lite-16b"]
B, S = 2, 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _with_cf(cfg, cf):
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _cfgs(arch, cf=None):
    cj, ct = jax_smoke(arch), get_smoke_config(arch)
    if cf is not None:
        cj, ct = _with_cf(cj, cf), _with_cf(ct, cf)
    return cj, ct


def _params(cj, seed=0):
    p = _np(jmoe.moe_init(jax.random.PRNGKey(seed), cj, jnp.float32))
    return p, tree_from_numpy(p, "cpu")


def reference_slots(topi, cap, e):
    """The reference's dispatch slot of each (token, choice), flat order:
    stable argsort, rank = position - searchsorted start, the trash slot
    ``e * cap`` past the capacity, taken back through the inverse order
    (``repro/models/moe.py:143-172``)."""
    b = topi.shape[0]
    flat_e = topi.reshape(b, -1)
    out = np.empty_like(flat_e, dtype=np.int64)
    for g in range(b):
        order = np.argsort(flat_e[g], kind="stable")
        srt = flat_e[g][order]
        rank = np.arange(len(srt)) - np.searchsorted(srt, srt, side="left")
        slot = np.where(rank < cap, srt * cap + rank, e * cap)
        out[g, order] = slot
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cf", [None, 1.0])
def test_grouped_matches_reference(arch, cf):
    cj, ct = _cfgs(arch, cf)
    p_np, p_t = _params(cj)
    x = _x((B, S, ct.d_model))
    e, k = ct.moe.num_experts, ct.moe.top_k
    cap = tmoe.expert_capacity(ct, S)

    _, topi_j, _ = jmoe._route(p_np, jnp.asarray(x), cj)
    _, topi_t, _ = tmoe._route(p_t, torch.from_numpy(x), ct)
    np.testing.assert_array_equal(topi_t.numpy(), np.asarray(topi_j))
    want_slots = reference_slots(np.asarray(topi_j), cap, e)
    got_slots = tmoe.dispatch_slots(
        topi_t.reshape(B, S * k).to(torch.int32), e, cap)
    np.testing.assert_array_equal(got_slots.numpy(), want_slots)
    dropped = int((want_slots == e * cap).sum())
    if cf == 1.0:
        assert dropped > 0          # the capacity drops tokens here
    else:
        assert dropped == 0

    y_j, aux_j = jmoe.moe_apply_grouped(p_np, jnp.asarray(x), cj)
    y_t, aux_t = tmoe.moe_apply_grouped(p_t, torch.from_numpy(x), ct)
    assert y_t.shape == (B, S, ct.d_model) and y_t.dtype == torch.float32
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               atol=1e-4, rtol=1e-4)
    assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-5, abs=1e-5)
    # moe_apply takes the grouped dispatch (no sharding rules in the port)
    y_a, aux_a = tmoe.moe_apply(p_t, torch.from_numpy(x), ct)
    assert torch.equal(y_a, y_t) and torch.equal(aux_a, aux_t)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_token_dispatch_matches_reference(arch):
    # decode: one token per row, capacity expert_capacity(cfg, 1) = 8
    cj, ct = _cfgs(arch)
    p_np, p_t = _params(cj, seed=1)
    x = _x((4, 1, ct.d_model), seed=1)
    assert tmoe.expert_capacity(ct, 1) == 8
    y_j, aux_j = jmoe.moe_apply(p_np, jnp.asarray(x), cj)
    y_t, aux_t = tmoe.moe_apply(p_t, torch.from_numpy(x), ct)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               atol=1e-4, rtol=1e-4)
    assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-5, abs=1e-5)


@pytest.mark.parametrize("arch,cf", [("olmoe-1b-7b", None),
                                     ("olmoe-1b-7b", 1.0),
                                     ("jamba-v0.1-52b", 1.0)])
def test_einsum_oracle_matches_reference(arch, cf):
    cj, ct = _cfgs(arch, cf)
    p_np, p_t = _params(cj, seed=2)
    x = _x((B, S, ct.d_model), seed=2)
    y_j, aux_j = jmoe.moe_apply_einsum(p_np, jnp.asarray(x), cj)
    y_t, aux_t = tmoe.moe_apply_einsum(p_t, torch.from_numpy(x), ct)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               atol=1e-4, rtol=1e-4)
    assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-5, abs=1e-5)
    # and the one-hot oracle equals the grouped dispatch, drops included
    y_g, _ = tmoe.moe_apply_grouped(p_t, torch.from_numpy(x), ct)
    np.testing.assert_allclose(y_t.detach().numpy(), y_g.detach().numpy(),
                               atol=1e-5, rtol=1e-5)


def test_expert_capacity_matches_reference():
    for e, k in ((64, 8), (16, 2), (8, 2), (4, 1)):
        for cf in (0.5, 1.0, 1.25, 2.0, 8.0):
            mj = JMoEConfig(num_experts=e, top_k=k, d_ff_expert=8,
                            capacity_factor=cf)
            mt = MoEConfig(num_experts=e, top_k=k, d_ff_expert=8,
                           capacity_factor=cf)
            cj = JModelConfig(name="c", family="moe", num_layers=1,
                              d_model=8, num_heads=1, num_kv_heads=1,
                              d_ff=8, vocab_size=16, moe=mj)
            ct = ModelConfig(name="c", family="moe", num_layers=1,
                             d_model=8, num_heads=1, num_kv_heads=1,
                             d_ff=8, vocab_size=16, moe=mt)
            for t in (1, 2, 7, 8, 31, 100, 4096):
                got = tmoe.expert_capacity(ct, t)
                assert got == jmoe.expert_capacity(cj, t), (e, k, cf, t)
                assert got >= 8 and got % 8 == 0


def test_moe_init_tree_matches_reference():
    for arch in ARCHS:
        cj, ct = _cfgs(arch)
        want = _np(jmoe.moe_init(jax.random.PRNGKey(0), cj, jnp.bfloat16))
        got = tmoe.moe_init(torch.Generator().manual_seed(0), ct,
                            torch.bfloat16, "cpu")
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        # router and three expert stacks, and a shared expert's MLP
        assert len(flat_w) == 4 + 3 * bool(ct.moe.num_shared)
        for path, w in flat_w:
            g = got
            for key in path:
                g = g[key.key]
            assert tuple(g.shape) == w.shape, path
            assert str(g.dtype).split(".")[-1] == str(w.dtype), path


# ---------------------------------------------------------------------- #
# The dispatch through the dataframe shuffle, over stacked ranks
# ---------------------------------------------------------------------- #
#: tests/md_scripts/moe_shuffle_parity.py's config: ample capacity, a
#: shared expert
PARITY = dict(name="parity-moe", family="moe", num_layers=1, d_model=64,
              num_heads=4, num_kv_heads=4, d_ff=96, vocab_size=256)
PARITY_MOE = dict(num_experts=8, top_k=2, d_ff_expert=96, num_shared=1,
                  capacity_factor=8.0)


def _parity_cfgs(comm="xla"):
    return (JModelConfig(**PARITY, moe=JMoEConfig(**PARITY_MOE,
                                                  communicator=comm)),
            ModelConfig(**PARITY, moe=MoEConfig(**PARITY_MOE,
                                                communicator=comm)))


@pytest.fixture(scope="module")
def parity_grouped():
    cj, ct = _parity_cfgs()
    p_np = _np(jmoe.moe_init(jax.random.PRNGKey(0), cj, jnp.float32))
    x = _x((8, 32, 64))
    # the port's grouped path is the one held to the reference
    y_j, aux_j = jmoe.moe_apply_grouped(p_np, jnp.asarray(x), cj)
    grads = _grads(tmoe.moe_apply_grouped, p_np, x, ct)
    np.testing.assert_allclose(grads[0].detach().numpy(), np.asarray(y_j),
                               atol=1e-4, rtol=1e-4)
    assert float(grads[1].detach()) == pytest.approx(float(aux_j), rel=1e-5)
    return p_np, x, grads


def _grads(fn, p_np, x, cfg, *args):
    """(y, aux, {leaf: grad of sum(y**2) + aux}) of ``fn``."""
    p_t = tree_from_numpy(p_np, "cpu")
    leaves = {"x": torch.from_numpy(x).requires_grad_(True),
              "router": p_t["router"].requires_grad_(True)}
    for k, v in p_t["experts"].items():
        leaves[k] = v.requires_grad_(True)
    for k, v in p_t["shared"].items():
        leaves["shared." + k] = v.requires_grad_(True)
    y, aux = fn(p_t, leaves["x"], cfg, *args)
    g = torch.autograd.grad((y ** 2).sum() + aux, list(leaves.values()))
    return y, aux, dict(zip(leaves, g))


@pytest.mark.parametrize("model_size", [2, 4])
@pytest.mark.parametrize("comm", ["xla", "ring", "bruck"])
def test_shuffle_dispatch_matches_grouped(parity_grouped, model_size, comm):
    p_np, x, (y_g, aux_g, g_g) = parity_grouped
    _, ct = _parity_cfgs(comm)
    y, aux, g = _grads(tmoe.moe_apply_shuffle, p_np, x, ct, model_size)
    np.testing.assert_allclose(y.detach().numpy(), y_g.detach().numpy(),
                               atol=2e-4, rtol=1e-3)
    assert float(aux.detach()) == pytest.approx(float(aux_g.detach()),
                                         rel=1e-4)
    assert sorted(g) == sorted(g_g)
    for name, want in g_g.items():
        np.testing.assert_allclose(g[name].numpy(), want.numpy(),
                                   atol=5e-3, rtol=5e-3, err_msg=name)


def test_dispatchers_take_their_ranks_from_radix_partition(monkeypatch):
    # one radix_partition call per grouped dispatch; two shuffles and the
    # local group-by-expert per shuffle dispatch
    calls = []
    real = tmoe.radix_partition

    def counted(dest, nb):
        calls.append((tuple(dest.shape), nb))
        return real(dest, nb)
    tshuffle = importlib.import_module("repro_torch.dataframe.shuffle")
    monkeypatch.setattr(tmoe, "radix_partition", counted)
    monkeypatch.setattr(tshuffle, "radix_partition", counted)
    cj, ct = _parity_cfgs()
    p_t = tree_from_numpy(
        _np(jmoe.moe_init(jax.random.PRNGKey(0), cj, jnp.float32)), "cpu")
    x = torch.from_numpy(_x((8, 32, 64)))
    tmoe.moe_apply_grouped(p_t, x, ct)
    assert calls == [((8, 32 * 2), 8)]
    calls.clear()
    tmoe.moe_apply_shuffle(p_t, x, ct, 4)
    tk = 8 * (32 // 4) * 2                         # rows a rank sends
    cap_send = max(8, -(-int(8.0 * tk) // (8 * 4)) * 8)
    assert calls == [((4, tk), 5), ((4, 4 * cap_send), 3),
                     ((4, 4 * cap_send), 5)]


def test_shuffle_dispatch_refuses_uneven_split():
    _, ct = _parity_cfgs()
    p_t = tree_from_numpy(
        _np(jmoe.moe_init(jax.random.PRNGKey(0), _parity_cfgs()[0],
                          jnp.float32)), "cpu")
    with pytest.raises(ValueError, match="divide"):
        tmoe.moe_apply_shuffle(p_t, torch.zeros((2, 30, 64)), ct, 4)
