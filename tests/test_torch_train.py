"""The port's training slice against the JAX package: the loss and its
gradients, AdamW steps, the schedule, checkpoints, int8 compression and
the SSD scan's autograd path.

Weights and train states come from the JAX initializers and go to the
port as numpy (``transformer.params_from_numpy`` /
``train_state_from_numpy``); batches are made with numpy from a seed.
Everything runs on the CPU in float32 with ``impl="chunked"`` and remat
on.  Tolerances, set from float32 rounding in another summation order:
the loss within 1e-5 relative; each gradient leaf within 1e-4 relative
L2 (the unembedding's gradient passes through bfloat16, as in the
reference, where a last-bit difference can flip one rounding); after
three AdamW steps each parameter within 1e-4 and each moment within 1e-3
relative L2, the per-step loss and gradient norm within 1e-5 relative;
the learning rate within 1e-6 relative (both packages compute it in
float32, where their cosines may differ in the last bit).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as jt
from repro.models.layers import NO_SHARDING
from repro_torch.models.layers import NO_SHARDING as T_NO_SHARDING
from repro.models.layers import softmax_cross_entropy as j_ce
from repro import train as jtrain
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer as tt
from repro_torch.models.layers import softmax_cross_entropy as t_ce
from repro_torch import train as ttrain

ARCHS = ["qwen3-8b", "mamba2-780m", "olmoe-1b-7b", "jamba-v0.1-52b",
         "llama3.2-3b", "qwen3-32b", "gemma-7b", "deepseek-v2-lite-16b"]
#: archs whose loss carries the MoE load-balancing term
MOE_ARCHS = ("olmoe-1b-7b", "jamba-v0.1-52b", "deepseek-v2-lite-16b")
#: a vocab that pads (to 256 rows): the padded logits must be masked
VOCAB = 250
CE_CHUNK = 16
B, S = 2, 40     # S not a multiple of CE_CHUNK: a ragged last chunk


def _cfgs(arch):
    return (dataclasses.replace(jax_smoke(arch), vocab_size=VOCAB),
            dataclasses.replace(get_smoke_config(arch), vocab_size=VOCAB))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(seed, b=B, s=S):
    toks = np.random.default_rng(seed).integers(0, VOCAB, (b, s + 1))
    toks = toks.astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :3] = -1           # ignored positions
    return batch


def _rel(got, want):
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _named(tree, cfg):
    return tt.named_params(tt.params_from_numpy(tree, cfg, "cpu"))


# ---------------------------------------------------------------------- #
# The loss and its gradients
# ---------------------------------------------------------------------- #
def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    for z in (0.0, 1e-4):
        want = float(j_ce(jnp.asarray(logits), jnp.asarray(labels), z))
        got = float(t_ce(torch.from_numpy(logits), torch.from_numpy(labels),
                         z))
        assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_grads_match_reference(arch):
    cj, ct = _cfgs(arch)
    assert ct.padded_vocab != ct.vocab_size
    params = jt.init_params(jax.random.PRNGKey(0), cj, jnp.float32)
    batch = _batch(1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (lj, pj), gj = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, cj, jb, NO_SHARDING, "chunked", True,
                             CE_CHUNK), has_aux=True))(params)
    model = tt.params_from_numpy(_np(params), ct, "cpu")
    lt, pt = tt.loss_fn(model, {k: torch.from_numpy(v)
                                for k, v in batch.items()},
                        "chunked", True, CE_CHUNK)
    lt.backward()
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5)
    assert float(pt["ce"].detach()) == pytest.approx(float(pj["ce"]),
                                                     rel=1e-5)
    # the MoE load-balancing term, on its own
    if arch in MOE_ARCHS:
        assert float(pj["aux"]) > 0.0
        assert float(pt["aux"].detach()) == pytest.approx(float(pj["aux"]),
                                                          rel=1e-5)
    else:
        assert float(pt["aux"]) == float(pj["aux"]) == 0.0
    want = _named(_np(gj), ct)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        if arch in MOE_ARCHS and n == "lm_head":
            continue                      # held below, from the same h
        assert _rel(got[n], w) <= 1e-4, n
    if arch in MOE_ARCHS:
        _unembedding_grad_from_reference_h(cj, ct, params, jb)


def _unembedding_grad_from_reference_h(cj, ct, params, jb):
    """The unembedding's gradient from the reference's own final h.

    Both packages round the unembedding's gradient to bfloat16 in every CE
    chunk.  Through a MoE stack the two h's differ at float32 rounding
    level on more elements that sit on a bfloat16 rounding boundary, and
    those one-ulp flips alone reach 1e-4 relative L2; from the same h the
    CE's arithmetic is held to 1e-4 as for the other archs."""
    h_j = jt.forward(params, cj, jb, NO_SHARDING, "chunked", True)[0]
    gj = jax.grad(lambda p: jt.chunked_ce_loss(
        p, cj, h_j, jb["labels"], NO_SHARDING, CE_CHUNK))(params)
    model = tt.params_from_numpy(_np(params), ct, "cpu")
    tt.chunked_ce_loss(model, torch.from_numpy(np.array(h_j)),
                       torch.from_numpy(np.array(jb["labels"])),
                       CE_CHUNK).backward()
    assert _rel(model.lm_head.grad,
                torch.from_numpy(np.array(gj["lm_head"]))) <= 1e-4


def test_loss_without_remat_equals_remat():
    _, ct = _cfgs("mamba2-780m")
    params = jt.init_params(jax.random.PRNGKey(3), _cfgs("mamba2-780m")[0],
                            jnp.float32)
    batch = {k: torch.from_numpy(v) for k, v in _batch(2).items()}
    grads = []
    for remat in (True, False):
        model = tt.params_from_numpy(_np(params), ct, "cpu")
        loss, _ = tt.loss_fn(model, batch, "chunked", remat, CE_CHUNK)
        loss.backward()
        grads.append((float(loss.detach()),
                      {n: p.grad for n, p in model.named_parameters()}))
    assert grads[0][0] == grads[1][0]
    for n, g in grads[0][1].items():
        assert torch.equal(g, grads[1][1][n]), n


def test_serving_entry_points_stay_without_autograd():
    _, ct = _cfgs("qwen3-8b")
    gen = torch.Generator().manual_seed(0)
    model = tt.init_params(ct, gen, torch.float32, "cpu")
    assert all(p.requires_grad for p in model.parameters())
    toks = torch.from_numpy(_batch(0)["tokens"])
    assert not tt.forward(model, toks).requires_grad
    logits, caches = tt.prefill(model, toks, cache_len=S + 2)
    assert not logits.requires_grad
    pos = torch.full((B,), S, dtype=torch.int32)
    assert not tt.decode_step(model, caches, toks[:, :1], pos).requires_grad


# ---------------------------------------------------------------------- #
# AdamW, the schedule, weight decay and the train step
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_follows_the_reference_stacked_tree(arch):
    # a leaf decays iff its reference leaf (body leaves stacked over
    # n_periods) has ndim >= 2: mark each reference leaf by that and
    # carry the marks across
    cj, ct = _cfgs(arch)
    tree = _np(jt.init_params(jax.random.PRNGKey(0), cj, jnp.float32))
    marks = jax.tree_util.tree_map(
        lambda a: np.full(a.shape, float(a.ndim >= 2), np.float32), tree)
    want = {n: bool(t.flatten()[0]) for n, t in _named(marks, ct).items()}
    params = _named(tree, ct)
    got = ttrain.weight_decay_mask(ct, params)
    assert got == want
    # a prefix layer's norms (deepseek's dense layer 0) are 1-D on the
    # stacked tree too and take no decay; body norms do
    n_prefix = tt.layer_layout(ct)[0]
    assert not got["final_norm"] and got[f"blocks.{n_prefix}.norm1"]
    if arch == "deepseek-v2-lite-16b":
        assert n_prefix == 1
        assert not got["blocks.0.norm1"] and not got["blocks.0.attn.kv_norm"]
        assert got["blocks.1.attn.kv_norm"] and got["blocks.0.mlp.w_up"]
    if arch == "mamba2-780m":
        assert got["blocks.1.mixer.a_log"] and params[
            "blocks.1.mixer.a_log"].dim() == 1


@pytest.mark.parametrize("arch", ["qwen3-8b", "mamba2-780m", "llama3.2-3b",
                                  "gemma-7b"])
def test_three_train_steps_match_reference(arch):
    cj, ct = _cfgs(arch)
    state_j = jtrain.init_train_state(jax.random.PRNGKey(0), cj, jnp.float32)
    state_t = tt.train_state_from_numpy(_np(state_j), ct, "cpu")
    # warmup 1 of 3 steps: every step sees another lr; weight decay 0.1
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=3)
    step_j = jax.jit(jtrain.make_train_step(cj, jtrain.AdamWConfig(**ocfg),
                                            NO_SHARDING, "chunked", True,
                                            CE_CHUNK))
    step_t = ttrain.make_train_step(ct, ttrain.AdamWConfig(**ocfg),
                                    T_NO_SHARDING, "chunked", True, CE_CHUNK)
    for i in range(3):
        batch = _batch(10 + i)
        state_j, mj = step_j(state_j, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        state_t, mt = step_t(state_t, batch)
        assert sorted(mt) == sorted(mj)
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert float(mt[k]) == pytest.approx(float(mj[k]), rel=1e-5), k
        assert float(mt["lr"]) == pytest.approx(float(mj["lr"]), rel=1e-6)
    want = tt.train_state_from_numpy(_np(state_j), ct, "cpu")
    assert int(state_t["opt"]["step"]) == int(want["opt"]["step"]) == 3
    for n, w in want["params"].items():
        assert _rel(state_t["params"][n], w) <= 1e-4, n
    for part in ("m", "v"):
        for n, w in want["opt"][part].items():
            assert _rel(state_t["opt"][part][n], w) <= 1e-3, (part, n)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_steps_match_reference(arch):
    """Three AdamW steps of the MoE archs, each from the reference's state.

    Carried across three steps, the MoE stacks' float32 differences grow
    past the tolerances: at the default eps 1e-8 a gradient element within
    float32 noise of 0 (olmoe: 1.4e-8 against a leaf's 0.27) flips its
    Adam update, and jamba's eight SMOKE layers (gradient norm ~150) carry
    a 3e-5 parameter difference to 3e-5 in the next step's gradient norm.
    So each step starts from the reference's state, with eps 1e-6 (the
    same code path), and every step is held to the tolerances above."""
    cj, ct = _cfgs(arch)
    state_j = jtrain.init_train_state(jax.random.PRNGKey(0), cj, jnp.float32)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=3, eps=1e-6)
    step_j = jax.jit(jtrain.make_train_step(cj, jtrain.AdamWConfig(**ocfg),
                                            NO_SHARDING, "chunked", True,
                                            CE_CHUNK))
    step_t = ttrain.make_train_step(ct, ttrain.AdamWConfig(**ocfg),
                                    T_NO_SHARDING, "chunked", True, CE_CHUNK)
    for i in range(3):
        batch = _batch(10 + i)
        state_t = tt.train_state_from_numpy(_np(state_j), ct, "cpu")
        state_j, mj = step_j(state_j, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        state_t, mt = step_t(state_t, batch)
        assert sorted(mt) == sorted(mj)
        assert float(mj["aux"]) > 0.0
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert float(mt[k]) == pytest.approx(float(mj[k]), rel=1e-5), k
        assert float(mt["lr"]) == pytest.approx(float(mj["lr"]), rel=1e-6)
        want = tt.train_state_from_numpy(_np(state_j), ct, "cpu")
        assert int(state_t["opt"]["step"]) == int(want["opt"]["step"]) == i + 1
        for n, w in want["params"].items():
            assert _rel(state_t["params"][n], w) <= 1e-4, (i, n)
        for part in ("m", "v"):
            for n, w in want["opt"][part].items():
                assert _rel(state_t["opt"][part][n], w) <= 1e-3, (i, part, n)


def test_lr_schedule_matches_reference():
    for kw in (dict(lr=1e-3, warmup_steps=10, total_steps=100,
                    min_lr_ratio=0.1),
               dict(lr=3e-4, warmup_steps=1, total_steps=7)):
        jc, tc = jtrain.AdamWConfig(**kw), ttrain.AdamWConfig(**kw)
        for s in range(0, kw["total_steps"] + 3):
            want = np.asarray(jtrain.lr_at(jc, jnp.asarray(s, jnp.int32)))
            got = ttrain.lr_at(tc, torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(float(want), rel=1e-6), \
                (kw, s)
    # the reference's test_lr_schedule_shape
    cfg = ttrain.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                             min_lr_ratio=0.1)
    lrs = [float(ttrain.lr_at(cfg, torch.tensor(s)))
           for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 1e-3) < 1e-9
    assert lrs[-1] == pytest.approx(1e-4, rel=1e-3)
    assert all(a >= b - 1e-12 for a, b in zip(lrs[1:], lrs[2:]))


def test_clip_by_global_norm_matches_reference():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}
    clipped, norm = ttrain.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(10.0)
    assert float(ttrain.global_norm(clipped)) == pytest.approx(1.0,
                                                               rel=1e-5)
    rng = np.random.default_rng(4)
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (("a", (3, 5)), ("b", (7,)), ("c", (2, 2, 2)))}
    for max_norm in (0.5, 100.0):
        jc, jn = jtrain.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in tree.items()}, max_norm)
        tc, tn = ttrain.clip_by_global_norm(
            {k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=1e-6)
        for k in tree:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                       rtol=1e-6)


def test_adamw_reduces_quadratic():
    w = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = ttrain.init_opt_state(w)
    cfg = ttrain.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                             weight_decay=0.0, clip_norm=100.0)
    for _ in range(150):
        w, state, _ = ttrain.adamw_update(w, {"w": 2 * w["w"]}, state, cfg)
    assert float(w["w"].abs().max()) < 0.25


# ---------------------------------------------------------------------- #
# Checkpoints
# ---------------------------------------------------------------------- #
def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": {"c": torch.tensor(7, dtype=torch.int32)},
             "h": torch.tensor([1.5, -2.25], dtype=torch.bfloat16)}
    path = str(tmp_path / "ckpt_5")
    ttrain.save(path, state, step=5)
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.tensor(0, dtype=torch.int32)},
            "h": torch.zeros(2, dtype=torch.bfloat16)}
    out = ttrain.restore(path, like)
    assert torch.equal(out["a"], state["a"])
    assert int(out["b"]["c"]) == 7 and out["b"]["c"].dtype == torch.int32
    assert torch.equal(out["h"], state["h"])
    assert ttrain.latest_step(str(tmp_path)) == 5


def test_checkpoint_reads_the_reference_format(tmp_path):
    # a checkpoint the JAX package wrote restores into the same tree
    state = {"a": jnp.arange(6, dtype=jnp.float32).reshape(2, 3),
             "b": {"c": jnp.asarray(7, jnp.int32)}}
    jtrain.save(str(tmp_path / "ckpt_2"), state, step=2)
    like = {"a": torch.zeros(2, 3), "b": {"c": torch.tensor(0, dtype=torch.int32)}}
    out = ttrain.restore(str(tmp_path / "ckpt_2"), like)
    np.testing.assert_array_equal(out["a"].numpy(), np.asarray(state["a"]))
    assert int(out["b"]["c"]) == 7
    assert ttrain.latest_step(str(tmp_path)) == 2


def test_checkpoint_shape_mismatch_raises(tmp_path):
    path = str(tmp_path / "ckpt_1")
    ttrain.save(path, {"a": torch.zeros(2, 3)})
    with pytest.raises(ValueError):
        ttrain.restore(path, {"a": torch.zeros(3, 3)})


def test_async_checkpointer_resume_is_bit_exact(tmp_path):
    # the reference's async checkpointer case, then: save after one step,
    # restore, one more step == two uninterrupted steps, bit for bit
    ck = ttrain.AsyncCheckpointer()
    w = {"w": torch.ones(128, 128)}
    ck.save(str(tmp_path / "ckpt_1"), w, 1)
    ck.wait()
    assert torch.equal(ttrain.restore(str(tmp_path / "ckpt_1"), w)["w"],
                       w["w"])
    _, ct = _cfgs("mamba2-780m")
    state = ttrain.init_train_state(ct, torch.Generator().manual_seed(0),
                                    torch.float32, "cpu")
    step = ttrain.make_train_step(ct, ttrain.AdamWConfig(warmup_steps=1,
                                                         total_steps=4),
                                  T_NO_SHARDING, "chunked", True, CE_CHUNK)
    state, _ = step(state, _batch(0))
    ck.save(str(tmp_path / "ckpt_9"), state, 9)
    ck.wait()
    straight, m1 = step(state, _batch(1))
    resumed, m2 = step(ttrain.restore(str(tmp_path / "ckpt_9"), state),
                       _batch(1))
    assert float(m1["loss"]) == float(m2["loss"])
    for n, t in straight["params"].items():
        assert torch.equal(t, resumed["params"][n]), n
    assert list(resumed["params"]) == list(straight["params"])


# ---------------------------------------------------------------------- #
# int8 compression
# ---------------------------------------------------------------------- #
def test_int8_quantization_matches_reference(rng):
    g = (rng.standard_normal((1000,)) * 0.01).astype(np.float32)
    jq, js = jtrain.quantize_int8(jnp.asarray(g), block=256)
    tq, ts = ttrain.quantize_int8(torch.from_numpy(g), block=256)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    back = ttrain.dequantize_int8(tq, ts, g.shape, torch.float32)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        jtrain.dequantize_int8(jq, js, g.shape, jnp.float32)))
    # the reference's bound: error at most scale / 2 per block
    err = np.abs(back.numpy() - g)
    bound = np.repeat(ts.numpy(), 256)[:1000] * 0.5 + 1e-9
    assert (err <= bound).all()


@pytest.mark.parametrize("ef", [False, True])
def test_compressed_all_reduce_matches_reference(ef):
    from repro.comm import get_communicator
    from repro_torch.comm import StackedCommunicator
    p, shape = 4, (5, 300)
    rng = np.random.default_rng(8)
    g = (rng.standard_normal((p,) + shape) * rng.random((p, 1, 1))
         ).astype(np.float32)
    err = (rng.standard_normal((p,) + shape) * 1e-3).astype(np.float32)
    comm = get_communicator("xla", "df")
    if ef:
        want = jax.vmap(lambda a, e: jtrain.ef_compressed_all_reduce(
            a, e, comm, block=256), axis_name="df")(jnp.asarray(g),
                                                    jnp.asarray(err))
        got = ttrain.ef_compressed_all_reduce(
            torch.from_numpy(g), torch.from_numpy(err),
            StackedCommunicator(p), block=256)
    else:
        want = (jax.vmap(lambda a: jtrain.compressed_all_reduce(
            a, comm, block=256), axis_name="df")(jnp.asarray(g)),)
        got = (ttrain.compressed_all_reduce(torch.from_numpy(g),
                                            StackedCommunicator(p),
                                            block=256),)
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("compressed", [False, True])
def test_compressed_data_parallel_training_converges(compressed):
    # tests/md_scripts/compression_train.py on 8 stacked ranks
    from repro_torch.comm import StackedCommunicator
    rng = np.random.default_rng(0)
    p, d = 8, 256
    comm = StackedCommunicator(p)
    w_true = rng.standard_normal(d).astype(np.float32)
    x = torch.from_numpy(rng.standard_normal((p, 64, d)).astype(np.float32))
    y = x @ torch.from_numpy(w_true) + torch.from_numpy(
        0.01 * rng.standard_normal((p, 64)).astype(np.float32))
    w = torch.zeros((p, d))
    err = torch.zeros((p, d))
    for _ in range(120):
        g = 2.0 / 64 * torch.einsum("rnd,rn->rd", x,
                                    torch.einsum("rnd,rd->rn", x, w) - y)
        if compressed:
            g, err = ttrain.ef_compressed_all_reduce(g, err, comm)
        else:
            g = comm.all_reduce(g) / p
        w = w - 0.05 * g
    resid = float(np.linalg.norm(w[0].numpy() - w_true)
                  / np.linalg.norm(w_true))
    assert resid < 0.05, resid
    assert torch.allclose(w[0], w[-1], atol=1e-5)


# ---------------------------------------------------------------------- #
# The SSD scan's autograd path
# ---------------------------------------------------------------------- #
def test_ssd_autograd_function_matches_plain_gradient(monkeypatch):
    # the kernel's operator is CUDA-only: stand the plain version in for
    # the Function's forward and hold its backward to autograd through the
    # plain one
    from repro_torch.kernels.ssd_scan import ops
    monkeypatch.setattr(ops, "ssd_scan_op",
                        lambda *a: ops.ssd_scan_chunked(*a[:5], chunk=a[5]))
    rng = np.random.default_rng(5)
    bh, t, p, n, chunk = 6, 40, 8, 16, 16
    arrs = [rng.standard_normal((bh, t, p)),
            rng.random((bh, t, 1)) * 0.1 + 0.01,
            -rng.random((bh, 1)) - 0.05,
            rng.standard_normal((bh, t, n)), rng.standard_normal((bh, t, n))]
    gy = torch.from_numpy(rng.standard_normal((bh, t, p)).astype(np.float32))
    gh = torch.from_numpy(rng.standard_normal((bh, n, p)).astype(np.float32))
    for use_h in (False, True):
        grads = []
        for fn in (lambda *v: ops.SsdScanKernel.apply(*v, chunk),
                   lambda *v: ops.ssd_scan_chunked(*v, chunk=chunk)):
            ins = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
                   for a in arrs]
            y, h = fn(*ins)
            loss = (y * gy).sum() + ((h * gh).sum() if use_h else 0.0)
            loss.backward()
            grads.append([v.grad for v in ins])
        for g, w in zip(*grads):
            assert torch.allclose(g, w, rtol=1e-5, atol=1e-6)
    before = ops.ssd_scan_backward.launches
    ins = [torch.tensor(a, dtype=torch.float32, requires_grad=True)
           for a in arrs]
    ops.SsdScanKernel.apply(*ins, chunk)[0].sum().backward()
    assert ops.ssd_scan_backward.launches == before + 1


# ---------------------------------------------------------------------- #
# The train driver
# ---------------------------------------------------------------------- #
def test_train_driver_runs_and_resumes(tmp_path):
    from repro_torch.launch import train as driver
    args = ["--arch", "mamba2-780m", "--smoke", "--steps", "4", "--batch",
            "2", "--seq", "16", "--device", "cpu", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "2"]
    losses = driver.main(args)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert ttrain.latest_step(str(tmp_path)) == 4
    assert driver.main(args + ["--resume"]) == []     # already at step 4

