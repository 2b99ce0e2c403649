"""The port's VLM and audio frontends against the JAX package, with the
shape cells and ``model_flops`` of ``launch/``.

llava-next-34b (vlm: precomputed patch embeddings ahead of the text) and
musicgen-large (audio: K codebook embeddings summed in, K logit heads) at
their SMOKE sizes: the JAX ``init_params`` tree goes to the port through
``params_from_numpy``, and the same numpy inputs from a seed go through
both packages' ``prefill`` / ``decode_step``, the audio ``ServeEngine``,
``loss_fn`` and three train steps, on the CPU (the port's plain kernels;
JAX's Pallas flash kernel in interpret mode under ``flash``).  Serving is
held within 1e-4 (float32, other summation orders); the loss, gradients
and train steps at ``tests/test_torch_train.py``'s tolerances.
"""

import ast
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import train as jtrain
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import roofline as jroof
from repro.launch import shapes as jshapes
from repro.models import transformer as jt
from repro.models.config import SHAPES
from repro.models.layers import NO_SHARDING
from repro_torch.models.layers import NO_SHARDING as T_NO_SHARDING
from repro.serve import ServeEngine as JaxEngine
from repro_torch import train as ttrain
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch import roofline as troof
from repro_torch.launch import serve as serve_main
from repro_torch.launch import shapes as tshapes
from repro_torch.launch import train as train_main
from repro_torch.models import transformer as tt
from repro_torch.serve import ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
FRONTENDS = ["llava-next-34b", "musicgen-large"]
B = 2
#: patch embeddings ahead of a smoke vlm prompt
PATCHES = 8
#: loss tests: a vocab that pads (to 256 rows) and a ragged last CE chunk
VOCAB, CE_CHUNK, S_TRAIN = 250, 16, 40


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(got, want):
    return float((got - want).norm() / max(float(want.norm()), 1e-30))


def _tokens(cfg, n, rng):
    """(B, n) token ids, or (B, n, K) for audio."""
    k = (cfg.num_codebooks,) if cfg.family == "audio" else ()
    return rng.integers(0, cfg.vocab_size, (B, n) + k).astype(np.int32)


def _inputs(cfg, s, seed, labels=False):
    """numpy inputs of a sequence of ``s`` positions: audio tokens (B, s,
    K); vlm patch embeddings (B, PATCHES, D) and s - PATCHES text tokens;
    with ``labels``, the next tokens (-1 on three positions of row 0)."""
    rng = np.random.default_rng(seed)
    n = s - PATCHES if cfg.family == "vlm" else s
    toks = _tokens(cfg, n + 1, rng)
    batch = {"tokens": toks[:, :-1]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, PATCHES, cfg.d_model)).astype(np.float32)
    if labels:
        batch["labels"] = toks[:, 1:].copy()
        batch["labels"][0, :3] = -1
    return batch


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=FRONTENDS)
def pair(request):
    arch = request.param
    cfg_j = jax_smoke(arch)
    params_j = jt.init_params(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    cfg = get_smoke_config(arch)
    return arch, cfg_j, params_j, cfg, tt.params_from_numpy(
        _np(params_j), cfg, "cpu")


# ---------------------------------------------------------------------- #
# Configs and parameters
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", FRONTENDS)
def test_configs_equal_the_reference(arch):
    assert arch in ARCHS
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(
        jax_config(arch))
    assert dataclasses.asdict(get_smoke_config(arch)) == dataclasses.asdict(
        jax_smoke(arch))


def test_archs_in_the_reference_order():
    assert ARCHS == JAX_ARCHS


def test_init_params_has_the_reference_shapes(pair):
    _, cfg_j, params_j, cfg, model = pair
    got = tt.named_params(tt.init_params(cfg, torch.Generator().manual_seed(
        0), torch.float32, "cpu"))
    want = tt.named_params(model)     # the reference's tree, carried across
    assert {n: tuple(t.shape) for n, t in got.items()} == {
        n: tuple(t.shape) for n, t in want.items()}
    table = (cfg.padded_vocab, cfg.d_model)
    if cfg.family == "audio":
        table = (cfg.num_codebooks,) + table
    for name in ("embed", "lm_head"):
        assert got[name].shape == table
        np.testing.assert_array_equal(want[name].numpy(),
                                      np.asarray(params_j[name]))


# ---------------------------------------------------------------------- #
# Serving
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("s,impl", [(24, "dense"), (160, "flash")])
def test_prefill_and_decode_match_reference(pair, s, impl):
    arch, cfg_j, params_j, cfg, model = pair
    steps = 3
    batch = _inputs(cfg, s, seed=s)
    logits_j, caches_j = jt.prefill(
        params_j, cfg_j, {k: jnp.asarray(v) for k, v in batch.items()},
        s + steps, impl=impl)
    patches = batch.get("patch_embeds")
    logits, caches = tt.prefill(
        model, torch.as_tensor(batch["tokens"], dtype=torch.long), s + steps,
        impl, None if patches is None else torch.from_numpy(patches))
    shape = (B, cfg.padded_vocab)
    if cfg.family == "audio":
        shape = (B, cfg.num_codebooks, cfg.padded_vocab)
    assert logits.shape == shape and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j), **TOL)
    assert bool((logits[..., cfg.vocab_size:] == -1e30).all())
    want = tt.unstack_layers(_np(caches_j), cfg)
    for g, w in zip(caches, want):
        for name in w:
            np.testing.assert_allclose(g[name].numpy(), w[name], **TOL)
    # teacher-forced decode; a vlm's positions count its patches
    forced = _tokens(cfg, steps, np.random.default_rng(1))
    step_j = jax.jit(lambda c, t, pos: jt.decode_step(params_j, cfg_j, c, t,
                                                      pos))
    for i in range(steps):
        pos = np.full((B,), s + i, np.int32)
        tok = forced[:, i:i + 1]
        logits_j, caches_j = step_j(caches_j, jnp.asarray(tok),
                                    jnp.asarray(pos))
        logits = tt.decode_step(model, caches, torch.as_tensor(
            tok, dtype=torch.long), torch.from_numpy(pos))
        assert logits.shape == shape
        np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                                   **TOL, err_msg=f"decode step {i}")


def test_patch_embeds_only_for_a_vlm(pair):
    _, _, _, cfg, model = pair
    batch = _inputs(cfg, 16, seed=0)
    tokens = torch.as_tensor(batch["tokens"], dtype=torch.long)
    wrong = (None if cfg.family == "vlm"
             else torch.zeros((B, PATCHES, cfg.d_model)))
    with pytest.raises(ValueError, match="patch_embeds"):
        tt.prefill(model, tokens, 32, patch_embeds=wrong)


@pytest.fixture(scope="module")
def audio():
    cfg_j = jax_smoke("musicgen-large")
    params_j = jt.init_params(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    cfg = get_smoke_config("musicgen-large")
    return cfg_j, params_j, cfg, tt.params_from_numpy(_np(params_j), cfg,
                                                      "cpu")


def test_audio_greedy_tokens_equal_reference_engine(audio):
    cfg_j, params_j, cfg, model = audio
    prompts = _inputs(cfg, 12, seed=2)["tokens"]
    want = JaxEngine(cfg_j, params_j, cache_len=22).generate(prompts, 10)
    got = ServeEngine(cfg, model, cache_len=22).generate(prompts, 10)
    assert got.tokens.shape == (B, 10, cfg.num_codebooks)
    assert (got.steps, got.prefill_len) == (want.steps, want.prefill_len)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    # EOS reads codebook 0, as the reference's engine
    eos = int(want.tokens[0, 0, 0])
    early = ServeEngine(cfg, model, cache_len=22, eos_id=eos).generate(
        prompts[:1], 10)
    assert early.steps == 1


def test_audio_temperature_sampling_shape(audio):
    _, _, cfg, model = audio
    eng = ServeEngine(cfg, model, cache_len=20)
    prompts = _inputs(cfg, 8, seed=3)["tokens"]
    a = eng.generate(prompts, 6, temperature=20.0, seed=7)
    b = eng.generate(prompts, 6, temperature=20.0, seed=7)
    assert a.tokens.shape == (B, 6, cfg.num_codebooks)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert 0 <= a.tokens.min() and a.tokens.max() < cfg.vocab_size
    # the codebooks draw apart: not one token copied across them
    assert not all(np.array_equal(a.tokens[..., 0], a.tokens[..., k])
                   for k in range(1, cfg.num_codebooks))


# ---------------------------------------------------------------------- #
# Training
# ---------------------------------------------------------------------- #
def _cfgs(arch):
    return (dataclasses.replace(jax_smoke(arch), vocab_size=VOCAB),
            dataclasses.replace(get_smoke_config(arch), vocab_size=VOCAB))


@pytest.mark.parametrize("arch", FRONTENDS)
def test_loss_fn_and_grads_match_reference(arch):
    cj, ct = _cfgs(arch)
    params = jt.init_params(jax.random.PRNGKey(0), cj, jnp.float32)
    batch = _inputs(ct, S_TRAIN, seed=1, labels=True)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (lj, pj), gj = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, cj, jb, NO_SHARDING, "chunked", True,
                             CE_CHUNK), has_aux=True))(params)
    model = tt.params_from_numpy(_np(params), ct, "cpu")
    lt, pt = tt.loss_fn(model, _torch(batch), "chunked", True, CE_CHUNK)
    lt.backward()
    assert float(lt.detach()) == pytest.approx(float(lj), rel=1e-5)
    assert float(pt["ce"].detach()) == pytest.approx(float(pj["ce"]),
                                                     rel=1e-5)
    assert float(pt["aux"]) == float(pj["aux"]) == 0.0
    want = tt.named_params(tt.params_from_numpy(_np(gj), ct, "cpu"))
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    for n, w in want.items():
        assert _rel(got[n], w) <= 1e-4, n


@pytest.mark.parametrize("arch", FRONTENDS)
def test_three_train_steps_match_reference(arch):
    cj, ct = _cfgs(arch)
    state_j = jtrain.init_train_state(jax.random.PRNGKey(0), cj, jnp.float32)
    state_t = tt.train_state_from_numpy(_np(state_j), ct, "cpu")
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=3)
    step_j = jax.jit(jtrain.make_train_step(cj, jtrain.AdamWConfig(**ocfg),
                                            NO_SHARDING, "chunked", True,
                                            CE_CHUNK))
    step_t = ttrain.make_train_step(ct, ttrain.AdamWConfig(**ocfg),
                                    T_NO_SHARDING, "chunked", True, CE_CHUNK)
    for i in range(3):
        batch = _inputs(ct, S_TRAIN, seed=10 + i, labels=True)
        state_j, mj = step_j(state_j, {k: jnp.asarray(v)
                                       for k, v in batch.items()})
        state_t, mt = step_t(state_t, batch)
        for k in ("loss", "ce", "aux", "grad_norm"):
            assert float(mt[k]) == pytest.approx(float(mj[k]), rel=1e-5), k
        assert float(mt["lr"]) == pytest.approx(float(mj["lr"]), rel=1e-6)
    want = tt.train_state_from_numpy(_np(state_j), ct, "cpu")
    assert int(state_t["opt"]["step"]) == 3
    for n, w in want["params"].items():
        assert _rel(state_t["params"][n], w) <= 1e-4, n
    for part in ("m", "v"):
        for n, w in want["opt"][part].items():
            assert _rel(state_t["opt"][part][n], w) <= 1e-3, (part, n)


# ---------------------------------------------------------------------- #
# launch/: shapes and model_flops
# ---------------------------------------------------------------------- #
_TORCH_DTYPES = {jnp.dtype(jnp.int32): torch.int32,
                 jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _same_spec(got, want):
    assert got.device.type == "meta"       # a shape and a dtype, no storage
    assert tuple(got.shape) == tuple(want.shape)
    assert got.dtype == _TORCH_DTYPES[jnp.dtype(want.dtype)]


@pytest.mark.parametrize("shape", list(SHAPES))
def test_shape_cells_and_specs_match_reference(shape):
    for arch in ARCHS:
        got, want = tshapes.cell(arch, shape), jshapes.cell(arch, shape)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        cfg, info = get_config(arch), SHAPES[shape]
        b, s = info["global_batch"], info["seq_len"]
        assert tshapes.vlm_patches(cfg, s) == jshapes.vlm_patches(cfg, s)
        for fn in ("train_batch_specs", "prefill_batch_specs"):
            g = getattr(tshapes, fn)(cfg, b, s)
            w = getattr(jshapes, fn)(jax_config(arch), b, s)
            assert sorted(g) == sorted(w), (arch, fn)
            for k in w:
                _same_spec(g[k], w[k])
        for g, w in zip(tshapes.decode_token_specs(cfg, b),
                        jshapes.decode_token_specs(jax_config(arch), b)):
            _same_spec(g, w)
    assert [dataclasses.asdict(c) for c in tshapes.all_cells()] == [
        dataclasses.asdict(c) for c in jshapes.all_cells()]


def test_vlm_patches_switch_at_4096():
    cfg = get_config("llava-next-34b")
    assert tshapes.vlm_patches(cfg, 4096) == 576
    assert tshapes.vlm_patches(cfg, 4097) == 2880


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_match_reference(kind):
    for arch in ARCHS:
        got = troof.model_flops(get_config(arch), kind, 4, 4096)
        assert got == jroof.model_flops(jax_config(arch), kind, 4, 4096)
        assert got > 0


# ---------------------------------------------------------------------- #
# The drivers
# ---------------------------------------------------------------------- #
def test_launch_serve_audio_smoke_on_cpu(capsys):
    serve_main.main(["--arch", "musicgen-large", "--smoke", "--device",
                     "cpu", "--batch", "2", "--prompt-len", "12",
                     "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[serve] arch=musicgen-large-smoke batch=2 prefill=12 " \
           "decoded=4" in out
    assert len(ast.literal_eval(out.split("first sequence:")[1].strip())) == 4


def _reference_exit(main, argv, monkeypatch):
    monkeypatch.setattr("sys.argv", ["prog"] + argv)
    with pytest.raises(SystemExit) as e:
        main()
    return str(e.value)


@pytest.mark.parametrize("driver,arch", [("serve", "llava-next-34b"),
                                         ("train", "llava-next-34b"),
                                         ("train", "musicgen-large")])
def test_drivers_exit_as_the_reference(driver, arch, monkeypatch):
    import importlib
    ref = importlib.import_module(f"repro.launch.{driver}").main
    port = {"serve": serve_main, "train": train_main}[driver].main
    argv = ["--arch", arch, "--smoke"]
    want = _reference_exit(ref, argv, monkeypatch)
    with pytest.raises(SystemExit) as e:
        port(argv + ["--device", "cpu"])
    assert str(e.value) == want and "token-LM" in want
