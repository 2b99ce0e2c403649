"""The port's sharded model stack over spawned gloo processes on the CPU.

Each group runs as this file started as a script (``<mode> <dir>``), one
process a rank, ``file://`` rendezvous under ``tmp_path``, one CPU
thread a process, and a 120 s timeout on the process group so that a
mismatched collective fails instead of hanging.  The groups start
together in a module fixture:

* ``train`` (4 processes, a (2, 2) ``("data", "model")`` mesh): the five
  archs of ``tests/md_scripts/sharded_train.py`` at SMOKE size, from the
  JAX package's float32 train state.  llama3.2-3b and mamba2-780m: the
  sharded loss within 1e-5 relative, the gradient norm within 1e-4 and
  every leaf's gradient (``full_tensor()``) within atol 1e-5 of the
  unsharded port, but for the unembedding's: its gradient passes
  through bfloat16 (the LM head is rounded to bfloat16, as in the
  reference) and each data rank rounds its own partial sum, so it is
  held to two bfloat16 steps of its largest element.  olmoe-1b-7b, jamba-v0.1-52b, deepseek-v2-lite-16b
  (the shuffle dispatch drops other rows at capacity than the grouped
  one): one train step held at the reference script's tolerances (loss
  rtol 2e-3, gradient norm rtol 2e-2) to the unsharded port and to the
  JAX package's ``NO_SHARDING`` step.
* ``moe`` (4 processes, (2, 2)): ``moe_shuffle_parity.py``'s case, the
  shuffle dispatch over the mesh's model group with ``xla``, ``ring`` and
  ``bruck``, against the unsharded grouped dispatch: values within atol
  2e-4 / rtol 1e-3, aux within rtol 1e-4, gradients within 5e-3.
* ``elastic`` (8 processes on a (4, 2) mesh, then 4 on (2, 2)):
  ``elastic_checkpoint.py``'s case, llama3.2-3b SMOKE trained, saved,
  restored with ``shardings`` onto the smaller mesh, trained on; the
  losses keep decreasing.
* ``serve`` (4 processes, (2, 2), serving rules): ``ServeEngine(rules=)``
  for qwen3-8b and jamba-v0.1-52b SMOKE: prefill logits within 1e-4 and
  greedy tokens equal to the unsharded engine's; again with a cache
  length that does not divide over the model axis (uneven KV shards),
  where the first decode step's logits are held within 1e-4.  Then sequence-parallel
  attention (queries sharded over ``model``, K and V gathered) through
  ``flash`` (each rank's slice against the key prefix ending with it),
  ``chunked`` and ``dense``, within 1e-5 of the unsharded attention.

The NCCL case (2 processes on two cards) runs only where two cards are.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \\
        tests/test_torch_sharded_train.py
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TRAIN_ARCHS = ("llama3.2-3b", "olmoe-1b-7b", "mamba2-780m", "jamba-v0.1-52b",
               "deepseek-v2-lite-16b")
GRAD_ARCHS = ("llama3.2-3b", "mamba2-780m")
SERVE_ARCHS = ("qwen3-8b", "jamba-v0.1-52b")
COMMS = ("xla", "ring", "bruck")
#: a cache length that does not divide over a model axis of 2
ODD_CACHE = 23
CE_CHUNK = 16
ELASTIC_STEPS = 3
#: mode -> processes
GROUPS = {"train": 4, "moe": 4, "elastic": 8, "serve": 4}


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (8, 32)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (8, 32)).astype(
                np.int32)}


def _opt():
    from repro_torch.train import AdamWConfig
    return AdamWConfig(warmup_steps=1, total_steps=4)


# ---------------------------------------------------------------------- #
# Children: one rank a process
# ---------------------------------------------------------------------- #
def _init(rank, world, d, tag):
    from datetime import timedelta
    import warnings
    import torch
    import torch.distributed as dist
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rv_{tag}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))


def _done(d, rank, tag, out):
    import torch.distributed as dist
    np.savez(os.path.join(d, f"{tag}{rank}.npz"), **out)
    dist.destroy_process_group()


def _loss_grads(cfg, params, batch, rules, mesh):
    """(loss, {name: full gradient}) of ``loss_fn`` at ``params``."""
    import torch
    from repro_torch.models import transformer as tt
    from repro_torch.models.layers import distribute, full, set_mesh
    from repro_torch.train import batch_specs
    import contextlib
    with set_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        model = tt.model_from_named(cfg, params)
        b = {k: torch.from_numpy(v) for k, v in batch.items()}
        if mesh is not None:
            bs = batch_specs(cfg, rules)
            b = {k: distribute(v, bs[k], mesh) for k, v in b.items()}
        names = list(params)
        with torch.enable_grad():
            loss, _ = tt.loss_fn(model, b, "auto", True, CE_CHUNK, rules)
            mp = dict(model.named_parameters())
            grads = torch.autograd.grad(loss, [mp[n] for n in names])
        return (float(full(loss)),
                {n: full(g).numpy() for n, g in zip(names, grads)})


def _train_child(rank, world, d):
    _init(rank, world, d, "train")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh, rules_for_mesh
    from repro_torch.models import transformer as tt
    from repro_torch.models.layers import NO_SHARDING
    from repro_torch.train import make_train_step, place_state
    mesh = make_local_mesh(model=2)
    rules = rules_for_mesh(mesh)
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = get_smoke_config(arch)
        with open(os.path.join(d, f"{arch}.pkl"), "rb") as f:
            tree = pickle.load(f)
        state = tt.train_state_from_numpy(tree, cfg, "cpu")
        batch = _batch(cfg, 0)
        if arch in GRAD_ARCHS:
            l1, g1 = _loss_grads(cfg, state["params"], batch, NO_SHARDING,
                                 None)
            l2, g2 = _loss_grads(cfg, place_state(state, cfg, rules, mesh)
                                 ["params"], batch, rules, mesh)
            out[f"{arch}/loss"] = np.array([l1, l2])
            out[f"{arch}/grad_norm"] = np.array(
                [np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                             for g in gs.values())) for gs in (g1, g2)])
            names = sorted(g1)
            out[f"{arch}/names"] = np.array(names)
            out[f"{arch}/grad_err"] = np.array(
                [float(np.abs(g1[n] - g2[n]).max()) for n in names])
            out[f"{arch}/grad_max"] = np.array(
                [float(np.abs(g1[n]).max()) for n in names])
        else:
            _, m1 = make_train_step(cfg, _opt(), NO_SHARDING,
                                    ce_chunk=CE_CHUNK)(state, batch)
            _, m2 = make_train_step(cfg, _opt(), rules, ce_chunk=CE_CHUNK)(
                place_state(state, cfg, rules, mesh), batch)
            for k in ("loss", "grad_norm"):
                out[f"{arch}/{k}"] = np.array([float(m1[k]), float(m2[k])])
    _done(d, rank, "train", out)


def moe_parity_config():
    from repro_torch.models.config import ModelConfig, MoEConfig
    return ModelConfig(
        name="parity-moe", family="moe", num_layers=1, d_model=64,
        num_heads=4, num_kv_heads=4, d_ff=96, vocab_size=256,
        moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=96, num_shared=1,
                      capacity_factor=8.0))


def _moe_child(rank, world, d):
    _init(rank, world, d, "moe")
    import dataclasses
    import torch
    from repro_torch.launch.mesh import make_local_mesh, rules_for_mesh
    from repro_torch.models import moe
    from repro_torch.models.layers import distribute, full, set_mesh
    from repro_torch.models.transformer import place
    mesh = make_local_mesh(model=2)
    rules = rules_for_mesh(mesh)
    cfg = moe_parity_config()
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg,
                          torch.float32, "cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 32, 64)).astype(np.float32))
    out = {}
    for name in COMMS:
        cfg_c = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, communicator=name))
        with set_mesh(mesh):
            p = place(params, moe.moe_specs(cfg, rules), mesh)
            p = {k: ({n: t.requires_grad_() for n, t in v.items()}
                     if isinstance(v, dict) else v.requires_grad_())
                 for k, v in p.items()}
            xs = distribute(x, rules.logical("batch", None, None), mesh)
            y, aux = moe.moe_apply_shuffle(p, xs, cfg_c, rules)
            loss = (y ** 2).sum() + aux
            leaves = {f"{k}/{n}": t for k, v in p.items()
                      for n, t in (v.items() if isinstance(v, dict)
                                   else [("", v)])}
            grads = torch.autograd.grad(loss, list(leaves.values()))
        out[f"{name}/y"] = full(y).detach().numpy()
        out[f"{name}/aux"] = full(aux).detach().numpy()
        for k, g in zip(leaves, grads):
            out[f"{name}/grad/{k}"] = full(g).numpy()
    _done(d, rank, "moe", out)


def _elastic_child(rank, world, d, phase):
    _init(rank, world, d, f"elastic{phase}")
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh, rules_for_mesh
    from repro_torch.models.layers import set_mesh
    from repro_torch.train import (init_train_state, make_train_step,
                                   place_state, restore, save, state_specs)
    cfg = get_smoke_config("llama3.2-3b")
    mesh = make_local_mesh(model=2)
    rules = rules_for_mesh(mesh)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    path = os.path.join(d, f"ckpt_{ELASTIC_STEPS}")
    if phase == 1:
        state = place_state(state, cfg, rules, mesh)
    else:
        with set_mesh(mesh):
            state = restore(path, state, shardings=state_specs(cfg, rules))
    out = {"step": np.array(int(state["opt"]["step"].full_tensor()))}
    step = make_train_step(cfg, _elastic_opt(), rules, ce_chunk=CE_CHUNK)
    losses = []
    for i in range(ELASTIC_STEPS):
        state, m = step(state, _batch(cfg, 100 + (phase - 1) * ELASTIC_STEPS
                                      + i))
        losses.append(float(m["loss"]))
    if phase == 1:
        save(path, state, ELASTIC_STEPS)
    out["losses"] = np.array(losses)
    _done(d, rank, f"elastic{phase}_", out)


def _elastic_opt():
    from repro_torch.train import AdamWConfig
    return AdamWConfig(warmup_steps=2, total_steps=20)


def _serve_child(rank, world, d):
    _init(rank, world, d, "serve")
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import (make_local_mesh, rules_for_mesh,
                                         serve_rules_for_mesh)
    from repro_torch.models import transformer as tt
    from repro_torch.models.attention import attention_impl
    from repro_torch.models.layers import (P, constrain, distribute, full,
                                           set_mesh)
    from repro_torch.serve import ServeEngine
    mesh = make_local_mesh(model=2)
    rules = serve_rules_for_mesh(mesh)
    out = {}
    for arch in SERVE_ARCHS:
        cfg = get_smoke_config(arch)
        model = tt.init_params(cfg, torch.Generator().manual_seed(0),
                               torch.float32, "cpu")
        prompts = np.random.default_rng(1).integers(
            0, cfg.vocab_size, (4, 16)).astype(np.int32)
        toks = torch.from_numpy(prompts).long()
        plain = ServeEngine(cfg, model, cache_len=24)
        sharded = ServeEngine(cfg, tt.shard_model(model, rules, mesh),
                              cache_len=24, rules=rules)
        out[f"{arch}/logits"] = np.stack(
            [full(e.prefill(toks)[0]).numpy() for e in (plain, sharded)])
        out[f"{arch}/tokens"] = np.stack(
            [e.generate(prompts, 6).tokens for e in (plain, sharded)])
        # an odd cache length: the model ranks hold 12 and 11 positions
        plain = ServeEngine(cfg, model, cache_len=ODD_CACHE)
        sharded = ServeEngine(cfg, tt.shard_model(model, rules, mesh),
                              cache_len=ODD_CACHE, rules=rules)
        step = []
        for e in (plain, sharded):
            logits, caches = e.prefill(toks)
            tok = torch.argmax(full(logits), dim=-1)[:, None]
            pos = torch.full((4,), 16, dtype=torch.int32)
            step.append(full(e.decode_step(caches, tok, pos)).numpy())
        out[f"{arch}/odd_decode"] = np.stack(step)
        out[f"{arch}/odd_tokens"] = np.stack(
            [e.generate(prompts, 6).tokens for e in (plain, sharded)])
    # sequence-parallel attention: each rank's query slice against the
    # gathered keys (flash: the key prefix up to the end of its slice)
    train = rules_for_mesh(mesh)
    g = torch.Generator().manual_seed(3)
    q = torch.randn(4, 4, 64, 16, generator=g)
    k, v = (torch.randn(4, 2, 64, 16, generator=g) for _ in range(2))
    out["attn/want"] = attention_impl(q, k, v, impl="dense").numpy()
    with set_mesh(mesh):
        qs, ks, vs = (distribute(t, P(), mesh) for t in (q, k, v))
        qs = constrain(qs, train, "batch", None, "model", None)
        for impl in ("flash", "chunked", "dense"):
            out[f"attn/{impl}"] = full(attention_impl(
                qs, ks, vs, impl=impl, rules=train)).numpy()
    _done(d, rank, "serve", out)


def _nccl_child(rank, world, d):
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{d}/rv_nccl",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh, rules_for_mesh
    from repro_torch.models.layers import NO_SHARDING
    from repro_torch.train import (init_train_state, make_train_step,
                                   place_state)
    cfg = get_smoke_config("olmoe-1b-7b")
    mesh = make_local_mesh(model=2)
    rules = rules_for_mesh(mesh)
    state = init_train_state(cfg, torch.Generator().manual_seed(0),
                             torch.float32, "cpu")
    state = {"params": {n: t.cuda() for n, t in state["params"].items()},
             "opt": {"step": state["opt"]["step"].cuda(),
                     **{k: {n: t.cuda() for n, t in state["opt"][k].items()}
                        for k in ("m", "v")}}}
    batch = _batch(cfg, 0)
    _, m1 = make_train_step(cfg, _opt(), NO_SHARDING, impl="dense",
                            ce_chunk=CE_CHUNK)(state, batch)
    _, m2 = make_train_step(cfg, _opt(), rules, impl="dense",
                            ce_chunk=CE_CHUNK)(
        place_state(state, cfg, rules, mesh), batch)
    np.savez(os.path.join(d, f"nccl{rank}.npz"),
             **{k: np.array([float(m1[k]), float(m2[k])])
                for k in ("loss", "grad_norm")})
    dist.destroy_process_group()


def _spawn(fn, world, *args):
    import torch.multiprocessing as mp
    mp.start_processes(fn, args=(world,) + args, nprocs=world,
                       start_method="spawn")


# ---------------------------------------------------------------------- #
# The JAX side (in the test process) and the fixtures
# ---------------------------------------------------------------------- #
def _reference_states(d):
    """Write each train arch's JAX float32 state (as numpy) for the
    children; return the states."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.train import init_train_state
    out = {}
    for arch in TRAIN_ARCHS:
        state = init_train_state(jax.random.PRNGKey(0),
                                 get_smoke_config(arch), jnp.float32)
        with open(os.path.join(d, f"{arch}.pkl"), "wb") as f:
            pickle.dump(jax.tree_util.tree_map(np.asarray, state), f)
        out[arch] = state
    return out


def _reference_steps(states):
    """The JAX package's NO_SHARDING step metrics of the MoE archs."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke_config
    from repro.models.layers import NO_SHARDING
    from repro.train import AdamWConfig, make_train_step
    out = {}
    for arch in TRAIN_ARCHS:
        if arch in GRAD_ARCHS:
            continue
        cfg = get_smoke_config(arch)
        _, m = jax.jit(make_train_step(
            cfg, AdamWConfig(warmup_steps=1, total_steps=4), NO_SHARDING,
            ce_chunk=CE_CHUNK))(states[arch], {
                k: jnp.asarray(v) for k, v in _batch(cfg, 0).items()})
        out[arch] = {k: float(m[k]) for k in ("loss", "grad_norm")}
    return out


def _start(mode, d):
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(SRC), here]), JAX_PLATFORMS="cpu",
        OMP_NUM_THREADS="1")
    log = open(os.path.join(d, "log.txt"), "w")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), mode,
                             d], stdout=log, stderr=subprocess.STDOUT,
                            env=env)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every group started at once; the JAX side runs meanwhile."""
    dirs = {m: str(tmp_path_factory.mktemp(m)) for m in GROUPS}
    procs = {m: _start(m, dirs[m]) for m in GROUPS if m != "train"}
    states = _reference_states(dirs["train"])
    procs["train"] = _start("train", dirs["train"])
    yield procs, dirs, _reference_steps(states)
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _results(runs, mode, tag=None):
    procs, dirs, _ = runs
    proc = procs[mode]
    if proc.wait(timeout=600):
        with open(os.path.join(dirs[mode], "log.txt")) as f:
            pytest.fail(f.read()[-4000:])
    return [dict(np.load(os.path.join(dirs[mode], f"{tag or mode}{r}.npz")))
            for r in range(GROUPS[mode] if tag is None else 4)]


def _param_names(arch):
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tt
    return tt.named_params(tt.init_params(get_smoke_config(arch),
                                          torch.Generator(), torch.float32,
                                          "meta"))


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_sharded_gradients_equal_unsharded(runs, arch):
    from repro_torch.configs import get_smoke_config
    for got in _results(runs, "train"):
        l1, l2 = got[f"{arch}/loss"]
        assert abs(l2 - l1) <= 1e-5 * abs(l1), (l1, l2)
        g1, g2 = got[f"{arch}/grad_norm"]
        assert abs(g2 - g1) <= 1e-4 * abs(g1), (g1, g2)
        unembed = "embed" if get_smoke_config(arch).tie_embeddings \
            else "lm_head"
        names = list(got[f"{arch}/names"])
        assert len(names) == len(_param_names(arch))
        for n, err, top in zip(names, got[f"{arch}/grad_err"],
                               got[f"{arch}/grad_max"]):
            # the unembedding's gradient passes through bfloat16 (the
            # reference's rounding of the LM head), and each rank rounds
            # its own partial sum: it agrees to bfloat16's resolution
            tol = 2.0 ** -7 * top if n == unembed else 1e-5
            assert err <= tol, (n, err, top)


@pytest.mark.parametrize("arch", [a for a in TRAIN_ARCHS
                                  if a not in GRAD_ARCHS])
def test_sharded_moe_train_step(runs, arch):
    ref = runs[2][arch]
    for got in _results(runs, "train"):
        for k, rtol in (("loss", 2e-3), ("grad_norm", 2e-2)):
            unsharded, sharded = got[f"{arch}/{k}"]
            np.testing.assert_allclose(sharded, unsharded, rtol=rtol,
                                       err_msg=k)
            np.testing.assert_allclose(sharded, ref[k], rtol=rtol,
                                       err_msg=k)


def _grouped_reference():
    import torch
    from repro_torch.models import moe
    cfg = moe_parity_config()
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    leaves = {}
    for k, v in p.items():
        for n, t in (v.items() if isinstance(v, dict) else [("", v)]):
            leaves[f"{k}/{n}"] = t.requires_grad_()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (8, 32, 64)).astype(np.float32))
    y, aux = moe.moe_apply_grouped(p, x, cfg)
    grads = torch.autograd.grad((y ** 2).sum() + aux, list(leaves.values()))
    return (y.detach().numpy(), float(aux.detach()),
            {k: g.numpy() for k, g in zip(leaves, grads)})


@pytest.mark.parametrize("name", COMMS)
def test_moe_shuffle_over_model_group(runs, name):
    y, aux, grads = _grouped_reference()
    for got in _results(runs, "moe"):
        np.testing.assert_allclose(got[f"{name}/y"], y, atol=2e-4,
                                   rtol=1e-3)
        np.testing.assert_allclose(float(got[f"{name}/aux"]), aux,
                                   rtol=1e-4)
        for k, g in grads.items():
            np.testing.assert_allclose(got[f"{name}/grad/{k}"], g,
                                       atol=5e-3, rtol=5e-3, err_msg=k)


def test_elastic_restore_onto_smaller_mesh(runs):
    first = _results(runs, "elastic", "elastic1_")
    second = _results(runs, "elastic", "elastic2_")
    for r in range(4):
        assert int(first[r]["step"]) == 0
        assert int(second[r]["step"]) == ELASTIC_STEPS
        np.testing.assert_array_equal(second[r]["losses"],
                                      second[0]["losses"])
    losses = np.concatenate([first[0]["losses"], second[0]["losses"]])
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_serving_equals_unsharded(runs, arch):
    for got in _results(runs, "serve"):
        plain, sharded = got[f"{arch}/logits"]
        np.testing.assert_allclose(sharded, plain, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got[f"{arch}/tokens"][1],
                                      got[f"{arch}/tokens"][0])
        plain, sharded = got[f"{arch}/odd_decode"]
        np.testing.assert_allclose(sharded, plain, atol=1e-4, rtol=0)
        np.testing.assert_array_equal(got[f"{arch}/odd_tokens"][1],
                                      got[f"{arch}/odd_tokens"][0])


@pytest.mark.parametrize("impl", ["flash", "chunked", "dense"])
def test_sequence_parallel_attention(runs, impl):
    for got in _results(runs, "serve"):
        np.testing.assert_allclose(got[f"attn/{impl}"], got["attn/want"],
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
def test_sharded_train_step_over_nccl(tmp_path):
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards (NCCL takes one rank a card)")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "nccl",
                           str(tmp_path)], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for r in range(2):
        got = dict(np.load(tmp_path / f"nccl{r}.npz"))
        np.testing.assert_allclose(got["loss"][1], got["loss"][0], rtol=2e-3)
        np.testing.assert_allclose(got["grad_norm"][1], got["grad_norm"][0],
                                   rtol=2e-2)


if __name__ == "__main__":
    mode, d = sys.argv[1], sys.argv[2]
    if mode == "train":
        _spawn(_train_child, GROUPS["train"], d)
    elif mode == "moe":
        _spawn(_moe_child, GROUPS["moe"], d)
    elif mode == "elastic":
        _spawn(_elastic_child, GROUPS["elastic"], d, 1)
        _spawn(_elastic_child, 4, d, 2)
    elif mode == "serve":
        _spawn(_serve_child, GROUPS["serve"], d)
    elif mode == "nccl":
        _spawn(_nccl_child, 2, d)
