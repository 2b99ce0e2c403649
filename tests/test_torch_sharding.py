"""The port's sharding vocabulary against the JAX package's, in process.

* Spec trees: for all ten archs, at full width and at SMOKE size, under
  training rules for (data, model) = (4, 2), (2, 2) and (8, 1) and under
  serving rules for (4, 2), the port's ``param_specs``, ``cache_specs``,
  ``opt_specs``, ``state_specs`` and ``batch_specs`` equal the JAX
  package's entry for entry (both sides build ``ShardingRules``
  directly, no mesh).  The reference stacks its body layers on a leading
  ``(n_periods,)`` axis; its body entries are compared with that entry
  dropped.  A parameter's and a cache's stack entry is always None; a
  moment's may name a mesh axis (its 2-D ZeRO spec is computed on the
  stacked shape), and the port's rule (``train/step.py``) drops it: every
  such leaf is named, for the archs of the table in ``PERF.md``, with
  its reference and port specs.
* ``placements``: spec -> DTensor placements on a mesh's axis names, and
  its refusals.
* On a 1-rank gloo group (a (1, 1) ``("data", "model")`` mesh):
  ``constrain``, the kernel dispatchers refusing DTensors, the kernel
  call sites under ``local_map`` (flash, the SSD scan, the grouped MoE
  dispatch's radix bucketize) equal to the unsharded path, and
  ``moe_apply``'s choice of dispatch.
"""

import types

import jax
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as jt
from repro.models.layers import ShardingRules as JRules
from repro.train import step as jstep
from repro.train.optim import opt_specs as j_opt_specs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import transformer as tt
from repro_torch.models.layers import (NO_SHARDING, P, ShardingRules,
                                       constrain, placements)
from repro_torch.train import batch_specs, opt_specs, state_specs
from repro_torch.train.step import param_shapes

#: (name, data, model, serving)
RULES = (("train4x2", 4, 2, False), ("train2x2", 2, 2, False),
         ("train8x1", 8, 1, False), ("serve4x2", 4, 2, True))

#: stacked leaves whose reference moment spec names a mesh axis on the
#: stack axis, full width, training rules (4, 2); per stacked leaf (the
#: port holds one per layer of the period slot)
STACK_LEAVES = {"mamba2-780m": 6, "olmoe-1b-7b": 4, "qwen3-8b": 4,
                "jamba-v0.1-52b": 51, "deepseek-v2-lite-16b": 0}


def _rules(cls, data, model, serving):
    if serving:
        return cls(batch="data", fsdp=None, model="model", tp_weights=True,
                   model_size=model, data_size=data)
    return cls(batch="data", fsdp="data", model="model", model_size=model,
               data_size=data)


def _t(spec):
    return tuple(spec)


def _names(path):
    """A reference tree path -> the port's name fragment (norms' {"scale":
    w} is the port's w)."""
    return ".".join(str(k) for k in path if k != "scale")


def _leaves(tree):
    """{path tuple: spec} of a reference tree whose leaves are specs."""
    from jax.sharding import PartitionSpec
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]

    def key(k):
        return getattr(k, "key", getattr(k, "idx", None))
    return {tuple(key(k) for k in p): s for p, s in flat}


def _unstack(tree, cfg):
    """A reference spec tree -> ({port name: spec}, {port name: the stack
    entry}) with every body leaf's leading entry dropped."""
    n_prefix, period, n_periods = jt.layer_layout(cfg)
    out, stack = {}, {}
    for path, spec in _leaves(tree).items():
        if path[0] == "prefix":
            out[f"blocks.{path[1]}.{_names(path[2:])}"] = _t(spec)
        elif path[0] == "body":
            j, rest = path[2], _names(path[3:])
            for p in range(n_periods):
                name = f"blocks.{n_prefix + p * period + j}.{rest}"
                out[name] = _t(spec)[1:]
                stack[name] = _t(spec)[0]
        else:
            out[_names(path)] = _t(spec)
    return out, stack


def _cfgs(arch, size):
    if size == "full":
        return jax_config(arch), get_config(arch)
    return jax_smoke(arch), get_smoke_config(arch)


@pytest.mark.parametrize("rule", RULES, ids=[r[0] for r in RULES])
@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_equal_reference(arch, size, rule):
    cj, ct = _cfgs(arch, size)
    rj, rt = (_rules(c, *rule[1:]) for c in (JRules, ShardingRules))
    # parameters: the stack entry of a body parameter is always None
    want, stack = _unstack(jt.param_specs(cj, rj), cj)
    got = tt.param_specs(ct, rt)
    assert set(stack.values()) <= {None}
    assert {n: _t(s) for n, s in got.items()} == want
    assert sorted(got) == sorted(param_shapes(ct))
    # caches
    want_c, stack_c = _unstack(jt.cache_specs(cj, rj), cj)
    assert set(stack_c.values()) <= {None}
    got_c = {f"blocks.{i}.{n}": _t(s)
             for i, c in enumerate(tt.cache_specs(ct, rt))
             for n, s in c.items()}
    assert got_c == want_c
    # optimizer and train state
    ojt = j_opt_specs(jt.param_specs(cj, rj))
    ot = opt_specs(got)
    assert _t(ot["step"]) == _t(ojt["step"]) == ()
    assert {n: _t(s) for n, s in ot["m"].items()} == want
    sj, st = jstep.state_specs(cj, rj), state_specs(ct, rt)
    assert {n: _t(s) for n, s in st["params"].items()} == want
    for mom in ("m", "v"):
        want_m, stack_m = _unstack(sj["opt"][mom], cj)
        assert {n: _t(s) for n, s in st["opt"][mom].items()} == want_m
    # batches
    assert {k: _t(v) for k, v in batch_specs(ct, rt).items()} == \
        {k: _t(v) for k, v in jstep.batch_specs(cj, rj).items()}
    # the stack-axis leaves: the reference puts a mesh axis there only on
    # moments under training rules (at (4, 2): the table's counts at full
    # width, none at SMOKE size; at (2, 2) SMOKE and (8, 1) full some too)
    moved = {n: a for n, a in stack_m.items() if a is not None}
    if rule[0] == "train4x2" and arch in STACK_LEAVES:
        n_periods = jt.layer_layout(cj)[2]
        per_leaf = STACK_LEAVES[arch] if size == "full" else 0
        assert len(moved) == per_leaf * n_periods, sorted(moved)[:8]
    if rule[3]:
        assert not moved


def test_stack_axis_rule_named_leaves():
    """The table's examples: the reference's moment spec on the stacked
    leaf, and the port's per layer with the stack entry dropped."""
    rj = _rules(JRules, 4, 2, False)
    rt = _rules(ShardingRules, 4, 2, False)
    cases = {
        "mamba2-780m": {"mixer.a_log": ("model", "data"),
                        "mixer.d_skip": ("model", "data"),
                        "mixer.dt_bias": ("model", "data"),
                        "mixer.conv": ("data", None, "model")},
        "olmoe-1b-7b": {"norm1": ("data", "model")},
        "qwen3-8b": {"norm1": ("data", "model")},
    }
    for arch, leaves in cases.items():
        cj, ct = _cfgs(arch, "full")
        stacked = _leaves(jstep.state_specs(cj, rj)["opt"]["m"])
        port = state_specs(ct, rt)["opt"]["m"]
        n_prefix = jt.layer_layout(cj)[0]
        for leaf, ref in leaves.items():
            path = ("body", "layers", 0) + tuple(leaf.split(".")) + (
                ("scale",) if leaf.startswith("norm") else ())
            assert _t(stacked[path]) == ref, (arch, leaf)
            assert _t(port[f"blocks.{n_prefix}.{leaf}"]) == ref[1:]


# ---------------------------------------------------------------------- #
# placements
# ---------------------------------------------------------------------- #
def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert placements(P("data", None), mesh) == [Shard(0), Replicate()]
    assert placements(P(None, "model", None), mesh) == [Replicate(),
                                                        Shard(1)]
    assert placements(P(), mesh) == [Replicate(), Replicate()]
    assert placements(P("model", "data"), mesh) == [Shard(1), Shard(0)]
    # two axes on one dim shard it over both, in mesh order
    assert placements(P(("data", "model"), None), mesh) == [Shard(0),
                                                           Shard(0)]
    pod = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert placements(P(("pod", "data"), "model"), pod) == [
        Shard(0), Shard(0), Shard(1)]
    with pytest.raises(ValueError, match="mesh's order"):
        placements(P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="names mesh axis 'pod'"):
        placements(P("pod"), mesh)
    with pytest.raises(ValueError, match="twice"):
        placements(P("data", "data"), mesh)


def test_rules_logical_and_enabled():
    r = _rules(ShardingRules, 4, 2, False)
    assert r.logical("batch", "fsdp", "model", "tp", None) == P(
        "data", "data", "model", None, None)
    s = _rules(ShardingRules, 4, 2, True)
    assert s.logical("fsdp", "tp") == P(None, "model")
    assert r.enabled and s.enabled and not NO_SHARDING.enabled
    with pytest.raises(ValueError):
        r.logical("heads")
    assert repr(P("data", None)) == "P('data', None)"


# ---------------------------------------------------------------------- #
# A 1-rank gloo group: DTensors on a (1, 1) mesh
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    d = tmp_path_factory.mktemp("pg")
    dist.init_process_group("gloo", init_method=f"file://{d}/rv", rank=0,
                            world_size=1)
    try:
        yield make_local_mesh(model=1)
    finally:
        dist.destroy_process_group()


def test_mesh_presets(mesh):
    from repro_torch.launch.mesh import rules_for_mesh, serve_rules_for_mesh
    assert mesh.mesh_dim_names == ("data", "model")
    assert rules_for_mesh(mesh) == ShardingRules(
        batch="data", fsdp="data", model="model", model_size=1, data_size=1)
    assert serve_rules_for_mesh(mesh) == ShardingRules(
        batch="data", fsdp=None, model="model", tp_weights=True,
        model_size=1, data_size=1)
    one = types.SimpleNamespace(mesh_dim_names=("df",), shape=(4,))
    assert rules_for_mesh(one) == ShardingRules(batch="df", fsdp="df")


def test_constrain(mesh):
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.models.layers import distribute, set_mesh
    x = torch.randn(4, 6)
    assert constrain(x, NO_SHARDING, "batch", None) is x
    rules = _rules(ShardingRules, 1, 1, False)
    # rules but no current mesh: the stacked ranks of one device
    assert constrain(x, rules, "batch", None) is x
    with set_mesh(mesh):
        with pytest.raises(TypeError, match="local_map"):
            constrain(x, rules, "batch", None)
        d = distribute(x, P(), mesh)
        c = constrain(d, rules, "batch", "model")
        assert list(c.placements) == [Shard(0), Shard(1)]
        assert list(d.placements) == [Replicate(), Replicate()]
        assert torch.equal(c.full_tensor(), x)


def test_kernel_dispatchers_refuse_dtensors(mesh):
    from repro_torch.kernels import (flash_attention, radix_partition,
                                     segmented_sum, ssd_scan)
    from repro_torch.models.layers import distribute

    def dt(t):
        return distribute(t, P(), mesh)
    q = torch.randn(1, 2, 8, 16)
    calls = {
        "flash_attention": lambda: flash_attention(dt(q), dt(q), dt(q)),
        "radix_partition": lambda: radix_partition(
            dt(torch.zeros((1, 8), dtype=torch.int32)), 4),
        "segmented_sum": lambda: segmented_sum(
            dt(torch.zeros((1, 8), dtype=torch.int32)),
            dt(torch.ones((1, 8))), 4),
        "ssd_scan": lambda: ssd_scan(*(dt(torch.randn(s)) for s in (
            (2, 8, 4), (2, 8, 1), (2, 1), (2, 8, 3), (2, 8, 3)))),
    }
    for name, call in calls.items():
        with pytest.raises(TypeError, match=f"{name} takes local tensors.*"
                                            f"local_map"):
            call()


@pytest.mark.parametrize("impl", ["flash", "chunked", "dense"])
def test_attention_on_a_mesh_equals_unsharded(mesh, impl):
    from repro_torch.models.attention import attention_impl
    from repro_torch.models.layers import distribute, set_mesh
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 4, 24, 16, generator=g) for _ in range(3))
    k, v = k[:, :2], v[:, :2]
    want = attention_impl(q, k, v, impl=impl)
    rules = _rules(ShardingRules, 1, 1, False)
    with set_mesh(mesh):
        got = attention_impl(*(distribute(t, P(), mesh) for t in (q, k, v)),
                             impl=impl, rules=rules)
    torch.testing.assert_close(got.full_tensor(), want, atol=1e-6,
                               rtol=1e-6)


def test_mamba_scan_under_local_map(mesh):
    from repro_torch.models import mamba2
    from repro_torch.models.layers import distribute, set_mesh
    from repro_torch.models.transformer import place
    cfg = get_smoke_config("mamba2-780m")
    p = mamba2.mamba_init(torch.Generator().manual_seed(0), cfg,
                          torch.float32, "cpu")
    u = torch.randn(2, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    want = mamba2.mamba_forward(p, u, cfg, "kernel", return_state=True)
    rules = _rules(ShardingRules, 1, 1, False)
    with set_mesh(mesh):
        ps = place(p, mamba2.mamba_specs(cfg, rules), mesh)
        us = distribute(u, P("data", "model", None), mesh)
        got = mamba2.mamba_forward(ps, us, cfg, "kernel", True, rules)
    for w, g in zip(want, got):
        torch.testing.assert_close(g.full_tensor(), w, atol=1e-6, rtol=1e-6)


def test_moe_apply_picks_the_reference_dispatch(monkeypatch):
    from repro_torch.models import moe
    seen = []
    monkeypatch.setattr(moe, "moe_apply_shuffle",
                        lambda *a: seen.append("shuffle"))
    monkeypatch.setattr(moe, "moe_apply_grouped",
                        lambda *a: seen.append("grouped"))
    cfg = get_smoke_config("olmoe-1b-7b")
    x = torch.zeros((2, 8, cfg.d_model))
    for rules, want in (
            (NO_SHARDING, "grouped"),
            (_rules(ShardingRules, 4, 2, True), "grouped"),       # serve
            (_rules(ShardingRules, 4, 2, False), "shuffle"),      # SP train
            (_rules(ShardingRules, 8, 1, False), "shuffle"),
            (_rules(ShardingRules, 1, 3, False), "grouped"),      # 8 % 3
            (ShardingRules(batch="df", fsdp="df"), "grouped")):   # no model
        seen.clear()
        moe.moe_apply(None, x, cfg, rules)
        assert seen == [want], rules


def test_grouped_dispatch_on_a_mesh_equals_unsharded(mesh):
    from repro_torch.models import moe
    from repro_torch.models.layers import distribute, set_mesh
    from repro_torch.models.transformer import place
    cfg = get_smoke_config("olmoe-1b-7b")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32,
                     "cpu")
    x = torch.randn(2, 8, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    y0, aux0 = moe.moe_apply_grouped(p, x, cfg)
    rules = _rules(ShardingRules, 1, 1, True)
    with set_mesh(mesh):
        y, aux = moe.moe_apply(place(p, moe.moe_specs(cfg, rules), mesh),
                               distribute(x, P(), mesh), cfg, rules)
    torch.testing.assert_close(y.full_tensor(), y0, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(aux.full_tensor(), aux0, atol=1e-7,
                               rtol=1e-5)
