"""The port's dry run on a production mesh (``repro_torch.launch.dryrun``,
``counting``, ``report``, the rest of ``roofline`` and
``mesh.make_production_mesh``; ROADMAP item 13.7) against the JAX
package's, on the CPU.

* The wire model (``_wire_bytes``) equals the reference's over every op
  and p in {1, 2, 16}.
* Four reshards of one (64, 32) float32 array over 8 ranks: the
  reference's ``parse_collectives`` reads them from the compiled HLO on 8
  host devices (a subprocess), the port's ``StepCounter`` from DTensor's
  redistribution on an 8-rank fake group: ``count``, ``result_bytes``
  and ``wire_bytes`` equal for the all-gather, the all-reduce and the
  all-to-all.  XLA's CPU backend lowers the reduce-scatter as an
  all-reduce of the whole sum and a slice: that case is held to that
  lowering (one all-reduce of p times the port's scattered bytes).
* Per-device argument bytes of every arch's ``train_4k`` cell (state and
  batch) on rank 0 of the (16, 16) mesh equal the reference's sum of
  ceiling-padded shard bytes over the same leaves, from ``eval_shape`` in
  a 256-device subprocess; where the reference's moment spec shards the
  stack axis, that leaf is counted the port's way (the stack entry
  dropped: ``train/step.py``) and named.
* Counting: a sharded ``mm`` on a fake (16, 16) mesh counts its local
  FLOPs only; a SMOKE prefill at L, 2L and 3L layers grows by the same
  work each L (every layer counted, the same prefix); the kernels'
  operators' fake outputs have their plain versions' shapes and dtypes
  over a grid and raise the launch's ``ValueError``s; no CPU kernel.
* End to end, each in a subprocess started by a module fixture: the
  command line on card stand-ins for llama3.2-3b ``prefill_32k`` (28 flash
  calls) and mamba2-780m ``prefill_32k`` (48 SSD calls) on (16, 16) and
  olmoe-1b-7b ``decode_32k`` on (2, 16, 16) (16 radix calls); five archs'
  train cells at SMOKE size on cpu stand-ins over a (4, 2) fake mesh; no
  process group left behind.
* ``report``'s three tables and ``splice`` equal the reference's for the
  same rows, ``analyze`` equals the reference's with its TPU constants
  monkeypatched to the H100's peaks, ``format_table`` equals.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \\
        tests/test_torch_dryrun.py
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ARCHS = ("qwen3-8b", "mamba2-780m", "olmoe-1b-7b", "jamba-v0.1-52b",
         "llama3.2-3b", "qwen3-32b", "gemma-7b", "deepseek-v2-lite-16b",
         "llava-next-34b", "musicgen-large")
OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
       "collective-permute")
#: the command-line cells: (arch, shape, --multi-pod, operator, calls)
CLI_CELLS = (("llama3.2-3b", "prefill_32k", False, "flash_attention", 28),
             ("mamba2-780m", "prefill_32k", False, "ssd_scan", 48),
             ("olmoe-1b-7b", "decode_32k", True, "radix_partition", 16))
TRAIN_SMOKE = ("llama3.2-3b", "mamba2-780m", "olmoe-1b-7b", "jamba-v0.1-52b",
               "deepseek-v2-lite-16b")
#: the reshards: array (64, 32) float32 over 8 ranks, in -> out specs
RESHARD_SHAPE = (64, 32)
RANKS = 8


# ---------------------------------------------------------------------- #
# Children (this file run as a script: ``<mode> <dir>``)
# ---------------------------------------------------------------------- #
def _reference_child(d):
    """The JAX side on 256 host devices: the reshards' collectives on the
    first 8, and every arch's train_4k argument bytes on (16, 16)."""
    from functools import partial
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as JP
    from repro.configs import get_config
    from repro.launch import roofline as jroof
    from repro.launch.mesh import rules_for_mesh
    from repro.launch.shapes import train_batch_specs
    from repro.models import transformer as jt
    from repro.train.optim import init_opt_state
    from repro.train.step import batch_specs, state_specs
    out = {"collectives": {}, "args": {}, "restacked": {}}
    mesh8 = Mesh(np.array(jax.devices()[:RANKS]), ("x",))
    x = jax.ShapeDtypeStruct(RESHARD_SHAPE, jnp.float32)
    for name, fn, spec_in, spec_out in (
            ("all-gather", lambda v: v, JP("x", None), JP()),
            ("all-reduce", lambda v: v.sum(0), JP("x", None), JP()),
            ("reduce-scatter", lambda v: v.sum(0), JP("x", None), JP("x")),
            ("all-to-all", lambda v: v, JP("x", None), JP(None, "x"))):
        compiled = jax.jit(fn, in_shardings=NamedSharding(mesh8, spec_in),
                           out_shardings=NamedSharding(mesh8, spec_out)
                           ).lower(x).compile()
        out["collectives"][name] = jroof.parse_collectives(
            compiled.as_text())
    mesh = jax.make_mesh((16, 16), ("data", "model"))
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    rules = rules_for_mesh(mesh)

    def shard_bytes(shape, dtype, spec):
        n = np.dtype(dtype).itemsize
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for dim, e in zip(shape, entries):
            ways = math.prod(sizes[a] for a in (
                e if isinstance(e, tuple) else (e,)) if a is not None)
            n *= -(-dim // ways)
        return n

    for arch in ARCHS:
        cfg = get_config(arch)
        params = jax.eval_shape(partial(jt.init_params, cfg=cfg),
                                jax.ShapeDtypeStruct((2,), jnp.uint32))
        state = {"params": params,
                 "opt": jax.eval_shape(init_opt_state, params)}
        total, restacked = 0, []

        def leaf(path, spec, sh):
            nonlocal total
            keys = [str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path]
            if "body" in keys and len(spec) and spec[0] is not None:
                # a moment sharded over the stack axis: the port's
                # per-layer leaves drop that entry
                restacked.append("/".join(keys))
                spec = JP(None, *spec[1:])
            total += shard_bytes(sh.shape, sh.dtype, spec)
        jax.tree_util.tree_map_with_path(
            leaf, state_specs(cfg, rules), state,
            is_leaf=lambda v: isinstance(v, JP))
        bspecs = batch_specs(cfg, rules)
        for k, sh in train_batch_specs(cfg, 256, 4096).items():
            total += shard_bytes(sh.shape, sh.dtype, bspecs[k])
        out["args"][arch] = total
        out["restacked"][arch] = restacked
    with open(os.path.join(d, "reference.json"), "w") as f:
        json.dump(out, f)


def _cli_child(d, arch, shape, multi_pod):
    from repro_torch.launch import dryrun
    sys.argv = ["dryrun", "--arch", arch, "--shape", shape, "--out", d] + (
        ["--multi-pod"] if multi_pod else [])
    dryrun.main()
    import torch.distributed as dist
    with open(os.path.join(d, "group.json"), "w") as f:
        json.dump({"left": dist.is_initialized()}, f)


def _smoke_train_child(d):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import Cell
    with dryrun.fake_group(RANKS):
        mesh = init_device_mesh("cpu", (RANKS // 2, 2),
                                mesh_dim_names=("data", "model"))
        for arch in TRAIN_SMOKE:
            dryrun.run_cell(Cell(arch, "train_4k", "train", 8, 32, True),
                            mesh, "local", d, ce_chunk=16,
                            cfg_override=get_smoke_config(arch))
    import torch.distributed as dist
    with open(os.path.join(d, "group.json"), "w") as f:
        json.dump({"left": dist.is_initialized()}, f)


def _start(d, *args, devices=None):
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(SRC), here]), JAX_PLATFORMS="cpu",
        OMP_NUM_THREADS="1")
    if devices:
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    log = open(os.path.join(d, "log.txt"), "w")
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), d]
                            + [str(a) for a in args], stdout=log,
                            stderr=subprocess.STDOUT, env=env)


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """The reference side, the command-line cells and the SMOKE train
    cells, started at once, before the file's first test."""
    dirs, procs = {}, {}
    dirs["reference"] = str(tmp_path_factory.mktemp("reference"))
    procs["reference"] = _start(dirs["reference"], "reference", devices=256)
    for arch, shape, multi, _, _ in CLI_CELLS:
        key = f"{arch}/{shape}"
        dirs[key] = str(tmp_path_factory.mktemp(arch))
        procs[key] = _start(dirs[key], "cli", arch, shape, int(multi))
    dirs["smoke"] = str(tmp_path_factory.mktemp("smoke"))
    procs["smoke"] = _start(dirs["smoke"], "smoke")
    yield procs, dirs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _done(runs, key):
    procs, dirs = runs
    if procs[key].wait(timeout=600):
        with open(os.path.join(dirs[key], "log.txt")) as f:
            pytest.fail(f.read()[-4000:])
    return dirs[key]


def _reference(runs):
    with open(os.path.join(_done(runs, "reference"), "reference.json")) as f:
        return json.load(f)


def _cell(runs, arch, shape):
    d = _done(runs, f"{arch}/{shape}")
    sub = next(s for s in ("single_pod", "multi_pod")
               if os.path.isdir(os.path.join(d, s)))
    with open(os.path.join(d, sub, f"{arch}__{shape}.json")) as f:
        row = json.load(f)
    with open(os.path.join(d, "group.json")) as f:
        return row, json.load(f)["left"]


def _rows(runs):
    return [_cell(runs, a, s)[0] for a, s, _, _, _ in CLI_CELLS]


# ---------------------------------------------------------------------- #
# The wire model and the collectives
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("p", [1, 2, 16])
@pytest.mark.parametrize("op", OPS)
def test_wire_bytes_equal_reference(op, p):
    from repro.launch.roofline import _wire_bytes as jwire
    from repro_torch.launch.roofline import _wire_bytes
    for b in (0, 4, 1 << 20, 3 * 5 * 7):
        assert _wire_bytes(op, b, p) == jwire(op, b, p)


@pytest.fixture
def fake8():
    from repro_torch.launch import dryrun
    with dryrun.fake_group(RANKS):
        yield
    import torch.distributed as dist
    assert not dist.is_initialized()


def _port_reshard(name):
    """StepCounter's collectives of the port's reshard ``name`` of a
    (64, 32) float32 DTensor on an 8-rank fake mesh (card stand-ins)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch import dryrun
    from repro_torch.launch.counting import StepCounter
    from repro_torch.models.layers import P
    mesh = init_device_mesh("cuda", (RANKS,), mesh_dim_names=("x",))
    with dryrun.stand_ins():
        x = dryrun.stand_in(RESHARD_SHAPE, torch.float32, P("x", None), mesh)
        steps = {
            "all-gather": lambda: x.redistribute(mesh, [Replicate()]),
            "all-reduce": lambda: x.sum(0).redistribute(mesh, [Replicate()]),
            "reduce-scatter": lambda: x.sum(0).redistribute(mesh,
                                                            [Shard(0)]),
            "all-to-all": lambda: x.redistribute(mesh, [Shard(1)])}
        steps[name]()                   # DTensor's propagation, cached
        with StepCounter([x]) as counter:
            counter.finish(steps[name]())
    return counter.collectives


@pytest.mark.parametrize("name", ["all-gather", "all-reduce", "all-to-all"])
def test_collectives_equal_reference_hlo(runs, fake8, name):
    want = _reference(runs)["collectives"][name]
    got = _port_reshard(name)
    for op in OPS:
        for k in ("count", "result_bytes", "wire_bytes"):
            assert got[op][k] == want[op][k], (op, k, got[op], want[op])
    assert got["total_wire_bytes"] == want["total_wire_bytes"]
    assert got[name]["count"] == 1


def test_reduce_scatter_against_xlas_all_reduce_lowering(runs, fake8):
    # XLA's CPU backend lowers "sum over the sharded dim, result sharded"
    # as an all-reduce of the whole sum and a slice; the port's DTensor
    # issues the reduce-scatter, whose result is one rank's share
    want = _reference(runs)["collectives"]["reduce-scatter"]
    got = _port_reshard("reduce-scatter")
    assert want["reduce-scatter"]["count"] == 0
    assert want["all-reduce"]["count"] == 1
    assert got["reduce-scatter"]["count"] == 1
    assert sum(got[op]["count"] for op in OPS) == 1
    share = got["reduce-scatter"]["result_bytes"]
    assert share * RANKS == want["all-reduce"]["result_bytes"]
    assert got["reduce-scatter"]["wire_bytes"] == share * (RANKS - 1)


def test_point_to_point_sends_are_counted(fake8):
    # the ring schedule's sends: a collective-permute each, one rank's
    # (4, 3) float32 block a step
    from repro_torch.comm.process_group import process_group_communicator
    from repro_torch.launch.counting import StepCounter
    comm = process_group_communicator("ring")
    assert not comm._staged(torch.device("cuda"))
    x = torch.zeros((1, RANKS, 4, 3), dtype=torch.float32)
    with StepCounter([x]) as counter:
        comm.all_to_all(x)
    cp = counter.collectives["collective-permute"]
    assert cp["count"] == RANKS - 1
    assert cp["result_bytes"] == (RANKS - 1) * 4 * 3 * 4
    assert cp["wire_bytes"] == cp["result_bytes"]


# ---------------------------------------------------------------------- #
# The production mesh and the arguments
# ---------------------------------------------------------------------- #
def test_production_mesh_needs_256_or_512_ranks(fake8):
    from repro_torch.launch import make_production_mesh
    from repro_torch.launch.mesh import make_local_mesh
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)
    assert make_local_mesh(model=2).device_type == "cuda"


def test_fake_group_refuses_a_second_group(fake8):
    from repro_torch.launch import dryrun
    with pytest.raises(RuntimeError, match="already has a default group"):
        with dryrun.fake_group(2):
            pass


def test_production_meshes():
    from repro_torch.launch import dryrun, make_production_mesh
    for world, multi, shape, names in (
            (256, False, (16, 16), ("data", "model")),
            (512, True, (2, 16, 16), ("pod", "data", "model"))):
        with dryrun.fake_group(world):
            mesh = make_production_mesh(multi_pod=multi)
            assert tuple(mesh.shape) == shape
            assert mesh.mesh_dim_names == names
            assert mesh.device_type == "cuda"


@pytest.mark.parametrize("arch", ARCHS)
def test_argument_bytes_equal_reference(runs, arch):
    from repro_torch.launch import dryrun
    from repro_torch.launch.counting import StepCounter
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.shapes import cell
    ref = _reference(runs)
    with dryrun.fake_group(256):
        mesh = make_production_mesh(device_type="cpu")
        with dryrun.stand_ins():
            _, arguments = dryrun.build_step(cell(arch, "train_4k"), mesh)
            got = StepCounter(arguments).argument_bytes
    assert got == ref["args"][arch], (arch, got, ref["args"][arch],
                                      ref["restacked"][arch])


def test_train_cell_on_card_stand_ins_needs_cuda(fake8):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import Cell
    if torch.backends.cuda.is_built():
        pytest.skip("this torch has CUDA: card train cells run")
    mesh = init_device_mesh("cuda", (4, 2), mesh_dim_names=("data", "model"))
    with pytest.raises(RuntimeError, match="built with CUDA"):
        dryrun.run_cell(Cell("llama3.2-3b", "train_4k", "train", 8, 32, True),
                        mesh, "local", "",
                        cfg_override=get_smoke_config("llama3.2-3b"))


@pytest.mark.parametrize("arch,impl", [("llama3.2-3b", "chunked"),
                                       ("jamba-v0.1-52b", "chunked"),
                                       ("mamba2-780m", "auto")])
def test_train_cells_take_chunked_attention(fake8, monkeypatch, arch, impl):
    # flash has no backward; an attention-free arch keeps the SSD kernel
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import Cell
    seen = {}
    monkeypatch.setattr(dryrun, "make_train_step",
                        lambda *a, **kw: seen.update(kw))
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    with dryrun.stand_ins():
        dryrun.build_step(Cell(arch, "train_4k", "train", 8, 32, True), mesh,
                          cfg_override=get_smoke_config(arch))
    assert seen["impl"] == impl


# ---------------------------------------------------------------------- #
# Indexing of card stand-ins on a torch built without CUDA
# ---------------------------------------------------------------------- #
def _index_forms():
    i, j, k = torch.tensor([0, 2]), torch.tensor([3, 1]), torch.tensor([2])
    mask = torch.tensor([True, False, True, True])
    mask2 = torch.arange(20).reshape(4, 5) % 3 == 0
    mask56 = torch.arange(30).reshape(5, 6) % 4 == 1
    return {
        "int": (1,), "negative int": (-1,), "slice": (slice(1, 3),),
        "stepped slice": (slice(None, None, 2),),
        "negative slice": (slice(-3, None), None, 2),
        "ellipsis last": (0, Ellipsis), "ellipsis first": (Ellipsis, 0),
        "ellipsis between": (0, Ellipsis, slice(1, None)),
        "none": (None, Ellipsis, None), "tensor": (i,),
        "tensor on dim 1": (slice(None), j),
        "tensors apart": (i, slice(None), j),
        "tensors together": (slice(None), j, i),
        "ellipsis and tensor": (Ellipsis, i),
        "int and tensor": (1, None, i),
        "mask": (mask,), "mask of two dims": (mask2,),
        "mask of two dims and ellipsis": (mask2, Ellipsis),
        "mask of two dims and int": (mask2, 0),
        "mask of two dims, slice, tensor": (mask2, slice(None), k),
        "mask, ellipsis, int": (mask2, Ellipsis, 1),
        "tensor, mask of two dims": (k, mask56),
        "slice, mask of two dims, tensor": (slice(1, 3), mask56, k),
    }


@pytest.mark.parametrize("form", list(_index_forms()))
def test_stand_in_indexing_equals_built_in(form):
    # the dispatcher-level indexing the stand-ins take, held to Python's
    # own on CPU tensors: the same values read, the same values written
    from repro_torch.launch import dryrun
    idx = _index_forms()[form]
    t = torch.arange(4 * 5 * 6 * 4, dtype=torch.float32).reshape(4, 5, 6, 4)
    want = t[idx]
    got = dryrun._index(t, idx)
    assert got.shape == want.shape and torch.equal(got, want)
    for value in (-1.0, torch.full(want.shape, -2.0),
                  torch.full(want.shape, -3.0, dtype=torch.float64)):
        a, b = t.clone(), t.clone()
        try:
            a[idx] = value
        except RuntimeError:        # what Python refuses, the substitute
            with pytest.raises(RuntimeError):
                dryrun._setitem(b, idx, value)
            continue
        dryrun._setitem(b, idx, value)
        assert torch.equal(a, b), (form, value)


def test_stand_in_indexing_leaves_other_tensors_alone(monkeypatch):
    # inside the block only fake card tensors take the substitute
    from repro_torch.launch import dryrun

    def refuse(*a):
        raise AssertionError("a tensor that is no stand-in was rerouted")
    monkeypatch.setattr(dryrun, "_index", refuse)
    monkeypatch.setattr(dryrun, "_setitem", refuse)
    t = torch.arange(6.0).reshape(2, 3)
    with dryrun._card_indexing():
        t[0, 1] = 7.0
        assert t[0, 1].item() == 7.0
        assert torch.equal(t.t().contiguous(), t.t().clone())
    for form in (True, [0, 1]):
        with pytest.raises(TypeError):
            dryrun._getitem(t, form)


# ---------------------------------------------------------------------- #
# Counting
# ---------------------------------------------------------------------- #
def test_sharded_mm_counts_local_flops():
    from torch.distributed.tensor import Shard
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.launch import dryrun
    from repro_torch.launch.counting import StepCounter
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.layers import P
    with dryrun.fake_group(256):
        mesh = make_production_mesh()
        with dryrun.stand_ins():
            x = dryrun.stand_in((1024, 4096), torch.float32,
                                P("data", None), mesh)
            w = dryrun.stand_in((4096, 4096), torch.float32,
                                P(None, "model"), mesh)
            with FlopCounterMode(display=False) as global_count:
                x @ w                   # DTensor's propagation: global
            with StepCounter([x, w]) as counter:
                y = x @ w
                counter.finish(y)
    assert y.placements == (Shard(0), Shard(1))
    assert counter.flops == 2 * 64 * 4096 * 256
    assert global_count.get_total_flops() == 2 * 1024 * 4096 * 4096
    assert counter.memory_analysis == {
        "argument_size_in_bytes": 4 * (64 * 4096 + 4096 * 256),
        "output_size_in_bytes": 4 * 64 * 256,
        "temp_size_in_bytes": 4 * 64 * 256}
    assert not any(v["count"] for k, v in counter.collectives.items()
                   if k != "total_wire_bytes")


def test_every_layer_is_counted():
    # a SMOKE prefill through the flash operator at L, 2L and 3L layers
    # on a fake (2, 2) mesh: each L adds the same counts
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.shapes import Cell
    base = get_smoke_config("qwen3-8b")
    n = base.num_layers
    got = []
    with dryrun.fake_group(4):
        mesh = make_local_mesh(model=2)
        for k in (1, 2, 3):
            r = dryrun.run_cell(
                Cell("qwen3-8b", "prefill_32k", "prefill", 4, 64, True), mesh,
                "local", "", extra={"impl": "flash"},
                cfg_override=dataclasses.replace(base, num_layers=k * n))
            got.append(r)
    assert [r["kernel_calls"]["flash_attention"] for r in got] == \
        [n, 2 * n, 3 * n]

    def diffs(f):
        v = [f(r) for r in got]
        return v[1] - v[0], v[2] - v[1]
    for f in (lambda r: r["cost_analysis"]["flops"],
              lambda r: r["cost_analysis"]["bytes accessed"],
              lambda r: r["collectives"]["total_wire_bytes"],
              lambda r: r["memory_analysis"]["argument_size_in_bytes"],
              *(lambda r, op=op: r["collectives"][op]["count"] for op in OPS),
              *(lambda r, op=op: r["collectives"][op]["result_bytes"]
                for op in OPS)):
        a, b = diffs(f)
        assert a == b
    assert diffs(lambda r: r["cost_analysis"]["flops"])[0] > 0
    assert diffs(lambda r: r["collectives"]["total_wire_bytes"])[0] > 0


# ---------------------------------------------------------------------- #
# The kernels' operators
# ---------------------------------------------------------------------- #
def _fake(*shapes_dtypes):
    return [torch.empty(s, dtype=dt, device="cuda") for s, dt in shapes_dtypes]


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,dtype", [
    (1, 2, 2, 8, 8, 16, True, F32), (2, 4, 2, 5, 9, 32, True, BF16),
    (1, 3, 1, 7, 7, 64, False, F32), (2, 2, 2, 3, 10, 128, False, BF16),
    (1, 1, 1, 1, 1, 256, True, F32)])
def test_flash_operator_fake_matches_plain(b, hq, hkv, sq, sk, d, causal,
                                           dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import attention_ref, flash_attention_cuda
    from repro_torch.kernels.flash_attention.ops import flash_flops
    from torch.utils.flop_counter import FlopCounterMode
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, hq, sq, d, generator=g).to(dtype)
    k, v = (torch.randn(b, hkv, sk, d, generator=g).to(dtype)
            for _ in range(2))
    want = attention_ref(q, k, v, causal=causal)
    before = flash_attention_cuda.launches
    with FakeTensorMode():
        fq, fk, fv = _fake(((b, hq, sq, d), dtype), ((b, hkv, sk, d), dtype),
                           ((b, hkv, sk, d), dtype))
        with FlopCounterMode(display=False) as fc:
            got = torch.ops.repro_torch.flash_attention(fq, fk, fv, causal,
                                                        None)
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    assert fc.get_total_flops() == flash_flops(sq, sk, d, b * hq, causal)
    assert flash_attention_cuda.launches == before


@pytest.mark.parametrize("case,match", [
    (dict(d=48), "head dims"), (dict(dtype=torch.float16), "float32 or"),
    (dict(sq=9, sk=8), "Sq <= Sk"), (dict(hq=3, hkv=2), "multiple of kv"),
    (dict(kdtype=BF16), "float32 or")])
def test_flash_operator_fake_raises_the_launchs_errors(case, match):
    from torch._subclasses.fake_tensor import FakeTensorMode
    c = dict(b=1, hq=2, hkv=2, sq=4, sk=8, d=64, dtype=F32, kdtype=None)
    c.update(case)
    kd = c["kdtype"] or c["dtype"]
    with FakeTensorMode():
        q, k, v = _fake(((c["b"], c["hq"], c["sq"], c["d"]), c["dtype"]),
                        ((c["b"], c["hkv"], c["sk"], c["d"]), kd),
                        ((c["b"], c["hkv"], c["sk"], c["d"]), kd))
        with pytest.raises(ValueError, match=match):
            torch.ops.repro_torch.flash_attention(q, k, v, True, None)


@pytest.mark.parametrize("bh,t,p,n,chunk", [
    (2, 10, 4, 8, 8), (3, 33, 64, 128, 128), (1, 1, 1, 1, 1),
    (4, 100, 16, 16, 32)])
def test_ssd_operator_fake_matches_plain(bh, t, p, n, chunk):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels import ssd_scan, ssd_scan_chunked, ssd_scan_cuda
    from repro_torch.kernels.ssd_scan.ops import ssd_counts
    shapes = [(bh, t, p), (bh, t, 1), (bh, 1), (bh, t, n), (bh, t, n)]
    g = torch.Generator().manual_seed(0)
    want = ssd_scan_chunked(*(torch.randn(s, generator=g) for s in shapes),
                            chunk=chunk)
    before = ssd_scan_cuda.launches
    with FakeTensorMode():
        with FlopCounterMode(display=False) as fc:
            got = ssd_scan(*_fake(*((s, F32) for s in shapes)), chunk=chunk)
    for g_, w in zip(got, want):
        assert (tuple(g_.shape), g_.dtype) == (tuple(w.shape), w.dtype)
    ch = min(chunk, -(-t // 8) * 8)
    assert fc.get_total_flops() == ssd_counts(bh, t, p, n, ch)[0]
    assert ssd_scan_cuda.launches == before


@pytest.mark.parametrize("case,match", [
    (dict(p=65), "P <= 64"), (dict(n=129), "N <= 128"),
    (dict(chunk=129), "chunk <= 128"), (dict(dtype=BF16), "float32"),
    (dict(dt_shape=(2, 8)), "dt has shape")])
def test_ssd_operator_fake_raises_the_launchs_errors(case, match):
    from torch._subclasses.fake_tensor import FakeTensorMode
    c = dict(bh=2, t=8, p=4, n=8, chunk=8, dtype=F32, dt_shape=None)
    c.update(case)
    bh, t, p, n = c["bh"], c["t"], c["p"], c["n"]
    with FakeTensorMode():
        x, dt, a, b, cc = _fake(((bh, t, p), c["dtype"]),
                                (c["dt_shape"] or (bh, t, 1), F32),
                                ((bh, 1), F32), ((bh, t, n), F32),
                                ((bh, t, n), F32))
        with pytest.raises(ValueError, match=match):
            torch.ops.repro_torch.ssd_scan(x, dt, a, b, cc, c["chunk"])


@pytest.mark.parametrize("p,n,nb", [(1, 1, 1), (4, 100, 9), (2, 9000, 300),
                                    (8, 0, 5)])
def test_radix_operator_fake_matches_plain(p, n, nb):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.kernels import (radix_partition, radix_partition_cuda,
                                     radix_partition_ref)
    dest = torch.from_numpy(np.random.default_rng(0).integers(
        0, nb, (p, n)).astype(np.int32))
    want = radix_partition_ref(dest, nb)
    before = radix_partition_cuda.launches
    with FakeTensorMode():
        got = radix_partition(*_fake(((p, n), torch.int32)), nb)
    for g_, w in zip(got, want):
        assert (tuple(g_.shape), g_.dtype) == (tuple(w.shape), w.dtype)
    assert radix_partition_cuda.launches == before


@pytest.mark.parametrize("shape,dtype,nb,match", [
    ((2, 8), torch.int32, 0, "num_buckets"),
    ((2, 8), torch.int32, 32769, "num_buckets"),
    ((2, 8), torch.int64, 4, "int32"), ((2, 2, 8), torch.int32, 4, "int32")])
def test_radix_operator_fake_raises_the_launchs_errors(shape, dtype, nb,
                                                      match):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        dest, = _fake((shape, dtype))
        with pytest.raises(ValueError, match=match):
            torch.ops.repro_torch.radix_partition(dest, nb)


@pytest.mark.parametrize("op,args", [
    ("flash_attention", lambda: (torch.zeros(1, 1, 4, 16),) * 3
     + (True, None)),
    ("ssd_scan", lambda: (torch.zeros(1, 4, 2), torch.zeros(1, 4, 1),
                          torch.zeros(1, 1), torch.zeros(1, 4, 2),
                          torch.zeros(1, 4, 2), 4)),
    ("radix_partition", lambda: (torch.zeros(1, 4, dtype=torch.int32), 2))])
def test_operators_have_no_cpu_kernel(op, args):
    with pytest.raises(NotImplementedError):
        getattr(torch.ops.repro_torch, op)(*args())


# ---------------------------------------------------------------------- #
# End to end
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,shape,multi,op,calls", CLI_CELLS,
                         ids=[f"{a}-{s}" for a, s, _, _, _ in CLI_CELLS])
def test_command_line_cells_on_card_stand_ins(runs, arch, shape, multi, op,
                                              calls):
    row, left = _cell(runs, arch, shape)
    assert not left
    assert row["mesh"] == ("multi_pod" if multi else "single_pod")
    assert row["chips"] == (512 if multi else 256)
    assert row["device"] == "cuda" and row["param_dtype"] == "bfloat16"
    assert row["kernel_calls"] == {op: calls}
    assert set(row["memory_analysis"]) == {
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes"}
    assert set(row["cost_analysis"]) == {"flops", "bytes accessed"}
    assert set(row["collectives"]) == set(OPS) | {"total_wire_bytes"}
    assert row["collectives"]["total_wire_bytes"] > 0
    assert row["collectives"]["all-gather"]["count"] \
        + row["collectives"]["all-reduce"]["count"] > 0
    t = row["roofline"]
    assert t["dominant"] in ("compute", "memory", "collective")
    assert 0 < t["roofline_fraction"] <= 1
    assert row["trace_s"] > 0 and row["counting_s"] > 0


@pytest.mark.parametrize("arch", TRAIN_SMOKE)
def test_train_cells_on_cpu_stand_ins(runs, arch):
    d = _done(runs, "smoke")
    with open(os.path.join(d, "group.json")) as f:
        assert not json.load(f)["left"]
    with open(os.path.join(d, f"{arch}__train_4k.json")) as f:
        row = json.load(f)
    assert row["device"] == "cpu" and row["chips"] == RANKS
    assert row["kernel_calls"] == {}     # the plain kernel versions
    ma = row["memory_analysis"]
    assert ma["temp_size_in_bytes"] > 0
    # the new state is as large as the old: parameters and moments
    assert ma["output_size_in_bytes"] >= ma["argument_size_in_bytes"] * 0.99
    assert row["collectives"]["reduce-scatter"]["count"] > 0
    assert row["roofline"]["model_flops"] > 0


def test_launch_package_exports_the_mesh_and_not_the_dry_run():
    code = ("import sys, repro_torch.launch as l\n"
            "assert callable(l.make_production_mesh)\n"
            "assert 'repro_torch.launch.dryrun' not in sys.modules\n"
            "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ,
                                   PYTHONPATH=os.path.abspath(SRC)))
    assert proc.returncode == 0 and proc.stdout.startswith("OK"), \
        proc.stderr[-2000:]


# ---------------------------------------------------------------------- #
# Report and roofline
# ---------------------------------------------------------------------- #
def _reference_schema(rows):
    """The port's rows as the reference's report reads them: the trace
    time in ``compile_s``."""
    return [dict(r, compile_s=r["trace_s"]) for r in rows]


@pytest.mark.parametrize("fn", ["dryrun_table", "roofline_table", "notes"])
def test_report_tables_equal_reference(runs, fn):
    from repro.launch import report as jreport
    from repro_torch.launch import report
    rows = _reference_schema(_rows(runs))
    assert getattr(report, fn)(rows) == getattr(jreport, fn)(rows)


def test_report_renders_trace_time_and_splices(runs, tmp_path):
    from repro.launch import report as jreport
    from repro_torch.launch import report
    rows = _rows(runs)
    table = report.dryrun_table(rows)
    for r in rows:
        assert f"| OK | {r['trace_s']:.1f} |" in table
    text = ("# x\n\n<!-- DRYRUN_TABLE -->\nold\n\n## y\n"
            "<!-- ROOFLINE_TABLE -->\n")
    for mod, name in ((report, "port.md"), (jreport, "ref.md")):
        (tmp_path / name).write_text(text)
        mod.splice(str(tmp_path / name), "DRYRUN_TABLE", table)
        mod.splice(str(tmp_path / name), "ROOFLINE_TABLE", "t")
    assert (tmp_path / "port.md").read_text() == \
        (tmp_path / "ref.md").read_text()


def test_report_main_reads_a_directory(runs, capsys, monkeypatch):
    from repro_torch.launch import report
    d = _done(runs, "llama3.2-3b/prefill_32k")
    monkeypatch.setattr(sys, "argv", ["report", "--dir",
                                      os.path.join(d, "single_pod")])
    report.main()
    out = capsys.readouterr().out
    assert "| llama3.2-3b | prefill_32k | OK |" in out
    assert "Dominant-term census:" in out


def test_analyze_and_format_table_equal_reference(runs, monkeypatch):
    from repro.configs import get_config as jconfig
    from repro.launch import roofline as jroof
    from repro_torch.configs import get_config
    from repro_torch.launch import roofline
    h = roofline.H100
    monkeypatch.setattr(jroof, "PEAK_FLOPS", h.bf16_flops_per_s)
    monkeypatch.setattr(jroof, "HBM_BW", h.hbm_bytes_per_s)
    monkeypatch.setattr(jroof, "LINK_BW", h.link_bytes_per_s)
    rows = _rows(runs)
    for r in rows:
        got = roofline.analyze(r, get_config(r["arch"]), r["chips"])
        want = jroof.analyze(r, jconfig(r["arch"]), r["chips"])
        assert got == want
        assert got == r["roofline"]
    assert roofline.format_table(rows) == jroof.format_table(rows)


if __name__ == "__main__":
    d, mode, *rest = sys.argv[1:]
    if mode == "reference":
        _reference_child(d)
    elif mode == "cli":
        arch, shape, multi = rest
        _cli_child(d, arch, shape, bool(int(multi)))
    elif mode == "smoke":
        _smoke_train_child(d)
    else:
        raise SystemExit(f"unknown mode {mode}")
