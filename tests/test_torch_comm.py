"""The port's communicators (``xla``, ``ring``, ``bruck``) against the
JAX package's: on the stacked rank axis, and over the processes of a
``torch.distributed`` gloo group on the CPU.

A subprocess with 8 JAX host devices runs the checks of
``tests/md_scripts/comm_collectives.py`` — every collective of every
communicator at p in {6, 8} (6 takes bruck's ring fallback), the chunked
all-to-all at 1 to 4 chunks over a capacity axis of 4, the broadcast —
and a small Fig-9 per communicator at 8 ranks.  The port computes the
same functions on the same inputs.  Data movement is exact; a reduction
of ``ring`` or ``bruck`` is exact against the JAX package's reduction
under the same schedule (the same adds in the same order), and within
1e-5 of ``xla``'s, as the JAX script holds its own.  The Fig-9 runs are
bit-identical across communicators and packages (integer-valued
payloads), and each communicator's stages sit under keys of their own.

The process-group communicators (``comm.process_group``) run in spawned
gloo groups of 2, 4, 6 and 8 processes, all four at once (this file run
as a script, ``group`` mode; ``file://`` rendezvous under ``tmp_path``,
one CPU thread a process).  Each process holds one rank.  Every
collective of every schedule equals the stacked communicator's rank for
rank, at p in {2, 6, 8} (6 takes bruck's ring fallback): data movement
and integer reductions exactly, float sums of ``xla`` within 1e-5 (the
group's own order); the ring and Bruck schedules add in the stacked
order, exactly.  Fig-9 over 8 processes, in ``bsp``, ``bsp_staged`` and
``amt`` under each schedule and through ``repro_torch.df``, equals the
stacked run slot for slot and the JAX package's 8-device run row for
row, with ``ExecStats`` totals and records equal on every process.  A
one-key table over 4 processes takes the same salting decisions on every
process, and its splitter estimator the same refresh.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \\
        tests/test_torch_comm.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
COMMS = ("xla", "ring", "bruck")
PS = (6, 8)
METHODS = ("all_to_all", "all_gather", "all_reduce", "reduce_scatter")
CHUNKS = (1, 2, 3, 4)
P8, ROWS, CAP = 8, 8 * 40, 64
MODES = ("bsp", "bsp_staged", "amt")
#: process-group sizes: collectives at 2, 6, 8; Fig-9 at 8; skew at 4
GROUPS = (2, 4, 6, 8)


def _inputs(p):
    rng = np.random.default_rng(p)
    return {"blocks": rng.standard_normal((p, p, 4, 3)).astype(np.float32),
            "flat": rng.standard_normal((p, 10)).astype(np.float32)}


def _arg(method):
    return "blocks" if method in ("all_to_all", "reduce_scatter") else "flat"


def _fig9_data(seed):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, int(ROWS * 0.9), ROWS).astype(np.int32),
            "v0": rng.integers(0, 256, ROWS).astype(np.float32)}


def fig9_plan(Plan, capacity):
    """``benchmarks/bench_pipeline.py::make_plan``."""
    return (Plan.scan("l")
            .join(Plan.scan("r"), on="k", out_capacity=capacity * 4,
                  bucket_capacity=capacity)
            .groupby(["k"], {"v0": ["sum"]}, bucket_capacity=capacity * 4)
            .sort(["k"], bucket_capacity=capacity * 4)
            .add_scalar(1.0, cols=["v0_sum"]))


def _reference_main(path):
    """JAX side: 8 host devices; writes ``path``."""
    import jax
    from jax.sharding import Mesh, PartitionSpec as Spec
    from repro import compat
    from repro.comm import get_communicator
    from repro.core import CylonEnv, DistTable, Plan, execute
    assert len(jax.devices()) == P8
    out = {}
    for p in PS:
        mesh = Mesh(np.asarray(jax.devices()[:p]), ("df",))
        x = _inputs(p)

        def run(fn, a):
            return np.asarray(jax.jit(compat.shard_map(
                lambda xl: fn(xl[0])[None], mesh=mesh, in_specs=Spec("df"),
                out_specs=Spec("df"), check_vma=False))(a))
        for name in COMMS:
            comm = get_communicator(name, "df")
            for method in METHODS:
                out[f"{p}/{name}/{method}"] = run(getattr(comm, method),
                                                  x[_arg(method)])
            for k in CHUNKS:
                out[f"{p}/{name}/chunked{k}"] = run(
                    lambda xl, c=comm, k=k: c.all_to_all_chunked(xl, k),
                    x["blocks"])
            out[f"{p}/{name}/broadcast"] = run(
                lambda xl, c=comm: c.broadcast(xl, root=2), x["flat"])
    for name in COMMS:
        env = CylonEnv(communicator=name)
        tables = {n: DistTable.from_numpy(_fig9_data(s), P8, capacity=CAP)
                  for n, s in (("l", 0), ("r", 1))}
        res = execute(fig9_plan(Plan, CAP), env, tables)
        for c, a in res.to_numpy().items():
            out[f"fig9/{name}/{c}"] = a
    for mode in MODES[1:]:
        res = execute(fig9_plan(Plan, CAP), CylonEnv(), tables, mode=mode)
        for c, a in res.to_numpy().items():
            out[f"fig9mode/{mode}/{c}"] = a
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory, group_runs):
    # group_runs: the process groups start first and run alongside
    path = str(tmp_path_factory.mktemp("comm8") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return dict(np.load(path))


def _comm(name, p):
    from repro_torch.comm import get_communicator
    return get_communicator(name, p)


def _t(a):
    import torch
    return torch.from_numpy(a.copy())


def test_registry_names():
    from repro_torch.comm import (BruckCommunicator, RingCommunicator,
                                  StackedCommunicator,
                                  available_communicators)
    assert available_communicators() == sorted(COMMS)
    assert type(_comm("xla", 4)) is StackedCommunicator
    assert type(_comm("ring", 4)) is RingCommunicator
    assert type(_comm("bruck", 4)) is BruckCommunicator
    with pytest.raises(ValueError, match="unknown communicator"):
        _comm("mpi", 4)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", COMMS)
@pytest.mark.parametrize("p", PS)
def test_collective_matches_reference(reference, p, name, method):
    got = getattr(_comm(name, p), method)(_t(_inputs(p)[_arg(method)]))
    got = got.numpy()
    want = reference[f"{p}/{name}/{method}"]
    assert got.shape == want.shape and got.dtype == want.dtype
    if name == "xla" and method in ("all_reduce", "reduce_scatter"):
        # XLA's own summation order is not the port's x.sum(0)
        np.testing.assert_allclose(got, want, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)
    # and every schedule agrees with xla, as the JAX script holds
    np.testing.assert_allclose(got, reference[f"{p}/xla/{method}"],
                               atol=1e-5)


@pytest.mark.parametrize("name", COMMS)
@pytest.mark.parametrize("p", PS)
def test_chunked_all_to_all_and_broadcast(reference, p, name):
    comm = _comm(name, p)
    x = _inputs(p)
    mono = reference[f"{p}/xla/all_to_all"]
    for k in CHUNKS:
        got = comm.all_to_all_chunked(_t(x["blocks"]), k).numpy()
        np.testing.assert_array_equal(got, reference[f"{p}/{name}/chunked{k}"])
        np.testing.assert_array_equal(got, mono)
    got = comm.broadcast(_t(x["flat"]), root=2).numpy()
    np.testing.assert_array_equal(got, reference[f"{p}/{name}/broadcast"])
    np.testing.assert_array_equal(got, np.repeat(x["flat"][2][None], p, 0))


@pytest.mark.parametrize("name", ("ring", "bruck"))
@pytest.mark.parametrize("p", (1, 2, 3, 5))
def test_small_and_odd_rank_counts_equal_xla(p, name):
    # integer payloads: every collective exact against xla, down to p = 1
    import torch
    g = torch.Generator().manual_seed(p)
    blocks = torch.randint(0, 1000, (p, p, 5), generator=g,
                           dtype=torch.int32)
    flat = torch.randint(0, 1000, (p, 7), generator=g, dtype=torch.int64)
    ref, comm = _comm("xla", p), _comm(name, p)
    for method, x in (("all_to_all", blocks), ("reduce_scatter", blocks),
                      ("all_gather", flat), ("all_reduce", flat)):
        want = getattr(ref, method)(x)
        got = getattr(comm, method)(x)
        assert got.dtype == want.dtype, method
        assert torch.equal(got, want), method
    counts = torch.randint(0, 9, (p, p), generator=g, dtype=torch.int32)
    assert torch.equal(comm.exchange_counts(counts), counts.T)


def test_fig9_per_communicator(reference):
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    tables = {n: DistTable.from_numpy(_fig9_data(s), P8, capacity=CAP,
                                      device="cpu")
              for n, s in (("l", 0), ("r", 1))}
    keys = {}
    for name in COMMS:
        env = CylonEnv(P8, device="cpu", communicator=name)
        res, st = execute(fig9_plan(Plan, CAP), env, tables,
                          collect_stats=True)
        assert st.rows_dropped == 0
        got = res.to_numpy()
        for c, want in ((k.split("/", 2)[2], v) for k, v in reference.items()
                        if k.startswith(f"fig9/{name}/")):
            np.testing.assert_array_equal(got[c], want, err_msg=c)
            np.testing.assert_array_equal(
                want, reference[f"fig9/xla/{c}"], err_msg=c)
        keys[name] = set(env._cache)
        assert all(name in k for k in keys[name])
    # the communicator's name is in every key: no stage is shared
    assert not (keys["xla"] & keys["ring"] or keys["xla"] & keys["bruck"]
                or keys["ring"] & keys["bruck"])


# ---------------------------------------------------------------------- #
# Process groups: one rank per process, gloo on the CPU
# ---------------------------------------------------------------------- #
def _int_inputs(p):
    rng = np.random.default_rng(100 + p)
    return {"blocks": rng.integers(0, 1000, (p, p, 5)).astype(np.int32),
            "flat": rng.integers(0, 1000, (p, 7)).astype(np.int64)}


def _perm(p):
    """A ppermute with a gap: rank p-1 sends nowhere, rank 0 gets
    nothing, rank 1 keeps its own."""
    return [(i, (i + 1) % p) for i in range(p - 1) if (i + 1) % p != 1] \
        + [(1, 1)] if p > 2 else [(0, 1)]


def _collective_results(comm, inputs, ints, p, rows):
    """Every collective of ``comm`` on the rows ``rows`` of the stacked
    inputs (all of them stacked; one over a process group)."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows]))
    out = {}
    for method in METHODS + ("all_reduce_max", "all_reduce_min"):
        for kind, x in (("f", inputs), ("i", ints)):
            arg = "blocks" if method in ("all_to_all", "reduce_scatter") \
                else "flat"
            out[f"{method}/{kind}"] = getattr(comm, method)(t(x[arg]))
    for k in CHUNKS:
        out[f"chunked{k}"] = comm.all_to_all_chunked(t(inputs["blocks"]), k)
    out["broadcast"] = comm.broadcast(t(inputs["flat"]), root=min(2, p - 1))
    out["ppermute"] = comm.ppermute(t(ints["flat"]), _perm(p))
    out["exchange_counts"] = comm.exchange_counts(
        t(ints["blocks"][:, :, 0]))
    return {k: v.numpy() for k, v in out.items()}


def _stats_json(st):
    return json.dumps({
        "rows_shuffled": st.rows_shuffled, "bytes_shuffled": st.bytes_shuffled,
        "rows_dropped": st.rows_dropped, "fired": list(st.fired),
        "num_stages": st.num_stages, "dispatches": st.dispatches,
        "salted_shuffles": st.salted_shuffles,
        "adapt_events": st.adapt_events, "shuffle_labels": st.shuffle_labels,
        "records": [[r.label, r.rows, r.bytes, r.dropped,
                     list(r.per_rank_rows), list(r.per_rank_dropped)]
                    for r in st.shuffle_records]})


def fig9_df(rdf, col, ld, rd):
    """Fig-9 through the frontend: merge -> groupby().agg -> sort_values
    -> assign, at the cell's capacities."""
    l, r = rdf.read_numpy(ld), rdf.read_numpy(rd)
    return (l.merge(r, on="k", out_capacity=CAP * 4, bucket_capacity=CAP)
            .groupby("k", bucket_capacity=CAP * 4).agg({"v0": ["sum", "mean"]})
            .sort_values("k", bucket_capacity=CAP * 4)
            .assign(v0_sum=col("v0_sum") + 1.0))


def _skew_tables(p):
    from strategies import one_key_table
    data = one_key_table(np.random.default_rng(7), 4000, hot=7)
    build = {"k": np.arange(64, dtype=np.int32),
             "w": np.arange(64, dtype=np.float32)}
    return data, build, 2 * 4000 // p


def _skew_plans(Plan, cap):
    g = (Plan.scan("t").groupby(["k"], {"v": ["sum", "count"]},
                                pre_aggregate=False, bucket_capacity=cap,
                                out_capacity=cap)
         .sort(["k"], bucket_capacity=cap))
    j = Plan.scan("t").join(Plan.scan("r"), on="k", bucket_capacity=cap,
                            shuffle_out_capacity=cap, out_capacity=4 * cap)
    return {"groupby": g, "join": j}


def _splitter_decisions(comm, rows):
    """A splitter estimator fed each rank's routed rows for 6 morsels:
    its refresh decisions and final splitters."""
    from repro_torch.adapt import AdaptiveConfig, SplitterEstimator
    rng = np.random.default_rng(5)
    routed = rng.integers(0, 50, (6, 4))
    routed[3:, 2] += 400                # rank 2 turns hot
    calls = []
    est = SplitterEstimator(
        np.array([10, 20, 30], np.int32),
        lambda s: (calls.append(s), np.array([5, 6, 7], np.int32))[1],
        64, AdaptiveConfig(), comm=comm)
    fired = [est.observe(routed[m][rows]) for m in range(6)]
    return fired, est.splitters.tolist(), calls


def _group_child(rank, world, d):
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        import repro_torch.df as rdf
        from repro_torch.comm import get_communicator
        from repro_torch.core import CylonEnv, Plan, execute
        from repro_torch.expr import col
        group = dist.group.WORLD
        out = {}
        if world in (2, 6, 8):
            for name in COMMS:
                comm = get_communicator(name, world, group=group)
                res = _collective_results(comm, _inputs(world),
                                          _int_inputs(world), world,
                                          slice(rank, rank + 1))
                out.update({f"{name}/{k}": v for k, v in res.items()})
        if world == P8:
            for name in COMMS:
                env = CylonEnv(communicator=name, process_group=group,
                               device="cpu")
                tables = {n: env.from_numpy(_fig9_data(s), capacity=CAP)
                          for n, s in (("l", 0), ("r", 1))}
                for mode in MODES:
                    res, st = execute(fig9_plan(Plan, CAP), env, tables,
                                      mode=mode, collect_stats=True)
                    key = f"fig9/{name}/{mode}"
                    out[f"{key}/stats"] = np.array(_stats_json(st))
                    out[f"{key}/__count"] = res.row_counts.numpy()
                    for c, v in res.columns.items():
                        out[f"{key}/slots/{c}"] = v.numpy()
                    for c, v in res.gather_numpy().items():
                        out[f"{key}/rows/{c}"] = v
            with rdf.session(env=CylonEnv(process_group=group,
                                          device="cpu")):
                res = fig9_df(rdf, col, _fig9_data(0),
                              _fig9_data(1)).collect()
            out["df/__count"] = res.row_counts.numpy()
            for c, v in res.columns.items():
                out[f"df/slots/{c}"] = v.numpy()
        if world == 4:
            env = CylonEnv(process_group=group, device="cpu")
            data, build, cap = _skew_tables(world)
            tables = {"t": env.from_numpy(data, capacity=cap),
                      "r": env.from_numpy(build)}
            for kind, plan in _skew_plans(Plan, cap).items():
                res, st = execute(plan, env, tables, optimize=False,
                                  collect_stats=True)
                out[f"skew/{kind}/stats"] = np.array(_stats_json(st))
                out[f"skew/{kind}/__count"] = res.row_counts.numpy()
                for c, v in res.columns.items():
                    out[f"skew/{kind}/slots/{c}"] = v.numpy()
            comm = get_communicator("xla", world, group=group)
            out["splitters"] = np.array(json.dumps(
                _splitter_decisions(comm, slice(rank, rank + 1))))
        np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _group_main(world, d):
    import torch.multiprocessing as mp
    mp.start_processes(_group_child, args=(world, d), nprocs=world,
                       start_method="spawn")


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    """Start every group size at once, each in its own subprocess of
    ``p`` spawned processes; (p -> (process, results directory))."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(SRC), here]), JAX_PLATFORMS="cpu")
    dirs = {p: str(tmp_path_factory.mktemp(f"group{p}")) for p in GROUPS}
    runs = {p: (subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "group", str(p),
         dirs[p]], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env), dirs[p]) for p in GROUPS}
    # the launcher as a user starts it: torchrun, 2 gloo processes
    runs["torchrun"] = (subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node=2", "-m", "repro_torch.launch.fig9",
         "--backend", "gloo", "--device", "cpu", "--rows", "4096",
         "--communicator", "bruck", "--check"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env), None)
    yield runs
    for proc, _ in runs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def groups(group_runs):
    """p -> [rank r's results] for every group size."""
    out = {}
    for p, (proc, d) in group_runs.items():
        log = proc.communicate(timeout=600)[0]
        assert proc.returncode == 0, log[-4000:]
        out[p] = (log if d is None else
                  [dict(np.load(os.path.join(d, f"rank{r}.npz")))
                   for r in range(p)])
    return out


def test_fig9_launcher_under_torchrun(groups):
    # repro_torch.launch.fig9 over 2 gloo processes, held to numpy
    log = groups["torchrun"]
    runs = [ln for ln in log.splitlines() if ln.startswith("[fig9] gloo")]
    assert len(runs) == 2 and all("dropped 0" in ln for ln in runs), log
    assert "equal to numpy" in log, log


@pytest.mark.parametrize("name", COMMS)
@pytest.mark.parametrize("p", (2, 6, 8))
def test_process_group_collectives_equal_stacked(groups, p, name):
    want = _collective_results(_comm(name, p), _inputs(p), _int_inputs(p),
                               p, slice(None))
    for r, got in enumerate(groups[p]):
        for k, w in want.items():
            g = got[f"{name}/{k}"]
            assert g.shape == (1,) + w.shape[1:] and g.dtype == w.dtype, k
            if name == "xla" and k in ("all_reduce/f", "reduce_scatter/f"):
                # the group's own summation order
                np.testing.assert_allclose(g[0], w[r], atol=1e-5, err_msg=k)
            else:
                np.testing.assert_array_equal(g[0], w[r], err_msg=k)


def test_process_group_registry():
    from repro_torch.comm import available_communicators
    from repro_torch.comm.process_group import (ProcessGroupBruck,
                                                ProcessGroupCommunicator,
                                                ProcessGroupRing,
                                                process_group_communicator)
    assert available_communicators() == sorted(COMMS)
    for cls, name in ((ProcessGroupCommunicator, "xla"),
                      (ProcessGroupRing, "ring"), (ProcessGroupBruck,
                                                   "bruck")):
        assert cls.name == name
    # the schedules run the ring / Bruck steps, the rest is the group's
    assert ProcessGroupRing.all_to_all.__qualname__.startswith("Ring")
    assert ProcessGroupRing.all_reduce_max.__qualname__.startswith(
        "ProcessGroupCommunicator")
    assert ProcessGroupBruck.all_to_all.__qualname__.startswith("Bruck")
    with pytest.raises(ValueError, match="no process-group communicator"):
        process_group_communicator("mpi")


def test_process_group_modules_import_no_jax_or_repro():
    code = ("import sys\n"
            "import repro_torch.comm.process_group, repro_torch.launch.fig9\n"
            "from repro_torch.core import CylonEnv\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ,
                                   PYTHONPATH=os.path.abspath(SRC)))
    assert proc.returncode == 0, proc.stderr[-3000:]


def _stacked_fig9(name, mode):
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    tables = {n: DistTable.from_numpy(_fig9_data(s), P8, capacity=CAP,
                                      device="cpu")
              for n, s in (("l", 0), ("r", 1))}
    env = CylonEnv(P8, device="cpu", communicator=name)
    return execute(fig9_plan(Plan, CAP), env, tables, mode=mode,
                   collect_stats=True)


def _same_slots(ranks, res, key):
    for r, got in enumerate(ranks):
        assert int(got[f"{key}/__count"][0]) == int(res.row_counts[r])
        for c, v in res.columns.items():
            np.testing.assert_array_equal(got[f"{key}/slots/{c}"][0],
                                          v[r].numpy(), err_msg=f"{c} @ {r}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", COMMS)
def test_fig9_over_eight_processes(reference, groups, name, mode):
    res, st = _stacked_fig9(name, mode)
    ranks = groups[P8]
    key = f"fig9/{name}/{mode}"
    _same_slots(ranks, res, key)
    want = json.loads(_stats_json(st))
    assert want["rows_dropped"] == 0
    for r, got in enumerate(ranks):
        # ExecStats totals and records: the stacked run's, on every process
        assert json.loads(str(got[f"{key}/stats"])) == want, r
        ref = f"fig9/{name}/" if mode == "bsp" else f"fig9mode/{mode}/"
        for c, v in reference.items():
            if c.startswith(ref) and "/" not in c[len(ref):]:
                np.testing.assert_array_equal(
                    got[f"{key}/rows/{c[len(ref):]}"], v, err_msg=c)


def test_fig9_frontend_over_eight_processes(groups):
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv
    from repro_torch.expr import col
    with rdf.session(env=CylonEnv(P8, device="cpu")):
        res = fig9_df(rdf, col, _fig9_data(0), _fig9_data(1)).collect()
    _same_slots(groups[P8], res, "df")


@pytest.mark.parametrize("kind", ("groupby", "join"))
def test_skewed_table_over_four_processes(groups, kind):
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    p = 4
    data, build, cap = _skew_tables(p)
    tables = {"t": DistTable.from_numpy(data, p, capacity=cap,
                                        device="cpu"),
              "r": DistTable.from_numpy(build, p, device="cpu")}
    res, st = execute(_skew_plans(Plan, cap)[kind], CylonEnv(p, device="cpu"),
                      tables, optimize=False, collect_stats=True)
    want = json.loads(_stats_json(st))
    assert want["salted_shuffles"] == 1 and want["rows_dropped"] == 0
    for r, got in enumerate(groups[p]):
        # the same SaltDecision on every process, the stacked run's
        assert json.loads(str(got[f"skew/{kind}/stats"])) == want, r
    _same_slots(groups[p], res, f"skew/{kind}")


def test_splitter_refresh_decided_alike_over_four_processes(groups):
    want = _splitter_decisions(None, slice(None))
    assert any(want[0])        # the hot rank makes it refresh
    for got in groups[4]:
        assert json.loads(str(got["splitters"])) == json.loads(
            json.dumps(want))


@pytest.mark.gpu
def test_nccl_fig9_over_two_cards_equals_stacked(tmp_path):
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("NCCL needs a card per rank: two or more cards")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "nccl", str(tmp_path)], capture_output=True,
                          text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res, _ = _stacked_fig9("xla", "bsp")
    got = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for r in range(2):
        np.testing.assert_array_equal(got[r]["rows/k"],
                                      res.to_numpy()["k"])


def _nccl_child(rank, world, d):
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    dist.init_process_group("nccl", init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        from repro_torch.core import CylonEnv, Plan, execute
        env = CylonEnv(process_group=dist.group.WORLD, device=f"cuda:{rank}")
        tables = {n: env.from_numpy(_fig9_data(s), capacity=CAP)
                  for n, s in (("l", 0), ("r", 1))}
        res = execute(fig9_plan(Plan, CAP), env, tables)
        np.savez(os.path.join(d, f"rank{rank}.npz"),
                 **{f"rows/{c}": v for c, v in res.gather_numpy().items()})
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[1] == "group":
        _group_main(int(sys.argv[2]), sys.argv[3])
    elif sys.argv[1] == "nccl":
        import torch.multiprocessing as mp
        mp.start_processes(_nccl_child, args=(2, sys.argv[2]), nprocs=2,
                           start_method="spawn")
    else:
        _reference_main(sys.argv[1])
