"""The port's communicators (``xla``, ``ring``, ``bruck`` on the stacked
rank axis) against the JAX package's.

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

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \\
        tests/test_torch_comm.py
"""

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
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
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


if __name__ == "__main__":
    _reference_main(sys.argv[1])
