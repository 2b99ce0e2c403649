"""Query serving through the port against the JAX package.

Every scenario of ``tests/test_serving.py`` runs here against
``repro_torch``: the ``DevicePool`` free-list (checked on both packages'
pools, which must behave alike), the single-flight ``ProgramCache``, the
thread-safe ``CylonEnv.run`` over a shared cache, session exclusivity and
every ``QueryScheduler`` case.  Where a case computes, the same numpy
inputs go through ``repro`` (its one CPU device) and ``repro_torch`` (rank
slots on the CPU) and the results compare exactly: the payloads are
integer-valued float32, so sums are exact.  Worker-parking frames wait on
a ``threading.Event`` instead of sleeping, so the cases hold under a
loaded machine.

The stress case follows ``tests/md_scripts/serving_stress.py``: a
subprocess with 8 JAX host devices runs its three queries on a 2-device
env; the port's scheduler (8 CPU slots, gangs of 2, 4 in flight) serves
16 submissions from 8 threads, ``collect()`` inside ``session(
scheduler=)`` from 8 threads, a mid-queue cancellation and faulted
queries, each bit-identical to the JAX results, with no stage built on a
warm gang.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \\
        tests/test_torch_serving.py
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _jax():
    import repro.core as jcore
    import repro.df as jdf
    import repro.faults as jfaults
    import repro.serve as jserve
    return jcore, jdf, jfaults, jserve


def _port():
    import repro_torch.core as tcore
    import repro_torch.df as tdf
    import repro_torch.faults as tfaults
    import repro_torch.serve as tserve
    return tcore, tdf, tfaults, tserve


PKGS = ["repro", "repro_torch"]


def _pkg(name):
    return _jax() if name == "repro" else _port()


class FakeDevice:
    """Stand-in slot for pool-only tests (the pool never touches it)."""

    def __init__(self, i):
        self.id = i

    def __repr__(self):
        return f"dev{self.id}"


def fake_pool(pkg, n=8):
    return _pkg(pkg)[0].DevicePool([FakeDevice(i) for i in range(n)])


def _same(got, want):
    assert sorted(got) == sorted(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


# --------------------------------------------------------------------- #
# DevicePool: locked free-list, both packages alike
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("pkg", PKGS)
class TestDevicePool:
    def test_reserve_lowest_first(self, pkg):
        pool = fake_pool(pkg, 8)
        a = pool.reserve(2)
        b = pool.reserve(3)
        assert [d.id for d in a] == [0, 1]
        assert [d.id for d in b] == [2, 3, 4]
        assert pool.available == 3

    def test_release_recarves_same_placement(self, pkg):
        pool = fake_pool(pkg, 8)
        a = pool.reserve(2)
        pool.reserve(2)
        first_ids = [d.id for d in a]
        a.release()
        again = pool.reserve(2)
        assert [d.id for d in again] == first_ids

    def test_exhaustion_raises(self, pkg):
        core = _pkg(pkg)[0]
        pool = fake_pool(pkg, 4)
        pool.reserve(3)
        with pytest.raises(core.PoolExhausted):
            pool.reserve(2)
        with pytest.raises(core.PoolExhausted):
            pool.reserve(5)          # larger than the pool itself
        assert pool.try_reserve(2) is None

    def test_release_is_idempotent(self, pkg):
        pool = fake_pool(pkg, 4)
        lease = pool.reserve(2)
        lease.release()
        lease.release()              # no double-free
        pool.release(lease)
        assert pool.available == 4
        assert lease.released

    def test_release_all(self, pkg):
        pool = fake_pool(pkg, 4)
        pool.reserve(1)
        lease = pool.reserve(2)
        pool.release_all()
        assert pool.available == 4
        assert lease.released

    def test_lease_is_sequence_and_context_manager(self, pkg):
        core = _pkg(pkg)[0]
        pool = fake_pool(pkg, 4)
        with pool.reserve(2) as lease:
            assert isinstance(lease, core.Lease)
            assert len(lease) == 2
            assert lease[0].id == 0
            assert [d.id for d in lease] == [0, 1]
            assert not lease.released
        assert lease.released
        assert pool.available == 4

    def test_blocking_reserve_token_deadline(self, pkg):
        faults = _pkg(pkg)[2]
        pool = fake_pool(pkg, 2)
        pool.reserve(2)
        with pytest.raises(faults.QueryTimeout):
            pool.reserve(1, block=True, poll_s=0.01,
                         token=faults.CancellationToken(0.05))

    def test_blocking_reserve_token_cancel(self, pkg):
        faults = _pkg(pkg)[2]
        pool = fake_pool(pkg, 2)
        held = pool.reserve(2)
        token = faults.CancellationToken()
        threading.Timer(0.05, token.cancel).start()
        with pytest.raises(faults.QueryCancelled):
            pool.reserve(1, block=True, poll_s=0.01, token=token)
        held.release()

    def test_blocking_reserve_waits_for_release(self, pkg):
        pool = fake_pool(pkg, 2)
        held = pool.reserve(2)
        got, waiting = [], threading.Event()

        def taker():
            waiting.set()
            lease = pool.reserve(2, block=True, poll_s=0.01)
            got.append([d.id for d in lease])
            lease.release()
        t = threading.Thread(target=taker)
        t.start()
        assert waiting.wait(30)
        time.sleep(0.02)
        assert not got               # still blocked
        held.release()
        t.join(timeout=30)
        assert got == [[0, 1]]

    def test_concurrent_reserve_release_never_overlaps(self, pkg):
        pool = fake_pool(pkg, 8)
        held_ids = set()
        guard = threading.Lock()
        errors = []

        def churn():
            for _ in range(60):
                lease = pool.reserve(2, block=True, poll_s=0.001)
                ids = {d.id for d in lease}
                with guard:
                    if held_ids & ids:
                        errors.append(f"overlap: {held_ids & ids}")
                    held_ids.update(ids)
                time.sleep(0.0005)
                with guard:
                    held_ids.difference_update(ids)
                lease.release()
        threads = [threading.Thread(target=churn) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not errors, errors
        assert pool.available == 8


def test_pool_of_rank_slots_on_a_device():
    tcore = _port()[0]
    pool = tcore.DevicePool(slots=4, device="cpu")
    assert pool.size == 4 and str(pool.device) == "cpu"
    assert [s.id for s in pool.devices] == [0, 1, 2, 3]
    with pool.reserve(2) as lease:
        env = tcore.CylonEnv(devices=lease)
        assert env.parallelism == 2 and env.device.type == "cpu"
    with pytest.raises(TypeError):
        tcore.DevicePool([FakeDevice(0)], slots=2)
    with pytest.raises(TypeError, match="devices= sets"):
        tcore.CylonEnv(2, devices=pool.reserve(2))
    assert tcore.DevicePool(device="cpu").size == 1


def test_pool_scheduler_and_executor_need_a_card(monkeypatch):
    # no fallback: without a card each raises unless asked for the CPU
    import torch
    tcore, _, _, tserve = _port()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tcore.DevicePool, lambda: tserve.QueryScheduler(),
                 lambda: tcore.CylonExecutor(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    ex = tcore.CylonExecutor(2, device="cpu")
    assert ex.parallelism == 2 and ex.env.device.type == "cpu"
    ex.release()
    assert ex.lease.released


# --------------------------------------------------------------------- #
# The kernel build and the launch counters under threads
# --------------------------------------------------------------------- #
def test_threads_building_one_kernel_run_the_compiler_once(tmp_path,
                                                           monkeypatch):
    # R1: eight threads ask for a kernel that is not built; the compiler
    # (stood in for here: no nvcc on the CPU) runs once, into a temporary
    # file named by process and thread, then renamed into place
    import subprocess as sp
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    runs = []

    def fake_compiler(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        runs.append(out)
        time.sleep(0.05)          # a slow compile widens the race
        with open(out, "wb") as f:
            f.write(b"lib")
        return sp.CompletedProcess(cmd, 0, stdout="ok")
    monkeypatch.setattr(build.subprocess, "run", fake_compiler)
    barrier = threading.Barrier(8)
    paths, errors = [], []

    def build_one():
        try:
            barrier.wait()
            paths.append(build.build("segmented_sum"))
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)
    threads = [threading.Thread(target=build_one) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    assert len(runs) == 1
    assert any(runs[0].endswith(f".{os.getpid()}.{t.ident}.tmp")
               for t in threads)
    assert paths == [build.library_path("segmented_sum")] * 8
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(paths[0]), "segmented_sum.log"])


def test_launch_counters_are_exact_under_threads():
    # R2: the wrappers' counters lose no launch when workers count at once
    from repro_torch.kernels.common import LaunchCounter
    counter = LaunchCounter(("onepass", "threepass"))
    barrier = threading.Barrier(8)

    def worker():
        barrier.wait()
        for _ in range(20_000):
            counter._count("onepass")
    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert counter.launches == 160_000
    assert counter.route_launches == {"onepass": 160_000, "threepass": 0}
    counter.reset()
    assert counter.launches == 0
    from repro_torch.kernels import CUDA_KERNELS
    assert all(isinstance(k, LaunchCounter) for k in CUDA_KERNELS)


# --------------------------------------------------------------------- #
# ProgramCache: process-level, single-flight (both packages alike)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("pkg", PKGS)
class TestProgramCache:
    def test_get_or_build_roundtrip(self, pkg):
        cache = _pkg(pkg)[3].ProgramCache(registry=False)
        calls = []
        value, built = cache.get_or_build("k", lambda: calls.append(1) or 42)
        assert (value, built) == (42, True)
        value, built = cache.get_or_build("k", lambda: calls.append(1) or 99)
        assert (value, built) == (42, False)
        assert len(calls) == 1
        assert "k" in cache and len(cache) == 1
        assert cache.peek("k") == 42
        assert cache.stats() == {"entries": 1, "hits": 1, "misses": 1,
                                 "singleflight_waits": 0}
        cache.clear()
        assert len(cache) == 0

    def test_single_flight_builds_once(self, pkg):
        cache = _pkg(pkg)[3].ProgramCache(registry=False)
        builds, results = [], []
        barrier = threading.Barrier(8)
        release = threading.Event()

        def slow_build():
            builds.append(threading.get_ident())
            release.wait(30)          # hold the build until all wait
            return "compiled"

        def racer():
            barrier.wait()
            results.append(cache.get_or_build("prog", slow_build))
        threads = [threading.Thread(target=racer) for _ in range(8)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 30
        while (cache.stats()["singleflight_waits"] < 7
               and time.monotonic() < deadline):
            time.sleep(0.001)
        release.set()
        for t in threads:
            t.join(timeout=30)
        assert len(builds) == 1, "the build must run exactly once"
        assert all(v == "compiled" for v, _ in results)
        assert sum(1 for _, built in results if built) == 1
        assert cache.stats()["singleflight_waits"] == 7

    def test_failed_build_is_retried(self, pkg):
        cache = _pkg(pkg)[3].ProgramCache(registry=False)
        attempts = []

        def flaky():
            attempts.append(1)
            if len(attempts) == 1:
                raise RuntimeError("compile boom")
            return "ok"
        with pytest.raises(RuntimeError, match="compile boom"):
            cache.get_or_build("k", flaky)
        assert "k" not in cache      # failed entry must not poison the key
        value, built = cache.get_or_build("k", flaky)
        assert (value, built) == ("ok", True)


def test_program_cache_exports_metrics():
    from repro_torch.obs.metrics import MetricsRegistry
    tserve = _port()[3]
    reg = MetricsRegistry()
    cache = tserve.ProgramCache(registry=reg)
    cache.get_or_build("k", lambda: 1)
    cache.get_or_build("k", lambda: 1)
    snap = reg.snapshot()["counters"]
    assert snap["program_cache_misses_total"][0]["value"] == 1
    assert snap["program_cache_hits_total"][0]["value"] == 1
    assert isinstance(tserve.GLOBAL_PROGRAM_CACHE, tserve.ProgramCache)


# --------------------------------------------------------------------- #
# CylonEnv.run: thread-safe stage cache, shared across gangs
# --------------------------------------------------------------------- #
def _sum_col(ctx, t):
    # per rank: the sum of the column's slots (padding is zero)
    v = t.columns["v"]
    if hasattr(v, "dim"):                # torch: (p, cap) stacked ranks
        return {"s": v.sum(dim=1, keepdim=True)}
    return {"s": v.sum(keepdims=True)}


def _ints(rng, n):
    return rng.integers(0, 256, n).astype(np.float32)


def _jax_sum(data_np):
    jcore, jdf, _, _ = _jax()
    env = jcore.CylonEnv()
    t = next(iter(jdf.read_numpy(data_np, env=env).sources.values()))
    return np.asarray(env.run(_sum_col, t)["s"]).reshape(-1)


def _port_env(**kw):
    return _port()[0].CylonEnv(device="cpu", **kw)


def _port_table(data_np, env):
    tdf = _port()[1]
    return next(iter(tdf.read_numpy(data_np, env=env).sources.values()))


class TestEnvThreadSafety:
    def test_concurrent_run_same_program_builds_once(self, rng):
        data_np = {"v": _ints(rng, 256)}
        env = _port_env()
        data = _port_table(data_np, env)
        barrier = threading.Barrier(8)
        outs, errors = [], []

        def worker():
            try:
                barrier.wait()
                for _ in range(5):
                    outs.append(env.run(_sum_col, data))
            except Exception as e:   # pragma: no cover - failure path
                errors.append(e)
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors
        # one miss, the rest hits (R3: the counters are locked)
        assert env.cache_misses == 1
        assert env.cache_hits == 39
        assert len(env._cache) == 1
        want = _jax_sum(data_np)
        for o in outs:
            np.testing.assert_array_equal(o["s"].numpy().reshape(-1), want)

    def test_fresh_env_shared_cache_zero_misses(self, rng):
        shared = _port()[3].ProgramCache(registry=False)
        data_np = {"v": _ints(rng, 256)}
        env1 = _port_env(program_cache=shared)
        t1 = _port_table(data_np, env1)
        env1.run(_sum_col, t1)
        assert (env1.cache_misses, env1.cache_hits) == (1, 0)

        env2 = _port_env(program_cache=shared)   # fresh gang, same slots
        t2 = _port_table(data_np, env2)
        out = env2.run(_sum_col, t2)
        assert env2.cache_misses == 0
        assert env2.cache_hits == 1
        np.testing.assert_array_equal(out["s"].numpy().reshape(-1),
                                      _jax_sum(data_np))

    def test_private_caches_stay_isolated(self, rng):
        data_np = {"v": _ints(rng, 64)}
        env1, env2 = _port_env(), _port_env()
        env1.run(_sum_col, _port_table(data_np, env1))
        env2.run(_sum_col, _port_table(data_np, env2))
        assert env1.cache_misses == 1
        assert env2.cache_misses == 1

    def test_gang_key_names_slots_device_and_communicator(self):
        tcore, _, _, tserve = _port()
        shared = tserve.ProgramCache(registry=False)
        pool = tcore.DevicePool(slots=4, device="cpu")
        lease = pool.reserve(2)
        a = tcore.CylonEnv(2, device="cpu", program_cache=shared)
        b = tcore.CylonEnv(devices=lease, program_cache=shared)
        assert a._gang_key == b._gang_key == ("cpu", (0, 1), "xla")
        c = tcore.CylonEnv(devices=pool.reserve(2), program_cache=shared)
        assert c._gang_key == ("cpu", (2, 3), "xla")
        d = tcore.CylonEnv(devices=lease, communicator="ring")
        assert d._gang_key == ("cpu", (0, 1), "ring")
        assert d.communicator_name == "ring"


# --------------------------------------------------------------------- #
# session(): scheduler scoping and exclusivity
# --------------------------------------------------------------------- #
class TestSessionArgs:
    def test_env_plus_communicator_raises(self):
        tdf = _port()[1]
        env = _port_env()
        with pytest.raises(TypeError, match="communicator"):
            with tdf.session(env=env, communicator="ring"):
                pass

    def test_env_plus_parallelism_or_device_still_raises(self):
        tdf = _port()[1]
        env = _port_env()
        with pytest.raises(TypeError, match="parallelism"):
            with tdf.session(env=env, parallelism=1):
                pass
        with pytest.raises(TypeError, match="device"):
            with tdf.session(env=env, device="cpu"):
                pass

    def test_session_communicator_builds_that_env(self):
        tdf = _port()[1]
        with tdf.session(parallelism=2, device="cpu",
                         communicator="bruck") as env:
            assert env.communicator_name == "bruck"
            assert tdf.get_env() is env

    def test_scheduler_exclusive_with_env_args(self):
        _, tdf, _, tserve = _port()
        env = _port_env()
        sched = tserve.QueryScheduler(gang_size=1, device="cpu")
        try:
            for kw in ({"env": env}, {"parallelism": 1}, {"device": "cpu"},
                       {"communicator": "ring"}):
                with pytest.raises(TypeError, match="scheduler"):
                    with tdf.session(scheduler=sched, **kw):
                        pass
            with tdf.session(scheduler=sched) as got:
                assert got is sched
                assert tdf.get_active_scheduler() is sched
                # a scheduler session scopes no env: get_env skips it
                with tdf.session(env=env):
                    assert tdf.get_env() is env
                    assert tdf.get_active_scheduler() is None
            assert tdf.get_active_scheduler() is None
        finally:
            sched.close()


# --------------------------------------------------------------------- #
# QueryScheduler
# --------------------------------------------------------------------- #
class _GatedFrame:
    """collect() that parks the worker until ``gate`` is set, then runs
    a real query; ``started`` says a worker took it."""

    def __init__(self, inner):
        self.inner = inner
        self.started = threading.Event()
        self.gate = threading.Event()

    def collect(self, **kw):
        self.started.set()
        assert self.gate.wait(120), "gate never opened"
        return self.inner.collect(**kw)


class _BoomFrame:
    def collect(self, **kw):
        raise ValueError("deliberate query failure")


def _data(seed=0, n=2048):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 20, n).astype(np.int32),
            "v": rng.integers(0, 256, n).astype(np.float32)}


def _query(df):
    return df[df.k > 5].groupby("k").agg({"v": ["sum"]}).sort_values("k")


@pytest.fixture(scope="module")
def expect():
    """The query's result from the JAX package on its one CPU device."""
    _, jdf, _, _ = _jax()
    return _query(jdf.read_numpy(_data())).collect().to_numpy()


@pytest.fixture
def frame():
    """The same data ingested by the port (one rank on the CPU), pinned
    to no env."""
    tdf = _port()[1]
    with tdf.session(device="cpu"):
        return tdf.read_numpy(_data())


def _sched(**kw):
    return _port()[3].QueryScheduler(device="cpu", **kw)


class TestQueryScheduler:
    def test_submit_result_matches_direct_collect(self, frame, expect):
        direct = _query(frame).collect(env=_port_env()).to_numpy()
        _same(direct, expect)
        with _sched(gang_size=1) as sched:
            handle = sched.submit(_query(frame))
            _same(handle.result(timeout=120).to_numpy(), expect)

    def test_handle_stats_lifecycle(self, frame):
        with _sched(gang_size=1) as sched:
            handle = sched.submit(_query(frame), label="lifecycle")
            handle.result(timeout=120)
        s = handle.stats
        assert s["label"] == "lifecycle"
        assert s["state"] == "done"
        assert s["devices"] == [0]
        assert s["queue_wait_s"] >= 0 and s["wall_s"] > 0
        assert s["submitted_at"] <= s["started_at"] <= s["finished_at"]
        assert s["cache_misses"] >= 0 and s["cache_hits"] >= 0
        assert handle.done() and handle.exception() is None

    def test_finished_query_is_recorded_in_metrics(self, frame):
        from repro_torch.obs.metrics import MetricsRegistry
        reg = MetricsRegistry()
        with _sched(gang_size=1, registry=reg, name="m") as sched:
            sched.submit(_query(frame)).result(timeout=120)
        snap = reg.snapshot()
        done = snap["counters"]["serve_completed_total"]
        assert done == [{"labels": {"scheduler": "m", "state": "done"},
                         "value": 1.0}]
        assert snap["query_records"][-1]["kind"] == "serve"
        assert "serve_query_wall_s" in snap["histograms"]

    def test_session_routes_collect_through_scheduler(self, frame, expect):
        tdf = _port()[1]
        with _sched(gang_size=1) as sched:
            with tdf.session(scheduler=sched):
                out = _query(frame).collect().to_numpy()
            assert sched.stats()["submitted"] == 1
        _same(out, expect)

    def test_ingest_in_scheduler_session_partitions_for_gang(self, expect):
        tdf = _port()[1]
        with _sched(gang_size=2, slots=4) as sched:
            with tdf.session(scheduler=sched):
                df = tdf.read_numpy(_data())
                src = next(iter(df.sources.values()))
                assert src.parallelism == 2 and src.device.type == "cpu"
                assert df._env is None
                out = _query(df).collect().to_numpy()
        _same(out, expect)

    def test_inner_env_session_masks_scheduler(self, frame):
        tdf = _port()[1]
        with _sched(gang_size=1) as sched:
            with tdf.session(scheduler=sched):
                with tdf.session(device="cpu") as env:  # innermost wins
                    _query(frame).collect()
                    assert env.cache_misses > 0
            assert sched.stats()["submitted"] == 0

    def test_repeat_query_fresh_gang_zero_misses(self, frame, expect):
        shared = _port()[3].ProgramCache(registry=False)
        with _sched(gang_size=1, program_cache=shared) as sched:
            h1 = sched.submit(_query(frame))
            _same(h1.result(timeout=120).to_numpy(), expect)
            assert h1.stats["cache_misses"] > 0
            h2 = sched.submit(_query(frame))    # fresh gang (new CylonEnv)
            _same(h2.result(timeout=120).to_numpy(), expect)
        assert h2.stats["cache_misses"] == 0
        assert h2.stats["cache_hits"] == \
            h1.stats["cache_misses"] + h1.stats["cache_hits"]

    def test_queueing_past_inflight_then_admission_reject(self, frame,
                                                          expect):
        tserve = _port()[3]
        sched = _sched(gang_size=1, max_inflight=1, max_queue=1)
        try:
            gated = _GatedFrame(_query(frame))
            h1 = sched.submit(gated)
            assert gated.started.wait(60)        # the worker took h1
            h2 = sched.submit(_query(frame))     # queued
            with pytest.raises(tserve.AdmissionRejected):
                sched.submit(_query(frame))      # over capacity: shed
            gated.gate.set()
            _same(h1.result(timeout=120).to_numpy(), expect)
            _same(h2.result(timeout=120).to_numpy(), expect)
            s = sched.stats()
            assert s["completed"] == 2 and s["rejected"] == 1
        finally:
            sched.close()

    def test_cancel_mid_queue(self, frame, expect):
        tfaults = _port()[2]
        sched = _sched(gang_size=1, max_inflight=1, max_queue=4)
        try:
            gated = _GatedFrame(_query(frame))
            h1 = sched.submit(gated)
            assert gated.started.wait(60)
            h2 = sched.submit(_query(frame))
            assert h2.cancel("changed my mind")
            with pytest.raises(tfaults.QueryCancelled):
                h2.result(timeout=5)             # resolves without a worker
            assert h2.stats["state"] == "cancelled"
            assert not h2.cancel()               # already finished
            gated.gate.set()
            _same(h1.result(timeout=120).to_numpy(), expect)  # unaffected
        finally:
            sched.close()

    def test_deadline_covers_queue_wait(self, frame, expect):
        tfaults = _port()[2]
        sched = _sched(gang_size=1, max_inflight=1, max_queue=4)
        try:
            gated = _GatedFrame(_query(frame))
            h1 = sched.submit(gated)
            assert gated.started.wait(60)
            h2 = sched.submit(_query(frame), timeout=0.1)  # expires queued
            deadline = time.monotonic() + 60
            while not h2.token.expired() and time.monotonic() < deadline:
                time.sleep(0.01)
            gated.gate.set()
            with pytest.raises(tfaults.QueryTimeout):
                h2.result(timeout=60)
            assert h2.stats["state"] == "timeout"
            _same(h1.result(timeout=120).to_numpy(), expect)
        finally:
            sched.close()

    def test_failed_query_propagates(self):
        with _sched(gang_size=1) as sched:
            handle = sched.submit(_BoomFrame())
            with pytest.raises(ValueError, match="deliberate"):
                handle.result(timeout=30)
            assert handle.stats["state"] == "failed"
            assert isinstance(handle.exception(), ValueError)

    def test_close_rejects_new_and_cancels_pending(self, frame):
        tfaults = _port()[2]
        sched = _sched(gang_size=1, max_inflight=1, max_queue=8)
        gated = _GatedFrame(_query(frame))
        h1 = sched.submit(gated)
        assert gated.started.wait(60)
        h2 = sched.submit(_query(frame))
        sched.close(cancel_pending=True, wait=False)
        with pytest.raises(tfaults.QueryCancelled):
            h2.result(timeout=5)
        with pytest.raises(RuntimeError, match="closed"):
            sched.submit(_query(frame))
        gated.gate.set()
        sched.close(wait=True)                   # workers drained
        assert h1.done()
        assert isinstance(h1.exception(), tfaults.QueryCancelled)

    def test_result_timeout_is_wait_bound_only(self, frame, expect):
        sched = _sched(gang_size=1)
        try:
            gated = _GatedFrame(_query(frame))
            handle = sched.submit(gated)
            with pytest.raises(TimeoutError):
                handle.result(timeout=0.05)
            gated.gate.set()
            _same(handle.result(timeout=120).to_numpy(), expect)
            assert handle.stats["state"] == "done"
        finally:
            sched.close()

    def test_validates_gang_size(self):
        with pytest.raises(ValueError):
            _sched(gang_size=0)
        with pytest.raises(ValueError):
            _sched(gang_size=99)
        with pytest.raises(TypeError):
            _port()[3].QueryScheduler(
                pool=_port()[0].DevicePool(device="cpu"), device="cpu")
        with _sched(gang_size=1) as sched:
            with pytest.raises(ValueError):
                sched.submit(object(), gang_size=99)

    def test_repr_and_handle_repr(self, frame):
        tserve = _port()[3]
        with _sched(gang_size=1, name="t") as sched:
            assert "t" in repr(sched)
            handle = sched.submit(_query(frame), label="shown")
            assert "shown" in repr(handle)
            handle.result(timeout=120)
            assert isinstance(handle, tserve.QueryHandle)


# --------------------------------------------------------------------- #
# Stress: serving_stress.py's queries, 8 slots, gangs of 2
# --------------------------------------------------------------------- #
N, GANG = 4000, 2
PARTS = [(0, 1), (2, 3), (4, 5), (6, 7)]
FAULTS = "stage:launch@0x1=raise;a2a:chunk@1x1=raise"


def _stress_data():
    rng = np.random.default_rng(7)
    nk = int(N * 0.9)
    ld = {"k": rng.integers(0, nk, N).astype(np.int32),
          "v0": rng.integers(0, 256, N).astype(np.float32),
          "junk": rng.integers(0, 256, N).astype(np.float32)}
    rd = {"k": rng.integers(0, nk, N).astype(np.int32),
          "w": rng.integers(0, 256, N).astype(np.float32)}
    return ld, rd


def _stress_queries(left, right, col):
    cap = next(iter(left.sources.values())).capacity
    jkw = dict(out_capacity=cap * 4, bucket_capacity=cap * 2,
               shuffle_out_capacity=cap * 2)
    return {
        "join": lambda: (left.merge(right, on="k", **jkw)
                         [(col("v0") > 4) & (col("w") < 250)]
                         .groupby("k").agg({"v0": ["sum"]})
                         .sort_values("k")),
        "groupby": lambda: (left.groupby("k")
                            .agg({"v0": ["sum", "mean"], "junk": ["max"]})
                            .sort_values("k")),
        "filter": lambda: (left[(col("v0") > 64) & (col("junk") < 200)]
                           .sort_values("k")),
    }


def _reference_main(path):
    """JAX side: 8 host devices, the queries on a 2-device env."""
    from repro.core import CylonEnv
    import repro.df as jdf
    from repro.expr import col
    import jax
    assert len(jax.devices()) == 8
    ld, rd = _stress_data()
    env = CylonEnv(jax.devices()[:GANG])
    left = jdf.read_numpy(ld, env=env, name="l")
    right = jdf.read_numpy(rd, env=env, name="r")
    out = {}
    for qname, q in _stress_queries(left, right, col).items():
        for c, a in q().collect(env=env).to_numpy().items():
            out[f"{qname}/{c}"] = a
    res, st = _stress_queries(left, right, col)["join"]().collect(
        env=env, mode="bsp_staged", a2a_chunks=2, collect_stats=True,
        faults=False)
    for c, a in res.to_numpy().items():
        out[f"join_staged/{c}"] = a
    np.savez(path, **out)


@pytest.fixture(scope="module")
def stress_reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve8") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    refs = {}
    for k, v in np.load(path).items():
        q, c = k.split("/", 1)
        refs.setdefault(q, {})[c] = v
    return refs


def test_stress_serving_matches_two_device_reference(stress_reference):
    tcore, tdf, tfaults, tserve = _port()
    from repro_torch.expr import col
    refs = stress_reference
    ld, rd = _stress_data()
    shared = tserve.ProgramCache(registry=False)
    pool = tcore.DevicePool(slots=8, device="cpu")
    sched = tserve.QueryScheduler(pool=pool, gang_size=GANG, max_inflight=4,
                                  max_queue=64, program_cache=shared,
                                  name="stress")
    # ingest inside the scheduler session: partitioned for gang_size=2,
    # pinned to no env, so the frames run on whichever gang is carved
    with tdf.session(scheduler=sched):
        left = tdf.read_numpy(ld, name="l")
        right = tdf.read_numpy(rd, name="r")
    queries = _stress_queries(left, right, col)
    names = sorted(queries)

    # warm every partition: each builds exactly the same number of stages
    per_part = None
    for part in PARTS:
        before = shared.misses
        env = tcore.CylonEnv(devices=[pool.devices[i] for i in part],
                             program_cache=shared)
        for qname, q in queries.items():
            _same(q().collect(env=env).to_numpy(), refs[qname])
        built = shared.misses - before
        assert built > 0 and built == (per_part or built), (part, built)
        per_part = built
    base = shared.misses

    # 16 mixed submissions from 8 threads
    handles, errors = [None] * 16, []
    barrier = threading.Barrier(8)

    def submitter(t):
        try:
            barrier.wait()
            for j in (2 * t, 2 * t + 1):
                handles[j] = (names[j % 3], sched.submit(
                    queries[names[j % 3]](), label=f"storm-{j}",
                    timeout=300.0))
        except Exception as e:  # pragma: no cover - failure path
            errors.append(e)
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    spans = []
    for qname, handle in handles:
        _same(handle.result(timeout=300).to_numpy(), refs[qname])
        s = handle.stats
        assert s["cache_misses"] == 0, (handle.label, s)
        assert tuple(s["devices"]) in set(PARTS), s["devices"]
        spans.append((s["started_monotonic"], s["finished_monotonic"],
                      frozenset(s["devices"])))
    for i, (a0, a1, da) in enumerate(spans):
        for b0, b1, db in spans[i + 1:]:
            if a0 < b1 and b0 < a1:
                assert not (da & db), "overlapping queries shared a slot"
    assert shared.misses == base, "the storm built a stage"

    # collect() inside session(scheduler=) from 8 threads
    route_errors = []

    def routed(t):
        try:
            with tdf.session(scheduler=sched):
                got = queries[names[t % 3]]().collect().to_numpy()
            _same(got, refs[names[t % 3]])
        except Exception as e:  # pragma: no cover - failure path
            route_errors.append(e)
    threads = [threading.Thread(target=routed, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not route_errors, route_errors
    assert shared.misses == base

    # cancellation mid-queue while the query in flight completes
    narrow = tserve.QueryScheduler(pool=pool, gang_size=GANG,
                                   max_inflight=1, max_queue=8,
                                   program_cache=shared, name="narrow")
    gated = _GatedFrame(queries["groupby"]())
    running = narrow.submit(gated)
    assert gated.started.wait(60)
    queued = [narrow.submit(queries[names[i % 3]]()) for i in range(3)]
    assert queued[1].cancel("mid-queue cancellation")
    with pytest.raises(tfaults.QueryCancelled):
        queued[1].result(timeout=5)
    gated.gate.set()
    _same(running.result(timeout=300).to_numpy(), refs["groupby"])
    for i in (0, 2):
        _same(queued[i].result(timeout=300).to_numpy(), refs[names[i % 3]])
    narrow.close()

    # faulted serving under a fixed-seed plan recovers bit-identically
    fkw = dict(mode="bsp_staged", a2a_chunks=2, collect_stats=True,
               faults=FAULTS,
               retries=tfaults.RetryPolicy(retries=6, backoff_s=0.001))
    fh = [sched.submit(queries["join"](), label=f"faulted-{i}", **fkw)
          for i in range(4)]
    fired = 0
    for handle in fh:
        out, st = handle.result(timeout=300)
        _same(out.to_numpy(), refs["join_staged"])
        assert st.rows_dropped == 0
        fired += st.faults_injected
    assert fired > 0, "fault plan never fired under serving"
    sched.close()
    assert pool.available == 8, "leaked slot leases"


if __name__ == "__main__":
    _reference_main(sys.argv[1])
