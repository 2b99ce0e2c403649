"""The port's lazy DataFrame frontend (``repro_torch.df``) against
``repro.df``.

Frontend operations run through both packages on the inputs of
``tests/test_df_frontend.py`` (one rank each, on the CPU): keys, integer
columns, EXPLAIN text and row placement must be identical; float sums and
means are held to ``rtol=1e-5`` (another summation order).  The session
and env resolution rules, their ``TypeError`` cases and the options
deferred to later slices are checked on the port alone, as is
``session(devices=lease)``: on a small Fig-9 it gives the rows, slots and
EXPLAIN text of ``session(parallelism=len(lease))``, with the lease's slots
as the env's ranks.  Fig-9 through the frontend must equal Fig-9 built
with ``Plan`` in all three modes.

One case runs at 8 ranks: a module-scoped subprocess runs the JAX
frontend on 8 host devices (``XLA_FLAGS`` must be set before jax is
imported, as in ``tests/test_torch_pipeline.py``) and the port, started
from the same input state, must match it slot for slot.  Run as a script
(``python tests/test_torch_df.py OUT.npz``) this file is that JAX side.

About 30 s in one worker, 20 s of it the 8-rank subprocess; the
``session(devices=)`` cases take under 1 s.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "src")
RTOL = 1e-5            # float sums and means: another summation order
MODES = ("bsp", "bsp_staged", "amt")
P, ROWS, CAP = 8, 320, 128  # the 8-rank case: headroom, so no drops


def _data(rng, n=256, keys=32):
    """``tests/test_df_frontend.py::_data``."""
    return {"k": rng.integers(0, keys, n).astype(np.int32),
            "v0": rng.integers(0, 64, n).astype(np.float32),
            "junk": rng.random(n).astype(np.float32)}


def _fig9_sources(rng, n=512):
    """``tests/test_df_frontend.py::_fig9_sources`` (integer-valued float
    payloads, so the frontend and ``Plan`` runs agree bit for bit)."""
    ld = {"k": rng.integers(0, int(n * 0.9), n).astype(np.int32),
          "v0": rng.integers(0, 256, n).astype(np.float32),
          "junk": rng.random(n).astype(np.float32)}
    rd = {"k": rng.integers(0, int(n * 0.9), n).astype(np.int32),
          "w": rng.integers(0, 256, n).astype(np.float32)}
    return ld, rd


def fig9_frontend(l_df, r_df, cap, col):
    """``tests/test_df_frontend.py::fig9_frontend`` over either package's
    ``col``."""
    return (l_df.merge(r_df, on="k", out_capacity=cap * 4)
            [(col("v0") > 4) & (col("w") < 250)]
            .groupby("k").agg({"v0": ["sum", "mean"]})
            .sort_values("k")
            .assign(v0_sum=col("v0_sum") + 1.0))


def fig9_with_plan(Plan, cap, col):
    """The same pipeline built with ``Plan`` (``tests/test_df_frontend.py``)."""
    return (Plan.scan("l").join(Plan.scan("r"), on="k", out_capacity=cap * 4)
            .filter((col("v0") > 4) & (col("w") < 250))
            .groupby(["k"], {"v0": ["sum", "mean"]})
            .sort(["k"])
            .with_columns({"v0_sum": col("v0_sum") + 1.0}))


def _same(got, want, exact_floats=False):
    assert sorted(got) == sorted(want)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.shape == w.shape, c
        if w.dtype.kind == "f" and not exact_floats:
            np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


def _reference_main(path):
    """JAX side of the 8-rank case; writes inputs and results to ``path``."""
    import repro.df as rdf
    from repro.core import CylonEnv, DistTable
    from repro.expr import col
    env = CylonEnv()
    assert env.parallelism == P, env.parallelism
    ld, rd = _fig9_sources(np.random.default_rng(7), n=ROWS)
    tables = {"l": DistTable.from_numpy(ld, P, capacity=CAP),
              "r": DistTable.from_numpy(rd, P, capacity=CAP)}
    out = {}
    for n, t in tables.items():
        for c, a in t.columns.items():
            out[f"in/{n}/{c}"] = np.asarray(a)
        out[f"in/{n}/__counts"] = np.asarray(t.row_counts)
    front = fig9_frontend(rdf.from_table(tables["l"], name="l"),
                          rdf.from_table(tables["r"], name="r"), CAP, col)
    out["explain"] = np.asarray(front.explain())
    for mode in MODES:
        res = front.collect(env=env, mode=mode)
        for c, a in res.columns.items():
            out[f"out/{mode}/{c}"] = np.asarray(a)
        out[f"out/{mode}/__counts"] = np.asarray(res.row_counts)
    np.savez(path, **out)


# ---------------------------------------------------------------------- #
# Frontend operations against repro.df (one rank each, on the CPU)
# ---------------------------------------------------------------------- #
@pytest.fixture
def envs():
    import repro.df as jdf
    import repro_torch.df as tdf
    from repro.core import CylonEnv as JEnv
    from repro_torch.core import CylonEnv
    j, t = JEnv(), CylonEnv(1, device="cpu")
    jdf.set_default_env(j)
    tdf.set_default_env(t)
    yield j, t
    jdf.reset_default_env()
    tdf.reset_default_env()


def _both(build, *datas):
    """``build(col, frames...)`` through both frontends on the same host
    data; returns (port frame, JAX frame)."""
    import repro.df as jdf
    import repro_torch.df as tdf
    from repro.expr import col as jcol
    from repro_torch.expr import col
    out = []
    for rdf, c in ((tdf, col), (jdf, jcol)):
        frames = [rdf.read_numpy(d, name=f"t{i}")
                  for i, d in enumerate(datas)]
        out.append(build(c, *frames))
    return out


OPS = {
    "filter-assign-select": lambda c, df: (
        df[c("v0") * 2 > 10].assign(v1=c("v0") + 1, flag=c("k") % 2)
        [["k", "v1", "flag"]]),
    "with-columns": lambda c, df: df.with_columns({"v 2": c("v0") * 2}),
    "sort": lambda c, df: df.sort_values(["k", "v0"]),
    "groupby-all-aggs": lambda c, df: (
        df.groupby("k").agg({"v0": ["sum", "mean", "min", "max"]},
                            junk=["count", "size"]).sort_values("k")),
    "repartition-groupby": lambda c, df: (
        df.repartition("k").groupby("k").agg(v0="sum").sort_values("k")),
}


@pytest.mark.parametrize("op", sorted(OPS))
def test_frame_op_matches_jax(envs, rng, op):
    tf, jf = _both(OPS[op], _data(rng))
    assert tf.columns == jf.columns
    assert tf.explain() == jf.explain()
    assert tf.num_stages() == jf.num_stages()
    _same(tf.to_numpy(), jf.to_numpy())


def test_merge_groupby_sort_matches_jax(envs, rng):
    ld, rd = _data(rng), _data(rng)
    rd = {"k": rd["k"], "w": rd["v0"]}
    tf, jf = _both(lambda c, l, r: (
        l.merge(r, on="k", out_capacity=16384)
        .groupby("k").agg({"v0": ["sum", "mean"], "w": "max"})
        .sort_values("k")), ld, rd)
    assert tf.explain() == jf.explain()
    _same(tf.to_numpy(), jf.to_numpy())


MISSING = {
    "dropna": lambda c, df: df.dropna(),
    "dropna-subset": lambda c, df: df.dropna(subset=["v"]),
    "fillna": lambda c, df: df.fillna({"v": -1.0, "w": 0.5}),
    "fillna-subset": lambda c, df: df.fillna(7.0, subset=["w"]),
    "isna": lambda c, df: df.isna(subset=["v", "w"]),
}


@pytest.mark.parametrize("op", sorted(MISSING))
def test_missing_data_op_matches_jax(envs, op):
    rng = np.random.default_rng(5)
    v = rng.random(64).astype(np.float32)
    w = rng.random(64).astype(np.float32)
    v[rng.random(64) < 0.3] = np.nan
    w[rng.random(64) < 0.3] = np.nan
    data = {"k": rng.integers(0, 9, 64).astype(np.int32), "v": v, "w": w}
    tf, jf = _both(MISSING[op], data)
    assert tf.explain() == jf.explain()
    _same(tf.to_numpy(nulls="mask"), jf.to_numpy(nulls="mask"))


def test_from_pandas_round_trip_matches_jax(envs):
    pd = pytest.importorskip("pandas")
    import repro.df as jdf
    import repro_torch.df as tdf
    pdf = pd.DataFrame({"k": np.arange(10, dtype=np.int32),
                        "v": np.linspace(0, 1, 10, dtype=np.float32),
                        "s": list("bababababa"),
                        "c": pd.Categorical(list("xyxyxyxyxy"))})
    got = tdf.from_pandas(pdf).to_pandas()
    want = jdf.from_pandas(pdf).to_pandas()
    for c in pdf.columns:
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
        np.testing.assert_array_equal(got[c], np.asarray(pdf[c]), err_msg=c)
    with pytest.raises(TypeError, match="unsupported dtype"):
        tdf.from_pandas(pd.DataFrame({"t": pd.to_datetime(["2023-01-01"])}))
    with pytest.raises(TypeError, match="mixes strings with"):
        tdf.from_pandas(pd.DataFrame({"s": ["a", 3]}))


def test_schema_validation_errors(envs, rng):
    import repro_torch.df as tdf
    from repro_torch.expr import col
    df = tdf.read_numpy(_data(rng))
    with pytest.raises(KeyError, match="unknown column"):
        df.filter(col("nope") > 0)
    with pytest.raises(KeyError, match="unknown column"):
        df[["k", "nope"]]
    with pytest.raises(AttributeError, match="no attribute or column"):
        df.nope
    with pytest.raises(KeyError, match="unknown column"):
        df.groupby("nope")
    with pytest.raises(TypeError, match="typed expression"):
        df.filter(lambda t: t)
    with pytest.raises(TypeError, match="cannot index"):
        df[3]
    agg = df.groupby("k").agg(v0="sum")
    assert agg.columns == ("k", "v0_sum")
    with pytest.raises(KeyError):
        agg.sort_values("v0")
    with pytest.raises(ValueError, match="at least one"):
        df.groupby("k").agg()
    assert "v0" in dir(df) and df["k"].name == "k"
    assert repr(df).startswith("<repro_torch.df.DataFrame cols=")


def test_dataframes_immutable_and_shareable(envs, rng):
    import repro_torch.df as tdf
    df = tdf.read_numpy(_data(rng))
    with pytest.raises(AttributeError):
        df.plan = None
    base = df[df.v0 > 8]
    a = base.groupby("k").agg(v0="sum")
    b = base.sort_values("k")
    assert a.columns == ("k", "v0_sum") and b.columns == df.columns


# ---------------------------------------------------------------------- #
# Session and env resolution (the port alone)
# ---------------------------------------------------------------------- #
def test_session_scopes_env(envs):
    import repro_torch.df as tdf
    from repro_torch.core import CylonEnv
    from repro_torch.df.session import _stack
    _, env = envs
    inner = CylonEnv(2, device="cpu")
    assert tdf.get_env() is env
    with tdf.session(inner) as got:
        assert got is inner and tdf.get_env() is inner
        with tdf.session(parallelism=3, device="cpu") as nested:
            assert tdf.get_env() is nested
            assert nested.parallelism == 3 and nested.device.type == "cpu"
        assert tdf.get_env() is inner
    assert tdf.get_env() is env
    assert not _stack()


def test_collect_uses_session_env(rng):
    import repro_torch.df as tdf
    tdf.reset_default_env()
    with tdf.session(parallelism=2, device="cpu") as env:
        df = tdf.read_numpy(_data(rng, n=64))
        before = env.cache_misses
        df.filter(df.v0 > 8).collect()
        assert env.cache_misses == before + 1   # built on the session env
    tdf.reset_default_env()


def test_explicit_and_ingest_env_win(envs, rng):
    import repro_torch.df as tdf
    from repro_torch.core import CylonEnv, DistTable
    _, env = envs
    other = CylonEnv(1, device="cpu")
    df = tdf.read_numpy(_data(rng, n=64), env=other)
    df.collect(env=other)
    df.filter(df.v0 > 8).collect()          # pinned to its ingest env
    assert other.cache_misses == 2 and env.cache_misses == 0
    bad = tdf.from_table(DistTable.from_numpy(_data(rng, n=64), 2,
                                              device="cpu"))
    with pytest.raises(ValueError, match="partitioned for 2 ranks"):
        bad.collect()                       # the session env has 1 rank
    with pytest.raises(ValueError, match="different envs"):
        df.merge(tdf.read_numpy(_data(rng, n=8),
                                env=CylonEnv(1, device="cpu")), on="k")


def test_session_stack_is_thread_local(envs):
    import threading
    import repro_torch.df as tdf
    from repro_torch.core import CylonEnv
    _, env = envs
    seen = {}

    def other_thread():
        seen["env"] = tdf.get_env()

    with tdf.session(CylonEnv(1, device="cpu")):
        t = threading.Thread(target=other_thread)
        t.start()
        t.join(timeout=30)
    assert not t.is_alive()
    assert seen["env"] is env


def test_merge_rejects_source_name_collision(envs, rng):
    import repro_torch.df as tdf
    a = tdf.read_numpy(_data(rng, n=32), name="t")
    b = tdf.read_numpy(_data(rng, n=32), name="t")
    with pytest.raises(ValueError, match="source name collision"):
        a.merge(b, on="k")
    self_joined = a.merge(a.assign(v1=a.v0 + 1), on="k", out_capacity=4096)
    assert "v0_r" in self_joined.columns
    with pytest.raises(TypeError, match="another repro_torch.df"):
        a.merge(3, on="k")


@pytest.mark.parametrize("kw", [
    dict(env="E", parallelism=2), dict(env="E", device="cpu"),
    dict(env="E", scheduler=object()), dict(scheduler=object(),
                                           device="cpu")])
def test_session_mixed_arguments_raise_type_error(kw):
    import repro_torch.df as tdf
    from repro_torch.core import CylonEnv
    if kw.get("env") == "E":
        kw = dict(kw, env=CylonEnv(1, device="cpu"))
    with pytest.raises(TypeError, match="not both"):
        with tdf.session(**kw):
            pass


@pytest.mark.parametrize("kw,match", [
    (dict(env="E"), "not both"), (dict(scheduler=object()), "not both"),
    (dict(parallelism=4), "pass neither"), (dict(device="cpu"),
                                             "pass neither")])
def test_session_devices_mixed_arguments_raise_type_error(kw, match):
    # a lease fixes the parallelism and the device, and an env or a
    # scheduler pins its own
    import repro_torch.df as tdf
    from repro_torch.core import CylonEnv, DevicePool
    if kw.get("env") == "E":
        kw = dict(kw, env=CylonEnv(1, device="cpu"))
    with DevicePool(slots=4, device="cpu").reserve(4) as lease:
        with pytest.raises(TypeError, match=match):
            with tdf.session(devices=lease, **kw):
                pass


def test_session_devices_equals_session_parallelism(rng):
    # session(devices=lease) is session(parallelism=len(lease)) on the
    # lease's device: the same rows in the same slots and the same EXPLAIN
    # text, with the lease's slots as the env's ranks
    import repro_torch.df as tdf
    from repro_torch.expr import col
    from repro_torch.core import DevicePool
    ld, rd = _fig9_sources(rng)
    pool = DevicePool(slots=6, device="cpu")
    pool.reserve(2)                  # the gang's slots are not 0..3
    lease = pool.reserve(4)
    runs = []
    for kw in (dict(devices=lease), dict(parallelism=4, device="cpu")):
        with tdf.session(**kw) as env:
            front = fig9_frontend(tdf.read_numpy(ld, name="l"),
                                  tdf.read_numpy(rd, name="r"), 128, col)
            out, st = front.collect(collect_stats=True)
        assert env.parallelism == 4 and str(env.device) == "cpu"
        assert st.rows_dropped == 0
        runs.append((env, front.explain(), out.to_reference()))
    (lenv, lexp, (lcols, lcounts)), (penv, pexp, (pcols, pcounts)) = runs
    assert lenv.slot_ids == lease.indices == (2, 3, 4, 5)
    assert penv.slot_ids == (0, 1, 2, 3)
    # env.devices lists the slots, as the JAX package's env its devices
    assert lenv.devices == list(lease)
    assert [(d.id, str(d.device)) for d in penv.devices] == \
        [(i, "cpu") for i in range(4)]
    with tdf.session(devices=penv.devices) as again:
        assert again.slot_ids == penv.slot_ids
    assert lexp == pexp
    np.testing.assert_array_equal(lcounts, pcounts)
    assert lcounts.sum() > 0
    _same(lcols, pcols, exact_floats=True)


def test_default_env_is_the_card(monkeypatch):
    # CylonEnv() is the lazy default: on the card, raising without one
    import repro_torch.df as tdf
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tdf.reset_default_env()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdf.get_env()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdf.read_numpy({"k": np.arange(4, dtype=np.int32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with tdf.session(parallelism=2):
            pass
    tdf.reset_default_env()


DEFERRED = [
    ("collect(timeout=)", 10), ("collect(retries=)", 10),
    ("collect(faults=)", 10),
    ("collect(adaptive=)", 10), ("session(timeout=)", 10),
    ("session(adaptive=)", 10), ("session(scheduler=)", 11),
]


@pytest.mark.parametrize("what,item", DEFERRED)
def test_deferred_options_name_their_roadmap_item(envs, rng, what, item):
    # item 10 brought the fault-tolerance and adaptive options and item
    # 11 the query scheduler: on a collect or as a session they run, and
    # a fault-free query gives the plain collect's result
    import repro_torch.df as tdf
    from repro_torch.serve import QueryScheduler
    data = _data(rng, n=16)
    df = tdf.read_numpy(data)
    env = envs[1]

    def in_session(**kw):
        with tdf.session(env=env, **kw):
            return df.collect()

    def in_scheduler():
        with QueryScheduler(device="cpu") as sched:
            with tdf.session(scheduler=sched):
                out = df.collect()
            assert sched.stats()["completed"] == 1
        return out
    calls = {
        "collect(timeout=)": lambda: df.collect(timeout=60.0),
        "collect(retries=)": lambda: df.collect(retries=2),
        "collect(faults=)": lambda: df.collect(
            faults="stage:launch=raise"),
        "collect(adaptive=)": lambda: df.collect(adaptive=False),
        "session(timeout=)": lambda: in_session(timeout=60.0),
        "session(adaptive=)": lambda: in_session(adaptive=False),
        "session(scheduler=)": in_scheduler,
    }
    _same(calls[what]().to_numpy(), df.collect().to_numpy(),
          exact_floats=True)
    with pytest.raises(TypeError, match="capacity only applies"):
        tdf.read_numpy(data, spill=True, capacity=64)


# ---------------------------------------------------------------------- #
# Fig-9: frontend against Plan, and against repro.df
# ---------------------------------------------------------------------- #
def test_fig9_frontend_matches_plan_all_modes(envs, rng):
    import repro_torch.df as tdf
    from repro_torch.core import DistTable, Plan, execute
    from repro_torch.expr import col
    _, env = envs
    ld, rd = _fig9_sources(rng)
    lt = DistTable.from_numpy(ld, 1, device="cpu")
    rt = DistTable.from_numpy(rd, 1, device="cpu")
    front = fig9_frontend(tdf.from_table(lt, name="l"),
                          tdf.from_table(rt, name="r"), lt.capacity, col)
    plan = fig9_with_plan(Plan, lt.capacity, col)
    assert "<lambda>" not in front.explain()
    assert front.explain() == plan.explain({"l": lt, "r": rt})
    for mode in MODES:
        a, st = front.collect(mode=mode, collect_stats=True)
        b, bst = execute(plan, env, {"l": lt, "r": rt}, mode=mode,
                         collect_stats=True)
        assert st.rows_dropped == 0 and bst.cache_misses == 0
        _same(a.to_numpy(), b.to_numpy(), exact_floats=True)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("df8") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("mode", MODES)
def test_fig9_frontend_8_ranks_matches_jax(reference, mode):
    import repro_torch.df as tdf
    from repro_torch.core import CylonEnv, DistTable
    from repro_torch.expr import col
    tables = {}
    for n in ("l", "r"):
        cols = {k.split("/")[2]: v for k, v in reference.items()
                if k.startswith(f"in/{n}/") and not k.endswith("__counts")}
        tables[n] = DistTable.from_reference(
            cols, reference[f"in/{n}/__counts"], CAP, device="cpu")
    front = fig9_frontend(tdf.from_table(tables["l"], name="l"),
                          tdf.from_table(tables["r"], name="r"), CAP, col)
    assert front.explain() == str(reference["explain"])
    res, st = front.collect(env=CylonEnv(P, device="cpu"), mode=mode,
                            collect_stats=True)
    assert st.rows_dropped == 0
    cols, counts = res.to_reference()
    np.testing.assert_array_equal(counts, reference[f"out/{mode}/__counts"])
    want = {k.split("/")[2]: v for k, v in reference.items()
            if k.startswith(f"out/{mode}/") and not k.endswith("__counts")}
    _same(cols, want)


# ---------------------------------------------------------------------- #
# Package boundary
# ---------------------------------------------------------------------- #
def test_repro_torch_df_imports_no_jax_or_repro():
    # import the frontend and run a string pipeline through it on the CPU
    # (the planner imports some modules lazily), import the training
    # slice (data pipeline, train, the train driver, the loss), then look at
    # sys.modules
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import repro_torch.df as rdf\n"
        "with rdf.session(parallelism=2, device='cpu'):\n"
        "    l = rdf.read_numpy({'s': np.array(['b', 'a', 'c']),\n"
        "                        'v': np.arange(3.0)}, name='l')\n"
        "    r = rdf.read_numpy({'s': np.array(['c', 'd', 'a']),\n"
        "                        'w': np.arange(3.0)}, name='r')\n"
        "    out = (l.merge(r, on='s')[rdf.col('s') < 'c']\n"
        "           .groupby('s').agg(v=['sum', 'count']).sort_values('s')\n"
        "           .to_numpy())\n"
        "assert list(out['s']) == ['a'], out\n"
        "import repro_torch.data, repro_torch.train\n"
        "import repro_torch.launch.train\n"
        "from repro_torch.models.transformer import loss_fn\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'repro_torch.planner.dictionary' in sys.modules\n"
        "assert 'pandas' not in sys.modules\n"
        "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ,
                                   PYTHONPATH=os.path.abspath(SRC)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


if __name__ == "__main__":
    _reference_main(sys.argv[1])
