"""The paper's Fig-9 pipeline through repro_torch against the JAX package.

A module-scoped subprocess runs the JAX plan on 8 host devices (the
pattern of ``tests/test_multidevice.py``: ``XLA_FLAGS`` must be set
before jax is imported) in ``bsp``, ``bsp_staged`` and ``amt`` with the
optimizer on and off, and writes its inputs and results to an ``.npz``.
The port starts from the same input state (``DistTable.from_reference``)
on 8 stacked ranks on the CPU and must match slot for slot: keys, counts
and row placement exactly, the float ``v0_sum`` column to ``rtol=1e-5``
(summation order may differ).  Both packages run at their default
``adaptive`` (on): on the paper's uniform keys nothing fires, and on a
left table whose keys are 99% one value both salt the join.  This file
also checks EXPLAIN parity, the import boundary of ``repro_torch`` and
its entry points' refusals.

Run as a script (``python tests/test_torch_pipeline.py OUT.npz``) it is
the JAX side of that comparison.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "src")
P = 8
ROWS = P * 40        # rows per table
CAP = 64             # per-rank capacity: headroom so no capacity drops
MODES = ("bsp", "bsp_staged", "amt")
RTOL = 1e-5          # v0_sum: float sums in another order


def make_table_data(rows, seed, cardinality=0.9):
    """``benchmarks/common.py::make_table_data``: uniform int32 keys at
    90% cardinality, float32 values (the paper's §V recipe)."""
    rng = np.random.default_rng(seed)
    n_unique = max(1, int(rows * cardinality))
    return {"k": rng.integers(0, n_unique, rows).astype(np.int32),
            "v0": rng.random(rows).astype(np.float32)}


def fig9_plan(Plan, capacity):
    """``benchmarks/bench_pipeline.py::make_plan``."""
    return (Plan.scan("l")
            .join(Plan.scan("r"), on="k", out_capacity=capacity * 4,
                  bucket_capacity=capacity)
            .groupby(["k"], {"v0": ["sum"]}, bucket_capacity=capacity * 4)
            .sort(["k"], bucket_capacity=capacity * 4)
            .add_scalar(1.0, cols=["v0_sum"]))


STAT_KEYS = ("num_stages", "num_shuffles", "dispatches", "rows_shuffled",
             "bytes_shuffled", "rows_dropped")
SKEW_KEYS = STAT_KEYS + ("salted_shuffles", "degraded")


def make_skewed_data(rows, seed, hot=7, frac=0.99):
    """``make_table_data`` with ``frac`` of the keys equal to ``hot``
    (``tests/strategies.py::one_key_table``)."""
    d = make_table_data(rows, seed)
    rng = np.random.default_rng(seed + 100)
    d["k"] = np.where(rng.random(rows) < frac, hot, d["k"]).astype(np.int32)
    return d


def _reference_main(path):
    """JAX side: 8 host devices, every mode x optimize; writes ``path``."""
    from repro.core import CylonEnv, DistTable, Plan, execute
    env = CylonEnv()
    assert env.parallelism == P, env.parallelism
    tables = {n: DistTable.from_numpy(make_table_data(ROWS, s), P,
                                      capacity=CAP)
              for n, s in (("l", 0), ("r", 1))}
    out = {}
    for n, t in tables.items():
        for c, a in t.columns.items():
            out[f"in/{n}/{c}"] = np.asarray(a)
        out[f"in/{n}/__counts"] = np.asarray(t.row_counts)
    plan = fig9_plan(Plan, CAP)
    for mode in MODES:
        for opt in (True, False):
            res, st = execute(plan, env, tables, mode=mode, optimize=opt,
                              collect_stats=True)
            tag = f"{mode}/{int(opt)}"
            for c, a in res.columns.items():
                out[f"out/{tag}/{c}"] = np.asarray(a)
            out[f"out/{tag}/__counts"] = np.asarray(res.row_counts)
            out[f"stats/{tag}"] = np.array(
                [getattr(st, k) for k in STAT_KEYS], np.int64)
    skewed = {"l": DistTable.from_numpy(make_skewed_data(ROWS, 0), P,
                                        capacity=CAP), "r": tables["r"]}
    for mode in MODES:
        for opt in (True, False):
            res, st = execute(plan, env, skewed, mode=mode, optimize=opt,
                              collect_stats=True)
            tag = f"skew/{mode}/{int(opt)}"
            for c, a in res.columns.items():
                out[f"out/{tag}/{c}"] = np.asarray(a)
            out[f"out/{tag}/__counts"] = np.asarray(res.row_counts)
            out[f"stats/{tag}"] = np.array(
                [getattr(st, k) for k in SKEW_KEYS], np.int64)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("fig9") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return dict(np.load(path))


def port_tables(ref):
    from repro_torch.core import DistTable
    tables = {}
    for n in ("l", "r"):
        cols = {k.split("/")[2]: v for k, v in ref.items()
                if k.startswith(f"in/{n}/") and not k.endswith("__counts")}
        tables[n] = DistTable.from_reference(cols, ref[f"in/{n}/__counts"],
                                             CAP, device="cpu")
    return tables


@pytest.mark.parametrize("opt", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_fig9_matches_reference(reference, mode, opt):
    from repro_torch.core import CylonEnv, Plan, execute
    env = CylonEnv(P, device="cpu")
    tables = port_tables(reference)
    res, st = execute(fig9_plan(Plan, CAP), env, tables, mode=mode,
                      optimize=opt, collect_stats=True)
    tag = f"{mode}/{int(opt)}"
    cols, counts = res.to_reference()
    np.testing.assert_array_equal(counts, reference[f"out/{tag}/__counts"])
    want = {k.split("/")[3]: v for k, v in reference.items()
            if k.startswith(f"out/{tag}/") and not k.endswith("__counts")}
    assert sorted(cols) == sorted(want)
    np.testing.assert_array_equal(cols["k"], want["k"])
    np.testing.assert_allclose(cols["v0_sum"], want["v0_sum"], rtol=RTOL)
    np.testing.assert_array_equal(
        [getattr(st, k) for k in STAT_KEYS], reference[f"stats/{tag}"])
    assert st.rows_dropped == 0
    # a repeated run reuses every stage callable
    _, again = execute(fig9_plan(Plan, CAP), env, tables, mode=mode,
                       optimize=opt, collect_stats=True)
    assert again.cache_misses == 0 and again.cache_hits >= 1


@pytest.mark.parametrize("opt", [True, False])
@pytest.mark.parametrize("mode", MODES)
def test_fig9_skewed_matches_reference_at_default(reference, mode, opt):
    # 99% of the left keys are one value: at their default both packages
    # salt the join in bsp / bsp_staged (amt's all-gather is skew-immune)
    # and keep every row, slot for slot
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    env = CylonEnv(P, device="cpu")
    tables = port_tables(reference)
    tables["l"] = DistTable.from_numpy(make_skewed_data(ROWS, 0), P,
                                       capacity=CAP, device="cpu")
    res, st = execute(fig9_plan(Plan, CAP), env, tables, mode=mode,
                      optimize=opt, collect_stats=True)
    tag = f"skew/{mode}/{int(opt)}"
    cols, counts = res.to_reference()
    np.testing.assert_array_equal(counts, reference[f"out/{tag}/__counts"])
    want = {k.split("/")[4]: v for k, v in reference.items()
            if k.startswith(f"out/{tag}/") and not k.endswith("__counts")}
    assert sorted(cols) == sorted(want)
    np.testing.assert_array_equal(cols["k"], want["k"])
    np.testing.assert_allclose(cols["v0_sum"], want["v0_sum"], rtol=RTOL)
    np.testing.assert_array_equal(
        [getattr(st, k) for k in SKEW_KEYS], reference[f"stats/{tag}"])
    assert st.rows_dropped == 0
    if opt and mode != "amt":
        # optimized, the groupby after the join is rank-local: salting the
        # join alone keeps the whole plan in-core (unoptimized, the hot
        # key's join output re-shuffles onto one rank and both packages
        # degrade to out-of-core)
        assert st.salted_shuffles == 1 and st.degraded == 0
    _, again = execute(fig9_plan(Plan, CAP), env, tables, mode=mode,
                       optimize=opt, collect_stats=True)
    assert again.cache_misses == 0


# ---------------------------------------------------------------------- #
# EXPLAIN parity (planner only: no execution, no subprocess)
# ---------------------------------------------------------------------- #
CAT = {"l": (("k", "v0", "junk"), 8000), "r": (("k", "w"), 8000)}


def _explain_plans():
    from repro.core import Plan as JPlan
    from repro_torch.core import Plan as TPlan
    return [(fig9_plan(JPlan, 1024), fig9_plan(TPlan, 1024)),
            (JPlan.scan("l").join(JPlan.scan("r"), on="k")
             .groupby(["k"], {"v0": ["sum"]}).sort(["k"])
             .add_scalar(1.0, cols=["v0_sum"]),
             TPlan.scan("l").join(TPlan.scan("r"), on="k")
             .groupby(["k"], {"v0": ["sum"]}).sort(["k"])
             .add_scalar(1.0, cols=["v0_sum"]))]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("opt", [True, False])
def test_explain_parity(which, opt):
    from repro.planner import compile_plan as jcompile
    from repro_torch.planner import compile_plan as tcompile
    jp, tp = _explain_plans()[which]
    for mode in MODES:
        assert tp.explain(CAT, optimize=opt, mode=mode) == \
            jp.explain(CAT, optimize=opt, mode=mode)
    ja, ta = jcompile(jp, CAT, opt), tcompile(tp, CAT, opt)
    assert (ta.num_stages, ta.num_shuffles, ta.fired) == \
        (ja.num_stages, ja.num_shuffles, ja.fired)


def test_fingerprint_is_structural():
    from repro_torch.core import Plan
    from repro_torch.planner import fingerprint, from_plan
    a = fig9_plan(Plan, 64)
    b = fig9_plan(Plan, 64)
    c = fig9_plan(Plan, 128)
    fa, fb, fc = (fingerprint(from_plan(x.node, dict(CAT)))
                  for x in (a, b, c))
    assert fa == fb and fa != fc


# ---------------------------------------------------------------------- #
# Package boundary and refusals
# ---------------------------------------------------------------------- #
def test_repro_torch_imports_no_jax_or_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('OK', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ,
                                   PYTHONPATH=os.path.abspath(SRC)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    from repro_torch.core import CylonEnv, DistTable
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CylonEnv()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CylonEnv(P)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistTable.from_numpy(make_table_data(16, 0), 2)
    assert CylonEnv(P, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(retries=2), dict(timeout=60.0),
                                dict(faults="stage:launch=raise"),
                                dict(adaptive=True)],
                         ids=lambda kw: next(iter(kw)))
@pytest.mark.parametrize("morsel_rows", [None, 8])
def test_execute_refuses_later_slices(kw, morsel_rows):
    # ROADMAP queue 1, item 10 brought these options: accepted in-core and
    # out-of-core alike, they leave a fault-free result as it was (the
    # injected stage:launch fault exists in-core only, and is replayed)
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    env = CylonEnv(2, device="cpu")
    t = DistTable.from_numpy(make_table_data(32, 0), 2, device="cpu")
    plan = fig9_plan(Plan, 32)
    want = execute(plan, env, {"l": t, "r": t}, morsel_rows=morsel_rows)
    got, st = execute(plan, env, {"l": t, "r": t}, morsel_rows=morsel_rows,
                      collect_stats=True, **kw)
    assert st.retries == st.faults_injected == (
        1 if "faults" in kw and morsel_rows is None else 0)
    for c, w in want.to_numpy().items():
        np.testing.assert_array_equal(got.to_numpy()[c], w, err_msg=c)


@pytest.mark.parametrize("morsel_rows", [None, 8])
def test_execute_debug_overflow_warns(morsel_rows):
    # out-of-core, execute(debug_overflow=True) makes every morsel shuffle
    # warn, once per (op label, rank), naming both; in-core it is a plan
    # node option (Plan.shuffle(..., debug_overflow=True)) and execute
    # refuses the keyword, as the JAX package does
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    env = CylonEnv(2, device="cpu")
    data = {"k": np.zeros(64, np.int32), "v0": np.ones(64, np.float32)}
    if morsel_rows is None:
        t = DistTable.from_numpy(data, 2, device="cpu")
        with pytest.raises(TypeError, match="without morsel_rows"):
            execute(Plan.scan("l").shuffle(["k"]), env, {"l": t},
                    optimize=False, debug_overflow=True)
        plan = Plan.scan("l").shuffle(["k"], out_capacity=16,
                                      debug_overflow=True)
        tables, kw = {"l": t}, {}
    else:
        plan = Plan.scan("l").shuffle(["k"])
        tables = {"l": data}
        kw = dict(morsel_rows=morsel_rows, capacity_factor=1.0,
                  debug_overflow=True, overflow="warn")
    with pytest.warns(RuntimeWarning, match=r"shuffle\(k\) @ rank 0 "
                                            r"dropped rows") as w:
        execute(plan, env, tables, optimize=False, **kw)
    named = [str(x.message) for x in w if "@ rank" in str(x.message)
             and "dropped rows" in str(x.message)]
    assert len(named) == 1


def test_overflow_policies():
    # "raise" fails, "warn" keeps the truncated result, and the default
    # ("degrade") replays the plan out-of-core and returns every row of
    # an amply capacitated run
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    from repro_torch.faults import CapacityOverflow
    env = CylonEnv(4, device="cpu")
    t = DistTable.from_numpy(make_table_data(256, 3, cardinality=0.02), 4,
                             device="cpu")
    plan = Plan.scan("l").join(Plan.scan("r"), on="k", out_capacity=16)
    tables = {"l": t, "r": t}
    with pytest.raises(CapacityOverflow, match="dropped"):
        execute(plan, env, tables, collect_stats=True, overflow="raise")
    with pytest.warns(RuntimeWarning, match="dropped .* join\\(k\\)"):
        _, st = execute(plan, env, tables, collect_stats=True,
                        overflow="warn")
    assert st.rows_dropped > 0
    full, fst = execute(Plan.scan("l").join(
        Plan.scan("r"), on="k", out_capacity=16384, bucket_capacity=256,
        shuffle_out_capacity=256), env, tables, collect_stats=True)
    assert fst.rows_dropped == 0 and fst.degraded == 0
    out, st = execute(plan, env, tables, collect_stats=True)
    assert isinstance(out, DistTable)
    assert st.rows_dropped == 0 and st.degraded > 0
    got, want = out.to_numpy(), full.to_numpy()
    assert out.total_rows() == full.total_rows()
    order_g = np.lexsort((got["v0_r"], got["v0"], got["k"]))
    order_w = np.lexsort((want["v0_r"], want["v0"], want["k"]))
    for c in want:
        np.testing.assert_array_equal(got[c][order_g], want[c][order_w])


def test_compile_plan_refuses_dictionaries():
    # string dictionaries compile (planner.dictionary is ported); what
    # compile_plan refuses is what no dictionary supports, with the JAX
    # package's DictTypeError: a sum over a string column, and a string
    # key joined to a numeric one
    from repro_torch.core import Plan
    from repro_torch.planner import DictTypeError, compile_plan
    cat = {"t": (("s", "v"), 10, {"s": ("a", "b")})}
    plan = Plan.scan("t").groupby(["s"], {"v": ["sum"]})
    assert compile_plan(plan, cat).root.dicts == {"s": ("a", "b")}
    raw = {"t": {"s": np.array(["b", "a"]), "v": np.ones(2)}}
    assert compile_plan(plan, raw).root.dicts == {"s": ("a", "b")}
    with pytest.raises(DictTypeError, match="not defined on the"):
        compile_plan(Plan.scan("t").groupby(["v"], {"s": ["sum"]}), cat)
    with pytest.raises(DictTypeError, match="numeric key"):
        compile_plan(Plan.scan("t").join(Plan.scan("u"), on="s"),
                     {**cat, "u": (("s", "w"), 10)})


if __name__ == "__main__":
    _reference_main(sys.argv[1])
