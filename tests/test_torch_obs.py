"""Observability (``repro_torch.obs``) against the JAX package's
``repro.obs``.

The cases of ``tests/test_obs.py`` run here.  The host-side pieces (spans,
``finish``, the Chrome export, the null tracer, ``resolve_tracer``, the
metrics registry) run the same script on both packages.  The executors
run the same plans on the same seeded numpy inputs through ``repro.core``
(one CPU device) and ``repro_torch.core`` (one rank on the CPU): stats,
shuffle records and the metrics they fold into the registry must match,
and so must the traces' span trees (names, categories, nesting and data
volumes; not times).  Tracing is invisible: on and off give the same
result, build no new stage and miss the stage cache never on a repeat.
Both drop warnings name the op and the rank.  EXPLAIN ANALYZE renders the
reference's text with the times masked; its roofline rows and wire bytes
are the reference's, and ``bound_s`` follows the card's formula with the
peaks passed in.
"""

import importlib
import json
import re

import numpy as np
import pytest

#: row width of the (int32 k, float32 v0) test tables
ROW_BYTES = 8
H100 = "NVIDIA H100 80GB HBM3"
PKGS = ["repro", "repro_torch"]


def _data(rng, n=96, keys=12):
    """Integer-valued float32 payloads: aggregation is exact, so traced and
    untraced runs must agree to the bit."""
    return {"k": rng.integers(0, keys, n).astype(np.int32),
            "v0": rng.integers(0, 64, n).astype(np.float32)}


def _obs(pkg):
    return importlib.import_module(f"{pkg}.obs")


@pytest.fixture(scope="module")
def envs():
    from repro.core import CylonEnv as JEnv
    from repro_torch.core import CylonEnv as TEnv
    return JEnv(), TEnv(1, device="cpu")


def _tables(data_by_name):
    from repro.core import DistTable as JDist
    from repro_torch.core import DistTable as TDist
    return ({n: JDist.from_numpy(d, 1) for n, d in data_by_name.items()},
            {n: TDist.from_numpy(d, 1, device="cpu")
             for n, d in data_by_name.items()})


def _plans(build):
    from repro.core import Plan as JPlan
    from repro_torch.core import Plan as TPlan
    return build(JPlan), build(TPlan)


def _np(table):
    return table.to_numpy()


def _same_cols(got, want):
    assert sorted(got) == sorted(want)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.dtype == w.dtype, c
        np.testing.assert_array_equal(g, w, err_msg=c)


def _records(st):
    return [(r.label, r.rows, r.bytes, r.dropped, r.per_rank_rows,
             r.segment) for r in st.shuffle_records]


def _tree(trace):
    """A trace's span tree without times or ids: (depth, name, category,
    attrs) in recording order; ``compiled`` (was a stage built) differs
    between runs, not packages, and is dropped."""
    depth = {}
    out = []
    for s in trace.spans:
        d = 0 if s.parent_id is None else depth[s.parent_id] + 1
        depth[s.span_id] = d
        attrs = {k: v for k, v in s.attrs.items()
                 if k not in ("compiled", "fingerprint")}
        out.append((d, s.name, s.category, s.instant, attrs))
    return out


def _fig9(Plan):
    return (Plan.scan("l").join(Plan.scan("r"), on="k", out_capacity=8192)
            .groupby(["k"], {"v0": ["sum"]}).sort(["k"]))


# ---------------------------------------------------------------------- #
# Tracer / Span mechanics (same script, both packages)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("pkg", PKGS)
def test_span_nesting_attrs_and_durations(pkg):
    tr = _obs(pkg).Tracer("t")
    with tr.span("query", "query") as q:
        with tr.span("stage:0", "stage", dispatch=0) as s:
            s.set(rows=10)
        tr.instant("chunk[0]", "chunk", bytes=64)
    assert q.span.end_s is not None
    trace = tr.finish()
    root = trace.root()
    assert root.name == "query" and root.parent_id is None
    assert [c.name for c in trace.children(root)] == ["stage:0", "chunk[0]"]
    stage = trace.find("stage")[0]
    assert stage.attrs == {"dispatch": 0, "rows": 10}
    assert root.duration_s >= stage.duration_s >= 0.0
    inst = trace.find("chunk")[0]
    assert inst.instant and inst.duration_s == 0.0
    assert trace.duration_s == root.duration_s


@pytest.mark.parametrize("pkg", PKGS)
def test_finish_closes_open_spans_and_is_idempotent(pkg):
    obs = _obs(pkg)
    tr = obs.Tracer()
    tr.span("query", "query")               # never exited
    t1 = tr.finish()
    assert t1.root().end_s is not None
    assert tr.finish() is t1                # frozen, not rebuilt
    assert obs.last_trace() is t1


def test_fence_returns_value_and_waits_on_tensors():
    import torch
    from repro_torch.core import DistTable
    from repro_torch.obs import Tracer
    from repro_torch.obs.trace import _cuda_devices
    tr = Tracer()
    t = DistTable.from_numpy({"k": np.arange(4, dtype=np.int32)}, 2,
                             device="cpu")
    with tr.span("s") as h:
        assert h.fence(41) == 41
        assert h.fence(t) is t              # CPU work is already done
    assert _cuda_devices((t, {"x": torch.zeros(2)}, [1]), set()) == set()


@pytest.mark.parametrize("pkg", PKGS)
def test_chrome_trace_export(pkg, tmp_path):
    tr = _obs(pkg).Tracer("q")
    with tr.span("query", "query"):
        with tr.span("stage:0", "stage"):
            tr.instant("shuffle(k)", "shuffle", rows=4, bytes=32)
    path = tmp_path / "trace.json"
    payload = tr.finish().to_chrome_trace(str(path))
    assert json.loads(path.read_text()) == payload
    assert payload["displayTimeUnit"] == "ms"
    evs = {e["name"]: e for e in payload["traceEvents"]}
    assert evs["query"]["ph"] == "X" and evs["shuffle(k)"]["ph"] == "i"
    assert evs["shuffle(k)"]["args"] == {"rows": 4, "bytes": 32}
    q, s = evs["query"], evs["stage:0"]
    assert q["ts"] == 0.0
    assert s["ts"] >= q["ts"]
    assert s["ts"] + s["dur"] <= q["ts"] + q["dur"] + 1e-3
    assert all(e["pid"] == 0 and e["tid"] == 0
               for e in payload["traceEvents"])


@pytest.mark.parametrize("pkg", PKGS)
def test_null_tracer_is_falsy_noop(pkg):
    null = _obs(pkg).NULL_TRACER
    assert not null and null.enabled is False
    with null.span("x", "stage", rows=1) as h:
        assert h.set(more=2) is h
        assert h.fence(42) == 42
    assert null.instant("y") is None
    assert null.finish() is None


@pytest.mark.parametrize("pkg", PKGS)
def test_resolve_tracer_env_and_args(pkg, monkeypatch):
    obs = _obs(pkg)
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    assert obs.resolve_tracer(None) is obs.NULL_TRACER
    monkeypatch.setenv("REPRO_TRACE", "1")
    assert isinstance(obs.resolve_tracer(None), obs.Tracer)
    monkeypatch.setenv("REPRO_TRACE", "0")
    assert obs.resolve_tracer(None) is obs.NULL_TRACER
    assert obs.resolve_tracer(False) is obs.NULL_TRACER
    assert isinstance(obs.resolve_tracer(True), obs.Tracer)
    t = obs.Tracer("mine")
    assert obs.resolve_tracer(t) is t
    assert obs.resolve_tracer(obs.NULL_TRACER) is obs.NULL_TRACER


# ---------------------------------------------------------------------- #
# Metrics registry
# ---------------------------------------------------------------------- #
def _registry_script(obs):
    reg = obs.MetricsRegistry(max_query_records=3)
    c = reg.counter("queries_total")
    c.inc(mode="bsp")
    c.inc(2, mode="bsp")
    c.inc(mode="amt")
    with pytest.raises(ValueError):
        c.inc(-1)
    assert reg.counter("queries_total") is c
    g = reg.gauge("queue_depth")
    g.set(5)
    g.set(2)
    h = reg.histogram("wall", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 10.0):
        h.observe(v)
    for i in range(5):
        reg.record_query({"i": i})
    obs.record_serve_query({"state": "done", "queue_wait_s": 0.01,
                            "wall_s": 0.2, "t_monotonic": 1.0},
                           scheduler="s", registry=reg)
    snap = json.loads(reg.to_json())
    for r in snap["query_records"]:
        r.pop("recorded_at")
    return (c.value(mode="bsp"), c.value(mode="amt"), c.value(mode="nope"),
            g.value(), h.series(), snap)


@pytest.mark.parametrize("pkg", PKGS)
def test_counter_gauge_histogram_and_records(pkg):
    bsp, amt, nope, gauge, series, snap = _registry_script(_obs(pkg))
    assert (bsp, amt, nope, gauge) == (3, 1, 0, 2)
    assert series["count"] == 3 and series["bucket_counts"] == [1, 1, 1]
    assert series["min"] == 0.05 and series["sum"] == 10.55
    assert snap["counters"]["queries_total"][0]["labels"] == {"mode": "amt"}
    assert [r.get("i") for r in snap["query_records"]] == [3, 4, None]
    assert snap["query_records"][-1]["kind"] == "serve"
    assert "t_monotonic" not in snap["query_records"][-1]


def test_registry_matches_reference():
    assert _registry_script(_obs("repro_torch")) == \
        _registry_script(_obs("repro"))


@pytest.mark.parametrize("pkg", PKGS)
def test_query_record_reset(pkg):
    reg = _obs(pkg).MetricsRegistry()
    reg.record_query({"i": 0})
    reg.counter("c").inc()
    reg.reset()
    assert reg.query_records == []
    assert reg.snapshot()["counters"] == {}


def test_record_exec_folds_stats_into_registry(envs, rng):
    from repro.core import execute as jexec
    from repro.obs import MetricsRegistry as JReg, record_exec as jrec
    from repro_torch.core import execute as texec
    from repro_torch.obs import MetricsRegistry as TReg, record_exec as trec
    jt, tt = _tables({"l": _data(rng)})
    jp, tp = _plans(lambda P: P.scan("l").shuffle(["k"]))
    _, jst = jexec(jp, envs[0], jt, optimize=False, collect_stats=True)
    _, tst = texec(tp, envs[1], tt, optimize=False, collect_stats=True)
    jreg, treg = JReg(), TReg()
    jr = jrec(jst, "fp123", 0.5, query="q1", registry=jreg)
    tr = trec(tst, "fp123", 0.5, query="q1", registry=treg)
    assert tr["fingerprint"] == "fp123" and tr["mode"] == "bsp"
    assert treg.counter("queries_total").value(mode="bsp") == 1
    assert treg.histogram("query_wall_s").series(mode="bsp")["count"] == 1
    for k in ("query", "fingerprint", "mode", "wall_time_s", "dispatches",
              "num_stages", "num_shuffles", "rows_shuffled",
              "bytes_shuffled", "rows_dropped", "shuffle_impl", "morsels",
              "rows_read", "bytes_read"):
        assert tr[k] == jr[k], k
    jc = jreg.snapshot()["counters"]
    tc = treg.snapshot()["counters"]
    assert tc == jc


# ---------------------------------------------------------------------- #
# Counter accuracy: stats, records and the registry match the reference
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["bsp", "bsp_staged", "amt"])
def test_counter_accuracy_all_modes(envs, rng, mode):
    from repro.core import execute as jexec
    from repro.obs import METRICS as JM
    from repro_torch.core import execute as texec
    from repro_torch.obs import METRICS as TM
    n = 96
    data = _data(rng, n)
    jt, tt = _tables({"l": data})
    jp, tp = _plans(lambda P: P.scan("l").shuffle(["k"]).groupby(
        ["k"], {"v0": ["sum"]}))
    before = (JM.counter("rows_shuffled_total").value(mode=mode),
              TM.counter("rows_shuffled_total").value(mode=mode))
    want, jst = jexec(jp, envs[0], jt, mode=mode, optimize=False,
                      collect_stats=True)
    got, tst = texec(tp, envs[1], tt, mode=mode, optimize=False,
                     collect_stats=True)
    assert tst.rows_shuffled == jst.rows_shuffled == 2 * n
    assert tst.bytes_shuffled == jst.bytes_shuffled == 2 * n * ROW_BYTES
    assert tst.rows_dropped == 0
    assert _records(tst) == _records(jst)
    after = (JM.counter("rows_shuffled_total").value(mode=mode),
             TM.counter("rows_shuffled_total").value(mode=mode))
    assert after[1] - before[1] == after[0] - before[0] == 2 * n
    assert TM.query_records[-1]["fingerprint"] == \
        JM.query_records[-1]["fingerprint"]
    _same_cols(_np(got), _np(want))


def test_counter_accuracy_out_of_core(envs, rng):
    from repro.core import execute as jexec
    from repro_torch.core import execute as texec
    n, m = 96, 16
    data = _data(rng, n)
    jp, tp = _plans(lambda P: P.scan("l").shuffle(["k"]))
    want, jst = jexec(jp, envs[0], {"l": data}, optimize=False,
                      collect_stats=True, morsel_rows=m, adaptive=False)
    got, tst = texec(tp, envs[1], {"l": data}, optimize=False,
                     collect_stats=True, morsel_rows=m, adaptive=False)
    assert tst.morsels == jst.morsels == n // m
    assert tst.rows_shuffled == n and tst.bytes_shuffled == n * ROW_BYTES
    assert _records(tst) == _records(jst)
    assert got.total_rows() == want.total_rows() == n


@pytest.mark.parametrize("mode", ["bsp_staged", "amt"])
def test_cache_hit_accuracy_and_timing_fields(rng, mode):
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    env = CylonEnv(1, device="cpu")
    t = DistTable.from_numpy(_data(rng), 1, device="cpu")
    plan = Plan.scan("l").shuffle(["k"]).groupby(["k"], {"v0": ["sum"]})
    _, s1 = execute(plan, env, {"l": t}, mode=mode, optimize=False,
                    collect_stats=True)
    assert s1.cache_hits + s1.cache_misses == s1.dispatches
    _, s2 = execute(plan, env, {"l": t}, mode=mode, optimize=False,
                    collect_stats=True)
    assert s2.cache_misses == 0 and s2.cache_hits == s2.dispatches
    want = (["stage:0", "stage:1"] if mode == "bsp_staged"
            else [f"op:{i}:{op}" for i, op in
                  enumerate(("scan", "shuffle", "groupby"))])
    assert [nm for nm, _ in s2.stage_times] == want
    assert s2.wall_time_s > 0
    assert all(secs >= 0 for _, secs in s2.stage_times)
    assert sum(secs for _, secs in s2.stage_times) <= s2.wall_time_s + 1e-6


# ---------------------------------------------------------------------- #
# Tracing is invisible to results and to the stage cache; the span tree
# is the reference's
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["bsp", "bsp_staged", "amt"])
def test_tracing_invisible_and_tree_matches_reference(envs, rng, mode):
    from repro.core import execute as jexec
    from repro.obs import Tracer as JTracer
    from repro_torch.core import execute as texec
    from repro_torch.obs import Tracer as TTracer, last_trace
    from repro_torch.planner import compile_plan
    ld = _data(rng, 128)
    rd = {"k": rng.integers(0, 12, 64).astype(np.int32),
          "w": rng.integers(0, 64, 64).astype(np.float32)}
    jt, tt = _tables({"l": ld, "r": rd})
    jp, tp = _plans(_fig9)
    env = envs[1]
    ref, _ = texec(tp, env, tt, mode=mode, collect_stats=True)
    keys0 = set(env._cache)
    tr = TTracer("rerun")
    out, s1 = texec(tp, env, tt, mode=mode, collect_stats=True, trace=tr)
    assert set(env._cache) == keys0          # tracing built NOTHING new
    assert s1.cache_misses == 0 and s1.cache_hits == s1.dispatches
    _same_cols(_np(out), _np(ref))
    trace = tr.finish()
    root = trace.root()
    assert root.category == "query"
    assert root.attrs["fingerprint"] == compile_plan(tp, tt).fingerprint
    assert trace.find("stage") and trace.find("shuffle")
    assert last_trace() is trace
    # the reference's tree, span for span
    jexec(jp, envs[0], jt, mode=mode, collect_stats=True, adaptive=False)
    jtr = JTracer("rerun")
    jexec(jp, envs[0], jt, mode=mode, collect_stats=True, trace=jtr,
          adaptive=False)
    assert _tree(trace) == _tree(jtr.finish())
    assert root.attrs["fingerprint"] == jtr.finish().root().attrs[
        "fingerprint"]


def test_tracing_invisible_out_of_core(envs, rng):
    from repro.core import execute as jexec
    from repro.obs import Tracer as JTracer
    from repro_torch.core import execute as texec
    from repro_torch.obs import Tracer as TTracer
    data = _data(rng, 128)
    jp, tp = _plans(lambda P: P.scan("l").shuffle(["k"]).groupby(
        ["k"], {"v0": ["sum"]}))
    kw = dict(optimize=False, collect_stats=True, morsel_rows=32,
              adaptive=False)
    env = envs[1]
    ref, _ = texec(tp, env, {"l": data}, **kw)
    keys0 = set(env._cache)
    tr = TTracer("ooc")
    out, s1 = texec(tp, env, {"l": data}, trace=tr, **kw)
    assert set(env._cache) == keys0
    assert s1.cache_misses == 0
    _same_cols(out.to_numpy(), ref.to_numpy())
    trace = tr.finish()
    assert trace.find("morsel")              # per-morsel spans
    assert trace.find("transfer", "h2d")     # MorselSource H2D volumes
    jtr = JTracer("ooc")
    jexec(jp, envs[0], {"l": data}, trace=jtr, **kw)
    assert _tree(trace) == _tree(jtr.finish())


# ---------------------------------------------------------------------- #
# Drop diagnostics name the op label and rank
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("pkg", PKGS)
def test_shuffle_drop_warning_names_label_and_rank(pkg, rng):
    core = importlib.import_module(f"{pkg}.core")
    kw = {} if pkg == "repro" else {"device": "cpu"}
    env = core.CylonEnv(**kw)
    t = core.DistTable.from_numpy(_data(rng, 128), 1, **kw)
    plan = core.Plan.scan("l").shuffle(["k"], out_capacity=32,
                                       debug_overflow=True)
    with pytest.warns(RuntimeWarning, match=r"shuffle\(k\) @ rank 0") as w:
        out = core.execute(plan, env, {"l": t}, optimize=False)
        np.asarray(out.row_counts)           # force execution + callback
    msgs = [str(x.message) for x in w if "@ rank" in str(x.message)]
    assert len(msgs) == 1 and "recv_dropped=96" in msgs[0]


def test_debug_overflow_warns_once_per_label_and_rank_out_of_core():
    # every morsel drops rows on every rank; the port warns once per
    # (label, rank) per query, naming both, and again in the next query
    from repro_torch.core import CylonEnv, Plan, execute
    env = CylonEnv(2, device="cpu")
    data = {"k": np.zeros(128, np.int32), "v0": np.ones(128, np.float32)}
    plan = Plan.scan("l").shuffle(["k"])
    for _ in range(2):
        with pytest.warns(RuntimeWarning) as w:
            _, st = execute(plan, env, {"l": data}, optimize=False,
                            morsel_rows=16, capacity_factor=1.0,
                            overflow="warn", debug_overflow=True,
                            collect_stats=True)
        per_rank = [str(x.message) for x in w if "@ rank" in str(x.message)
                    and "dropped rows" in str(x.message)]
        assert len(per_rank) == 1 and \
            per_rank[0].startswith("shuffle(k) @ rank 0")
        assert st.rows_dropped > 0 and st.morsels == 4


@pytest.mark.parametrize("pkg", PKGS)
def test_morsel_drop_warning_attributes_loss(pkg):
    core = importlib.import_module(f"{pkg}.core")
    env = (core.CylonEnv() if pkg == "repro"
           else core.CylonEnv(1, device="cpu"))
    ld = {"k": np.zeros(64, np.int32), "v0": np.ones(64, np.float32)}
    rd = {"k": np.zeros(64, np.int32), "w": np.ones(64, np.float32)}
    plan = core.Plan.scan("l").join(core.Plan.scan("r"), on="k")
    with pytest.warns(RuntimeWarning,
                      match=r"capacity pressure \(join\(k\).*@ rank 0"):
        core.execute(plan, env, {"l": ld, "r": rd}, optimize=False,
                     morsel_rows=16, overflow="warn", adaptive=False)


# ---------------------------------------------------------------------- #
# EXPLAIN ANALYZE
# ---------------------------------------------------------------------- #
def _mask_times(text):
    text = re.sub(r"wall=[0-9.]+s", "wall=?", text)
    return re.sub(r"[0-9]+\.[0-9]{4}s", "?s", text)


@pytest.mark.parametrize("mode", ["bsp_staged", "bsp", "morsel"])
def test_run_analyzed_matches_reference(envs, rng, tmp_path, mode):
    from repro.obs import run_analyzed as janalyzed
    from repro_torch.launch.roofline import DEVICE_PEAKS, stage_roofline
    from repro_torch.obs import run_analyzed as tanalyzed
    ld = _data(rng, 128)
    rd = {"k": rng.integers(0, 12, 64).astype(np.int32),
          "w": rng.integers(0, 64, 64).astype(np.float32)}
    jt, tt = _tables({"l": ld, "r": rd})
    jp, tp = _plans(_fig9)
    kw = dict(mode="bsp_staged") if mode == "morsel" else dict(mode=mode)
    if mode == "morsel":
        jt, tt = {"l": ld, "r": jt["r"]}, {"l": ld, "r": tt["r"]}
        kw["morsel_rows"] = 32
    peaks = DEVICE_PEAKS[H100]
    result, report = tanalyzed(tp, envs[1], tt, peaks=peaks,
                               adaptive=False, **kw)
    _, jreport = janalyzed(jp, envs[0], jt, adaptive=False, **kw)
    text = report.explain_analyze()
    assert _mask_times(text) == _mask_times(jreport.explain_analyze())
    assert "act: moved" in text and "rows=128" in text
    assert f"out_rows={result.total_rows()}" in text
    rows = report.stage_table()
    jrows = jreport.stage_table()
    assert [(r["stage"], r["ops"], r["rows_shuffled"], r["wire_bytes"])
            for r in rows] == \
        [(r["stage"], r["ops"], r["rows_shuffled"], r["wire_bytes"])
         for r in jrows]
    secs = dict((int(n.split(":")[1]), s) for n, s in report.stats.stage_times
                if n.startswith("stage:"))
    for r in rows:
        # the card's formula: 2x wire through HBM for pack and unpack,
        # plus the transpose reading and writing the wire once, one card
        want = 4.0 * r["wire_bytes"] / peaks.hbm_bytes_per_s
        assert r["bound_s"] == pytest.approx(want, rel=1e-12)
        assert r["bound_s"] == stage_roofline(r["wire_bytes"],
                                              r["elapsed_s"],
                                              peaks)["step_s_lower_bound"]
        assert r["elapsed_s"] == secs.get(r["stage"])
        if r["elapsed_s"]:
            assert r["roofline_fraction"] == pytest.approx(
                want / r["elapsed_s"], rel=1e-12)
    md = report.roofline_table()
    assert md.splitlines()[0] == jreport.roofline_table().splitlines()[0]
    d = json.loads(report.to_json())
    assert d["device"] == H100 and d["rows_dropped"] == 0
    assert d["fingerprint"] == report.pplan.fingerprint == \
        jreport.pplan.fingerprint
    assert d["rows_shuffled"] == report.stats.rows_shuffled
    assert d["bytes_shuffled"] == report.stats.bytes_shuffled
    payload = report.to_chrome_trace(str(tmp_path / "t.json"))
    evs = payload["traceEvents"]
    assert {"query", "stage"} <= {e["cat"] for e in evs}
    roots = [e for e in evs if e["cat"] == "query"]
    assert len(roots) == 1
    assert str(report).startswith("== EXPLAIN ANALYZE")


def test_run_analyzed_trace_off_and_cpu_peaks(rng):
    from repro_torch.core import CylonEnv, DistTable, Plan
    from repro_torch.launch.roofline import DEVICE_PEAKS
    from repro_torch.obs import run_analyzed
    env = CylonEnv(1, device="cpu")
    t = DistTable.from_numpy(_data(rng), 1, device="cpu")
    plan = Plan.scan("l").groupby(["k"], {"v0": ["sum"]})
    _, report = run_analyzed(plan, env, {"l": t}, trace=False)
    assert report.trace is None
    with pytest.raises(ValueError, match="no trace attached"):
        report.to_chrome_trace()
    assert "EXPLAIN ANALYZE" in report.explain_analyze()
    # no peaks for the CPU: the bound is the card's or nothing
    with pytest.raises(ValueError, match="'cpu'"):
        report.stage_table()
    with pytest.raises(ValueError, match="'cpu'"):
        str(report)
    _, report = run_analyzed(plan, env, {"l": t}, trace=False,
                             peaks=DEVICE_PEAKS[H100])
    assert report.stage_table()


def test_df_collect_analyze(rng):
    import repro_torch.df as tdf
    from repro_torch.launch.roofline import DEVICE_PEAKS
    with tdf.session(parallelism=2, device="cpu"):
        df = tdf.read_numpy(_data(rng))
        out, report = df.groupby("k").agg(v0="sum").collect(
            analyze=True, peaks=DEVICE_PEAKS[H100])
        assert "act:" in report.explain_analyze()
        assert report.result_rows == out.total_rows()
        assert report.trace is not None
        with pytest.raises(TypeError, match="already collects stats"):
            df.collect(analyze=True, collect_stats=True)
        text = df.groupby("k").agg(v0="sum").explain_analyze(
            peaks=DEVICE_PEAKS[H100])
        assert "EXPLAIN ANALYZE" in text and "| stage |" in text
        traced = df.groupby("k").agg(v0="sum").collect(trace=True)
        assert traced.total_rows() == out.total_rows()


def test_roofline_peaks_table():
    from repro_torch.launch.roofline import (DEVICE_PEAKS, device_peaks,
                                             peaks_for, roofline_terms)
    peaks = peaks_for(H100)
    assert peaks is DEVICE_PEAKS[H100]
    assert (peaks.hbm_bytes_per_s, peaks.f32_flops_per_s,
            peaks.bf16_flops_per_s) == (3.35e12, 67e12, 989e12)
    with pytest.raises(ValueError, match="'NVIDIA A100"):
        peaks_for("NVIDIA A100-SXM4-40GB")
    with pytest.raises(ValueError, match="'cpu'"):
        device_peaks("cpu")
    t = roofline_terms(0.0, 2e9, 1e9, peaks, devices=2)
    assert t["memory_s"] == pytest.approx(2e9 / (2 * 3.35e12))
    assert t["collective_s"] == pytest.approx(2e9 / (2 * 3.35e12))
    assert t["step_s_lower_bound"] == pytest.approx(4e9 / (2 * 3.35e12))
    assert t["dominant"] == "memory"


# ---------------------------------------------------------------------- #
# Faults and adaptivity in spans and EXPLAIN ANALYZE
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["bsp_staged", "bsp", "morsel"])
def test_run_analyzed_matches_reference_at_default(envs, rng, mode):
    # both packages at their default adaptive: out-of-core the morsel
    # tuner replans the degrade steps, and the header says so
    # (adapt[salted= refreshes= autotune=]) in both texts
    from repro.obs import run_analyzed as janalyzed
    from repro_torch.launch.roofline import DEVICE_PEAKS
    from repro_torch.obs import run_analyzed as tanalyzed
    ld = _data(rng, 128)
    rd = {"k": rng.integers(0, 12, 64).astype(np.int32),
          "w": rng.integers(0, 64, 64).astype(np.float32)}
    jt, tt = _tables({"l": ld, "r": rd})
    jp, tp = _plans(_fig9)
    kw = dict(mode="bsp_staged") if mode == "morsel" else dict(mode=mode)
    if mode == "morsel":
        jt, tt = {"l": ld, "r": jt["r"]}, {"l": ld, "r": tt["r"]}
        kw["morsel_rows"] = 32
    _, report = tanalyzed(tp, envs[1], tt, peaks=DEVICE_PEAKS[H100], **kw)
    _, jreport = janalyzed(jp, envs[0], jt, **kw)
    text = report.explain_analyze()
    assert _mask_times(text) == _mask_times(jreport.explain_analyze())
    assert ("adapt[salted=0 refreshes=0 autotune=" in text) == \
        (mode == "morsel")
    got, want = report.to_dict(), jreport.to_dict()
    for k in ("retries", "degraded", "faults_injected", "adaptive",
              "salted_shuffles", "splitter_refreshes", "autotune_steps",
              "adapt_events"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("mode", ["bsp_staged", "morsel"])
def test_retry_spans_and_header_match_reference(envs, rng, mode):
    # a fault at the first dispatch unit: the trace gets the reference's
    # retry:<unit> instant, and out-of-core the replayed segment's spans;
    # EXPLAIN ANALYZE's header reports retries= degraded= as the
    # reference does
    from repro.core import execute as jexec
    from repro.obs import Tracer as JTracer, run_analyzed as janalyzed
    from repro_torch.core import execute as texec
    from repro_torch.launch.roofline import DEVICE_PEAKS
    from repro_torch.obs import Tracer as TTracer, run_analyzed as tanalyzed
    ld = _data(rng, 128)
    rd = {"k": rng.integers(0, 12, 64).astype(np.int32),
          "w": rng.integers(0, 64, 64).astype(np.float32)}
    jt, tt = _tables({"l": ld, "r": rd})
    jp, tp = _plans(_fig9)
    kw = dict(mode="bsp_staged", collect_stats=True)
    faults = "stage:launch@0=raise"
    if mode == "morsel":
        jt, tt = {"l": ld, "r": jt["r"]}, {"l": ld, "r": tt["r"]}
        kw = dict(collect_stats=True, morsel_rows=32)
        faults = "morsel:execute@1=raise"
    ttr, jtr = TTracer("faults"), JTracer("faults")
    _, tst = texec(tp, envs[1], tt, trace=ttr, faults=faults, **kw)
    _, jst = jexec(jp, envs[0], jt, trace=jtr, faults=faults, **kw)
    assert tst.retries == jst.retries == 1
    tree, jtree = _tree(ttr.finish()), _tree(jtr.finish())
    assert tree == jtree
    assert [t for t in tree if t[1].startswith("retry:")]
    if mode == "morsel":
        # the faulted segment's morsel spans are recorded twice: the
        # attempt that failed and the replay
        assert sum(t[1] == "morsel[0]" for t in tree) >= 2
    kw.pop("collect_stats")
    _, report = tanalyzed(tp, envs[1], tt, peaks=DEVICE_PEAKS[H100],
                          faults=faults, **kw)
    _, jreport = janalyzed(jp, envs[0], jt, faults=faults, **kw)
    text = report.explain_analyze()
    assert "retries=1 degraded=" in text
    assert _mask_times(text) == _mask_times(jreport.explain_analyze())


#: rows of the 8-rank one-key table (``skew_parity.py``'s recipe, cut)
N_SKEW = 4000


def _skew_explain(core, obs, env, dist_kw):
    """EXPLAIN ANALYZE texts of the salted groupby and join on 8 ranks,
    default adaptive, in ``bsp_staged`` (and the join out-of-core)."""
    rng = np.random.default_rng(11)
    keys = np.where(rng.random(N_SKEW) < 0.99, 7,
                    rng.integers(0, 1000, N_SKEW)).astype(np.int32)
    data = {"k": keys, "v": rng.integers(0, 100, N_SKEW).astype(np.float32)}
    build = {"k": np.arange(64, dtype=np.int32),
             "w": rng.integers(0, 100, 64).astype(np.float32)}
    t = core.DistTable.from_numpy(data, 8, capacity=N_SKEW // 4, **dist_kw)
    bt = core.DistTable.from_numpy(build, 8, **dist_kw)
    g = (core.Plan.scan("t").groupby(["k"], {"v": ["sum", "count"]},
                                     pre_aggregate=False).sort(["k"]))
    j = core.Plan.scan("t").join(core.Plan.scan("r"), on="k",
                                 out_capacity=N_SKEW)
    out = {}
    for name, plan, tables, kw in (
            ("groupby", g, {"t": t}, {}),
            ("join", j, {"t": t, "r": bt}, {}),
            ("join_ooc", j, {"t": data, "r": build},
             dict(morsel_rows=64, capacity_factor=4.0))):
        _, report = obs.run_analyzed(plan, env, tables, optimize=False,
                                     **kw, **({"peaks": dist_kw["peaks"]}
                                              if "peaks" in dist_kw else {}))
        out[name] = _mask_times(report.explain_analyze())
    return out


def _reference_main(path):
    """JAX side: 8 host devices; writes the texts to ``path``."""
    import repro.core as core
    import repro.obs as obs
    env = core.CylonEnv()
    assert env.parallelism == 8, env.parallelism
    with open(path, "w") as f:
        json.dump(_skew_explain(core, obs, env, {}), f)


@pytest.fixture(scope="module")
def reference_skew_texts(tmp_path_factory):
    import os
    import subprocess
    import sys
    here = os.path.dirname(os.path.abspath(__file__))
    path = str(tmp_path_factory.mktemp("obs8") / "ref.json")
    env = dict(os.environ,
               PYTHONPATH=os.path.abspath(os.path.join(here, os.pardir,
                                                       "src")),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["groupby", "join", "join_ooc"])
def test_salted_explain_analyze_matches_reference(reference_skew_texts,
                                                  name):
    # the salted node's note (salted[k:8, hot:1] / salted[broadcast, ...])
    # and the :remerge / :broadcast shuffles attributed to their node, on
    # 8 ranks, as the reference renders them
    import repro_torch.core as core
    import repro_torch.obs as obs
    from repro_torch.launch.roofline import DEVICE_PEAKS
    env = core.CylonEnv(8, device="cpu")
    got = _skew_explain(core, obs, env, {"device": "cpu"})
    assert got[name] == reference_skew_texts[name]
    assert "adapt[salted=1" in got[name] and "salted[" in got[name]
    report = obs.run_analyzed(
        core.Plan.scan("t").groupby(["k"], {"v": ["sum"]},
                                    pre_aggregate=False),
        env, {"t": {"k": np.full(512, 7, np.int32),
                    "v": np.ones(512, np.float32)}},
        optimize=False, morsel_rows=64, peaks=DEVICE_PEAKS[H100])[1]
    assert report.to_dict()["adapt_events"][0]["kind"] == "salted"


if __name__ == "__main__":
    import sys
    _reference_main(sys.argv[1])
