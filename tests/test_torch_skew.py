"""Adaptive skew handling through the port against the JAX package.

``repro_torch.adapt`` is held to ``repro.adapt`` on the same seeded numpy
inputs: the resolved configs, the detection samples (row for row, from
numpy dicts, ``DistTable`` s and ``SpillTable`` s — the port gathers the
sampled rows on the device and copies only them), the hot hashes and the
``SaltDecision`` s on the one-key, Zipf and null-heavy tables of
``tests/strategies.py``, ``salted_dest``'s destinations and hot masks,
and the ``MorselTuner`` / ``SplitterEstimator`` step sequences.

One case runs at 8 ranks: a module-scoped subprocess runs the JAX side of
``tests/md_scripts/skew_parity.py``'s one-key table on 8 host devices
(``XLA_FLAGS`` must be set before jax is imported) — ``groupby_salted``,
``replicate_hot_rows``, ``execute`` in ``bsp`` / ``bsp_staged`` / ``amt``
and a 16-morsel run, adaptive on and off — and the port, on 8 stacked
ranks, must match it bit for bit (integer payloads, float sums below
2**24, so every sum is exact) with equal adapt stats and shuffle labels.
Run as a script (``python tests/test_torch_skew.py OUT.npz``) this file is
that JAX side.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "src")

from strategies import null_heavy_frame, one_key_table, zipf_table  # noqa: E402

P = 4  # simulated gang size for the host-side detection units


def _same(got, want):
    assert sorted(got) == sorted(want)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.dtype == w.dtype, c
        np.testing.assert_array_equal(g, w, err_msg=c)


# ---------------------------------------------------------------------- #
# Config, detection and decisions (host logic), equal value for value
# ---------------------------------------------------------------------- #
def test_resolve_adaptive_matches_reference():
    from repro.adapt import resolve_adaptive as jres
    from repro_torch.adapt import AdaptiveConfig, resolve_adaptive as tres
    from repro_torch.adapt.config import DISABLED
    for arg in (None, True, False, {"salt_k": 3},
                {"sample_rows": 64, "autotune": False}):
        assert tres(arg).token() == jres(arg).token()
    assert tres(False) == DISABLED
    cfg = AdaptiveConfig(max_hot_keys=2)
    assert tres(cfg) is cfg
    with pytest.raises(TypeError, match="unknown adaptive"):
        tres({"salt_q": 3})
    with pytest.raises(TypeError, match="adaptive="):
        tres("yes")


def _null_heavy(rng, n):
    """``null_heavy_frame``'s keys as nullable columns, plus a key that
    is hot among the valid rows."""
    from repro_torch.nulls import mask_name
    frame = null_heavy_frame(rng, n=n, null_frac=0.6)
    k = frame["k"].to_numpy()
    valid = ~np.isnan(k)
    keys = np.where(rng.random(n) < 0.7, 3, np.nan_to_num(k)).astype(np.int32)
    return {"k": keys, mask_name("k"): valid,
            "v": rng.integers(0, 100, n).astype(np.float32)}


TABLES = {"one_key": lambda rng: one_key_table(rng, 6000),
          "zipf": lambda rng: zipf_table(rng, 6000),
          "null_heavy": lambda rng: _null_heavy(rng, 6000)}


def _holders(data, pkg):
    """The same rows as a numpy dict, a 4-rank ``DistTable`` and a
    4-rank chunked ``SpillTable`` of package ``pkg``."""
    import importlib
    core = importlib.import_module(f"{pkg}.core")
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    return {"dict": data,
            "dist": core.DistTable.from_numpy(data, P, **kw),
            "spill": core.SpillTable.from_numpy(data, P, chunk_rows=97)}


@pytest.mark.parametrize("holder", ["dict", "dist", "spill"])
@pytest.mark.parametrize("table", sorted(TABLES))
def test_detection_samples_and_hot_hashes_match(table, holder):
    from repro.adapt import AdaptiveConfig as JCfg
    from repro.adapt.hotkeys import (_count_hot_rows as jcount,
                                     detect_hot_keys as jdetect,
                                     sample_key_columns as jsample)
    from repro_torch.adapt import AdaptiveConfig as TCfg
    from repro_torch.adapt.hotkeys import (_count_hot_rows as tcount,
                                           detect_hot_keys as tdetect,
                                           sample_key_columns as tsample)
    data = TABLES[table](np.random.default_rng(3))
    for cfg_kw in ({}, {"sample_rows": 100}):
        jcfg, tcfg = JCfg(**cfg_kw), TCfg(**cfg_kw)
        want = jsample(_holders(data, "repro")[holder], ["k"], jcfg)
        got = tsample(_holders(data, "repro_torch")[holder], ["k"], tcfg)
        _same(got, want)
        hot = tdetect(got, ["k"], P, tcfg)
        assert hot == jdetect(want, ["k"], P, jcfg)
        if table == "one_key":
            assert hot
        if hot:
            for limit_rows in (len(data["k"]), 3_000_000):
                assert tcount(_holders(data, "repro_torch")[holder], ["k"],
                              hot, limit_rows) == \
                    jcount(_holders(data, "repro")[holder], ["k"], hot,
                           limit_rows)


@pytest.mark.parametrize("table", sorted(TABLES))
def test_salt_decisions_match(table):
    from repro.adapt import AdaptiveConfig as JCfg
    from repro.adapt.hotkeys import plan_salt_decisions as jdecide
    from repro.core import Plan as JPlan
    from repro.planner import compile_plan as jcompile
    from repro_torch.adapt import AdaptiveConfig as TCfg
    from repro_torch.adapt.hotkeys import (plan_salt_decisions as tdecide,
                                           salt_cache_token)
    from repro_torch.core import Plan as TPlan
    from repro_torch.planner import compile_plan as tcompile
    from repro_torch.planner.explain import adapt_note
    data = TABLES[table](np.random.default_rng(5))
    build = {"k": np.arange(64, dtype=np.int32),
             "w": np.ones(64, np.float32)}
    tables = {"t": data, "r": build}

    def plans(Plan):
        return [Plan.scan("t").groupby(["k"], {"v": ["sum"]},
                                       pre_aggregate=False),
                Plan.scan("t").groupby(["k"], {"v": ["sum"]},
                                       pre_aggregate=True),
                Plan.scan("t").join(Plan.scan("r"), on="k")]
    for jp, tp in zip(plans(JPlan), plans(TPlan)):
        for cfg_kw in ({}, {"max_broadcast_rows": 0}, {"salt_k": 3}):
            jl = jcompile(jp, tables, optimize_plan=False)
            tl = tcompile(tp, tables, optimize_plan=False)
            jev, tev = [], []
            want = jdecide(jl.order, tables, 8, JCfg(**cfg_kw), jev)
            got = tdecide(tl.order, tables, 8, TCfg(**cfg_kw), tev)
            assert [d.cache_token() for d in got.values()] == \
                [d.cache_token() for d in want.values()]
            assert [d.note() for d in got.values()] == \
                [d.note() for d in want.values()]
            assert tev == jev
            assert [adapt_note(e) for e in tev] == \
                [d.note() for d in got.values()]
            assert (salt_cache_token(got) == ()) == (not got)


def test_salted_dest_matches_reference():
    import jax.numpy as jnp
    from repro.dataframe.groupby import salted_dest as jsalted
    from repro.dataframe.ops_local import hash_columns_np
    from repro.dataframe.table import Table as JTable
    from repro_torch.comm import StackedCommunicator
    from repro_torch.dataframe import salted_dest as tsalted
    from repro_torch.dataframe.table import Table as TTable
    import torch
    rng = np.random.default_rng(9)
    cap = 256
    keys = np.where(np.arange(cap) < 96, 7,
                    rng.integers(100, 400, cap)).astype(np.int32)
    hot = tuple(int(x) for x in hash_columns_np(
        {"k": np.array([7, 123], np.int32)}, ["k"]))

    class _FakeComm:
        def size(self):
            return 8

    for k in (1, 3, 8):
        wd, wh = jsalted(JTable({"k": jnp.asarray(keys)}, cap), _FakeComm(),
                         ["k"], hot, k)
        t = TTable({"k": torch.from_numpy(keys)[None]},
                   torch.tensor([cap], dtype=torch.int32))
        gd, gh = tsalted(t, StackedCommunicator(8), ["k"], hot, k)
        np.testing.assert_array_equal(gd[0].numpy(), np.asarray(wd))
        np.testing.assert_array_equal(gh[0].numpy(), np.asarray(wh))
    assert len(np.unique(gd[0].numpy()[gh[0].numpy()])) == 8


def _tuner_steps(mod_cfg, mod_tuner, salted):
    ev = []
    t = mod_tuner(mod_cfg(), capacity_factor=2.0, events=ev)
    out = []
    m, w = 1024, 2048
    for worst in (6144, 100, 0, 9, 4000):
        a = np.zeros((4, 3), np.int64)
        a[1, 2] = worst
        m, w = t.degrade(m, w, [a], salted=salted, label="seg")
        out.append((m, w))
    t.observe_expansion(100, 800)
    out.append(t.initial_morsel(512))
    return out, ev, t.steps


@pytest.mark.parametrize("salted", [False, True])
def test_morsel_tuner_steps_match(salted):
    from repro.adapt import AdaptiveConfig as JCfg, MorselTuner as JTuner
    from repro_torch.adapt import AdaptiveConfig as TCfg, MorselTuner as TTuner
    from repro_torch.faults import default_degrade_step
    assert _tuner_steps(TCfg, TTuner, salted) == \
        _tuner_steps(JCfg, JTuner, salted)
    assert default_degrade_step(1024, 2048) == (512, 2048)
    assert default_degrade_step(8, 2048) == (8, 4096)


def _estimator_steps(mod_cfg, mod_est):
    fresh = iter([np.array([1, 2, 3]), np.array([1, 2, 3]),
                  np.array([5, 6, 7])])
    ev = []
    est = mod_est(np.array([10, 20, 30]), lambda s: next(fresh), 8,
                  mod_cfg(), events=ev, label="sort(k)")
    out = []
    for counts in ([100, 100, 100, 100], [0, 4000, 0, 0], [0, 4000, 0, 0],
                   [10, 10, 5000, 10], [1, 1, 1, 9000]):
        out.append((est.observe(np.array(counts)), est.refreshes,
                    tuple(est.splitters), round(est.imbalance(), 6)))
    return out, ev


def test_splitter_estimator_steps_match():
    from repro.adapt import AdaptiveConfig as JCfg
    from repro.adapt import SplitterEstimator as JEst
    from repro_torch.adapt import AdaptiveConfig as TCfg
    from repro_torch.adapt import SplitterEstimator as TEst
    assert _estimator_steps(TCfg, TEst) == _estimator_steps(JCfg, JEst)


def test_rules_and_logical_helpers_match():
    from repro.core import Plan as JPlan
    from repro.expr import col as jcol
    from repro.planner import compile_plan as jcompile
    from repro.planner.logical import preserves_rows_and_columns as jpres
    from repro.planner.rules import skew_candidates as jcand
    from repro_torch.core import Plan as TPlan
    from repro_torch.expr import col as tcol
    from repro_torch.planner import compile_plan as tcompile
    from repro_torch.planner.logical import preserves_rows_and_columns as tpres
    from repro_torch.planner.rules import skew_candidates as tcand
    tables = {"t": {"k": np.zeros(8, np.int32), "v": np.ones(8, np.float32)},
              "r": {"k": np.zeros(8, np.int32), "w": np.ones(8, np.float32)}}

    def plan(Plan, col):
        return (Plan.scan("t").with_columns({"v2": col("v") + 1.0})
                .project(["k", "v", "v2"]).add_scalar(1.0, cols=["v"])
                .filter(col("v") > 0.0)
                .join(Plan.scan("r"), on="k")
                .groupby(["k"], {"v": ["sum"]}, pre_aggregate=False)
                .sort(["k"]))
    for opt in (False, True):
        jo = jcompile(plan(JPlan, jcol), tables, optimize_plan=opt).order
        to = tcompile(plan(TPlan, tcol), tables, optimize_plan=opt).order
        assert [n.op for n in tcand(to)] == [n.op for n in jcand(jo)]
        for cols in (["k"], ["v"], ["v2"]):
            assert [tpres(n, cols) for n in to] == \
                [jpres(n, cols) for n in jo]


# ---------------------------------------------------------------------- #
# The port's own invariants (one process, 8 stacked ranks on the CPU)
# ---------------------------------------------------------------------- #
def _plans(Plan, cap=None):
    big = {} if cap is None else dict(bucket_capacity=cap, out_capacity=cap)
    g = (Plan.scan("t").groupby(["k"], {"v": ["sum", "count"]},
                                pre_aggregate=False, **big)
         .sort(["k"], **({} if cap is None else dict(bucket_capacity=cap))))
    j = Plan.scan("t").join(
        Plan.scan("r"), on="k",
        **({} if cap is None else dict(bucket_capacity=cap,
                                       shuffle_out_capacity=cap,
                                       out_capacity=cap)))
    return g, j


def _oracle(keys, vals):
    uk = np.unique(keys)
    return (uk, np.array([vals[keys == k].sum() for k in uk], np.float32),
            np.array([(keys == k).sum() for k in uk], np.int32))


def test_two_hot_keys_in_a_row_on_one_env():
    # the port's stage cache holds the callable built for a key, hot
    # hashes included: a second query with another hot key must not run
    # the first one's salted stage (salt_cache_token keeps them apart)
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    env = CylonEnv(8, device="cpu")
    gplan, _ = _plans(Plan)
    n = 8000
    for hot in (7, 11, 7):
        rng = np.random.default_rng(hot)
        data = one_key_table(rng, n, hot=hot)
        t = DistTable.from_numpy(data, 8, capacity=2 * n // 8, device="cpu")
        for mode in ("bsp", "bsp_staged"):
            out, st = execute(gplan, env, {"t": t}, mode=mode,
                              optimize=False, collect_stats=True)
            assert st.salted_shuffles == 1 and st.rows_dropped == 0
            assert st.degraded == 0
            got = out.to_numpy()
            uk, s, c = _oracle(data["k"], data["v"])
            np.testing.assert_array_equal(got["k"], uk)
            np.testing.assert_array_equal(got["v_sum"], s)
            np.testing.assert_array_equal(got["v_count"], c)
        sp, st = execute(gplan, env, {"t": data}, optimize=False,
                         collect_stats=True, morsel_rows=64,
                         capacity_factor=4.0)
        assert st.salted_shuffles == 1 and st.rows_dropped == 0
        np.testing.assert_array_equal(sp.to_numpy()["v_sum"], s)


def test_uniform_keys_build_no_new_stage():
    # adaptive on and nothing fires: exactly the adaptive=False stages, 0
    # misses on the repeat, in every mode and out-of-core
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    env = CylonEnv(8, device="cpu")
    n = 8000
    rng = np.random.default_rng(1)
    data = {"k": rng.integers(0, 100_000, n).astype(np.int32),
            "v": rng.integers(0, 100, n).astype(np.float32)}
    build = {"k": rng.integers(0, 100_000, 64).astype(np.int32),
             "w": np.ones(64, np.float32)}
    t = DistTable.from_numpy(data, 8, capacity=2 * n // 8, device="cpu")
    bt = DistTable.from_numpy(build, 8, device="cpu")
    gplan, jplan = _plans(Plan)
    runs = [(gplan, {"t": t}, dict(mode=m)) for m in
            ("bsp", "bsp_staged", "amt")]
    runs += [(jplan, {"t": t, "r": bt}, dict(mode="bsp")),
             (gplan, {"t": data}, dict(morsel_rows=128)),
             (jplan, {"t": data, "r": build}, dict(morsel_rows=128))]
    for plan, tables, kw in runs:
        execute(plan, env, tables, optimize=False, collect_stats=True,
                adaptive=False, **kw)
        keys = set(env._cache)
        for _ in range(2):
            _, st = execute(plan, env, tables, optimize=False,
                            collect_stats=True, **kw)
            assert st.adaptive and st.salted_shuffles == 0
            assert st.cache_misses == 0, kw
        assert set(env._cache) == keys, kw


def test_session_and_collect_knob_threading(rng):
    import repro_torch.df as tdf
    data = one_key_table(rng, 512)
    with tdf.session(parallelism=8, device="cpu") as env:
        q = tdf.read_numpy(data).groupby("k").agg({"v": ["sum"]})
        _, st = q.collect(collect_stats=True)
        assert st.adaptive is True           # default on
        with tdf.session(env=env, adaptive=False):
            _, st = q.collect(collect_stats=True)
            assert st.adaptive is False
            # a per-call argument beats the session default
            _, st = q.collect(collect_stats=True, adaptive=True)
            assert st.adaptive is True
        _, st = q.collect(collect_stats=True, adaptive={"salting": False})
        assert st.adaptive is True and st.salted_shuffles == 0


def test_repartition_balanced_matches_sort_routing():
    # repartition_balanced is the sample sort's range routing without the
    # local sort: the same rows land on the same ranks
    import torch
    from repro_torch.comm import StackedCommunicator
    from repro_torch.core import DistTable
    from repro_torch.dataframe import repartition_balanced, sort
    rng = np.random.default_rng(4)
    data = zipf_table(rng, 4000)
    t = DistTable.from_numpy(data, 4, capacity=2000, device="cpu").to_table()
    comm = StackedCommunicator(4)
    got, st = repartition_balanced(t, comm, "k")
    ref, rst = sort(t, comm, ["k"])
    assert torch.equal(got.row_count, ref.row_count)
    assert int(st.send_dropped.sum()) == 0
    for r in range(4):
        n = int(got.row_count[r])
        np.testing.assert_array_equal(
            np.sort(got.columns["k"][r, :n].numpy()),
            ref.columns["k"][r, :n].numpy())


# ---------------------------------------------------------------------- #
# 8 ranks: skew_parity's one-key table against the JAX package
# ---------------------------------------------------------------------- #
P8, N8 = 8, 40_000
BIG = N8 + 8192
MORSEL8 = -(-(N8 // P8 // 16) // 8) * 8      # ~16 morsels per rank
EXEC_STATS = ("salted_shuffles", "splitter_refreshes", "autotune_steps",
              "rows_dropped", "degraded", "retries", "faults_injected",
              "rows_shuffled", "bytes_shuffled", "morsels", "dispatches")


def _skew_inputs():
    """``tests/md_scripts/skew_parity.py``'s recipe."""
    rng = np.random.default_rng(11)
    keys = np.where(rng.random(N8) < 0.99, 7,
                    rng.integers(0, 1000, N8)).astype(np.int32)
    vals = rng.integers(0, 100, N8).astype(np.float32)
    build = {"k": np.arange(64, dtype=np.int32),
             "w": rng.integers(0, 100, 64).astype(np.float32)}
    return {"k": keys, "v": vals}, build


def _runs():
    """Every 8-rank run of package ``pkg``, as {name: (kwargs)}: the
    plans of skew_parity.py (generous capacities: ``g`` / ``j``) and the
    in-core capacities (``gt``, where only salting avoids the hot rank's
    drops), adaptive off, on and at the default."""
    runs = {}
    for a_name, a in (("off", False), ("on", True), ("default", None)):
        for mode in ("bsp", "bsp_staged", "amt"):
            runs[f"g/{mode}/{a_name}"] = ("g", "dist", dict(mode=mode,
                                                             adaptive=a))
        runs[f"gt/bsp/{a_name}"] = ("gt", "dist", dict(adaptive=a))
        runs[f"j/bsp_staged/{a_name}"] = ("j", "dist",
                                          dict(mode="bsp_staged",
                                               adaptive=a))
        runs[f"g/morsel/{a_name}"] = ("g", "host", dict(
            morsel_rows=MORSEL8, capacity_factor=4.0, adaptive=a))
        runs[f"j/morsel/{a_name}"] = ("j", "host", dict(
            morsel_rows=MORSEL8, capacity_factor=4.0, adaptive=a))
        runs[f"s/morsel/{a_name}"] = ("s", "host", dict(
            morsel_rows=MORSEL8, capacity_factor=4.0, adaptive=a))
    return runs


def _execute_all(core, env, dist_kw, hash_np, direct):
    """Run ``_runs`` in package module ``core``; returns a flat dict of
    numpy results for the comparison."""
    data, build = _skew_inputs()
    cap = 2 * (N8 // P8)
    t = core.DistTable.from_numpy(data, P8, capacity=cap, **dist_kw)
    bt = core.DistTable.from_numpy(build, P8, **dist_kw)
    gplan, jplan = _plans(core.Plan, BIG)
    plans = {"g": gplan, "j": jplan, "gt": _plans(core.Plan)[0],
             "s": core.Plan.scan("t").sort(["k"])}
    out = {}
    for name, (pn, src, kw) in _runs().items():
        tables = ({"t": t, "r": bt} if src == "dist"
                  else {"t": data, "r": build})
        res, st = core.execute(plans[pn], env,
                               {k: tables[k] for k in
                                (["t", "r"] if pn == "j" else ["t"])},
                               optimize=False, collect_stats=True, **kw)
        for c, a in res.to_numpy().items():
            out[f"out/{name}/{c}"] = a
        if src == "dist":
            out[f"rows/{name}"] = np.asarray(res.row_counts)
        else:
            out[f"rows/{name}"] = np.array([res.rank_rows(r)
                                            for r in range(P8)])
        out[f"stats/{name}"] = np.array([getattr(st, k) for k in EXEC_STATS],
                                        np.int64)
        out[f"labels/{name}"] = np.array(
            [f"{r.label}#{r.segment}#{r.rows}#{r.dropped}"
             for r in st.shuffle_records])
    hot = tuple(int(x) for x in hash_np({"k": np.array([7], np.int32)},
                                        ["k"]))
    out.update(direct(env, t, bt, hot, cap))
    return out


def _reference_direct(env, t, bt, hot, cap):
    """JAX side of the direct ``groupby_salted`` / ``replicate_hot_rows``
    calls, inside ``env.run``."""
    import jax.numpy as jnp
    from repro.dataframe.groupby import groupby_salted
    from repro.dataframe.ops_local import hash_columns
    from repro.dataframe.shuffle import replicate_hot_rows, shuffle
    from repro.planner.physical import _hot_mask

    def g(ctx, tbl):
        kw = dict(bucket_capacity=cap, out_capacity=cap)
        out, st1, st2 = groupby_salted(tbl, ctx.comm, ["k"],
                                       {"v": ["sum", "count"]}, hot, 8,
                                       shuffle_kw=kw, remerge_kw=kw)
        return out, st1.sent_counts, st1.send_dropped, st2.sent_counts

    def r(ctx, tbl):
        h = hash_columns(tbl, ["k"])
        is_hot = _hot_mask(h, hot)
        dest = jnp.where(is_hot, ctx.comm.size(),
                         (h % jnp.uint32(ctx.comm.size())).astype(jnp.int32))
        base, _ = shuffle(tbl, ctx.comm, dest=dest)
        out, st = replicate_hot_rows(tbl, ctx.comm, is_hot, 8, base)
        return out, st.sent_counts, st.recv_counts, st.send_dropped

    return _direct_results(env.run(g, t), env.run(r, bt))


def _port_direct(env, t, bt, hot, cap):
    import torch
    from repro_torch.dataframe import (groupby_salted, hash_columns,
                                       replicate_hot_rows, shuffle)
    from repro_torch.dataframe.groupby import hot_mask

    def g(ctx, tbl):
        kw = dict(bucket_capacity=cap, out_capacity=cap)
        out, st1, st2 = groupby_salted(tbl, ctx.comm, ["k"],
                                       {"v": ["sum", "count"]}, hot, 8,
                                       shuffle_kw=kw, remerge_kw=kw)
        return out, st1.sent_counts, st1.send_dropped, st2.sent_counts

    def r(ctx, tbl):
        h = hash_columns(tbl, ["k"])
        is_hot = hot_mask(h, hot)
        dest = torch.where(is_hot, ctx.comm.size(),
                           (h % ctx.comm.size()).to(torch.int32))
        base, _ = shuffle(tbl, ctx.comm, dest=dest)
        out, st = replicate_hot_rows(tbl, ctx.comm, is_hot, 8, base)
        return out, st.sent_counts, st.recv_counts, st.send_dropped

    return _direct_results(env.run(g, t), env.run(r, bt))


def _direct_results(gres, rres):
    out = {}
    for tag, res in (("groupby_salted", gres), ("replicate", rres)):
        table, *arrays = res
        for c, a in table.to_numpy().items():
            out[f"direct/{tag}/out/{c}"] = a
        out[f"direct/{tag}/rows"] = np.asarray(table.row_counts)
        for i, a in enumerate(arrays):
            out[f"direct/{tag}/a{i}"] = np.asarray(a).reshape(P8, -1)
    return out


def _reference_main(path):
    """JAX side: 8 host devices; writes ``path``."""
    from repro.core import CylonEnv
    import repro.core as core
    from repro.dataframe.ops_local import hash_columns_np
    env = CylonEnv()
    assert env.parallelism == P8, env.parallelism
    np.savez(path, **_execute_all(core, env, {}, hash_columns_np,
                                  _reference_direct))


@pytest.fixture(scope="module")
def reference8(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("skew8") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, timeout=900,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port8():
    import repro_torch.core as core
    from repro_torch.dataframe.ops_local import hash_columns_np
    env = core.CylonEnv(P8, device="cpu")
    return _execute_all(core, env, {"device": "cpu"}, hash_columns_np,
                        _port_direct)


@pytest.mark.parametrize("run", sorted(_runs()))
def test_one_key_eight_ranks_matches_reference(reference8, port8, run):
    for kind in ("rows", "stats", "labels"):
        np.testing.assert_array_equal(port8[f"{kind}/{run}"],
                                      reference8[f"{kind}/{run}"],
                                      err_msg=f"{kind}/{run}")
    want = {k.split("/", 3)[3]: v for k, v in reference8.items()
            if k.startswith(f"out/{run}/")}
    got = {k.split("/", 3)[3]: v for k, v in port8.items()
           if k.startswith(f"out/{run}/")}
    _same(got, want)
    stats = dict(zip(EXEC_STATS, port8[f"stats/{run}"]))
    assert stats["rows_dropped"] == 0
    if run.endswith("/on") and "amt" not in run and not run.startswith("s"):
        assert stats["salted_shuffles"] >= 1


@pytest.mark.parametrize("tag", ["groupby_salted", "replicate"])
def test_direct_salted_calls_match_reference(reference8, port8, tag):
    keys = sorted(k for k in reference8 if k.startswith(f"direct/{tag}/"))
    assert keys == sorted(k for k in port8 if k.startswith(f"direct/{tag}/"))
    for k in keys:
        np.testing.assert_array_equal(port8[k], reference8[k], err_msg=k)


def test_default_now_salts_where_the_reference_does(reference8, port8):
    # the departure this slice closes: at the in-core capacities the
    # reference salts by default and keeps every row in-core, where the
    # port used to run unsalted, drop rows on the hot rank and degrade to
    # out-of-core; adaptive=False still degrades, in both packages
    idx = {k: EXEC_STATS.index(k) for k in ("salted_shuffles",
                                            "rows_dropped", "degraded")}
    for pkg in (reference8, port8):
        default = pkg["stats/gt/bsp/default"]
        off = pkg["stats/gt/bsp/off"]
        assert default[idx["salted_shuffles"]] == 1
        assert default[idx["rows_dropped"]] == 0
        assert default[idx["degraded"]] == 0
        assert off[idx["salted_shuffles"]] == 0 and off[idx["degraded"]] >= 1
    for k in idx.values():
        assert port8["stats/gt/bsp/default"][k] == \
            reference8["stats/gt/bsp/default"][k]


if __name__ == "__main__":
    _reference_main(sys.argv[1])
