"""Out-of-core morsel execution through the port against the JAX package.

Each case of ``tests/test_out_of_core.py`` that the port covers runs here
on the same seeded numpy inputs through ``repro.core`` (one CPU device)
and ``repro_torch.core`` (one rank on the CPU): spill tables and their
chunking, ``MorselSource``, morsel plans against in-core plans, the
``warn`` / ``degrade`` / ``raise`` overflow policies, the compile-cache
invariant, the in-core ``degrade`` and the store / repartition fixes.
Keys, integer payloads, integer-valued float payloads, row counts, drop
counts and cache hit / miss counts must match exactly, and so must the
row placement: the port mirrors the reference's sub-bucketing and host
sorts.  Payloads with random floats pass through filters and additions
only, so they are exact too.  Cases written before the port had its
adaptive layer run both packages with ``adaptive=False``; the
``*_at_default`` cases run both at their default (adaptive on: morsel
autotuning replans the degrade steps).

One case runs at 8 ranks: a module-scoped subprocess runs the JAX Fig-9
pipeline in-core and out-of-core on 8 host devices (``XLA_FLAGS`` must be
set before jax is imported, as in ``tests/test_torch_pipeline.py``) and
the port, on 8 stacked ranks, must match it slot for slot.  Run as a
script (``python tests/test_torch_out_of_core.py OUT.npz``) this file is
that JAX side.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "src")

from strategies import exact_table, one_key_table, zipf_table  # noqa: E402

#: ExecStats fields a morsel run must match exactly
MORSEL_STATS = ("morsels", "morsel_rows", "rows_shuffled", "bytes_shuffled",
                "rows_dropped", "spill_bytes", "h2d_bytes", "d2h_bytes",
                "dispatches", "cache_misses", "cache_hits", "degraded")


def _same(got, want):
    assert sorted(got) == sorted(want)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.dtype == w.dtype, c
        np.testing.assert_array_equal(g, w, err_msg=c)


def _same_stats(got, want, keys=MORSEL_STATS):
    assert {k: getattr(got, k) for k in keys} == \
        {k: getattr(want, k) for k in keys}


def _spill_ranks(spill):
    return [spill.rank_concat(r) for r in range(spill.parallelism)]


@pytest.fixture(scope="module")
def envs():
    """(JAX env on its one CPU device, port env of one rank on the CPU)."""
    from repro.core import CylonEnv as JEnv
    from repro_torch.core import CylonEnv as TEnv
    return JEnv(), TEnv(1, device="cpu")


def _both(envs, build, tables_j, tables_t, **kw):
    """``execute`` of the plan ``build(Plan, col)`` in both packages."""
    from repro.core import Plan as JPlan, execute as jexec
    from repro.expr import col as jcol
    from repro_torch.core import Plan as TPlan, execute as texec
    from repro_torch.expr import col as tcol
    jenv, tenv = envs
    want = jexec(build(JPlan, jcol), jenv, tables_j, **kw)
    got = texec(build(TPlan, tcol), tenv, tables_t, **kw)
    return got, want


def _dist_pair(data, p=1, **kw):
    from repro.core import DistTable as JDist
    from repro_torch.core import DistTable as TDist
    return JDist.from_numpy(data, p, **kw), TDist.from_numpy(
        data, p, device="cpu", **kw)


# ---------------------------------------------------------------------- #
# SpillTable
# ---------------------------------------------------------------------- #
def test_spill_roundtrip_and_chunking(rng):
    from repro.core import SpillTable as JSpill
    from repro_torch.core import SpillTable as TSpill
    data = {"k": rng.integers(0, 9, 100).astype(np.int32),
            "v": rng.random(100).astype(np.float32),
            "i64": rng.integers(-2**40, 2**40, 100)}
    want = JSpill.from_numpy(data, 4, chunk_rows=8)
    got = TSpill.from_numpy(data, 4, chunk_rows=8)
    # host chunks keep host dtypes (64-bit narrows only on upload)
    assert got.schema == want.schema
    assert got.schema["i64"][0] == np.int64
    for r in range(4):
        assert got.rank_rows(r) == want.rank_rows(r) == 25
        assert len(got.rank_chunks(r)) == len(want.rank_chunks(r)) == 4
    assert got.nbytes() == want.nbytes() == 100 * 16
    _same(got.to_numpy(), want.to_numpy())
    _same(got.to_numpy(), data)


def test_spill_schema_survives_empty_ranks():
    from repro.core import SpillTable as JSpill
    from repro_torch.core import SpillTable as TSpill
    data = {"k": np.arange(3, dtype=np.int32)}
    for sp in (JSpill.from_numpy(data, 4), TSpill.from_numpy(data, 4)):
        assert sp.rank_rows(3) == 0
        assert sp.column_names == ("k",)
        empty = sp.rank_concat(3)
        assert empty["k"].dtype == np.int32 and len(empty["k"]) == 0


@pytest.mark.parametrize("bad", [{"k": np.arange(4, dtype=np.float32)},
                                 {"x": np.arange(4, dtype=np.int32)}])
def test_spill_rejects_mismatched_chunks(bad):
    from repro.core import SpillTable as JSpill
    from repro_torch.core import SpillTable as TSpill
    for cls in (JSpill, TSpill):
        sp = cls(2)
        sp.append(0, {"k": np.arange(4, dtype=np.int32)})
        with pytest.raises(ValueError, match="schema"):
            sp.append(1, bad)


def test_spill_from_dist_keeps_rank_placement(rng):
    from repro.core import SpillTable as JSpill
    from repro_torch.core import SpillTable as TSpill
    data = exact_table(rng, 64)
    jt, tt = _dist_pair(data, 2)
    want, got = JSpill.from_dist(jt), TSpill.from_dist(tt)
    assert got.parallelism == want.parallelism == 2
    assert [got.rank_rows(r) for r in range(2)] == \
        [want.rank_rows(r) for r in range(2)] == [32, 32]
    for g, w in zip(_spill_ranks(got), _spill_ranks(want)):
        _same(g, w)


def test_spilled_chunks_own_their_memory(rng):
    # each spilled chunk is a pageable array of its own: it shares memory
    # with neither the device table nor another chunk, so a spill holds
    # only its valid rows; d2h_bytes counts the counts and whole columns,
    # as the JAX package does, d2h_copied_bytes the rows up to the fullest
    # rank
    from repro_torch.core import DistTable, SpillTable
    from repro_torch.planner.morsel import _Acc, _append_out, _schema_of
    data = exact_table(rng, 50)
    t = DistTable.from_numpy(data, 4, capacity=40, device="cpu")
    counts = t.row_counts.numpy()
    out, acc = SpillTable(4, schema=_schema_of(t)), _Acc()
    _append_out(out, t, acc)
    _append_out(out, t, acc)
    chunks = [c for r in range(4) for c in out._chunks[r]]
    assert len(chunks) == 2 * int((counts > 0).sum())
    for i, c in enumerate(chunks):
        for k, a in c.items():
            assert a.flags.owndata, k
            assert not np.shares_memory(a, t.columns[k].numpy()), k
            for d in chunks[i + 1:]:
                assert not np.shares_memory(a, d[k]), k
    whole = sum(v.numel() * v.element_size() for v in t.columns.values())
    widest = sum(v[:, :counts.max()].numel() * v.element_size()
                 for v in t.columns.values())
    assert acc.d2h_bytes == 2 * (counts.nbytes + whole)
    assert acc.d2h_copied_bytes == 2 * (counts.nbytes + widest)
    assert acc.spill_bytes == sum(a.nbytes for c in chunks
                                  for a in c.values())


# ---------------------------------------------------------------------- #
# MorselSource
# ---------------------------------------------------------------------- #
def test_morsel_source_streams_fixed_capacity(rng):
    from repro.core import MorselSource as JSource, SpillTable as JSpill
    from repro_torch.core import MorselSource as TSource
    from repro_torch.core import SpillTable as TSpill
    data = exact_table(rng, 100)
    want = JSource(JSpill.from_numpy(data, 2), morsel_rows=16)
    got = TSource(TSpill.from_numpy(data, 2), morsel_rows=16, device="cpu")
    wm, gm = list(want), list(got)
    assert len(gm) == len(wm) == got.num_morsels == want.num_morsels == 4
    assert all(m.capacity == 16 for m in gm)
    for g, w in zip(gm, wm):
        np.testing.assert_array_equal(g.row_counts.numpy(),
                                      np.asarray(w.row_counts))
        cols, _ = g.to_reference()
        _same(cols, {n: np.asarray(a) for n, a in w.columns.items()})
    assert got.h2d_bytes == want.h2d_bytes > 0


def test_morsel_source_empty_input_yields_one_empty_morsel():
    from repro.core import MorselSource as JSource, SpillTable as JSpill
    from repro_torch.core import MorselSource as TSource
    from repro_torch.core import SpillTable as TSpill
    data = {"k": np.zeros(0, np.int32)}
    for morsels in (list(JSource(JSpill.from_numpy(data, 2), 8)),
                    list(TSource(TSpill.from_numpy(data, 2), 8,
                                 device="cpu"))):
        assert len(morsels) == 1
        assert int(np.asarray(morsels[0].row_counts).sum()) == 0


def test_morsel_source_narrows_64bit_on_upload(rng):
    # the spill keeps int64 / float64; the device morsel holds what
    # jnp.asarray makes of them (int32 / float32, wrapping)
    from repro.core import MorselSource as JSource, SpillTable as JSpill
    from repro_torch.core import MorselSource as TSource
    from repro_torch.core import SpillTable as TSpill
    data = {"k": rng.integers(-2**40, 2**40, 40),
            "v": rng.random(40)}
    (w,), (g,) = (list(JSource(JSpill.from_numpy(data, 1), 64)),
                  list(TSource(TSpill.from_numpy(data, 1), 64,
                               device="cpu")))
    cols, _ = g.to_reference()
    _same(cols, {n: np.asarray(a) for n, a in w.columns.items()})
    assert cols["k"].dtype == np.int32 and cols["v"].dtype == np.float32


# ---------------------------------------------------------------------- #
# Morsel execution vs in-core and vs the JAX package (1 rank)
# ---------------------------------------------------------------------- #
def test_morsel_local_plan_bit_identical(envs, rng):
    from repro_torch.core import DistTable, Plan, SpillTable, execute
    from repro_torch.expr import col
    data = {"k": rng.integers(0, 50, 500).astype(np.int32),
            "v0": rng.random(500).astype(np.float32)}

    def build(Plan, col):
        return (Plan.scan("l").filter(col("v0") > 0.25)
                .add_scalar(2.0, cols=["v0"]))
    got, want = _both(envs, build, {"l": data}, {"l": data}, morsel_rows=64)
    assert isinstance(got, SpillTable)
    _same(got.to_numpy(), want.to_numpy())
    ref = execute(build(Plan, col), envs[1],
                  {"l": DistTable.from_numpy(data, 1, device="cpu")})
    _same(got.to_numpy(), ref.to_numpy())


@pytest.mark.parametrize("opt", [False, True])
def test_morsel_pipeline_bit_identical(envs, rng, opt):
    from repro_torch.core import DistTable, Plan, execute
    ld = exact_table(rng, 600)
    rd = {"k": rng.integers(0, 50, 400).astype(np.int32),
          "w": rng.integers(0, 100, 400).astype(np.float32)}

    def build(Plan, col):
        return (Plan.scan("l").join(Plan.scan("r"), on="k",
                                    out_capacity=16384)
                .groupby(["k"], {"v0": ["sum", "mean"]})
                .sort(["k"]).add_scalar(1.0, cols=["v0_sum"]))
    tables = {"l": ld, "r": rd}
    (got, gst), (want, wst) = _both(envs, build, tables, tables,
                                    optimize=opt, collect_stats=True,
                                    morsel_rows=64, capacity_factor=16.0,
                                    adaptive=False)
    assert gst.rows_dropped == 0 and gst.morsels >= 600 // 64
    assert min(gst.spill_bytes, gst.h2d_bytes, gst.d2h_bytes) > 0
    _same_stats(gst, wst, [k for k in MORSEL_STATS
                           if k not in ("cache_misses", "cache_hits")])
    _same(got.to_numpy(), want.to_numpy())
    lt, rt = (DistTable.from_numpy(d, 1, device="cpu") for d in (ld, rd))
    ref, rst = execute(build(Plan, None), envs[1], {"l": lt, "r": rt},
                       optimize=opt, collect_stats=True)
    assert rst.rows_dropped == 0
    _same(got.to_numpy(), ref.to_numpy())


def test_morsel_groupby_only_matches(envs, rng):
    data = exact_table(rng, 333, keys=40)

    def build(Plan, col):
        return Plan.scan("l").groupby(["k"], {"v0": ["sum", "min", "max"]})
    (got, gst), (want, wst) = _both(envs, build, {"l": data}, {"l": data},
                                    optimize=False, morsel_rows=32,
                                    collect_stats=True)
    # the port sub-buckets the partials as the reference does, so even
    # the rank-local order of the combined groups matches
    _same(got.to_numpy(), want.to_numpy())
    _same_stats(gst, wst, ("morsels", "rows_dropped", "spill_bytes",
                           "h2d_bytes", "d2h_bytes", "dispatches"))


@pytest.mark.parametrize("table", [zipf_table, one_key_table])
def test_morsel_adversarial_keys_bit_identical(envs, rng, table):
    # Zipf(1.5) and 99%-one-key tables (tests/strategies) through the
    # morsel path: adversarial key mass must not perturb results or drop
    # rows
    data = table(rng, 500)
    data = {"k": data["k"], "v0": data["v"]}

    def build(Plan, col):
        return Plan.scan("l").groupby(["k"], {"v0": ["sum", "count"]})
    (got, gst), (want, wst) = _both(envs, build, {"l": data}, {"l": data},
                                    optimize=False, morsel_rows=64,
                                    collect_stats=True,
                                    adaptive=False)
    assert gst.rows_dropped == wst.rows_dropped == 0
    _same(got.to_numpy(), want.to_numpy())


def test_morsel_respills_mismatched_parallelism(envs, rng):
    # a spill bucketed for 4 ranks streamed on a 1-rank env keeps every
    # row (re-bucketed on the host), not just rank 0's share
    from repro.core import SpillTable as JSpill
    from repro_torch.core import SpillTable as TSpill
    data = exact_table(rng, 32)

    def build(Plan, col):
        return Plan.scan("l").add_scalar(0.0, cols=["v0"])
    got, want = _both(envs, build, {"l": JSpill.from_numpy(data, 4)},
                      {"l": TSpill.from_numpy(data, 4)}, morsel_rows=8)
    assert got.total_rows() == want.total_rows() == 32
    _same(got.to_numpy(), want.to_numpy())
    np.testing.assert_array_equal(got.to_numpy()["k"], data["k"])


def _exploding_join(n_right):
    ld = {"k": np.zeros(64, np.int32), "v0": np.arange(64, dtype=np.float32)}
    rd = {"k": np.zeros(n_right, np.int32),
          "w": np.arange(n_right, dtype=np.float32)}

    def build(Plan, col):
        return Plan.scan("l").join(Plan.scan("r"), on="k")
    return build, {"l": ld, "r": rd}


def test_morsel_warns_on_capacity_pressure(envs):
    # an exploding all-equal-key join overflows the per-morsel working
    # capacity; under overflow="warn" the loss is loud and counted the
    # same in both packages
    build, tables = _exploding_join(64)
    with pytest.warns(RuntimeWarning, match="out-of-core execution dropped"):
        (got, gst), (want, wst) = _both(
            envs, build, tables, tables, optimize=False, morsel_rows=16,
            collect_stats=True, overflow="warn",
            adaptive=False)
    assert gst.rows_dropped == wst.rows_dropped > 0
    _same_stats(gst, wst, ("morsels", "rows_shuffled", "rows_dropped",
                           "degraded"))
    _same(got.to_numpy(), want.to_numpy())


def test_morsel_degrade_recovers_every_row(envs):
    # the default policy: the exploding join re-executes with halved
    # morsels / grown working capacity until every row fits, with the
    # reference's degrade steps
    build, tables = _exploding_join(8)
    (got, gst), (want, wst) = _both(envs, build, tables, tables,
                                    optimize=False, morsel_rows=16,
                                    collect_stats=True,
                                    adaptive=False)
    assert gst.rows_dropped == wst.rows_dropped == 0
    assert gst.degraded == wst.degraded > 0
    out = got.to_numpy()
    assert len(out["k"]) == 64 * 8
    _same(out, want.to_numpy())
    order = np.lexsort((out["w"], out["v0"]))
    np.testing.assert_array_equal(out["v0"][order],
                                  np.repeat(np.arange(64, dtype=np.float32),
                                            8))
    np.testing.assert_array_equal(out["w"][order],
                                  np.tile(np.arange(8, dtype=np.float32), 64))


@pytest.mark.parametrize("n_right", [8, 64])
def test_morsel_degrade_recovers_every_row_at_default(envs, n_right):
    # both packages at their default adaptive: the tuner replans each
    # degrade step from the observed overflow peak, with the reference's
    # steps, replays and rows
    build, tables = _exploding_join(n_right)
    (got, gst), (want, wst) = _both(envs, build, tables, tables,
                                    optimize=False, morsel_rows=16,
                                    collect_stats=True)
    assert gst.adaptive and wst.adaptive
    assert gst.rows_dropped == wst.rows_dropped == 0
    assert gst.autotune_steps == gst.degraded > 0
    _same_stats(gst, wst, MORSEL_STATS + ("autotune_steps",
                                          "splitter_refreshes",
                                          "salted_shuffles"))
    assert [e["how"] for e in gst.adapt_events] == \
        [e["how"] for e in wst.adapt_events]
    out = got.to_numpy()
    assert len(out["k"]) == 64 * n_right
    _same(out, want.to_numpy())


def test_morsel_overflow_raise_policy(envs):
    from repro.faults import CapacityOverflow as JOverflow
    from repro_torch.faults import CapacityOverflow as TOverflow
    from repro.core import Plan as JPlan, execute as jexec
    from repro_torch.core import Plan as TPlan, execute as texec
    build, tables = _exploding_join(64)
    jenv, tenv = envs
    with pytest.raises(JOverflow, match="dropped"):
        jexec(build(JPlan, None), jenv, tables, optimize=False,
              morsel_rows=16, overflow="raise")
    with pytest.raises(TOverflow, match="dropped"):
        texec(build(TPlan, None), tenv, tables, optimize=False,
              morsel_rows=16, overflow="raise")


@pytest.mark.parametrize("which", ["amt", "dest"])
def test_morsel_rejects_amt_and_dest_shuffle(envs, rng, which):
    from repro.core import Plan as JPlan, execute as jexec
    from repro_torch.core import Plan as TPlan, execute as texec
    data = exact_table(rng, 64)
    for Plan, execute, env in ((JPlan, jexec, envs[0]),
                               (TPlan, texec, envs[1])):
        if which == "amt":
            with pytest.raises(ValueError, match="allgather baseline"):
                execute(Plan.scan("l").shuffle(["k"]), env, {"l": data},
                        mode="amt", morsel_rows=16)
        else:
            bad = Plan.scan("l").shuffle(["k"], dest=np.zeros(64, np.int32))
            with pytest.raises(ValueError, match="cannot stream"):
                execute(bad, env, {"l": data}, optimize=False,
                        morsel_rows=16)


# ---------------------------------------------------------------------- #
# Stage-cache regression: 8 morsels -> exactly 1 cache miss
# ---------------------------------------------------------------------- #
def test_eight_morsels_one_cache_miss(rng):
    from repro_torch.core import CylonEnv, Plan, execute
    from repro_torch.expr import col
    env = CylonEnv(1, device="cpu")
    data = {"k": rng.integers(0, 9, 8 * 32).astype(np.int32),
            "v0": rng.random(8 * 32).astype(np.float32)}
    plan = (Plan.scan("l").filter(col("k") >= 0)
            .add_scalar(1.0, cols=["v0"]))
    h0, m0 = env.cache_hits, env.cache_misses
    _, st = execute(plan, env, {"l": data}, morsel_rows=32,
                    collect_stats=True)
    assert st.morsels == 8
    # the per-morsel zero-rebuild invariant: ONE stage built, 7 reuses
    assert env.cache_misses - m0 == 1 == st.cache_misses
    assert env.cache_hits - h0 == 7 == st.cache_hits
    # a second execution of the same plan builds nothing at all
    _, st2 = execute(plan, env, {"l": data}, morsel_rows=32,
                     collect_stats=True)
    assert st2.cache_misses == 0 and st2.cache_hits == 8


def test_in_core_degrade_recovers_join_overflow(envs):
    # the default policy on an under-capacitated in-core join: the run
    # detects the drop and replays the plan out-of-core, re-scattering the
    # complete result to a DistTable — no rows lost, as in the reference
    from repro_torch.core import DistTable
    ld = {"k": np.zeros(32, np.int32), "v0": np.arange(32, dtype=np.float32)}
    rd = {"k": np.zeros(32, np.int32), "w": np.arange(32, dtype=np.float32)}
    (jl, tl), (jr, tr) = _dist_pair(ld), _dist_pair(rd)

    def build(Plan, col):
        return Plan.scan("l").join(Plan.scan("r"), on="k", out_capacity=64)
    (got, gst), (want, wst) = _both(envs, build, {"l": jl, "r": jr},
                                    {"l": tl, "r": tr}, optimize=False,
                                    collect_stats=True,
                                    adaptive=False)
    assert isinstance(got, DistTable)
    assert gst.rows_dropped == wst.rows_dropped == 0
    assert gst.degraded == wst.degraded > 0
    assert got.total_rows() == want.total_rows() == 32 * 32
    assert got.capacity == want.capacity
    _same(got.to_numpy(), want.to_numpy())


def test_in_core_degrade_recovers_join_overflow_at_default(envs):
    # the same under-capacitated join with both packages at their default
    # adaptive: the out-of-core replay is replanned by the tuner
    from repro_torch.core import DistTable
    ld = {"k": np.zeros(32, np.int32), "v0": np.arange(32, dtype=np.float32)}
    rd = {"k": np.zeros(32, np.int32), "w": np.arange(32, dtype=np.float32)}
    (jl, tl), (jr, tr) = _dist_pair(ld), _dist_pair(rd)

    def build(Plan, col):
        return Plan.scan("l").join(Plan.scan("r"), on="k", out_capacity=64)
    (got, gst), (want, wst) = _both(envs, build, {"l": jl, "r": jr},
                                    {"l": tl, "r": tr}, optimize=False,
                                    collect_stats=True)
    assert isinstance(got, DistTable)
    assert gst.rows_dropped == wst.rows_dropped == 0
    assert gst.degraded == wst.degraded > 0
    assert gst.autotune_steps == wst.autotune_steps > 0
    assert got.total_rows() == want.total_rows() == 32 * 32
    _same(got.to_numpy(), want.to_numpy())


def test_in_core_degrade_refuses_a_plan_that_cannot_stream(envs):
    # a self-join's build side shares the streamed chain, so the default
    # policy cannot replay it out-of-core: both packages raise
    # CapacityOverflow naming that, instead of returning a truncated table
    from repro.core import Plan as JPlan, execute as jexec
    from repro.faults import CapacityOverflow as JOverflow
    from repro_torch.core import Plan as TPlan, execute as texec
    from repro_torch.faults import CapacityOverflow as TOverflow
    data = {"k": np.zeros(16, np.int32), "v0": np.ones(16, np.float32)}
    jt, tt = _dist_pair(data)
    for Plan, execute, env, table, err in (
            (JPlan, jexec, envs[0], jt, JOverflow),
            (TPlan, texec, envs[1], tt, TOverflow)):
        src = Plan.scan("l")
        plan = src.join(src, on="k", out_capacity=32)
        with pytest.raises(err, match="cannot degrade"):
            execute(plan, env, {"l": table}, optimize=False,
                    collect_stats=True)


# ---------------------------------------------------------------------- #
# The frontend's out-of-core entry points (repro_torch.df vs repro.df)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("source", ["read_numpy_spill", "from_table_dict",
                                    "from_table_spill"])
def test_frontend_out_of_core_matches_jax(rng, source):
    import repro.df as jdf
    import repro_torch.df as tdf
    from repro.core import CylonEnv as JEnv, SpillTable as JSpill
    from repro_torch.core import SpillTable as TSpill
    data = exact_table(rng, 300, keys=30)
    frames = []
    for rdf, spill, env in ((jdf, JSpill, JEnv()), (tdf, TSpill, None)):
        with (tdf.session(parallelism=1, device="cpu") if env is None
              else jdf.session(env)):
            df = {"read_numpy_spill": lambda: rdf.read_numpy(
                      data, spill=True, chunk_rows=64),
                  "from_table_dict": lambda: rdf.from_table(data),
                  "from_table_spill": lambda: rdf.from_table(
                      spill.from_numpy(data, 1, chunk_rows=50))}[source]()
            q = (df.groupby("k").agg({"v0": ["sum", "mean"]})
                 .sort_values("k"))
            frames.append(q.collect(morsel_rows=32, collect_stats=True,
                                    adaptive=False))
    (want, wst), (got, gst) = frames
    assert isinstance(got, TSpill)
    _same(got.to_numpy(), want.to_numpy())
    _same_stats(gst, wst, ("morsels", "rows_dropped", "spill_bytes",
                           "h2d_bytes", "d2h_bytes"))


def test_frontend_out_of_core_matches_jax_at_default(rng):
    # both frontends at their default adaptive (a Zipf key: detection runs,
    # one rank, nothing to salt)
    import repro.df as jdf
    import repro_torch.df as tdf
    from repro.core import CylonEnv as JEnv
    data = zipf_table(rng, 300)
    frames = []
    for rdf, env in ((jdf, JEnv()), (tdf, None)):
        with (tdf.session(parallelism=1, device="cpu") if env is None
              else jdf.session(env)):
            q = (rdf.read_numpy(data, spill=True, chunk_rows=64)
                 .groupby("k").agg({"v": ["sum", "mean"]}).sort_values("k"))
            frames.append(q.collect(morsel_rows=32, collect_stats=True))
    (want, wst), (got, gst) = frames
    _same(got.to_numpy(), want.to_numpy())
    _same_stats(gst, wst, MORSEL_STATS + ("autotune_steps",
                                          "splitter_refreshes",
                                          "salted_shuffles", "adaptive"))


def test_frontend_spill_source_runs_in_core(rng):
    # a SpillTable scan without morsel_rows is scattered onto the env's
    # ranks (2x headroom), as in repro.df
    import repro_torch.df as tdf
    from repro_torch.core import DistTable, SpillTable
    data = exact_table(rng, 100, keys=10)
    with tdf.session(parallelism=2, device="cpu"):
        df = tdf.from_table(SpillTable.from_numpy(data, 2, chunk_rows=16),
                            name="l")
        out = df.groupby("k").agg({"v0": "sum"}).sort_values("k").collect()
    assert isinstance(out, DistTable)
    got = out.to_numpy()
    np.testing.assert_array_equal(got["k"], np.unique(data["k"]))
    np.testing.assert_array_equal(
        got["v0_sum"], np.bincount(data["k"], weights=data["v0"])[
            np.unique(data["k"])].astype(np.float32))


@pytest.mark.parametrize("overflow", ["warn", "raise"])
def test_frontend_collect_passes_overflow(overflow):
    import repro_torch.df as tdf
    from repro_torch.faults import CapacityOverflow
    ld = {"k": np.zeros(64, np.int32), "v0": np.ones(64, np.float32)}
    rd = {"k": np.zeros(64, np.int32), "w": np.ones(64, np.float32)}
    with tdf.session(parallelism=1, device="cpu"):
        q = tdf.from_table(ld, name="l").merge(
            tdf.from_table(rd, name="r"), on="k")
        if overflow == "raise":
            with pytest.raises(CapacityOverflow, match="dropped"):
                q.collect(morsel_rows=16, overflow=overflow)
        else:
            with pytest.warns(RuntimeWarning, match="dropped"):
                q.collect(morsel_rows=16, overflow=overflow)


# ---------------------------------------------------------------------- #
# CylonStore / repartition
# ---------------------------------------------------------------------- #
def test_repartition_explicit_zero_capacity_not_ignored(rng):
    from repro_torch.core import DistTable, repartition
    t = DistTable.from_numpy(exact_table(rng, 10), 2, device="cpu")
    with pytest.raises(ValueError, match="exceeds capacity"):
        repartition(t, 2, capacity=0)
    with pytest.raises(ValueError):
        DistTable.from_numpy(exact_table(rng, 10), 2, capacity=0,
                             device="cpu")


def test_repartition_preserves_dtypes_and_values(rng):
    from repro.core import repartition as jrepart
    from repro_torch.core import repartition as trepart
    data = {"i": rng.integers(-5, 5, 37).astype(np.int32),
            "u": rng.integers(0, 2**32, 37, dtype=np.uint64).astype(
                np.uint32),
            "f": rng.integers(0, 100, 37).astype(np.float32)}
    jt, tt = _dist_pair(data, 3)
    got, want = trepart(tt, 5), jrepart(jt, 5)
    assert got.parallelism == want.parallelism == 5
    assert got.device == tt.device
    cols, counts = got.to_reference()
    np.testing.assert_array_equal(counts, np.asarray(want.row_counts))
    _same(cols, {n: np.asarray(a) for n, a in want.columns.items()})
    _same(got.to_numpy(), data)


def test_repartition_empty_table_preserves_columns():
    import torch
    from repro_torch.core import DistTable, repartition
    t = DistTable.from_numpy({"k": np.zeros(0, np.int32),
                              "v": np.zeros(0, np.float32)}, 2,
                             device="cpu")
    out = repartition(t, 3)
    assert out.parallelism == 3
    assert out.column_names == ("k", "v")
    assert out.total_rows() == 0
    assert out.columns["v"].dtype == torch.float32


def test_store_get_repartitions_on_capacity_change(rng):
    from repro_torch.core import CylonStore, DistTable
    store = CylonStore()
    t = DistTable.from_numpy(exact_table(rng, 32), 2, device="cpu")
    store.put("t", t)
    assert store.get("t") is t
    assert store.get("t", target_parallelism=2) is t
    out = store.get("t", capacity=64)      # same gang, new capacity
    assert out.capacity == 64
    np.testing.assert_array_equal(out.to_numpy()["k"], t.to_numpy()["k"])
    out2 = store.get("t", target_parallelism=4)
    assert out2.parallelism == 4


def test_store_accepts_spill_tables(rng):
    from repro.core import CylonStore as JStore, SpillTable as JSpill
    from repro_torch.core import CylonStore, DistTable, SpillTable
    data = exact_table(rng, 48)
    store, jstore = CylonStore(), JStore()
    store.put("sp", SpillTable.from_numpy(data, 4))
    jstore.put("sp", JSpill.from_numpy(data, 4))
    got = store.get("sp", target_parallelism=2, device="cpu")
    want = jstore.get("sp", target_parallelism=2)
    assert isinstance(got, DistTable) and got.parallelism == 2
    cols, counts = got.to_reference()
    np.testing.assert_array_equal(counts, np.asarray(want.row_counts))
    _same(cols, {n: np.asarray(a) for n, a in want.columns.items()})


def test_store_get_waits_and_times_out():
    from repro_torch.core import CylonStore
    with pytest.raises(TimeoutError):
        CylonStore().get("missing", timeout=0.01)


def test_rescatter_bucketed_matches_gather(rng):
    from repro.core import SpillTable as JSpill, rescatter as jresc
    from repro_torch.core import SpillTable as TSpill, rescatter as tresc
    data = exact_table(rng, 77)
    got = tresc(TSpill.from_numpy(data, 3, chunk_rows=10), 4, device="cpu")
    want = jresc(JSpill.from_numpy(data, 3, chunk_rows=10), 4)
    cols, counts = got.to_reference()
    np.testing.assert_array_equal(counts, np.asarray(want.row_counts))
    _same(cols, {n: np.asarray(a) for n, a in want.columns.items()})
    _same(got.to_numpy(), data)


def test_checkpoint_refuses_drift_and_stale_replay(rng):
    from repro_torch.core.store import Checkpoint, SpillTable
    sp = SpillTable.from_numpy(exact_table(rng, 16), 2)
    ck = Checkpoint(sp)
    assert ck.validate() is sp
    sp.append(0, {"k": np.zeros(1, np.int32),
                  "v0": np.zeros(1, np.float32)})
    with pytest.raises(RuntimeError, match="validation failed"):
        ck.validate()
    ck.release()
    with pytest.raises(RuntimeError, match="released"):
        ck.validate()


def test_concat_tables_matches_jax(rng):
    import jax.numpy as jnp
    import torch
    from repro.dataframe import Table as JTable, concat_tables as jconcat
    from repro_torch.dataframe import Table as TTable
    from repro_torch.dataframe import concat_tables as tconcat
    parts = [(rng.integers(0, 9, 8).astype(np.int32), n) for n in (5, 8, 3)]
    want = jconcat([JTable({"k": jnp.asarray(v)}, jnp.int32(n))
                    for v, n in parts], capacity=16)
    got = tconcat([TTable({"k": torch.from_numpy(v[None])},
                          torch.tensor([n], dtype=torch.int32))
                   for v, n in parts], capacity=16)
    assert int(got.row_count[0]) == int(want.row_count) == 16
    np.testing.assert_array_equal(got.columns["k"][0].numpy(),
                                  np.asarray(want.columns["k"]))


# ---------------------------------------------------------------------- #
# Host-side hash mirror (spill sub-bucketing)
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("keys", [["k"], ["k", "f"], ["u", "k", "f"],
                                  ["h"], ["h", "u"]])
def test_hash_columns_np_matches_device_hash(rng, keys):
    import jax.numpy as jnp
    import torch
    from repro.dataframe.ops_local import hash_columns_np as jhash_np
    from repro.dataframe.ops_local import hash_columns as jhash
    from repro.dataframe.table import Table as JTable
    from repro_torch.dataframe import Table as TTable
    from repro_torch.dataframe.ops_local import hash_columns, hash_columns_np
    cols = {"k": rng.integers(-1000, 1000, 256).astype(np.int32),
            "f": rng.random(256).astype(np.float32),
            "u": rng.integers(0, 2**32, 256, dtype=np.uint64).astype(
                np.uint32),
            "h": rng.integers(0, 2**16, 256).astype(np.uint16)}
    host = hash_columns_np(cols, keys)
    dev = hash_columns(TTable({k: torch.from_numpy(v[None])
                               for k, v in cols.items()},
                              torch.tensor([256], dtype=torch.int32)), keys)
    want = np.asarray(jhash(JTable({k: jnp.asarray(v)
                                    for k, v in cols.items()},
                                   jnp.int32(256)), keys))
    np.testing.assert_array_equal(host, jhash_np(cols, keys))
    np.testing.assert_array_equal(dev[0].numpy().astype(np.uint32), host)
    np.testing.assert_array_equal(want, host)


# ---------------------------------------------------------------------- #
# The launch counts chip_smoke.py holds the card to
# ---------------------------------------------------------------------- #
def test_morsel_calls_match_the_launch_counts_chip_smoke_expects(
        monkeypatch):
    # chip_smoke.py holds the card's out-of-core radix and segmented-sum
    # launches, morsels and dispatches to ``ooc_launches_expected``, which
    # derives them from the plan and the data; on the CPU the same launch
    # counts are the dispatchers' calls, at several oversubscriptions
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    from repro_torch.dataframe import ops_local
    from repro_torch.planner import compile_plan
    sys.path.insert(0, os.path.join(HERE, os.pardir))
    try:
        import chip_smoke as cs
    finally:
        sys.path.pop(0)
    shuffle_mod = sys.modules["repro_torch.dataframe.shuffle"]
    calls = {"radix_partition": 0, "segmented_sum": 0}
    for mod, name in ((shuffle_mod, "radix_partition"),
                      (ops_local, "segmented_sum")):
        def counted(*args, _real=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _real(*args, **kw)
        monkeypatch.setattr(mod, name, counted)
    rows, p = 4000, 8
    ld, rd = cs.make_exact_data(rows, 0, "v0"), cs.make_exact_data(rows, 1,
                                                                   "w")
    cap = cs.capacity_for(rows, p)
    env = CylonEnv(p, device="cpu")
    tables = {"l": ld, "r": DistTable.from_numpy(rd, p, capacity=cap,
                                                 device="cpu")}
    plan = cs.fig9_plan(Plan, cap)
    pplan = compile_plan(plan, tables)
    for morsel in (64, 128, 504):
        for k in calls:
            calls[k] = 0
        out, st = execute(plan, env, tables, collect_stats=True,
                          morsel_rows=morsel, capacity_factor=4.0)
        want, morsels, dispatches = cs.ooc_launches_expected(
            pplan, ld, cs.host_reference(ld, rd)[1],
            max(out.rank_rows(r) for r in range(p)), morsel, p)
        assert calls == want, morsel
        assert (st.morsels, st.dispatches) == (sum(morsels), dispatches)


# ---------------------------------------------------------------------- #
# 8 ranks: the Fig-9 pipeline against the JAX package's run_morsel
# ---------------------------------------------------------------------- #
P8, N8 = 8, 4000


def _fig9_inputs():
    """``tests/md_scripts/out_of_core_parity.py``'s recipe at N8 rows."""
    rng = np.random.default_rng(7)
    ld = {"k": rng.integers(0, int(N8 * 0.9), N8).astype(np.int32),
          "v0": rng.integers(0, 100, N8).astype(np.float32),
          "junk": rng.random(N8).astype(np.float32)}
    rd = {"k": rng.integers(0, int(N8 * 0.9), N8).astype(np.int32),
          "w": rng.integers(0, 100, N8).astype(np.float32)}
    return ld, rd


def _fig9(Plan, cap):
    return (Plan.scan("l")
            .join(Plan.scan("r"), on="k", out_capacity=cap * 4,
                  bucket_capacity=cap * 2, shuffle_out_capacity=cap * 2)
            .groupby(["k"], {"v0": ["sum", "mean"]}, bucket_capacity=cap * 4)
            .sort(["k"], bucket_capacity=cap * 4)
            .add_scalar(1.0, cols=["v0_sum"]))


MORSEL8 = -(-(-(-N8 // P8) // 8) // 8) * 8      # rows/rank/8, 8-aligned
STATS8 = ("morsels", "morsel_rows", "rows_shuffled", "bytes_shuffled",
          "rows_dropped", "spill_bytes", "h2d_bytes", "d2h_bytes",
          "dispatches", "cache_misses", "degraded")


def _reference_main(path):
    """JAX side: 8 host devices, Fig-9 in-core and out-of-core, optimizer
    off and on; writes ``path``."""
    from repro.core import CylonEnv, DistTable, Plan, execute
    env = CylonEnv()
    assert env.parallelism == P8, env.parallelism
    ld, rd = _fig9_inputs()
    lt, rt = DistTable.from_numpy(ld, P8), DistTable.from_numpy(rd, P8)
    out = {}
    for opt in (False, True):
        plan = _fig9(Plan, lt.capacity)
        ref, rst = execute(plan, env, {"l": lt, "r": rt}, optimize=opt,
                           collect_stats=True)
        for adaptive, suffix in ((False, ""), (None, "-default")):
            sp, st = execute(plan, env, {"l": ld, "r": rd}, optimize=opt,
                             collect_stats=True, morsel_rows=MORSEL8,
                             capacity_factor=4.0, adaptive=adaptive)
            tag = str(int(opt)) + suffix
            for c, a in sp.to_numpy().items():
                out[f"out/{tag}/{c}"] = a
            out[f"rows/{tag}"] = np.array([sp.rank_rows(r)
                                           for r in range(P8)])
            out[f"stats/{tag}"] = np.array([getattr(st, k) for k in STATS8],
                                           np.int64)
        out[f"in_core_rows_shuffled/{opt:d}"] = np.int64(rst.rows_shuffled)
    np.savez(path, **out)


@pytest.fixture(scope="module")
def reference8(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ooc8") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), path],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("opt", [False, True])
def test_fig9_eight_ranks_matches_reference(reference8, opt):
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    env = CylonEnv(P8, device="cpu")
    ld, rd = _fig9_inputs()
    lt = DistTable.from_numpy(ld, P8, device="cpu")
    rt = DistTable.from_numpy(rd, P8, device="cpu")
    plan = _fig9(Plan, lt.capacity)
    ref, rst = execute(plan, env, {"l": lt, "r": rt}, optimize=opt,
                       collect_stats=True)
    sp, st = execute(plan, env, {"l": ld, "r": rd}, optimize=opt,
                     collect_stats=True, morsel_rows=MORSEL8,
                     capacity_factor=4.0, adaptive=False)
    tag = str(int(opt))
    want = {k.split("/")[2]: v for k, v in reference8.items()
            if k.startswith(f"out/{tag}/")}
    _same(sp.to_numpy(), want)
    np.testing.assert_array_equal([sp.rank_rows(r) for r in range(P8)],
                                  reference8[f"rows/{tag}"])
    np.testing.assert_array_equal([getattr(st, k) for k in STATS8],
                                  reference8[f"stats/{tag}"])
    assert st.rows_dropped == 0 and st.morsels >= 16
    # morsels change when rows move, never how many; and the streamed
    # result is the in-core result bit for bit
    assert st.rows_shuffled == rst.rows_shuffled == \
        reference8[f"in_core_rows_shuffled/{tag}"]
    _same(sp.to_numpy(), ref.to_numpy())
    _, again = execute(plan, env, {"l": ld, "r": rd}, optimize=opt,
                       collect_stats=True, morsel_rows=MORSEL8,
                       capacity_factor=4.0, adaptive=False)
    assert again.cache_misses == 0 and again.cache_hits > 0


@pytest.mark.parametrize("opt", [False, True])
def test_fig9_eight_ranks_matches_reference_at_default(reference8, opt):
    # both packages at their default adaptive: detection runs on the Fig-9
    # keys (uniform), nothing fires, and the run builds no stage that
    # adaptive=False does not
    from repro_torch.core import CylonEnv, Plan, execute
    env = CylonEnv(P8, device="cpu")
    ld, rd = _fig9_inputs()
    plan = _fig9(Plan, -(-N8 // P8 // 8) * 8)
    execute(plan, env, {"l": ld, "r": rd}, optimize=opt, morsel_rows=MORSEL8,
            capacity_factor=4.0, adaptive=False)
    keys = set(env._cache)
    sp, st = execute(plan, env, {"l": ld, "r": rd}, optimize=opt,
                     collect_stats=True, morsel_rows=MORSEL8,
                     capacity_factor=4.0)
    assert set(env._cache) == keys and st.cache_misses == 0
    assert st.adaptive and st.salted_shuffles == 0
    tag = f"{opt:d}-default"
    want = {k.split("/")[2]: v for k, v in reference8.items()
            if k.startswith(f"out/{tag}/")}
    _same(sp.to_numpy(), want)
    np.testing.assert_array_equal([sp.rank_rows(r) for r in range(P8)],
                                  reference8[f"rows/{tag}"])
    np.testing.assert_array_equal([getattr(st, k) for k in STATS8],
                                  reference8[f"stats/{tag}"])


if __name__ == "__main__":
    _reference_main(sys.argv[1])
