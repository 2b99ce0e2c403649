"""Dictionary-encoded string columns in repro_torch against the JAX package.

The port (``repro_torch.dataframe.schema``, ``planner.dictionary``,
``DistTable`` ingest and egress, ``ops_local.recode``) runs on the CPU on
the inputs of ``tests/test_strings.py`` (the word pool and tables of
``tests/strategies.py``), beside ``repro`` on its one CPU device.  Codes,
dictionaries, keys, counts, lowered expressions and EXPLAIN text must be
identical; float sums are held to ``rtol=1e-5`` (another summation
order).
"""

import numpy as np
import pytest
import torch

import repro.df as jdf
import repro_torch.df as tdf
from repro.core import CylonEnv as JEnv
from repro.core import DistTable as JTable
from repro.core import Plan as JPlan
from repro.dataframe import schema as jschema
from repro.dataframe.ops_local import recode as jax_recode
from repro.dataframe.table import Table as JaxTable
from repro.expr import col as jcol
from repro.expr import lit as jlit
from repro_torch.core import CylonEnv, DistTable, Plan
from repro_torch.dataframe import Table, ops_local
from repro_torch.dataframe import schema
from repro_torch.expr import col, lit
from strategies import POOL, string_keyed_skew_table, string_table

RTOL = 1e-5    # float sums: the packages add in another order


@pytest.fixture
def envs():
    j, t = JEnv(), CylonEnv(1, device="cpu")
    jdf.set_default_env(j)
    tdf.set_default_env(t)
    yield j, t
    jdf.reset_default_env()
    tdf.reset_default_env()


def _same(got, want):
    """Equal column sets; strings, ints and keys exact, floats to RTOL."""
    assert sorted(got) == sorted(want)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.shape == w.shape, c
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=RTOL, err_msg=c)
        else:
            np.testing.assert_array_equal(g, w, err_msg=c)


def _both(build, data_l, data_r=None):
    """Run ``build(rdf, col, lit, frames...)`` through both frontends on
    the same host data; returns (port result, JAX result, port frame,
    JAX frame)."""
    out = []
    for rdf, c, lt in ((tdf, col, lit), (jdf, jcol, jlit)):
        frames = [rdf.read_numpy(data_l, name="l")]
        if data_r is not None:
            frames.append(rdf.read_numpy(data_r, name="r"))
        out.append(build(c, lt, *frames))
    return out[0].to_numpy(), out[1].to_numpy(), out[0], out[1]


# ---------------------------------------------------------------------- #
# Encoding layer: the same codes and dictionaries as the JAX package
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arr", [
    np.random.default_rng(0).choice(np.asarray(POOL), 64),
    np.asarray(["b", "a", "b"], dtype=object),
    np.asarray([], dtype=object),
    np.asarray([b"oak", b"ash"]),
])
def test_encode_decode_match_jax(arr):
    codes, d = schema.encode_strings(arr)
    jcodes, jd = jschema.encode_strings(arr)
    assert d == jd and list(d) == sorted(set(d))
    np.testing.assert_array_equal(codes, jcodes)
    assert codes.dtype == np.int32
    np.testing.assert_array_equal(schema.decode_codes(codes, d),
                                  jschema.decode_codes(jcodes, jd))
    assert schema.dictionary_of(arr) == jschema.dictionary_of(arr)


def test_encode_decode_rejections_match_jax():
    for mod in (schema, jschema):
        with pytest.raises(TypeError, match="all-string"):
            mod.encode_strings(np.asarray(["a", 1], dtype=object))
        for codes, d in (([0, 2], ("a", "b")), ([-1], ("a",)), ([0], ())):
            with pytest.raises(ValueError, match="out of range"):
                mod.decode_codes(np.asarray(codes, np.int32), d)


def test_recode_mapping_matches_jax():
    old = ("b", "d")
    new = schema.merge_dictionaries(old, ("a", "c", "d"))
    assert new == jschema.merge_dictionaries(old, ("a", "c", "d"))
    np.testing.assert_array_equal(schema.recode_mapping(old, new),
                                  jschema.recode_mapping(old, new))
    np.testing.assert_array_equal(schema.recode_mapping((), ("a",)),
                                  jschema.recode_mapping((), ("a",)))
    with pytest.raises(ValueError, match="missing"):
        schema.recode_mapping(("z",), ("a", "b"))


def test_recode_op_matches_jax():
    # the gather, with codes outside the table clipped as jnp.take(clip)
    mapping = schema.recode_mapping(("b", "d"), ("a", "b", "c", "d"))
    codes = np.asarray([0, 1, 1, 0, 5, -2], np.int32)
    got = ops_local.recode(Table({"s": torch.as_tensor(codes[None])},
                                 torch.tensor([6], dtype=torch.int32)),
                           {"s": mapping})
    want = jax_recode(JaxTable({"s": codes}, np.int32(6)), {"s": mapping})
    np.testing.assert_array_equal(got.columns["s"][0].numpy(),
                                  np.asarray(want.columns["s"]))
    assert got.columns["s"].dtype == torch.int32


# the comparison table of tests/test_strings.py (with its reflected case)
LOWER_CASES = [
    (lambda c, l: c("s") == "cedar", "s == 1"),
    (lambda c, l: c("s") == "nope", "s == -1"),
    (lambda c, l: c("s") != "oak", "s != 2"),
    (lambda c, l: c("s") < "cedar", "s < 1"),
    (lambda c, l: c("s") <= "cedar", "s < 2"),
    (lambda c, l: c("s") > "cedar", "s >= 2"),
    (lambda c, l: c("s") >= "cedar", "s >= 1"),
    (lambda c, l: c("s") < "beech", "s < 1"),
    (lambda c, l: c("s") <= "beech", "s < 1"),
    (lambda c, l: c("s") > "beech", "s >= 1"),
    (lambda c, l: l("cedar") < c("s"), "s >= 2"),
    (lambda c, l: c("s") == c("s"), "s == s"),
]


@pytest.mark.parametrize("case", range(len(LOWER_CASES)))
def test_lower_expr_comparison_table_matches_jax(case):
    build, want = LOWER_CASES[case]
    d = {"s": ("ash", "cedar", "oak")}
    lowered, out_d = schema.lower_expr(build(col, lit), d)
    jlowered, jout_d = jschema.lower_expr(build(jcol, jlit), d)
    assert out_d is None and jout_d is None
    assert repr(lowered) == repr(jlowered) == want
    assert lowered.fingerprint() == jlowered.fingerprint()


@pytest.mark.parametrize("build,match", [
    (lambda c, l: c("s") + 1, "arithmetic"),
    (lambda c, l: c("s") == 3, "numeric"),
    (lambda c, l: c("s") == c("t"), "different dictionaries"),
    (lambda c, l: c("s") & True, "boolean"),
    (lambda c, l: c("s").fill_null("zzz"), "not in the column's dictionary"),
])
def test_lower_expr_rejections_match_jax(build, match):
    d = {"s": ("a", "b"), "t": ("a", "c")}
    with pytest.raises(schema.DictTypeError, match=match):
        schema.lower_expr(build(col, lit), d)
    with pytest.raises(jschema.DictTypeError, match=match):
        jschema.lower_expr(build(jcol, jlit), d)


def test_bare_literal_lowers_to_a_singleton_dictionary():
    lowered, out_d = schema.lower_expr(lit("x"), {"s": ("a",)})
    assert out_d == ("x",) and lowered.value == 0
    assert schema.expr_dictionary(col("s"), {"s": ("a",)}) == ("a",)


# ---------------------------------------------------------------------- #
# Ingest / egress
# ---------------------------------------------------------------------- #
def test_disttable_ingest_matches_jax(rng):
    data = string_table(rng)
    t = DistTable.from_numpy(dict(data), 4, device="cpu")
    j = JTable.from_numpy(dict(data), 4)
    assert t.dictionaries == j.dictionaries
    cols, counts = t.to_reference()
    np.testing.assert_array_equal(cols["s"], np.asarray(j.columns["s"]))
    np.testing.assert_array_equal(counts, np.asarray(j.row_counts))
    np.testing.assert_array_equal(t.to_numpy()["s"], data["s"])
    raw = t.to_numpy(decode=False)["s"]
    np.testing.assert_array_equal(raw, j.to_numpy(decode=False)["s"])
    assert raw.dtype == np.int32


def test_nullable_string_column_matches_jax():
    data = {"s": np.asarray(["oak", None, "ash", None], dtype=object),
            "v": np.arange(4, dtype=np.float32)}
    t = DistTable.from_numpy(dict(data), 2, device="cpu")
    j = JTable.from_numpy(dict(data), 2)
    assert t.dictionaries == j.dictionaries
    got, want = t.to_numpy(), j.to_numpy()
    assert list(got["s"]) == list(want["s"])


# ---------------------------------------------------------------------- #
# Pipelines: the port's frontend against repro.df, one rank each
# ---------------------------------------------------------------------- #
FILTERS = [
    lambda c: c("s") == "oak",
    lambda c: c("s") != "oak",
    lambda c: c("s") < "elm",
    lambda c: c("s") >= "cedar",
    lambda c: c("s") <= "frost",          # literal not in the pool
    lambda c: (c("s") > "birch") & (c("v") > 4),
]


@pytest.mark.parametrize("which", range(len(FILTERS)))
def test_string_filter_matches_jax(envs, rng, which):
    got, want, tf, jf = _both(lambda c, l, df: df[FILTERS[which](c)],
                              string_table(rng))
    _same(got, want)
    assert tf.explain() == jf.explain()


@pytest.mark.parametrize("make,aggs", [
    (string_table, {"v": ["sum", "mean", "count"]}),
    (string_keyed_skew_table, {"v": ["sum", "count"]}),
])
def test_string_groupby_matches_jax(envs, rng, make, aggs):
    got, want, _, _ = _both(
        lambda c, l, df: df.groupby("s").agg(aggs).sort_values("s"),
        make(rng))
    _same(got, want)


def test_groupby_string_min_max_matches_jax(envs, rng):
    got, want, _, _ = _both(
        lambda c, l, df: df.groupby("v").agg({"s": ["min", "max"]})
        .sort_values("v"), string_table(rng))
    _same(got, want)


def test_string_sort_matches_jax(envs, rng):
    data = string_table(rng)
    got, want, _, _ = _both(lambda c, l, df: df.sort_values("s"), data)
    _same(got, want)
    np.testing.assert_array_equal(got["s"], np.sort(data["s"]))


def test_merge_same_dictionary_has_no_recode(envs, rng):
    ld = string_table(rng)
    rd = {"s": ld["s"].copy(),
          "w": rng.integers(0, 9, 128).astype(np.float32)}
    got, want, tf, jf = _both(
        lambda c, l, a, b: a.merge(b, on="s", out_capacity=65536)
        .sort_values(["s", "v", "w"]), ld, rd)
    assert "recode[" not in tf.explain()
    assert tf.explain() == jf.explain()
    _same(got, want)


def test_merge_dictionary_mismatch_recodes_like_jax(envs, rng):
    ld = string_table(rng, pool=POOL[:5])
    rd = {"s": rng.choice(np.asarray(POOL[3:]), 128),
          "w": rng.integers(0, 9, 128).astype(np.float32)}
    got, want, tf, jf = _both(
        lambda c, l, a, b: a.merge(b, on="s", out_capacity=65536)
        .groupby("s").agg({"v": ["sum", "count"]}).sort_values("s"),
        ld, rd)
    text = tf.explain()
    assert "recode[s:|D|=8]" in text and "recode: join(s)" in text
    assert text == jf.explain()
    _same(got, want)
    assert tf.collect().dictionaries["s"] == tuple(sorted(set(POOL)))


def test_explain_golden_recode_matches_jax():
    # the docs/planner.md example (tests/test_strings.py::GOLDEN_RECODE)
    cat = {"l": (("k", "v"), 512, {"k": ("ash", "birch", "cedar", "elm")}),
           "r": (("k", "w"), 512, {"k": ("cedar", "elm", "fir", "oak")})}
    plans = [P.scan("l").join(P.scan("r"), on="k").filter(c("k") < "fir")
             .groupby(["k"], {"v": ["sum"]})
             for P, c in ((Plan, col), (JPlan, jcol))]
    for opt in (True, False):
        text = plans[0].explain(cat, optimize=opt)
        assert text == plans[1].explain(cat, optimize=opt)
        assert text.count("recode[k:|D|=6]") == 2


def test_string_key_joined_to_numeric_key_raises(envs, rng):
    ld = string_table(rng)
    rd = {"s": rng.integers(0, 8, 128).astype(np.int32),
          "w": rng.integers(0, 9, 128).astype(np.float32)}
    dl, dr = tdf.read_numpy(ld, name="l"), tdf.read_numpy(rd, name="r")
    with pytest.raises(TypeError, match="numeric key"):
        dl.merge(dr, on="s").collect()


def test_assign_string_passthrough_and_literal_match_jax(envs, rng):
    data = string_table(rng)
    got, want, _, _ = _both(
        lambda c, l, df: df.assign(s2=c("s"), tag=l("hi")), data)
    _same(got, want)
    np.testing.assert_array_equal(got["s2"], data["s"])
    assert set(got["tag"]) == {"hi"}


def test_string_arithmetic_raises_clearly(envs, rng):
    df = tdf.read_numpy(string_table(rng))
    with pytest.raises(TypeError, match="arithmetic"):
        df.assign(bad=df.s + 1).collect()
    with pytest.raises(TypeError, match="numeric value"):
        df[df.s > 3].collect()
    with pytest.raises(TypeError, match="not defined on the"):
        df.groupby("v").agg({"s": "sum"}).collect()


# ---------------------------------------------------------------------- #
# The stage cache and recode tables
# ---------------------------------------------------------------------- #
def test_stale_compiled_plan_rejects_different_dictionaries():
    # recode tables and lowered literals are fixed at compile time: a
    # lowered plan must not run against tables whose dictionaries changed
    from repro_torch.planner import compile_plan, run_physical
    env = CylonEnv(1, device="cpu")
    mk = lambda words: DistTable.from_numpy(  # noqa: E731
        {"s": np.asarray(words), "v": np.asarray([1, 2], np.int32)}, 1,
        device="cpu")
    t1, t2 = mk(["ash", "oak"]), mk(["elm", "yew"])
    pplan = compile_plan(Plan.scan("t").sort(["s"]), {"t": t1})
    assert list(run_physical(pplan, env, {"t": t1}).to_numpy()["s"]) == \
        ["ash", "oak"]
    with pytest.raises(ValueError, match="differ from the ones this plan"):
        run_physical(pplan, env, {"t": t2})


def test_compile_plan_does_not_mutate_logical_dag():
    # recompiling a caller-held DAG against other dictionaries must not
    # reuse the first compile's recode tables or lowered literals
    from repro_torch.planner import compile_plan, from_plan, run_physical
    mk = lambda ks: DistTable.from_numpy(  # noqa: E731
        {"s": np.asarray(ks), "v": np.arange(len(ks), dtype=np.int32)}, 1,
        device="cpu")
    plan = Plan.scan("l").join(Plan.scan("r"), on="s")
    t1 = {"l": mk(["ash", "oak"]), "r": mk(["elm", "oak"])}
    t2 = {"l": mk(["m", "p"]), "r": mk(["o", "p"])}
    node = from_plan(plan.node, {k: (("s", "v"), 2.0) for k in t1})
    compile_plan(node, t1)
    out = run_physical(compile_plan(node, t2), CylonEnv(1, device="cpu"), t2)
    assert list(out.to_numpy()["s"]) == ["p"]


@pytest.mark.parametrize("mode", ["bsp", "bsp_staged", "amt"])
def test_recode_tables_reach_the_device_once_per_stage(monkeypatch, rng,
                                                       mode):
    # the same gather-table tensor serves every run of a built stage, and
    # the dictionaries are part of the stage-cache key (a different pair
    # of dictionaries builds new stages)
    from repro_torch.core import execute
    seen = []
    real = ops_local.recode

    def spy(table, mappings):
        seen.append({c: id(m) for c, m in mappings.items()})
        return real(table, mappings)

    monkeypatch.setattr(ops_local, "recode", spy)
    env = CylonEnv(2, device="cpu")
    ld = string_table(rng, pool=POOL[:5])
    rd = string_table(rng, pool=POOL[3:], value_col="w")
    tables = {"l": DistTable.from_numpy(ld, 2, capacity=128, device="cpu"),
              "r": DistTable.from_numpy(rd, 2, capacity=128, device="cpu")}
    plan = Plan.scan("l").join(Plan.scan("r"), on="s", out_capacity=8192)
    first = execute(plan, env, tables, mode=mode,
                    collect_stats=True)[0].to_numpy()
    n_first = len(seen)
    assert n_first == 2                       # one recode per join side
    _, st = execute(plan, env, tables, mode=mode, collect_stats=True)
    assert st.cache_misses == 0
    assert seen[n_first:] == seen[:n_first]   # the same tensors
    other = {"l": DistTable.from_numpy(string_table(rng, pool=POOL[:6]), 2,
                                       capacity=128, device="cpu"),
             "r": tables["r"]}
    _, st = execute(plan, env, other, mode=mode, collect_stats=True)
    assert st.cache_misses > 0
    assert first["s"].dtype.kind == "U"
