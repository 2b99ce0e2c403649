"""repro_torch rank-local operators against the JAX package's.

The same numpy inputs (from a seed) go through ``repro.dataframe`` under
``jax.vmap`` over ranks and through ``repro_torch.dataframe`` batched
over a stacked rank axis, on the CPU.  Tolerances: keys, integer columns,
row counts and row placement exact (every slot, padding included); float
sums ``rtol=1e-5`` (summation order may differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dataframe import ops_local as jops
from repro.dataframe.table import Table as JTable
from repro.expr import col as jcol
from repro.expr import lit as jlit
from repro_torch.dataframe import ops_local as tops
from repro_torch.dataframe.table import Table as TTable
from repro_torch.expr import col as tcol
from repro_torch.expr import lit as tlit

RTOL = 1e-5  # float sums: summation order may differ


def make_ranks(seed, p=4, cap=64, n_keys=20, masks=(), full=False,
               empty=False, float_key=False):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, n_keys, (p, cap)).astype(np.int32)
    cols = {"k": (k.astype(np.float32) / 4 if float_key else k),
            "v": rng.random((p, cap)).astype(np.float32),
            "w": rng.integers(-50, 50, (p, cap)).astype(np.int32)}
    for c in masks:
        m = rng.random((p, cap)) < 0.7
        cols[f"__m_{c}"] = m
        cols[c] = np.where(m, cols[c], 0).astype(cols[c].dtype)
    counts = rng.integers(0, cap + 1, p).astype(np.int32)
    if full:
        counts[:] = cap
    if empty:
        counts[0] = 0
    return cols, counts


def run_jax(fn, cols, counts):
    def f(c, n):
        return fn(JTable(dict(c), n))
    out = jax.jit(jax.vmap(f))(
        {k: jnp.asarray(v) for k, v in cols.items()}, jnp.asarray(counts))
    return jax.tree_util.tree_map(np.asarray, out)


def run_torch(fn, cols, counts):
    t = TTable({k: torch.as_tensor(v) for k, v in cols.items()},
               torch.as_tensor(counts))
    return fn(t)


def assert_tables_equal(jt, tt, float_cols=()):
    """Every column, every slot; ``float_cols`` within RTOL."""
    np.testing.assert_array_equal(np.asarray(jt.row_count),
                                  tt.row_count.numpy())
    assert sorted(jt.columns) == sorted(tt.columns)
    for name, a in jt.columns.items():
        b = tt.columns[name].numpy()
        assert a.dtype == b.dtype, name
        if name in float_cols:
            np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.mark.parametrize("key_cols", [["k"], ["k", "w"], ["v"], ["w", "v"]])
def test_hash_columns_bit_exact(key_cols):
    cols, counts = make_ranks(0)
    got = run_torch(lambda t: tops.hash_columns(t, key_cols), cols, counts)
    for r in range(4):
        want = jops.hash_columns_np({c: cols[c][r] for c in key_cols},
                                    key_cols)
        np.testing.assert_array_equal(got[r].numpy().astype(np.uint32), want)
    # and the jnp version, as uint32
    jh = run_jax(lambda t: jops.hash_columns(t, key_cols), cols, counts)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), jh)


def test_hash_columns_np_copy_matches_reference():
    cols, _ = make_ranks(1)
    flat = {c: cols[c].reshape(-1) for c in ("k", "v", "w")}
    for keys in (["k"], ["v", "w"]):
        np.testing.assert_array_equal(tops.hash_columns_np(flat, keys),
                                      jops.hash_columns_np(flat, keys))


@pytest.mark.parametrize("case", ["plain", "masked", "full", "empty",
                                  "float_key"])
@pytest.mark.parametrize("by", [["k"], ["k", "w"]])
def test_sort_local(case, by):
    kw = {"masked": dict(masks=("k", "v")), "full": dict(full=True),
          "empty": dict(empty=True), "float_key": dict(float_key=True)}
    cols, counts = make_ranks(2, **kw.get(case, {}))
    jt = run_jax(lambda t: jops.sort_local(t, by), cols, counts)
    tt = run_torch(lambda t: tops.sort_local(t, by), cols, counts)
    assert_tables_equal(jt, tt)


@pytest.mark.parametrize("case", ["plain", "masked", "full", "empty"])
def test_groupby_local(case):
    kw = {"masked": dict(masks=("k", "v", "w")), "full": dict(full=True),
          "empty": dict(empty=True)}
    cols, counts = make_ranks(3, **kw.get(case, {}))
    aggs = {"v": ["sum", "min", "max", "count"],
            "w": ["sum", "min", "max", "size"]}
    jt = run_jax(lambda t: jops.groupby_local(t, ["k"], aggs), cols, counts)
    tt = run_torch(lambda t: tops.groupby_local(t, ["k"], aggs), cols, counts)
    assert_tables_equal(jt, tt, float_cols=("v_sum",))


@pytest.mark.parametrize("case", ["plain", "masked", "full", "empty"])
@pytest.mark.parametrize("out_cap", [None, 40, 256])
def test_join_local(case, out_cap):
    kw = {"masked": dict(masks=("k", "v")), "full": dict(full=True),
          "empty": dict(empty=True)}
    lcols, lcounts = make_ranks(4, n_keys=12, **kw.get(case, {}))
    rcols, rcounts = make_ranks(5, n_keys=12, **kw.get(case, {}))

    def jjoin(lc, ln, rc, rn):
        return jops.join_local(JTable(dict(lc), ln), JTable(dict(rc), rn),
                               "k", out_capacity=out_cap, with_overflow=True)
    jo, jov = jax.jit(jax.vmap(jjoin))(
        {k: jnp.asarray(v) for k, v in lcols.items()}, jnp.asarray(lcounts),
        {k: jnp.asarray(v) for k, v in rcols.items()}, jnp.asarray(rcounts))
    jo = jax.tree_util.tree_map(np.asarray, jo)
    tl = TTable({k: torch.as_tensor(v) for k, v in lcols.items()},
                torch.as_tensor(lcounts))
    tr = TTable({k: torch.as_tensor(v) for k, v in rcols.items()},
                torch.as_tensor(rcounts))
    to, tov = tops.join_local(tl, tr, "k", out_capacity=out_cap,
                              with_overflow=True)
    assert_tables_equal(jo, to)
    np.testing.assert_array_equal(tov.numpy(), np.asarray(jov))
    cap = out_cap or 64
    np.testing.assert_array_equal(
        tops.join_overflow(tl, tr, "k", cap).numpy(),
        jax.vmap(lambda lc, ln, rc, rn: jops.join_overflow(
            JTable(dict(lc), ln), JTable(dict(rc), rn), "k", cap))(
            {k: jnp.asarray(v) for k, v in lcols.items()},
            jnp.asarray(lcounts),
            {k: jnp.asarray(v) for k, v in rcols.items()},
            jnp.asarray(rcounts)))


def test_drop_null_keys():
    cols, counts = make_ranks(6, masks=("k", "w"))
    jt = run_jax(lambda t: jops.drop_null_keys(t, ["k", "w"]), cols, counts)
    tt = run_torch(lambda t: tops.drop_null_keys(t, ["k", "w"]), cols,
                   counts)
    assert_tables_equal(jt, tt)


@pytest.mark.parametrize("which", ["cmp", "and", "nullable", "isnull"])
def test_filter_expr(which):
    cols, counts = make_ranks(7, masks=("v",))

    def pred(c):
        return {"cmp": c("v") > 0.5,
                "and": (c("k") % 3 == 0) & (c("w") < 10),
                "nullable": (c("v") * 2 > 0.4) | (c("k") > 15),
                "isnull": c("v").is_null()}[which]
    jt = run_jax(lambda t: jops.filter_expr(t, pred(jcol)), cols, counts)
    tt = run_torch(lambda t: tops.filter_expr(t, pred(tcol)), cols, counts)
    assert_tables_equal(jt, tt)


def test_with_columns_and_add_scalar():
    cols, counts = make_ranks(8, masks=("v",))

    def exprs(c, lit):
        return {"x": c("w") * 3 - 1, "y": c("v") / 2 + c("w"),
                "z": c("k") // 4, "q": c("v").fill_null(-1.0),
                "m": c("w") % 7, "one": lit(1), "half": lit(0.5)}
    jt = run_jax(lambda t: jops.add_scalar(
        jops.with_columns(t, exprs(jcol, jlit)), 1.5, ["y", "v"]), cols,
        counts)
    tt = run_torch(lambda t: tops.add_scalar(
        tops.with_columns(t, exprs(tcol, tlit)), 1.5, ["y", "v"]), cols,
        counts)
    assert_tables_equal(jt, tt)
