"""Unsigned columns (uint16, uint32) through the port against the JAX
package.

torch on the CPU has no gather, scatter, comparison or searchsorted for
these dtypes, so the port moves them as the signed type of the same width
and orders and compares them widened (``repro_torch.dtypes``).  Each case
runs the same seeded inputs through both packages on the CPU — a groupby
keyed by an unsigned column, a groupby summing one, a sort, a join carrying
one, a min/max and a filter — with uint32 values past 2**31, where a
signed view would misorder them.  At one rank the results must match slot
for slot; at four ranks (the JAX side stays on its one CPU device) they
must match as tables, in the row order the operation defines.  Every
comparison is exact, dtypes included: the float payload holds integers,
so its sums are exact in any order.
"""

import numpy as np
import pytest

PLANS = ("groupby_key", "groupby_sum", "sort", "join", "minmax", "filter")
DTYPES = (np.uint16, np.uint32)


def _data(dt, n=200, seed=3):
    rng = np.random.default_rng(seed)
    top = int(np.iinfo(dt).max)
    # the top of the range (past 2**31 for uint32) and some small values
    u = rng.integers(top - 60, top, n, endpoint=True, dtype=np.uint64)
    u[::5] = rng.integers(0, 40, len(u[::5]))
    left = {"k": rng.integers(0, 16, n).astype(np.int32),
            "u": u.astype(dt),
            "v0": rng.integers(0, 100, n).astype(np.float32)}
    right = {"k": rng.integers(0, 16, n).astype(np.int32),
             "w": rng.integers(0, top, n, endpoint=True,
                               dtype=np.uint64).astype(dt)}
    return left, right


def _plan(Plan, col, name, dt):
    # the largest literal the JAX package takes for a uint32 column is
    # 2**31 - 1 (a Python int becomes an int32 there)
    half = int(np.iinfo(dt).max) // 2
    return {
        "groupby_key": lambda: Plan.scan("l").groupby(["u"],
                                                      {"v0": ["sum"]}),
        "groupby_sum": lambda: Plan.scan("l").groupby(["k"],
                                                      {"u": ["sum"]}),
        "sort": lambda: Plan.scan("l").sort(["u"]),
        "join": lambda: Plan.scan("l").join(Plan.scan("r"), on="k",
                                            out_capacity=8192),
        "minmax": lambda: Plan.scan("l").groupby(["k"],
                                                 {"u": ["min", "max"]}),
        "filter": lambda: Plan.scan("l").filter(col("u") > half),
    }[name]()


def _jax(name, dt):
    from repro.core import CylonEnv, DistTable, Plan, execute
    from repro.expr import col
    left, right = _data(dt)
    tables = {"l": DistTable.from_numpy(left, 1),
              "r": DistTable.from_numpy(right, 1)}
    out, st = execute(_plan(Plan, col, name, dt), CylonEnv(), tables,
                      collect_stats=True)
    assert st.rows_dropped == 0
    return out.to_numpy()


def _port(name, dt, p):
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    from repro_torch.expr import col
    left, right = _data(dt)
    # capacity headroom: 4 ranks share 200 rows by hash, unevenly
    cap = 256 if p == 1 else 128
    tables = {n: DistTable.from_numpy(d, p, capacity=cap, device="cpu")
              for n, d in (("l", left), ("r", right))}
    out, st = execute(_plan(Plan, col, name, dt),
                      CylonEnv(p, device="cpu"), tables, collect_stats=True)
    assert st.rows_dropped == 0
    return out.to_numpy()


def _canonical(table, name):
    """Rows in the order the operation defines across ranks: groupbys by
    key, the sort as it is (globally ordered), joins and filters by every
    column."""
    if name == "groupby_key":
        order = np.argsort(table["u"], kind="stable")
    elif name in ("groupby_sum", "minmax"):
        order = np.argsort(table["k"], kind="stable")
    elif name == "sort":
        order = np.arange(len(table["u"]))
    else:
        order = np.lexsort([table[c] for c in sorted(table)])
    return {c: v[order] for c, v in table.items()}


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("name", PLANS)
@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d.__name__)
def test_unsigned_columns_match_jax(dt, name, p):
    want = _jax(name, dt)
    got = _port(name, dt, p)
    assert sorted(got) == sorted(want)
    if p > 1:
        want, got = _canonical(want, name), _canonical(got, name)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)
    unsigned = [c for c in want if want[c].dtype == dt]
    assert unsigned, "no unsigned column in the result"
    if dt == np.uint32 and name != "groupby_sum":
        # values a signed view would misorder took part
        assert any((want[c] >= 2**31).any() for c in unsigned)


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: d.__name__)
def test_order_view_keeps_unsigned_order(dt):
    # the widened keys order as the values do, past half the range
    import torch
    from repro_torch.dtypes import order_view, signed_view
    vals = np.array([0, 1, np.iinfo(dt).max // 2, np.iinfo(dt).max // 2 + 1,
                     np.iinfo(dt).max], dtype=dt)
    t = torch.from_numpy(vals[::-1].copy())
    np.testing.assert_array_equal(
        torch.sort(order_view(t)).values.numpy().astype(dt), vals)
    assert signed_view(t).dtype.itemsize == np.dtype(dt).itemsize
    assert bool((signed_view(t) < 0).any())   # why the view never orders
