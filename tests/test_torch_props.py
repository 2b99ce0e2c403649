"""The port's distributed join / groupby / sort against pandas and the JAX
package, on the reference's pandas-oracle suites.

``tests/test_df_props.py`` runs the JAX package's ``shuffle`` +
``join_local``, ``groupby`` and ``sort`` over ranks simulated with
``jax.vmap`` on tables from ``tests/strategies.py``: per-rank counts of 0,
1, half and the whole capacity, duplicate-rich small-range keys and
integer-valued payloads, so every aggregate is exact.  Here the same
tables go through the port's stacked ranks on the CPU (every column
``(p, capacity)``, the ``xla`` communicator) and each case is held both to
the pandas oracle and to the reference's own run at the same p, for p in
{1, 2, 3, 4, 8}: the fixed adversarial cases, a fixed-seed twin and the
hypothesis suites at the reference's 15 examples each, derandomized.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import test_df_props as ref
from strategies import (HAVE_HYPOTHESIS, all_rows_one_rank,
                        draw_rank_tables, random_rank_tables)
from repro_torch.comm import get_communicator
from repro_torch.dataframe import Table, groupby, join_local, shuffle, sort

CAP = ref.CAP
PS = [1, 2, 3, 4, 8]
AGGS = {"v": ["sum", "mean", "min", "max", "count"]}
LCOLS = {"k": np.int32, "v": np.float32, "i": np.int32}
RCOLS = {"k": np.int32, "w": np.float32, "u": np.uint32}
KCOLS = {"k": np.int32, "v": np.float32}


# ---------------------------------------------------------------------- #
# The port's drivers: the reference's, over stacked ranks
# ---------------------------------------------------------------------- #
def _table(ranks, cols):
    arrays, counts = ref._mk_rank_arrays(ranks, cols)
    return Table({n: torch.as_tensor(a) for n, a in arrays.items()},
                 torch.as_tensor(counts))


def _gather(table):
    """Valid rows of every rank, in rank order, as host arrays."""
    counts = table.row_count.numpy()
    return {n: np.concatenate([c[r, :counts[r]].numpy()
                               for r in range(len(counts))])
            for n, c in table.columns.items()}


def _port_join(p, lranks, rranks):
    comm = get_communicator("xla", p)
    kw = dict(bucket_capacity=CAP, out_capacity=p * CAP)
    ls, _ = shuffle(_table(lranks, LCOLS), comm, key_cols=["k"], **kw)
    rs, _ = shuffle(_table(rranks, RCOLS), comm, key_cols=["k"], **kw)
    return _gather(join_local(ls, rs, "k", out_capacity=(p * CAP) ** 2))


def _port_groupby(p, ranks):
    out, _ = groupby(_table(ranks, KCOLS), get_communicator("xla", p), ["k"],
                     AGGS, pre_aggregate=True, bucket_capacity=CAP,
                     out_capacity=p * CAP)
    return _gather(out)


def _port_sort(p, ranks):
    out, _ = sort(_table(ranks, KCOLS), get_communicator("xla", p),
                  ["k", "v"], samples=8, bucket_capacity=CAP,
                  out_capacity=p * CAP)
    return _gather(out)


# ---------------------------------------------------------------------- #
# Pandas oracles (those of tests/test_df_props.py) and the three checks
# ---------------------------------------------------------------------- #
def _frame(ranks, cols):
    return pd.DataFrame({n: ref._concat_ranks(ranks, n, d)
                         for n, d in cols.items()})


def _check_join(p, lranks, rranks):
    got = _port_join(p, lranks, rranks)
    merged = _frame(lranks, LCOLS).merge(_frame(rranks, RCOLS), on="k",
                                         how="inner")
    names = ["k", "v", "i", "w", "u"]
    ref._assert_same_records(got, {c: merged[c].to_numpy() for c in names},
                             names)
    ref._assert_same_records(got, ref._dist_join(p, lranks, rranks), names)


def _check_groupby(p, ranks):
    got = _port_groupby(p, ranks)
    want_ref = ref._dist_groupby(p, ranks, AGGS)
    if not any(ranks):
        assert all(len(v) == 0 for v in got.values())
        assert all(len(v) == 0 for v in want_ref.values())
        return
    g = _frame(ranks, KCOLS).groupby("k")["v"].agg(["sum", "min", "max",
                                                    "count"])
    # the engine's mean is f32 sum / f32 count, as the reference's oracle
    want = {"k": g.index.to_numpy(np.int32),
            "v_sum": g["sum"].to_numpy(np.float32),
            "v_mean": (g["sum"].to_numpy(np.float32)
                       / g["count"].to_numpy(np.float32)),
            "v_min": g["min"].to_numpy(np.float32),
            "v_max": g["max"].to_numpy(np.float32),
            "v_count": g["count"].to_numpy(np.int32)}
    ref._assert_same_records(got, want, ["k"])
    ref._assert_same_records(got, want_ref, ["k"])


def _check_sort(p, ranks):
    got = _port_sort(p, ranks)
    df = _frame(ranks, KCOLS)
    # global key order is exact; cross-rank tie order follows the sort keys
    np.testing.assert_array_equal(got["k"], np.sort(df["k"].to_numpy(),
                                                    kind="stable"))
    want = df.sort_values(["k", "v"])
    ref._assert_same_records(got, {"k": want["k"].to_numpy(),
                                   "v": want["v"].to_numpy()}, ["k", "v"])
    # the same rows on the same ranks as the reference
    want_ref = ref._dist_sort(p, ranks)
    for c in ("k", "v"):
        np.testing.assert_array_equal(got[c], want_ref[c], err_msg=c)


# ---------------------------------------------------------------------- #
# Fixed adversarial cases (tests/test_df_props.py's, at every p)
# ---------------------------------------------------------------------- #
_rows = ref._rows


def test_join_empty_ranks_and_duplicates():
    lranks = [_rows([1, 1, 2], [1., 2., 3.], [7, 8, 9]), {},
              _rows([2, 3], [4., 5.], [1, 2]), {}]
    rranks = [{}, _rows([1, 2, 2], w=[10., 20., 30.], u=[1, 2, 3]),
              {}, _rows([9], w=[0.], u=[0])]
    _check_join(4, lranks, rranks)


def test_join_exact_capacity_and_skew(rng):
    lranks = [_rows([5] * CAP, rng.random(CAP), np.arange(CAP))
              for _ in range(2)]
    rranks = [_rows([5] * CAP, w=rng.random(CAP), u=np.arange(CAP))
              for _ in range(2)]
    _check_join(2, lranks, rranks)


def test_groupby_empty_ranks_duplicates_skew(rng):
    ranks = [_rows([3] * CAP, rng.integers(0, 50, CAP)), {},
             _rows([3, 4, 4, 5], [1, 2, 3, 4]), {}]
    _check_groupby(4, ranks)
    _check_groupby(1, [_rows([0, 0, 0], [1, 2, 3])])


def test_sort_empty_ranks_and_ties(rng):
    ranks = [_rows([2, 2, 1], [3., 1., 2.]), {},
             _rows([0] * CAP, rng.integers(0, 9, CAP)), {}]
    _check_sort(4, ranks)


@pytest.mark.parametrize("p", PS)
def test_all_rows_one_rank(p):
    # one rank holds every row (a full table), the others none
    rng = np.random.default_rng(p)
    ranks = all_rows_one_rank(rng, p, CAP, names=("v",), loaded=p - 1)
    _check_groupby(p, ranks)
    _check_sort(p, ranks)


@pytest.mark.parametrize("p", PS)
def test_random_rank_tables(p):
    # fixed-seed twin of the hypothesis suites below
    rng = np.random.default_rng(100 + p)
    for _ in range(3):
        _check_join(p, random_rank_tables(rng, p, ("v", "i"), cap=CAP),
                    random_rank_tables(rng, p, ("w", "u"), cap=CAP))
        _check_groupby(p, random_rank_tables(rng, p, ("v",), cap=CAP))
        _check_sort(p, random_rank_tables(rng, p, ("v",), cap=CAP))


# ---------------------------------------------------------------------- #
# Hypothesis suites (the reference's strategies, 15 examples each,
# derandomized so every run draws the same tables)
# ---------------------------------------------------------------------- #
if HAVE_HYPOTHESIS:
    from hypothesis import given, settings, strategies as st

    SUITE = settings(max_examples=15, deadline=None, derandomize=True)

    @pytest.mark.parametrize("p", PS)
    @SUITE
    @given(data=st.data())
    def test_join_matches_pandas_and_reference(p, data):
        _check_join(p, draw_rank_tables(data, p, ("v", "i"), cap=CAP),
                    draw_rank_tables(data, p, ("w", "u"), cap=CAP))

    @pytest.mark.parametrize("p", PS)
    @SUITE
    @given(data=st.data())
    def test_groupby_matches_pandas_and_reference(p, data):
        _check_groupby(p, draw_rank_tables(data, p, ("v",), cap=CAP))

    @pytest.mark.parametrize("p", PS)
    @SUITE
    @given(data=st.data())
    def test_sort_matches_pandas_and_reference(p, data):
        _check_sort(p, draw_rank_tables(data, p, ("v",), cap=CAP))
