"""repro_torch shuffle, communicator and distributed operators against the
JAX package's.

The JAX side runs p ranks in-process under ``jax.vmap(axis_name="df")``
(as ``tests/test_shuffle_sortfree.py`` does); the port runs the same
numpy inputs on its stacked-ranks communicator, on the CPU.  Tolerances:
keys, integer columns, counts, row placement and drop counts exact (every
slot); float sums ``rtol=1e-5``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import get_communicator as jget_comm
from repro.dataframe import groupby as jgroupby
from repro.dataframe import join as jjoin
from repro.dataframe import shuffle as jshuffle
from repro.dataframe import sort as jsort
from repro.dataframe.table import Table as JTable
from repro_torch.comm import StackedCommunicator
from repro_torch.dataframe import groupby as tgroupby
from repro_torch.dataframe import join as tjoin
from repro_torch.dataframe import shuffle as tshuffle
from repro_torch.dataframe import sort as tsort
from repro_torch.dataframe.table import Table as TTable

RTOL = 1e-5  # float sums: summation order may differ


def make_ranks(seed, p, cap, n_keys=50, skew=False, masks=()):
    rng = np.random.default_rng(seed)
    if skew:   # zipf-skewed keys: a few destinations absorb most rows
        k = (rng.zipf(1.4, (p, cap)) % n_keys).astype(np.int32)
    else:
        k = rng.integers(0, n_keys, (p, cap)).astype(np.int32)
    cols = {"k": k, "v": rng.random((p, cap)).astype(np.float32),
            "w": rng.integers(0, 1000, (p, cap)).astype(np.int32)}
    for c in masks:
        m = rng.random((p, cap)) < 0.75
        cols[f"__m_{c}"] = m
        cols[c] = np.where(m, cols[c], 0).astype(cols[c].dtype)
    counts = rng.integers(0, cap + 1, p).astype(np.int32)
    return cols, counts


def run_jax(fn, *tables):
    """``fn(comm, *Tables)`` on p vmapped ranks; outputs as numpy."""
    comm = jget_comm("xla", "df")

    def f(*flat):
        ts = [JTable(dict(c), n) for c, n in zip(flat[::2], flat[1::2])]
        return fn(comm, *ts)
    flat = []
    for cols, counts in tables:
        flat += [{k: jnp.asarray(v) for k, v in cols.items()},
                 jnp.asarray(counts)]
    out = jax.jit(jax.vmap(f, axis_name="df"))(*flat)
    return jax.tree_util.tree_map(np.asarray, out)


def run_torch(fn, *tables):
    p = len(tables[0][1])
    comm = StackedCommunicator(p)
    ts = [TTable({k: torch.as_tensor(v) for k, v in cols.items()},
                 torch.as_tensor(counts)) for cols, counts in tables]
    return fn(comm, *ts)


def assert_tables_equal(jt, tt, float_cols=()):
    np.testing.assert_array_equal(tt.row_count.numpy(),
                                  np.asarray(jt.row_count))
    assert sorted(jt.columns) == sorted(tt.columns)
    for name, a in jt.columns.items():
        b = tt.columns[name].numpy()
        assert a.dtype == b.dtype, name
        if name in float_cols:
            np.testing.assert_allclose(b, a, rtol=RTOL, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def assert_stats_equal(js, ts):
    np.testing.assert_array_equal(ts.sent_counts.numpy(), js.sent_counts)
    np.testing.assert_array_equal(ts.recv_counts.numpy(), js.recv_counts)
    np.testing.assert_array_equal(ts.send_dropped.numpy(), js.send_dropped)
    np.testing.assert_array_equal(ts.recv_dropped.numpy(), js.recv_dropped)


@pytest.mark.parametrize("impl", ["radix", "sorted"])
@pytest.mark.parametrize("p", [1, 3, 8])
def test_shuffle_matches_reference(impl, p):
    data = make_ranks(p, p, 64, masks=("v",))
    kw = dict(key_cols=["k"], bucket_capacity=24, impl=impl)
    jt, js = run_jax(lambda c, t: jshuffle(t, c, **kw), data)
    tt, ts = run_torch(lambda c, t: tshuffle(t, c, **kw), data)
    assert_tables_equal(jt, tt)
    assert_stats_equal(js, ts)
    assert ts.shuffle_impl == impl


@pytest.mark.parametrize("chunks", [1, 2, 3, 8])
def test_chunked_all_to_all(chunks):
    data = make_ranks(11, 4, 48)
    kw = dict(key_cols=["k"], bucket_capacity=24, a2a_chunks=chunks)
    jt, js = run_jax(lambda c, t: jshuffle(t, c, **kw), data)
    tt, ts = run_torch(lambda c, t: tshuffle(t, c, **kw), data)
    assert_tables_equal(jt, tt)
    assert_stats_equal(js, ts)
    assert ts.a2a_chunks == chunks


@pytest.mark.parametrize("impl", ["radix", "sorted"])
def test_skewed_overflow_counts(impl):
    # 5 hot keys into 8 x 16-slot buckets and a small receive table: both
    # send and receive drops, counted identically
    data = make_ranks(12, 8, 64, n_keys=5, skew=True)
    kw = dict(key_cols=["k"], bucket_capacity=16, out_capacity=40,
              impl=impl)
    jt, js = run_jax(lambda c, t: jshuffle(t, c, **kw), data)
    tt, ts = run_torch(lambda c, t: tshuffle(t, c, **kw), data)
    assert_tables_equal(jt, tt)
    assert_stats_equal(js, ts)
    assert int(ts.send_dropped.sum()) > 0
    assert int(ts.recv_dropped.sum()) > 0
    kept = int(tt.row_count.sum()) + int(ts.recv_dropped.sum())
    assert kept + int(ts.send_dropped.sum()) == int(data[1].sum())


def test_shuffle_explicit_dest():
    data = make_ranks(13, 4, 32)
    dest = np.random.default_rng(0).integers(0, 4, (4, 32)).astype(np.int32)
    jt, _ = run_jax(lambda c, t: jshuffle(
        t, c, dest=jnp.asarray(dest)[jax.lax.axis_index("df")]), data)
    tt, _ = run_torch(lambda c, t: tshuffle(t, c, dest=torch.as_tensor(dest)),
                      data)
    assert_tables_equal(jt, tt)


@pytest.mark.parametrize("pre", [True, False])
def test_groupby_distributed(pre):
    data = make_ranks(14, 4, 64, n_keys=30, masks=("v",))
    aggs = {"v": ["sum", "mean", "min", "max", "count"], "w": ["sum", "size"]}
    jt, js = run_jax(lambda c, t: jgroupby(t, c, ["k"], aggs,
                                           pre_aggregate=pre), data)
    tt, ts = run_torch(lambda c, t: tgroupby(t, c, ["k"], aggs,
                                             pre_aggregate=pre), data)
    assert_tables_equal(jt, tt, float_cols=("v_sum", "v_mean"))
    assert_stats_equal(js, ts)


def test_join_distributed():
    l, r = make_ranks(15, 4, 48, n_keys=40), make_ranks(16, 4, 48, n_keys=40)
    jt, jl, jr = run_jax(lambda c, a, b: jjoin(a, b, c, "k",
                                               out_capacity=128), l, r)
    tt, tl, tr = run_torch(lambda c, a, b: tjoin(a, b, c, "k",
                                                 out_capacity=128), l, r)
    assert_tables_equal(jt, tt)
    assert_stats_equal(jl, tl)
    assert_stats_equal(jr, tr)


@pytest.mark.parametrize("masks", [(), ("k",)])
def test_sort_distributed(masks):
    data = make_ranks(17, 4, 64, n_keys=500, masks=masks)
    jt, js = run_jax(lambda c, t: jsort(t, c, ["k", "w"], samples=16), data)
    tt, ts = run_torch(lambda c, t: tsort(t, c, ["k", "w"], samples=16),
                       data)
    assert_tables_equal(jt, tt)
    assert_stats_equal(js, ts)


# ---------------------------------------------------------------------- #
# Communicator: the stacked collectives against jax.lax on vmapped ranks
# ---------------------------------------------------------------------- #
def test_stacked_collectives_match_lax():
    p = 4
    x = np.random.default_rng(18).integers(0, 100, (p, p, 3)).astype(
        np.int32)
    jc = jget_comm("xla", "df")
    tc = StackedCommunicator(p)

    def jall(a):
        return (jc.all_to_all(a), jc.all_gather(a[0]), jc.all_reduce(a),
                jc.reduce_scatter(a), jc.all_reduce_max(a),
                jc.all_reduce_min(a), jc.broadcast(a, root=2),
                jc.exchange_counts(a[:, 0]), jc.all_to_all_chunked(a, 2),
                jc.ppermute(a, [(i, (i + 1) % p) for i in range(p)]))
    want = jax.tree_util.tree_map(
        np.asarray, jax.vmap(jall, axis_name="df")(jnp.asarray(x)))
    t = torch.as_tensor(x)
    got = (tc.all_to_all(t), tc.all_gather(t[:, 0]), tc.all_reduce(t),
           tc.reduce_scatter(t), tc.all_reduce_max(t), tc.all_reduce_min(t),
           tc.broadcast(t, root=2), tc.exchange_counts(t[:, :, 0]),
           tc.all_to_all_chunked(t, 2),
           tc.ppermute(t, [(i, (i + 1) % p) for i in range(p)]))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(tc.rank().numpy(), np.arange(p))


@pytest.mark.parametrize("chunks", [0, -1, 1.5, True, 9])
def test_all_to_all_chunked_rejects_bad_chunks(chunks):
    tc = StackedCommunicator(2)
    with pytest.raises(ValueError, match="all_to_all_chunked"):
        tc.all_to_all_chunked(torch.zeros((2, 2, 8)), chunks)


def test_all_to_all_chunked_needs_capacity_axis():
    tc = StackedCommunicator(2)
    with pytest.raises(ValueError, match="capacity axis"):
        tc.all_to_all_chunked(torch.zeros((2, 2)), 1)


def test_shuffle_rejects_unknown_impl_and_debug_overflow():
    data = make_ranks(19, 2, 8)
    with pytest.raises(ValueError, match="unknown shuffle impl"):
        run_torch(lambda c, t: tshuffle(t, c, key_cols=["k"],
                                        impl="quantum"), data)
    # debug_overflow no longer refuses: it warns only where rows drop
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        run_torch(lambda c, t: tshuffle(t, c, key_cols=["k"],
                                        debug_overflow=True), data)
    with pytest.warns(RuntimeWarning, match=r"@ rank \d dropped rows"):
        run_torch(lambda c, t: tshuffle(t, c, key_cols=["k"],
                                        out_capacity=1,
                                        debug_overflow=True), data)
