"""Ingest of 64-bit host columns: the port against the JAX package.

The JAX package stores every ingested column with ``jnp.asarray`` and runs
with 64-bit types disabled, so numpy's and pandas' default dtypes land on
the device as 32-bit ones: int64 as int32 and uint64 as uint32 (both
wrapping), float64 as float32.  The port must hold the same dtypes and the
same values, slot for slot, exactly: through ``DistTable.from_numpy``,
``df.read_numpy`` and ``df.from_pandas``, with null masks and NaN-bearing
floats, and through ``expr.as_tensor`` for literals.  A small Fig-9-shaped
pipeline over such inputs must then give the reference's result (keys
exact, float sums and means to ``rtol=1e-5``: another summation order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

RTOL = 1e-5            # float sums and means: another summation order
BIG = 2 ** 31 + 5      # wraps to -2147483643 in int32


def _columns(seed=0, n=37):
    rng = np.random.default_rng(seed)
    keys = np.arange(n)                                   # int64
    keys[::9] += BIG
    nan = rng.random(n)
    nan[::5] = np.nan
    return {
        "arange": np.arange(n),                           # int64
        "k": keys,
        "f64": np.random.default_rng(0).random(n),        # float64
        "u64": (rng.integers(0, 2 ** 62, n, dtype=np.uint64)
                * np.uint64(3)),                          # past 2**32
        "nan": nan,                                       # float64 + mask
        "i32": rng.integers(-9, 9, n).astype(np.int32),   # kept as is
        "b": rng.random(n) < 0.5,                         # kept as is
    }


def _same_slots(jax_table, port_table):
    """Device columns of both tables: equal names, dtypes and values in
    every slot, padding included, and equal row counts."""
    cols, counts = port_table.to_reference()
    assert sorted(cols) == sorted(jax_table.columns)
    for name, want in jax_table.columns.items():
        want = np.asarray(want)
        got = cols[name]
        assert got.dtype == want.dtype, (name, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(counts, np.asarray(jax_table.row_counts))


@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("name", sorted(_columns()))
def test_from_numpy_narrows_like_jax(name, p):
    from repro.core import DistTable as JTable
    from repro_torch.core import DistTable
    data = {name: _columns()[name]}
    _same_slots(JTable.from_numpy(data, p),
                DistTable.from_numpy(data, p, device="cpu"))


def test_from_numpy_wraps_the_big_key():
    from repro.core import DistTable as JTable
    from repro_torch.core import DistTable
    data = {"k": np.array([1, 2, 3, BIG]), "v": np.random.default_rng(0)
            .random(4)}
    want = JTable.from_numpy(data, 1).to_numpy()
    got = DistTable.from_numpy(data, 1, device="cpu").to_numpy()
    assert got["k"].tolist() == want["k"].tolist() == [1, 2, 3, -2147483643]
    assert got["v"].dtype == want["v"].dtype == np.float32
    np.testing.assert_array_equal(got["v"], want["v"])


@pytest.fixture
def envs():
    import repro.df as jdf
    import repro_torch.df as tdf
    from repro.core import CylonEnv as JEnv
    from repro_torch.core import CylonEnv
    jdf.set_default_env(JEnv())
    tdf.set_default_env(CylonEnv(1, device="cpu"))
    yield
    jdf.reset_default_env()
    tdf.reset_default_env()


def test_read_numpy_narrows_like_jax(envs):
    import repro.df as jdf
    import repro_torch.df as tdf
    data = _columns(seed=1)
    _same_slots(jdf.read_numpy(data).collect(),
                tdf.read_numpy(data).collect())


def test_from_pandas_default_dtypes_match_jax(envs):
    pd = pytest.importorskip("pandas")
    import repro.df as jdf
    import repro_torch.df as tdf
    data = _columns(seed=2)
    pdf = pd.DataFrame({"k": data["k"], "f64": data["f64"],
                        "nan": data["nan"], "u64": data["u64"],
                        "s": ["ab", "c", "ab"] * 12 + ["d"]})
    assert str(pdf["k"].dtype) == "int64" and str(pdf["f64"].dtype) == \
        "float64"
    jt, tt = jdf.from_pandas(pdf).collect(), tdf.from_pandas(pdf).collect()
    _same_slots(jt, tt)
    want, got = jt.to_numpy(nulls="mask"), tt.to_numpy(nulls="mask")
    assert sorted(got) == sorted(want)
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        np.testing.assert_array_equal(got[c], want[c], err_msg=c)


@pytest.mark.parametrize("value", [np.arange(3), np.arange(3) * 0.5,
                                   np.array([2 ** 40 + 3], np.uint64),
                                   np.array([1 + 2j]), np.int64(BIG),
                                   np.float64(0.1)])
def test_as_tensor_narrows_like_jnp_asarray(value):
    from repro_torch.dtypes import x32_dtype
    from repro_torch.expr import as_tensor
    got = as_tensor(value)
    want = np.asarray(jnp.asarray(value))
    assert got.numpy().dtype == want.dtype == x32_dtype(np.asarray(value)
                                                         .dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fig9_on_64bit_inputs_matches_jax(envs):
    # the Fig-9 pipeline (join -> groupby sum and mean -> sort -> add a
    # scalar) on numpy-default inputs: int64 keys, some past 2**31, and
    # float64 values, through both frontends
    import repro.df as jdf
    import repro_torch.df as tdf
    from repro.expr import col as jcol
    from repro_torch.expr import col
    rng = np.random.default_rng(3)
    n = 400
    lk, rk = rng.integers(0, 300, n), rng.integers(0, 300, n)
    lk[::7] += BIG
    rk[::5] += BIG
    ld = {"k": lk, "v0": rng.random(n)}
    rd = {"k": rk, "w": rng.random(n)}
    out = []
    for rdf, c in ((tdf, col), (jdf, jcol)):
        # named sources: EXPLAIN prints the scans' names, and the default
        # names count frames per process, which other tests advance
        l, r = rdf.read_numpy(ld, name="l"), rdf.read_numpy(rd, name="r")
        out.append(l.merge(r, on="k", out_capacity=8192)
                   .groupby("k").agg({"v0": ["sum", "mean"], "w": "max"})
                   .sort_values("k")
                   .assign(v0_sum=c("v0_sum") + 1.0))
    tf, jf = out
    assert tf.explain() == jf.explain()
    got, want = tf.to_numpy(), jf.to_numpy()
    assert sorted(got) == sorted(want)
    assert (want["k"] < 0).any()          # the wrapped keys took part
    for c in want:
        assert got[c].dtype == want[c].dtype, c
        if want[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c], want[c], rtol=RTOL,
                                       err_msg=c)
        else:
            np.testing.assert_array_equal(got[c], want[c], err_msg=c)
