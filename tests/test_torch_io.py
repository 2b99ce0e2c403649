"""File ingest (Parquet / CSV into ``SpillTable``) through the port against
the JAX package.

Each case of ``tests/test_io.py`` runs here on files written once per test
from seeded numpy: ``repro.io`` and ``repro_torch.io`` read the same
files, and each rank's chunks (names, dtypes, values: codes and ``__m_*``
masks included), the dictionaries and the ``IngestInfo`` must be equal,
and so must the tables both packages scatter onto their ranks from them.
Plans over the ingested tables give the same EXPLAIN text (the scan label
names its source), the same results, ``rows_read`` / ``bytes_read`` and
shuffle records, in every in-core mode and out-of-core.

The reference's ``from_pandas`` of mixed NaN / ``None`` fails in the JAX
package itself, so the port is held to that function's docstring there,
not to its output.

One case runs at 8 ranks: a module-scoped subprocess runs the JAX side of
``tests/md_scripts/ingest_parity.py`` (scaled down) on 8 host devices —
``XLA_FLAGS`` must be set before jax is imported — and the port, on 8
stacked ranks, must match it slot for slot, in-core and 8x oversubscribed.
Run as a script (``python tests/test_torch_io.py DIR``) this file is that
JAX side.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, os.pardir, "src")
H100 = "NVIDIA H100 80GB HBM3"


# ---------------------------------------------------------------------- #
# Helpers
# ---------------------------------------------------------------------- #
def _write_parquet(path, cols, schema=None):
    import pyarrow as pa
    import pyarrow.parquet as pq
    table = cols if isinstance(cols, pa.Table) else pa.table(cols,
                                                             schema=schema)
    pq.write_table(table, str(path))


def _pq_dataset(tmp_path, nfiles=3, rows=20, seed=11):
    """``tests/test_io.py::_pq_dataset``: unique ``i``, nullable string key
    ``k``, nullable float ``v``, nullable int ``n`` per file."""
    rng = np.random.default_rng(seed)
    paths = []
    for f in range(nfiles):
        i = np.arange(f * rows, (f + 1) * rows)
        k = [f"key{rng.integers(0, 8):02d}" if rng.random() > 0.2 else None
             for _ in range(rows)]
        v = [float(rng.integers(0, 50)) if rng.random() > 0.2 else None
             for _ in range(rows)]
        n = [int(rng.integers(0, 9)) if rng.random() > 0.2 else None
             for _ in range(rows)]
        p = tmp_path / f"part{f}.parquet"
        _write_parquet(p, {"i": i, "k": k, "v": v, "n": n})
        paths.append(str(p))
    return paths


def _csv_dataset(tmp_path):
    (tmp_path / "a.csv").write_text(
        "i,k,v\n0,alpha,1.5\n1,,\n2,beta,3.0\n3,alpha,\n")
    (tmp_path / "b.csv").write_text(
        "i,k,v\n4,gamma,2.5\n5,beta,\n6,,0.5\n")
    return [str(tmp_path / "a.csv"), str(tmp_path / "b.csv")]


def _read(pkg, fmt, source, p, **kw):
    """Read ``source`` with ``pkg``'s reader and a fresh dictionary cache
    (unless one is passed)."""
    import importlib
    io = importlib.import_module(f"{pkg}.io")
    kw.setdefault("dict_cache", io.DictionaryCache())
    reader = io.read_parquet if fmt == "parquet" else io.read_csv
    return reader(source, parallelism=p, **kw)


def _same_spill(got, want):
    """Chunks per rank (names, dtypes, values), dictionaries, provenance,
    and the tables both packages scatter onto their ranks from them."""
    from repro.core.store import rescatter as jrescatter
    from repro_torch.core.store import rescatter as trescatter
    assert got.parallelism == want.parallelism
    assert got.schema == want.schema
    assert got.dictionaries == want.dictionaries
    assert dataclasses.asdict(got.provenance) == \
        dataclasses.asdict(want.provenance)
    assert str(got.provenance) == str(want.provenance)
    for r in range(want.parallelism):
        gc, wc = got.rank_chunks(r), want.rank_chunks(r)
        assert len(gc) == len(wc), r
        for g, w in zip(gc, wc):
            assert list(g) == list(w)
            for c in w:
                assert g[c].dtype == w[c].dtype, c
                np.testing.assert_array_equal(g[c], w[c], err_msg=c)
    if want.total_rows():
        jt = jrescatter(want, want.parallelism)
        tt = trescatter(got, got.parallelism, device="cpu")
        assert tt.capacity == jt.capacity
        assert tt.provenance is got.provenance
        jcols, jcounts = ({k: np.asarray(v) for k, v in jt.columns.items()},
                          np.asarray(jt.row_counts))
        tcols, tcounts = tt.to_reference()
        np.testing.assert_array_equal(tcounts, jcounts)
        assert sorted(tcols) == sorted(jcols)
        for c in jcols:
            assert tcols[c].dtype == jcols[c].dtype, c
            np.testing.assert_array_equal(tcols[c], jcols[c], err_msg=c)


def _both(fmt, source, p, monkeypatch=None, lane=None, **kw):
    if lane == "python":
        monkeypatch.setenv("REPRO_NO_PYARROW", "1")
    want = _read("repro", fmt, source, p, **kw)
    got = _read("repro_torch", fmt, source, p, **kw)
    _same_spill(got, want)
    return got, want


# ---------------------------------------------------------------------- #
# Ingest: same SpillTable as the JAX package
# ---------------------------------------------------------------------- #
def _case_multi_file(tmp_path):
    return "parquet", _pq_dataset(tmp_path), dict(batch_rows=8), 2


def _case_glob_columns(tmp_path):
    _pq_dataset(tmp_path)
    return ("parquet", str(tmp_path / "*.parquet"), dict(columns=["i", "v"]),
            2)


def _case_empty(tmp_path):
    import pyarrow as pa
    schema = pa.schema([("i", pa.int64()), ("k", pa.string()),
                        ("x", pa.float32())])
    _write_parquet(tmp_path / "empty.parquet",
                   {"i": [], "k": [], "x": []}, schema=schema)
    return "parquet", str(tmp_path / "empty.parquet"), {}, 2


def _case_growth(tmp_path):
    # file b introduces a lexicographically-earlier key: every code
    # assigned while reading file a is stale and is recoded at finalize
    _write_parquet(tmp_path / "a.parquet", {"k": ["m", "z", None, "m"]})
    _write_parquet(tmp_path / "b.parquet", {"k": ["a", "m", "a", None]})
    return ("parquet", [str(tmp_path / "a.parquet"),
                        str(tmp_path / "b.parquet")], {}, 2)


def _case_all_null(tmp_path):
    import pyarrow as pa
    _write_parquet(tmp_path / "n.parquet",
                   pa.table({"i": [1, 2, 3],
                             "s": pa.array([None, None, None],
                                           type=pa.string())}))
    return "parquet", str(tmp_path / "n.parquet"), {}, 1


def _case_wide_dtypes(tmp_path):
    # 64-bit and narrow numeric columns keep their host dtypes in the
    # chunks and narrow only on the way up, as jnp.asarray narrows them
    rng = np.random.default_rng(5)
    n = 40
    _write_parquet(tmp_path / "w.parquet", {
        "i64": rng.integers(-2**40, 2**40, n),
        "f64": rng.random(n),
        "i16": rng.integers(-300, 300, n).astype(np.int16),
        "u8": rng.integers(0, 255, n).astype(np.uint8),
        "b": rng.random(n) > 0.5})
    return "parquet", str(tmp_path / "w.parquet"), dict(batch_rows=16), 3


def _case_csv(tmp_path):
    return "csv", _csv_dataset(tmp_path), dict(batch_rows=3), 2


def _case_csv_promotion(tmp_path):
    # the first file parses x as int64, the second needs float64
    (tmp_path / "a.csv").write_text("i,x\n0,1\n1,2\n")
    (tmp_path / "b.csv").write_text("i,x\n2,3.5\n3,\n")
    return ("csv", [str(tmp_path / "a.csv"), str(tmp_path / "b.csv")], {},
            1)


INGEST_CASES = {
    "parquet-multi-file-nulls": (_case_multi_file, None),
    "parquet-glob-columns": (_case_glob_columns, None),
    "parquet-empty": (_case_empty, None),
    "parquet-dictionary-growth": (_case_growth, None),
    "parquet-all-null-string": (_case_all_null, None),
    "parquet-wide-dtypes": (_case_wide_dtypes, None),
    "csv-arrow": (_case_csv, None),
    "csv-python": (_case_csv, "python"),
    "csv-python-promotion": (_case_csv_promotion, "python"),
    "csv-arrow-promotion": (_case_csv_promotion, None),
}


@pytest.mark.parametrize("case", sorted(INGEST_CASES))
def test_ingest_matches_reference(tmp_path, monkeypatch, case):
    make, lane = INGEST_CASES[case]
    fmt, source, kw, p = make(tmp_path)
    got, want = _both(fmt, source, p, monkeypatch, lane, **kw)
    info = got.provenance
    assert info.rows == got.total_rows() and info.format == fmt
    files = source if isinstance(source, list) else None
    if files:
        assert info.bytes_read == sum(os.path.getsize(f) for f in files)
    if case == "parquet-dictionary-growth":
        assert info.recodes >= 1 and got.dictionaries["k"] == ("a", "m", "z")
        raw = got.to_numpy(decode=False, nulls="mask")
        assert not raw["k"][~raw["__m_k"]].any()   # canonical null code
    if case in ("parquet-all-null-string", "parquet-empty"):
        name = "s" if case == "parquet-all-null-string" else "k"
        assert got.dictionaries[name] == ("",)
    if case == "parquet-wide-dtypes":
        assert got.schema["i64"][0] == np.int64        # host dtype kept
        assert got.schema["f64"][0] == np.float64
    if case.startswith("csv-python-promotion"):
        assert got.schema["x"][0] == np.float64


def test_csv_lanes_agree(tmp_path, monkeypatch):
    paths = _csv_dataset(tmp_path)
    arrow = _read("repro_torch", "csv", paths, 2)
    monkeypatch.setenv("REPRO_NO_PYARROW", "1")
    python = _read("repro_torch", "csv", paths, 2)
    a, b = arrow.to_numpy(), python.to_numpy()
    order_a, order_b = np.argsort(a["i"]), np.argsort(b["i"])
    assert arrow.dictionaries == python.dictionaries
    assert set(a) == set(b)
    for c in a:
        for x, y in zip(np.asarray(a[c], object)[order_a],
                        np.asarray(b[c], object)[order_b]):
            assert (x is None) == (y is None), c
            if x is not None:
                assert x == y or (np.isnan(x) and np.isnan(y)), c


@pytest.mark.parametrize("fmt", ["parquet", "csv"])
def test_missing_source_raises(tmp_path, fmt):
    for pkg in ("repro", "repro_torch"):
        with pytest.raises(FileNotFoundError):
            _read(pkg, fmt, str(tmp_path / f"nope-*.{fmt}"), 2)
        with pytest.raises(FileNotFoundError):
            _read(pkg, fmt, str(tmp_path / f"nope.{fmt}"), 2)


def test_csv_header_mismatch(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_NO_PYARROW", "1")
    (tmp_path / "a.csv").write_text("i,x\n0,1\n")
    (tmp_path / "b.csv").write_text("i,y\n1,2\n")
    for pkg in ("repro", "repro_torch"):
        with pytest.raises(ValueError, match="header"):
            _read(pkg, "csv", [str(tmp_path / "a.csv"),
                               str(tmp_path / "b.csv")], 1)


def test_read_parquet_without_pyarrow_raises(tmp_path, monkeypatch):
    paths = _pq_dataset(tmp_path, nfiles=1)
    monkeypatch.setenv("REPRO_NO_PYARROW", "1")
    for pkg in ("repro", "repro_torch"):
        with pytest.raises(ImportError, match="requires pyarrow"):
            _read(pkg, "parquet", paths, 1)


@pytest.mark.parametrize("fmt", ["parquet", "csv"])
def test_repeat_read_cache_hit_and_bit_identity(tmp_path, fmt):
    from repro.io import DictionaryCache as JCache
    from repro_torch.io import DictionaryCache as TCache
    if fmt == "parquet":
        paths = _pq_dataset(tmp_path)
    else:
        paths = _csv_dataset(tmp_path)
    caches = {"repro": JCache(), "repro_torch": TCache()}
    first = {pkg: _read(pkg, fmt, paths, 2, batch_rows=8,
                        dict_cache=caches[pkg]) for pkg in caches}
    second = {pkg: _read(pkg, fmt, paths, 2, batch_rows=8,
                         dict_cache=caches[pkg]) for pkg in caches}
    for reads in (first, second):
        _same_spill(reads["repro_torch"], reads["repro"])
    t1, t2 = first["repro_torch"], second["repro_torch"]
    assert caches["repro_torch"].hits == caches["repro"].hits == 1
    assert caches["repro_torch"].misses == caches["repro"].misses == 1
    assert t2.provenance.dict_cache_hit and t2.provenance.recodes == 0
    assert t1.dictionaries == t2.dictionaries
    a = t1.to_numpy(decode=False, nulls="mask")
    b = t2.to_numpy(decode=False, nulls="mask")
    assert set(a) == set(b)
    for c in a:
        np.testing.assert_array_equal(a[c], b[c], err_msg=c)


def test_cache_invalidated_by_rewrite(tmp_path):
    from repro.io import DictionaryCache as JCache
    from repro_torch.io import DictionaryCache as TCache
    paths = _pq_dataset(tmp_path, nfiles=1)
    caches = {"repro": JCache(), "repro_torch": TCache()}
    for pkg, cache in caches.items():
        _read(pkg, "parquet", paths, 1, dict_cache=cache)
    # rewrite with different content: the size/mtime key no longer matches
    _write_parquet(paths[0], {"i": np.arange(4), "k": ["zz", None, "a", "b"],
                              "v": [1.0, None, 3.0, 4.0],
                              "n": [1, 2, None, 4]})
    out = {pkg: _read(pkg, "parquet", paths, 1, dict_cache=cache)
           for pkg, cache in caches.items()}
    _same_spill(out["repro_torch"], out["repro"])
    got = out["repro_torch"]
    assert not got.provenance.dict_cache_hit
    assert caches["repro_torch"].misses == 2
    assert got.dictionaries["k"] == ("a", "b", "zz")


def test_dictionary_cache_lru_and_numeric_sources(tmp_path):
    from repro_torch.io import DictionaryCache
    cache = DictionaryCache(max_entries=2)
    for i in range(3):
        cache.put(("k", i), {"s": ("a",)})
    assert len(cache) == 2 and cache.get(("k", 0)) is None
    assert cache.get(("k", 2)) == {"s": ("a",)}
    assert (cache.hits, cache.misses) == (1, 1)
    # a numeric-only source never stores dictionaries: a second read
    # consults the cache, misses, and still recodes nothing
    _write_parquet(tmp_path / "n.parquet", {"x": np.arange(10)})
    cache = DictionaryCache()
    for _ in range(2):
        s = _read("repro_torch", "parquet", str(tmp_path / "n.parquet"), 2,
                  dict_cache=cache)
        assert not s.provenance.dict_cache_hit and s.provenance.recodes == 0
    assert len(cache) == 0 and cache.misses == 2


# ---------------------------------------------------------------------- #
# from_pandas of mixed NaN / None: held to the reference's docstring
# ---------------------------------------------------------------------- #
def test_from_pandas_mixed_nan_none_contract():
    # ``repro.df.from_pandas``: numeric / bool columns pass through,
    # object columns are dictionary-encoded; NaN / None become validity
    # masks (``read_numpy``), decoded back as NaN / None by to_pandas.
    pd = pytest.importorskip("pandas")
    import repro_torch.df as tdf
    pdf = pd.DataFrame({"a": [1.0, np.nan, 3.0, np.nan],
                        "s": ["x", None, "y", None],
                        "b": [10, 20, 30, 40]})
    with tdf.session(parallelism=2, device="cpu"):
        got = tdf.from_pandas(pdf).to_numpy()
        out = tdf.from_pandas(pdf).to_pandas()
        raw = tdf.from_pandas(pdf).to_numpy(nulls="mask")
    order = np.argsort(got["b"])
    assert list(got["b"][order]) == [10, 20, 30, 40]
    np.testing.assert_array_equal(got["a"][order], pdf["a"])  # NaN == NaN
    assert list(got["s"][order]) == ["x", None, "y", None]
    # pandas 3 infers a string dtype for str/None object columns, whose
    # missing value is NaN: the nulls stay nulls, under pandas' own marker
    out = out.sort_values("b").reset_index(drop=True)
    assert list(out["s"].isna()) == [False, True, False, True]
    assert list(out["s"].dropna()) == ["x", "y"]
    assert "__m_a" in raw and "__m_s" in raw and "__m_b" not in raw
    assert raw["b"].dtype == np.int32              # no float widening


# ---------------------------------------------------------------------- #
# Plans over ingested tables: EXPLAIN, stats, results against the JAX
# package (1 rank each; the 8-rank case is below)
# ---------------------------------------------------------------------- #
@pytest.fixture
def envs():
    import repro.df as jdf
    import repro_torch.df as tdf
    from repro.core import CylonEnv as JEnv
    from repro_torch.core import CylonEnv as TEnv
    j, t = JEnv(), TEnv(1, device="cpu")
    jdf.set_default_env(j)
    tdf.set_default_env(t)
    yield j, t
    jdf.reset_default_env()
    tdf.reset_default_env()


def _pipeline(rdf, paths, dim_path):
    facts = rdf.read_parquet(paths, name="facts",
                             dict_cache=_cache(rdf))
    dim = rdf.read_parquet(dim_path, name="dim", dict_cache=_cache(rdf))
    return (facts.merge(dim, on="k", out_capacity=512)
            .groupby("k").agg({"v": ["sum", "count"], "w": "max"})
            .sort_values("k"))


def _cache(rdf):
    import importlib
    pkg = rdf.__name__.split(".")[0]
    return importlib.import_module(f"{pkg}.io").DictionaryCache()


def _same_records(got, want):
    g = [(r.label, r.rows, r.bytes, r.dropped, r.per_rank_rows, r.segment)
         for r in got.shuffle_records]
    w = [(r.label, r.rows, r.bytes, r.dropped, r.per_rank_rows, r.segment)
         for r in want.shuffle_records]
    assert g == w


def _same_cols(got, want):
    assert sorted(got) == sorted(want)
    for c in want:
        g, w = np.asarray(got[c]), np.asarray(want[c])
        assert g.dtype == w.dtype, c
        np.testing.assert_array_equal(g, w, err_msg=c)


def test_parquet_pipeline_matches_reference(envs, tmp_path):
    import repro.df as jdf
    import repro_torch.df as tdf
    paths = _pq_dataset(tmp_path, nfiles=2, rows=24)
    _write_parquet(tmp_path / "dim.parquet",
                   {"k": [f"key{i:02d}" for i in range(8)] + [None],
                    "w": [float(i) for i in range(8)] + [None]})
    dim = str(tmp_path / "dim.parquet")
    jq, tq = _pipeline(jdf, paths, dim), _pipeline(tdf, paths, dim)
    text = tq.explain()
    assert text == jq.explain()
    assert "scan[parquet: 2 files, ~48 rows]" in text
    assert "scan[parquet: 1 file, ~9 rows]" in text
    nbytes = sum(os.path.getsize(p) for p in paths + [dim])
    for mode in ("bsp", "bsp_staged", "amt"):
        want, wst = jq.collect(mode=mode, collect_stats=True,
                               adaptive=False)
        got, gst = tq.collect(mode=mode, collect_stats=True)
        assert (gst.rows_read, gst.bytes_read) == \
            (wst.rows_read, wst.bytes_read) == (48 + 9, nbytes)
        assert gst.rows_dropped == 0
        _same_records(gst, wst)
        _same_cols(got.to_numpy(nulls="mask"), want.to_numpy(nulls="mask"))
    # out-of-core: keys, counts and maxima exact; sums of integer-valued
    # floats exact in any order
    want, wst = jq.collect(morsel_rows=8, collect_stats=True,
                           adaptive=False)
    got, gst = tq.collect(morsel_rows=8, collect_stats=True)
    assert gst.morsels == wst.morsels > 1
    assert (gst.rows_read, gst.bytes_read) == (wst.rows_read, wst.bytes_read)
    _same_records(gst, wst)
    _same_cols(got.to_numpy(nulls="mask"), want.to_numpy(nulls="mask"))


def test_ingested_scan_capacity(envs, tmp_path):
    # in-core, an ingested scan gets 2x a balanced share per rank, or
    # scan_capacity; either way the rows and the result are the same
    import repro_torch.df as tdf
    from repro_torch.core import CylonEnv
    paths = _pq_dataset(tmp_path, nfiles=2, rows=24)
    env = CylonEnv(4, device="cpu")
    df = tdf.read_parquet(paths, env=env, columns=["i", "n"],
                          dict_cache=_cache(tdf))
    q = df.groupby("n").agg(i="sum").sort_values("n")
    a = q.collect()
    b = q.collect(scan_capacity=24)
    assert a.capacity != b.capacity or a.capacity == 24
    _same_cols(a.to_numpy(nulls="mask"), b.to_numpy(nulls="mask"))
    with pytest.raises(ValueError, match="exceeds capacity"):
        q.collect(scan_capacity=8)


def test_explain_analyze_reports_scan_stage(envs, tmp_path):
    import repro.df as jdf
    import repro_torch.df as tdf
    from repro_torch.launch.roofline import DEVICE_PEAKS
    paths = _pq_dataset(tmp_path)
    jf = jdf.read_parquet(paths, dict_cache=_cache(jdf), name="f")
    tf = tdf.read_parquet(paths, dict_cache=_cache(tdf), name="f")
    jq = jf.dropna(subset=["k"]).groupby("k").agg({"v": "sum"})
    tq = tf.dropna(subset=["k"]).groupby("k").agg({"v": "sum"})
    text = tq.explain_analyze(peaks=DEVICE_PEAKS[H100])
    ref = jq.explain_analyze(adaptive=False)
    assert "stage scan: ingested 60 rows" in text
    assert _mask_times(text.split("\n\n")[0]) == \
        _mask_times(ref.split("\n\n")[0])
    # without peaks the CPU has no roofline: the table refuses, naming it
    with pytest.raises(ValueError, match="'cpu'"):
        tq.explain_analyze()


def _mask_times(text):
    import re
    text = re.sub(r"wall=[0-9.]+s", "wall=?", text)
    return re.sub(r"[0-9]+\.[0-9]{4}s", "?s", text)


# ---------------------------------------------------------------------- #
# Package boundary
# ---------------------------------------------------------------------- #
def test_io_and_obs_import_no_jax_or_repro(tmp_path):
    _pq_dataset(tmp_path, nfiles=2)
    code = (
        "import sys\n"
        "import repro_torch.io as io, repro_torch.obs as obs\n"
        "import repro_torch.df as rdf\n"
        "from repro_torch.launch.roofline import DEVICE_PEAKS\n"
        f"src = {str(tmp_path / '*.parquet')!r}\n"
        "with rdf.session(parallelism=2, device='cpu'):\n"
        "    df = rdf.read_parquet(src)\n"
        "    q = df.groupby('k').agg(v='sum')\n"
        "    out, rep = q.collect(analyze=True, mode='bsp_staged',\n"
        "        peaks=DEVICE_PEAKS['NVIDIA H100 80GB HBM3'])\n"
        "    rep.roofline_table()\n"
        "assert obs.last_trace() is rep.trace\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ,
                                   PYTHONPATH=os.path.abspath(SRC)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


# ---------------------------------------------------------------------- #
# 8 ranks: tests/md_scripts/ingest_parity.py, scaled down
# ---------------------------------------------------------------------- #
P8 = 8
N8, NFILES8, NK8 = 1600, 4, 120


def _ingest_data():
    """``ingest_parity.py``'s recipe at ``N8`` rows: each later file draws
    from an earlier slice of the key space (the dictionary grows and
    recode fires), 10% nulls in keys and values; integer-valued floats."""
    rng = np.random.default_rng(23)
    keys = [f"key{i:04d}" for i in range(NK8)]

    def cell(pool):
        return str(rng.choice(pool)) if rng.random() > 0.1 else None

    def val():
        return float(rng.integers(0, 256)) if rng.random() > 0.1 else None

    facts = []
    for f in range(NFILES8):
        n = N8 // NFILES8
        pool = keys[NK8 - (f + 1) * (NK8 // NFILES8):]
        facts.append({"k": [cell(pool) for _ in range(n)],
                      "v0": [val() for _ in range(n)]})
    dim = {"k": keys + [None],
           "w": [float(i) if i % 7 else None for i in range(NK8)] + [3.0]}
    return keys, facts, dim


def _ingest_files(d):
    _, facts, dim = _ingest_data()
    paths = []
    for f, cols in enumerate(facts):
        p = os.path.join(d, f"facts{f}.parquet")
        if not os.path.exists(p):
            _write_parquet(p, cols)
        paths.append(p)
    dim_path = os.path.join(d, "dim.parquet")
    if not os.path.exists(dim_path):
        _write_parquet(dim_path, dim)
    return paths, dim_path


def _ingest_pipeline(rdf, col, facts, dim, pivot):
    jkw = dict(out_capacity=4096, bucket_capacity=2048,
               shuffle_out_capacity=2048)
    return (facts.merge(dim, on="k", **jkw)
            [(col("v0") > 4) & (col("k") < pivot)]
            .groupby("k").agg({"v0": ["sum", "count"], "w": "max"})
            .sort_values("k"))


MORSEL8 = (N8 // P8) // 8


def _run8(rdf, col, env, d, jax_kw):
    """Both packages' side of the 8-rank case; returns numpy arrays."""
    import importlib
    pkg = rdf.__name__.split(".")[0]
    io = importlib.import_module(f"{pkg}.io")
    keys, _, _ = _ingest_data()
    paths, dim_path = _ingest_files(d)
    cache = io.DictionaryCache()
    rdf.set_default_env(env)
    try:
        facts = rdf.read_parquet(paths, dict_cache=cache, name="facts")
        dim = rdf.read_parquet(dim_path, dict_cache=cache, name="dim")
        info = facts.sources["facts"].provenance
        pipe = _ingest_pipeline(rdf, col, facts, dim, keys[NK8 // 2])
        out = {"explain": np.array(pipe.explain()),
               "info": np.array([info.rows, info.batches, info.recodes,
                                 info.bytes_read, int(info.dict_cache_hit)])}
        for mode in ("bsp", "bsp_staged"):
            res, st = pipe.collect(mode=mode, collect_stats=True, **jax_kw)
            for c, a in res.to_numpy(nulls="mask").items():
                out[f"{mode}/{c}"] = a
            out[f"{mode}/stats"] = np.array(
                [st.rows_read, st.bytes_read, st.rows_shuffled,
                 st.bytes_shuffled, st.rows_dropped])
        sp, st = pipe.collect(morsel_rows=MORSEL8, collect_stats=True,
                              capacity_factor=16.0, **jax_kw)
        for c, a in sp.to_numpy(nulls="mask").items():
            out[f"ooc/{c}"] = a
        out["ooc/stats"] = np.array([st.rows_read, st.bytes_read,
                                     st.rows_shuffled, st.rows_dropped,
                                     st.morsels])
        facts2 = rdf.read_parquet(paths, dict_cache=cache, name="facts2")
        info2 = facts2.sources["facts2"].provenance
        out["info2"] = np.array([info2.recodes, int(info2.dict_cache_hit)])
        raw = facts2.sources["facts2"].to_numpy(decode=False, nulls="mask")
        for c, a in raw.items():
            out[f"raw/{c}"] = a
        _, report = pipe.collect(mode="bsp_staged", analyze=True,
                                 trace=False, **jax_kw)
        out["analyze"] = np.array(_mask_times(report.explain_analyze()))
        out["stage_rows"] = np.array([
            (r["stage"], r["rows_shuffled"], r["wire_bytes"])
            for r in _stage_rows(report)])
    finally:
        rdf.reset_default_env()
    return out


def _stage_rows(report):
    from repro_torch.launch.roofline import DEVICE_PEAKS
    if "repro_torch" in type(report).__module__:
        from repro_torch.obs.analyze import stage_table
        return stage_table(report.pplan, report.stats, DEVICE_PEAKS[H100])
    return report.stage_table()


def _reference_main(d):
    import repro.df as rdf
    from repro.core import CylonEnv
    from repro.expr import col
    env = CylonEnv()
    assert env.parallelism == P8, env.parallelism
    out = _run8(rdf, col, env, d, dict(adaptive=False))
    np.savez(os.path.join(d, "ref.npz"), **out)


@pytest.fixture(scope="module")
def reference8(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ingest8"))
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), d],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return d, dict(np.load(os.path.join(d, "ref.npz")))


def test_ingest_pipeline_eight_ranks_matches_reference(reference8):
    import repro_torch.df as tdf
    from repro_torch.core import CylonEnv
    from repro_torch.expr import col
    d, want = reference8
    got = _run8(tdf, col, CylonEnv(P8, device="cpu"), d, {})
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    info = want["info"]
    assert info[0] == N8 and info[2] > 0 and info[4] == 0
    assert list(want["info2"]) == [0, 1]       # cache hit, no recodes
    assert want["ooc/stats"][3] == 0 and want["ooc/stats"][4] >= 8
    # out-of-core is the in-core result, bit for bit
    for c in [k.split("/", 1)[1] for k in want if k.startswith("bsp/")]:
        if c != "stats":
            np.testing.assert_array_equal(want[f"ooc/{c}"],
                                          want[f"bsp/{c}"], err_msg=c)


if __name__ == "__main__":
    _reference_main(sys.argv[1])
