"""Out-of-core morsels, file ingest and fault recovery over a process
group, held to the stacked port run and to the JAX package's 4-device run.

One module fixture spawns one gloo group of 4 CPU processes (this file
run as a script, ``group`` mode; ``file://`` rendezvous, one CPU thread
a process) and runs every case in it.  Each process holds one rank and is
given the whole input — a host dict, a spill, or the same list of files —
as ``DistTable.from_numpy`` over a group is.  Beside it, one subprocess
with 4 JAX host devices (``XLA_FLAGS`` set before jax is imported) runs
the reference's side of the cases it has, and the pytest process runs
every case over 4 ranks stacked on the CPU.

The cases, at 2 x 8,192 rows and ``morsel_rows`` 256 (each rank's 2,048
rows stream in 8 morsels):

* Fig-9 out-of-core (``bsp``, optimized) through ``execute`` and through
  ``repro_torch.df``;
* an under-capacitated in-core join that the ``degrade`` policy streams
  out-of-core and scatters back;
* a sort-only plan (splitters pooled from every rank) over Zipf keys;
* a Zipf-skewed groupby with ``adaptive=True`` from a spill over the
  group (the hot key salted, the partials re-routed to their home ranks
  through the communicator);
* Parquet and CSV ingest (both CSV lanes) of string keys and values with
  10% nulls, later files adding keys: each process's rows, the
  dictionaries and the ``IngestInfo`` counts, then a groupby + sort of
  the files in-core and out-of-core; and one file read in two batches
  (fewer than the processes; the Parquet batches cross row groups);
* a ``raise`` at ``spill:append`` and at ``build:resident`` on every
  process, a ``raise`` on one process alone, ``random_plan`` seeds 1-3
  over the out-of-core sites, and a ``hang`` under ``timeout=``.

Each process's result is rank r of the stacked run exactly: keys,
integer columns, integer-valued float sums (exact in any order), row
placement and drop counts; the stacked run is held to the JAX package's
rank for rank the same way, in every case but the faults.  A recovered run is bit-identical to the
fault-free one and ``ExecStats.retries`` is equal on every process; the
hang raises ``QueryTimeout`` on every process and the group goes on to
its last collective.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \\
        tests/test_torch_pg_out_of_core.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
sys.path.insert(0, HERE)

from strategies import zipf_table  # noqa: E402

P = 4
ROWS = 8192
MORSEL = 256
CF = 4.0
CAP = -(-(ROWS // P + ROWS // P // 8) // 8) * 8     # share + 1/8
OOC_SITES = ("segment:launch", "morsel:compile", "morsel:execute",
             "transfer:h2d", "transfer:d2h", "spill:append",
             "spill:combine", "build:resident")
FAULTS = {"spill_append": "spill:append@1=raise",
          "build_resident": "build:resident@0=raise"}
SEEDS = (1, 2, 3)
FEW = 1500          # a file's 2,048 rows in two batches
#: ExecStats fields each process shares with the stacked run
SHARED = ("rows_shuffled", "bytes_shuffled", "rows_dropped", "morsels",
          "morsel_rows", "dispatches", "degraded", "spill_bytes",
          "d2h_bytes", "rows_read", "bytes_read", "salted_shuffles",
          "splitter_refreshes", "autotune_steps")


# ---------------------------------------------------------------------- #
# Inputs
# ---------------------------------------------------------------------- #
def _exact(rows, seed, payload):
    """Uniform int32 keys at 90% cardinality, an integer-valued float32
    payload (``tests/md_scripts/out_of_core_parity.py``'s recipe)."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, int(rows * 0.9), rows).astype(np.int32),
            payload: rng.integers(0, 100, rows).astype(np.float32)}


def _zipf(seed):
    return zipf_table(np.random.default_rng(seed), ROWS, a=3.0)


def _file_tables(nfiles=4, rows=2048, nk=300):
    """String keys (``key%04d``, later files adding keys) and values with
    10% nulls, an int column without."""
    rng = np.random.default_rng(29)
    out = []
    for f in range(nfiles):
        hi = nk * (f + 2) // (nfiles + 1)
        keys = np.array([f"key{i:04d}" for i in rng.integers(0, hi, rows)],
                        dtype=object)
        v = rng.integers(0, 50, rows).astype(np.float64)
        keys[rng.random(rows) < 0.1] = None
        v[rng.random(rows) < 0.1] = np.nan
        out.append({"s": keys, "v": v,
                    "i": rng.integers(0, 1000, rows).astype(np.int64)})
    return out


def _write_files(d):
    import pyarrow as pa
    import pyarrow.parquet as pq
    import pandas as pd
    for f, t in enumerate(_file_tables()):
        pq.write_table(pa.table({"s": pa.array(list(t["s"]), pa.string()),
                                 "v": pa.array(t["v"], from_pandas=True),
                                 "i": pa.array(t["i"])}),
                       os.path.join(d, f"part{f}.parquet"),
                       row_group_size=1000)
        pd.DataFrame(t).to_csv(os.path.join(d, f"part{f}.csv"), index=False)


def _files(d, ext):
    return [os.path.join(d, f"part{f}.{ext}") for f in range(4)]


def fig9_plan(Plan):
    return (Plan.scan("l").join(Plan.scan("r"), on="k", out_capacity=CAP * 4)
            .groupby(["k"], {"v0": ["sum"]}).sort(["k"])
            .add_scalar(1.0, cols=["v0_sum"]))


def _sort_plan(Plan):
    return Plan.scan("t").sort(["k"])


def _skew_plan(Plan):
    return (Plan.scan("t").groupby(["k"], {"v": ["sum", "count"]},
                                   pre_aggregate=False).sort(["k"]))


def _files_query(f):
    return (f.groupby("s").agg({"v": ["sum", "count"], "i": ["max"]})
            .sort_values("s"))


def _df_query(rdf, col, ld, rd):
    l = rdf.read_numpy(ld, spill=True)
    r = rdf.read_numpy(rd, capacity=CAP)
    return (l.merge(r, on="k", out_capacity=CAP * 4).groupby("k")
            .agg({"v0": ["sum", "mean"]}).sort_values("k")
            .assign(v0_sum=col("v0_sum") + 1.0))


def _degrade_inputs():
    return ({"k": np.zeros(32, np.int32),
             "v0": np.arange(32, dtype=np.float32)},
            {"k": np.zeros(32, np.int32),
             "w": np.arange(32, dtype=np.float32)})


def _degrade_plan(Plan):
    return Plan.scan("l").join(Plan.scan("r"), on="k", out_capacity=64)


# ---------------------------------------------------------------------- #
# Recording results rank by rank
# ---------------------------------------------------------------------- #
def _spill_out(out, key, spill):
    """Rank r's rows of a spill (raw codes and masks) under
    ``key/r/column``; its dictionaries under ``key/dicts``."""
    for j, r in enumerate(spill.held()):
        for c, v in spill.rank_concat(j).items():
            out[f"{key}/{r}/{c}"] = np.asarray(v)
    out[f"{key}/dicts"] = np.array(json.dumps(
        {c: list(d) for c, d in sorted(spill.dictionaries.items())}))


def _dist_out(out, key, dt, p=P):
    """Rank r's row count and every slot of a port ``DistTable``."""
    held = dt.comm.rank().tolist() if dt.comm is not None else range(p)
    counts = dt.row_counts.cpu().numpy()
    for j, r in enumerate(held):
        out[f"{key}/{r}/__count"] = np.array(counts[j])
        for c, v in dt.columns.items():
            out[f"{key}/{r}/{c}"] = v[j].cpu().numpy()


def _stats_out(out, key, st):
    d = {k: getattr(st, k) for k in SHARED}
    d["records"] = [[r.label, r.rows, r.bytes, r.dropped,
                     list(r.per_rank_rows), list(r.per_rank_dropped)]
                    for r in st.shuffle_records]
    for k in ("retries", "faults_injected", "h2d_bytes"):
        d[k] = getattr(st, k)
    out[f"{key}/stats"] = np.array(json.dumps(d))


def _ingest_out(out, key, spill):
    _spill_out(out, key, spill)
    prov = spill.provenance
    out[f"{key}/info"] = np.array(json.dumps(
        [prov.rows, prov.batches, prov.bytes_read, prov.recodes,
         prov.dict_cache_hit]))


# ---------------------------------------------------------------------- #
# The port's side: every case, on a stacked env or over the group
# ---------------------------------------------------------------------- #
def _port_cases(env, files_dir, with_faults):
    """Every case on ``env`` (4 stacked ranks, or one rank of a group of
    4): a flat dict of each held rank's results."""
    import repro_torch.df as rdf
    from repro_torch.core import Plan, SpillTable, execute
    from repro_torch.expr import col
    from repro_torch.faults import random_plan
    from repro_torch.io import DictionaryCache, read_csv, read_parquet
    group = env.comm if env.ranks_held < env.parallelism else None
    out = {}
    ld, rd = _exact(ROWS, 0, "v0"), _exact(ROWS, 1, "w")
    tables = {"l": ld, "r": env.from_numpy(rd, capacity=CAP)}

    def ooc(**kw):
        return execute(fig9_plan(Plan), env, tables, morsel_rows=MORSEL,
                       capacity_factor=CF, collect_stats=True, **kw)
    spill, st = ooc()
    _spill_out(out, "ooc", spill)
    _stats_out(out, "ooc", st)

    with rdf.session(env=env):
        res, st = _df_query(rdf, col, ld, rd).collect(
            morsel_rows=MORSEL, capacity_factor=CF, collect_stats=True)
    _spill_out(out, "df", res)
    _stats_out(out, "df", st)

    dl, dr = _degrade_inputs()
    res, st = execute(_degrade_plan(Plan), env,
                      {"l": env.from_numpy(dl), "r": env.from_numpy(dr)},
                      optimize=False, collect_stats=True)
    _dist_out(out, "degrade", res)
    _stats_out(out, "degrade", st)

    res, st = execute(_sort_plan(Plan), env, {"t": _zipf(3)},
                      morsel_rows=MORSEL, capacity_factor=CF,
                      collect_stats=True)
    _spill_out(out, "sort", res)
    _stats_out(out, "sort", st)

    skew = SpillTable.from_numpy(_zipf(5), P, chunk_rows=1000, comm=group)
    res, st = execute(_skew_plan(Plan), env, {"t": skew}, optimize=False,
                      morsel_rows=MORSEL, capacity_factor=CF,
                      collect_stats=True, adaptive=True)
    _spill_out(out, "skew", res)
    _stats_out(out, "skew", st)

    cache = DictionaryCache()
    pq = _files(files_dir, "parquet")
    _ingest_out(out, "parquet", read_parquet(pq, P, batch_rows=500,
                                             dict_cache=cache, comm=group))
    _ingest_out(out, "parquet_again", read_parquet(
        pq, P, batch_rows=500, dict_cache=cache, comm=group))
    _ingest_out(out, "csv", read_csv(_files(files_dir, "csv"), P,
                                     block_bytes=16 << 10, dict_cache=None,
                                     comm=group))
    os.environ["REPRO_NO_PYARROW"] = "1"
    try:
        _ingest_out(out, "csv_python", read_csv(
            _files(files_dir, "csv"), P, batch_rows=700, dict_cache=None,
            comm=group))
    finally:
        del os.environ["REPRO_NO_PYARROW"]
    # one file in two batches: processes 2 and 3 keep none
    _ingest_out(out, "parquet_few", read_parquet(
        pq[:1], P, batch_rows=FEW, dict_cache=None, comm=group))
    os.environ["REPRO_NO_PYARROW"] = "1"
    try:
        _ingest_out(out, "csv_few", read_csv(
            _files(files_dir, "csv")[:1], P, batch_rows=FEW,
            dict_cache=None, comm=group))
    finally:
        del os.environ["REPRO_NO_PYARROW"]
    with rdf.session(env=env):
        f = rdf.read_parquet(pq, batch_rows=500, name="f",
                             dict_cache=None)
        q = _files_query(f)
        res, st = q.collect(collect_stats=True)
        _dist_out(out, "files_in_core", res)
        _stats_out(out, "files_in_core", st)
        res, st = q.collect(morsel_rows=MORSEL, collect_stats=True)
        _spill_out(out, "files_ooc", res)
        _stats_out(out, "files_ooc", st)

    if not with_faults:
        return out
    for name, plan in FAULTS.items():
        spill, st = ooc(faults=plan)
        _spill_out(out, f"fault/{name}", spill)
        _stats_out(out, f"fault/{name}", st)
    me = int(env.comm.rank()[0]) if group is not None else None
    # one process alone faults (rank 1): the others replay with it
    spill, st = ooc(faults="morsel:execute@2=raise" if me == 1 else None)
    _spill_out(out, "fault/alone", spill)
    _stats_out(out, "fault/alone", st)
    for seed in SEEDS:
        spill, st = ooc(faults=random_plan(seed, sites=OOC_SITES))
        _spill_out(out, f"fault/seed{seed}", spill)
        _stats_out(out, f"fault/seed{seed}", st)
    return out


def _hang_case(env):
    """A hang under ``timeout=``: the exception each process raised, its
    seconds, then one more collective (the group is not left blocked)."""
    import time
    from repro_torch.core import Plan, execute
    from repro_torch.faults import QueryTimeout
    ld, rd = _exact(ROWS, 0, "v0"), _exact(ROWS, 1, "w")
    tables = {"l": ld, "r": env.from_numpy(rd, capacity=CAP)}
    t = time.perf_counter()
    try:
        execute(fig9_plan(Plan), env, tables, morsel_rows=MORSEL,
                capacity_factor=CF, faults="morsel:execute@1=hang",
                timeout=2.0)
        raised = "none"
    except QueryTimeout:
        raised = "QueryTimeout"
    wall = time.perf_counter() - t
    res, _ = execute(_degrade_plan(Plan), env,
                     {n: env.from_numpy(d) for n, d in
                      zip("lr", _degrade_inputs())}, optimize=False,
                     collect_stats=True)
    return {"hang/raised": np.array(raised), "hang/wall": np.array(wall),
            "hang/after": np.array(res.total_rows())}


def _group_child(rank, world, d, files_dir):
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        from repro_torch.comm.process_group import barrier_before_teardown
        from repro_torch.core import CylonEnv
        env = CylonEnv(process_group=dist.group.WORLD, device="cpu")
        out = _port_cases(env, files_dir, with_faults=True)
        out.update(_hang_case(env))
        np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
        barrier_before_teardown()
    finally:
        dist.destroy_process_group()


def _group_main(world, d, files_dir):
    import torch.multiprocessing as mp
    mp.start_processes(_group_child, args=(world, d, files_dir),
                       nprocs=world, start_method="spawn")


# ---------------------------------------------------------------------- #
# The JAX package's side (4 host devices)
# ---------------------------------------------------------------------- #
def _reference_main(path, files_dir):
    import jax
    import repro.df as rdf
    from repro.core import CylonEnv, DistTable, Plan, SpillTable, execute
    from repro.expr import col
    from repro.io import DictionaryCache, read_csv, read_parquet
    assert len(jax.devices()) == P
    env = CylonEnv()
    out = {}

    def dist_out(key, dt):
        counts = np.asarray(dt.row_counts)
        for r in range(P):
            out[f"{key}/{r}/__count"] = np.array(counts[r])
            for c, v in dt.columns.items():
                v = np.asarray(v).reshape((P, dt.capacity) + v.shape[1:])
                out[f"{key}/{r}/{c}"] = v[r]

    ld, rd = _exact(ROWS, 0, "v0"), _exact(ROWS, 1, "w")
    spill = execute(fig9_plan(Plan), env,
                    {"l": ld, "r": DistTable.from_numpy(rd, P, CAP)},
                    morsel_rows=MORSEL, capacity_factor=CF)
    _spill_out(out, "ooc", _Held(spill))
    with rdf.session(env=env):
        _spill_out(out, "df", _Held(_df_query(rdf, col, ld, rd).collect(
            morsel_rows=MORSEL, capacity_factor=CF)))
    dl, dr = _degrade_inputs()
    dist_out("degrade", execute(_degrade_plan(Plan), env, {
        "l": DistTable.from_numpy(dl, P), "r": DistTable.from_numpy(dr, P)},
        optimize=False, collect_stats=True)[0])
    _spill_out(out, "sort", _Held(execute(
        _sort_plan(Plan), env, {"t": _zipf(3)}, morsel_rows=MORSEL,
        capacity_factor=CF)))
    _spill_out(out, "skew", _Held(execute(
        _skew_plan(Plan), env,
        {"t": SpillTable.from_numpy(_zipf(5), P, chunk_rows=1000)},
        optimize=False, morsel_rows=MORSEL, capacity_factor=CF,
        adaptive=True)))
    pq, csv = _files(files_dir, "parquet"), _files(files_dir, "csv")
    cache = DictionaryCache()
    _spill_out(out, "parquet", _Held(read_parquet(
        pq, P, batch_rows=500, dict_cache=cache)))
    _spill_out(out, "parquet_again", _Held(read_parquet(
        pq, P, batch_rows=500, dict_cache=cache)))
    _spill_out(out, "parquet_few", _Held(read_parquet(
        pq[:1], P, batch_rows=FEW, dict_cache=None)))
    _spill_out(out, "csv", _Held(read_csv(
        csv, P, block_bytes=16 << 10, dict_cache=None)))
    os.environ["REPRO_NO_PYARROW"] = "1"
    try:
        _spill_out(out, "csv_python", _Held(read_csv(
            csv, P, batch_rows=700, dict_cache=None)))
        _spill_out(out, "csv_few", _Held(read_csv(
            csv[:1], P, batch_rows=FEW, dict_cache=None)))
    finally:
        del os.environ["REPRO_NO_PYARROW"]
    with rdf.session(env=env):
        q = _files_query(rdf.read_parquet(pq, batch_rows=500, name="f",
                                          dict_cache=None))
        dist_out("files_in_core", q.collect())
        _spill_out(out, "files_ooc", _Held(q.collect(morsel_rows=MORSEL)))
    np.savez(path, **out)


class _Held:
    """A JAX ``SpillTable`` seen as ``_spill_out`` reads a port one."""

    def __init__(self, spill):
        self._s = spill
        self.dictionaries = spill.dictionaries

    def held(self):
        return list(range(self._s.parallelism))

    def rank_concat(self, r):
        return self._s.rank_concat(r)


# ---------------------------------------------------------------------- #
# Fixtures
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the group of 4 and the JAX side at once; returns
    (group process, its directory, JAX process, its output, files)."""
    files = str(tmp_path_factory.mktemp("pg_files"))
    _write_files(files)
    gdir = str(tmp_path_factory.mktemp("pg_group"))
    ref = str(tmp_path_factory.mktemp("pg_ref") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(SRC), HERE]), JAX_PLATFORMS="cpu")
    env.pop("REPRO_NO_PYARROW", None)
    group = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "group", str(P), gdir,
         files], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env)
    jax = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "ref", ref, files],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    yield group, gdir, jax, ref, files
    for proc in (group, jax):
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def stacked(runs):
    """Every case over 4 ranks stacked on the CPU (while the group and
    the JAX side run)."""
    from repro_torch.core import CylonEnv
    return _port_cases(CylonEnv(P, device="cpu"), runs[4], with_faults=True)


@pytest.fixture(scope="module")
def ranks(runs, stacked):
    group, gdir = runs[0], runs[1]
    log = group.communicate(timeout=600)[0]
    assert group.returncode == 0, log[-4000:]
    return [dict(np.load(os.path.join(gdir, f"rank{r}.npz")))
            for r in range(P)]


@pytest.fixture(scope="module")
def reference(runs, stacked):
    jax, path = runs[2], runs[3]
    log = jax.communicate(timeout=600)[0]
    assert jax.returncode == 0, log[-4000:]
    return dict(np.load(path))


def _rank_keys(res, key, r):
    pre = f"{key}/{r}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _same_rank(got, want, key, r):
    g, w = _rank_keys(got, key, r), _rank_keys(want, key, r)
    assert sorted(g) == sorted(w) and w, (key, r, sorted(g), sorted(w))
    for c in w:
        assert g[c].dtype == w[c].dtype, (key, r, c)
        np.testing.assert_array_equal(g[c], w[c], err_msg=f"{key} {r} {c}")


def _stats(res, key):
    return json.loads(str(res[f"{key}/stats"]))


# ---------------------------------------------------------------------- #
# Tests
# ---------------------------------------------------------------------- #
CASES = ("ooc", "df", "degrade", "sort", "skew", "parquet", "parquet_again",
         "parquet_few", "csv", "csv_python", "csv_few", "files_in_core",
         "files_ooc")


@pytest.mark.parametrize("case", CASES)
def test_each_process_holds_stacked_rank(ranks, stacked, case):
    # rows, slots, row counts and dictionaries: rank r of the stacked run
    for r, got in enumerate(ranks):
        _same_rank(got, stacked, case, r)
        if f"{case}/dicts" in stacked:
            assert str(got[f"{case}/dicts"]) == str(stacked[f"{case}/dicts"])


@pytest.mark.parametrize("case", CASES)
def test_stacked_run_matches_jax(reference, stacked, case):
    for r in range(P):
        _same_rank(stacked, reference, case, r)
    if f"{case}/dicts" in reference:
        assert str(stacked[f"{case}/dicts"]) == \
            str(reference[f"{case}/dicts"])


@pytest.mark.parametrize("case", [c for c in CASES
                                  if not c.startswith(("parquet", "csv"))])
def test_stats_equal_the_stacked_run(ranks, stacked, case):
    want = _stats(stacked, case)
    assert want["rows_dropped"] == 0
    for got in ranks:
        g = _stats(got, case)
        assert {k: g[k] for k in SHARED + ("records",)} == \
            {k: want[k] for k in SHARED + ("records",)}
        # each process uploads the sort's p - 1 splitters itself
        sorts = sum(rec[0].startswith("sort(") for rec in want["records"])
        assert g["h2d_bytes"] - want["h2d_bytes"] == \
            (P - 1) * (P - 1) * 4 * sorts * (want["morsel_rows"] is not None)


def test_degrade_streamed_and_salting_fired(stacked):
    assert _stats(stacked, "degrade")["degraded"] > 0
    assert _stats(stacked, "skew")["salted_shuffles"] == 1
    assert _stats(stacked, "files_ooc")["morsels"] >= 3


@pytest.mark.parametrize("case", ("parquet", "parquet_again", "parquet_few",
                                  "csv", "csv_python", "csv_few"))
def test_ingest_counts_are_the_groups(ranks, stacked, case):
    rows, batches, nbytes, recodes, hit = json.loads(
        str(stacked[f"{case}/info"]))
    few = case.endswith("_few")
    assert rows == (1 if few else 4) * 2048
    assert batches < P if few else batches > P
    for got in ranks:
        g = json.loads(str(got[f"{case}/info"]))
        assert g[:3] == [rows, batches, nbytes] and g[4] == hit
        if case == "parquet_again":
            # every process starts from the cached final dictionaries
            assert hit and g[3] == recodes == 0
        elif not few:
            assert g[3] > 0 and recodes > 0


@pytest.mark.parametrize("name", sorted(FAULTS) + ["alone"]
                         + [f"seed{s}" for s in SEEDS])
def test_recovered_run_bit_identical(ranks, stacked, name):
    key = f"fault/{name}"
    for r, got in enumerate(ranks):
        _same_rank(got, stacked, key, r)
        _same_rank(got, got, "ooc", r)
        g, w = _rank_keys(got, key, r), _rank_keys(got, "ooc", r)
        for c in w:
            np.testing.assert_array_equal(g[c], w[c], err_msg=f"{key} {c}")
    retries = {_stats(got, key)["retries"] for got in ranks}
    assert len(retries) == 1, retries
    if name != "alone" and not name.startswith("seed"):
        assert retries == {1}
        assert _stats(ranks[0], key)["faults_injected"] == P
    if name == "alone":
        assert retries == {1}
        assert _stats(ranks[0], key)["faults_injected"] == 1


def test_hang_times_out_on_every_process(ranks):
    for got in ranks:
        assert str(got["hang/raised"]) == "QueryTimeout"
        assert 2.0 <= float(got["hang/wall"]) < 60
        assert int(got["hang/after"]) == 32 * 32


if __name__ == "__main__":
    if sys.argv[1] == "group":
        _group_main(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        _reference_main(sys.argv[2], sys.argv[3])
