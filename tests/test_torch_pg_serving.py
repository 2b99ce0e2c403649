"""Query serving over gangs of processes and the §IV-C ``CylonStore``
hand-off over a process group, held to the stacked port run and to the
JAX package's gang run.

One module fixture spawns one gloo group of 4 CPU processes (this file
run as a script, ``group`` mode; ``file://`` rendezvous, one CPU thread
a process) and runs every case in it; beside it, one subprocess with 4
JAX host devices runs the reference's side, and the pytest process runs
the stacked port gang.  Every process is given the whole input of each
query, as an SPMD program over the group is.

The cases, at 2 x 4,096 rows (integer-valued payloads):

* ``DevicePool(process_group=)``: lowest-first leases, ``PoolExhausted``,
  a re-carve to the same placement and the sub-group reused;
* the three query kinds of ``benchmarks/bench_pipeline.py::run_serving``
  (join + filter + groupby + sort, groupby sum / mean + sort, filter +
  sort) pre-warmed on both gangs of 2, then through ``QueryScheduler``
  serially and with ``max_inflight=2`` (each kind twice: the repeats
  build nothing), and through ``session(scheduler=)``;
* on a scheduler with ``max_inflight=1`` and ``max_queue=2``: a ``hang``
  under ``timeout=`` mid-flight (``QueryTimeout`` on both members, and
  the group goes on), a deadline that passes in the queue, a mid-queue
  cancel issued on process 2 alone, ``AdmissionRejected`` on every
  process at once, a failing query (an injected fault with no retry),
  and a query that one member alone fails after its last fault site
  (process 1, then the gang's rank 0): failed with that exception type
  on every process;
* ``DevicePool`` refuses a group other than the world, and a world
  destroyed and made again gets new gang groups (one process);
* the §IV-C pipeline: ``preprocess`` on a gang of 2, ``get`` at 4 and
  onto the other gang at 2, and the first batches of each;
* ``launch/train.py --smoke`` (2 steps) under the group, its
  preprocessing on a gang of 2 processes.

Each member's result is rank r of the stacked port gang: keys, integer
columns, integer-valued float sums (exact in any order), row placement
and row counts, every slot.  The stacked gang is held to the JAX
package's gang run rank for rank the same way.  Every process sees the
same admission outcome, gang and exception type of each submission.
The driver's batches equal the stacked driver's, its losses are within
``tests/test_torch_sharded_train.py``'s rtol 2e-3.

About 25 s in one worker (the group of 4 and the JAX side at once).

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q \\
        tests/test_torch_pg_serving.py
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")

P = 4
GANG = 2
ROWS = 4096
KINDS = ("filter", "groupby", "join")
CORPUS = dict(num_docs=1024, payload_tokens=16, vocab_size=1000,
              dup_rate=0.3, seed=7)
BATCH, SEQ, N_BATCHES = 4, 16, 2
TRAIN_ARGS = ["--arch", "llama3.2-3b", "--smoke", "--device", "cpu",
              "--steps", "2", "--batch", "4", "--seq", "32",
              "--data-parallelism", str(GANG)]


# ---------------------------------------------------------------------- #
# Inputs and queries (both packages)
# ---------------------------------------------------------------------- #
def _data(seed, payload):
    """``benchmarks/common.py::make_table_data(exact_values=True)``."""
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, int(ROWS * 0.9), ROWS).astype(np.int32),
            payload: rng.integers(0, 256, ROWS).astype(np.float32)}


def _queries(col, left, right, cap):
    jkw = dict(out_capacity=cap * 4, bucket_capacity=cap * 2,
               shuffle_out_capacity=cap * 2)
    return {
        "join": lambda: (left.merge(right, on="k", **jkw)
                         [(col("v0") > 4) & (col("w") < 250)]
                         .groupby("k").agg({"v0": ["sum"]})
                         .sort_values("k")),
        "groupby": lambda: (left.groupby("k").agg({"v0": ["sum", "mean"]})
                            .sort_values("k")),
        "filter": lambda: left[col("v0") > 64].sort_values("k"),
    }


def _port_queries(rdf, device="cpu"):
    from repro_torch.core import DistTable
    from repro_torch.expr import col
    lt = DistTable.from_numpy(_data(0, "v0"), GANG, device=device)
    rt = DistTable.from_numpy(_data(1, "w"), GANG, device=device)
    return _queries(col, rdf.from_table(lt, name="l"),
                    rdf.from_table(rt, name="r"), lt.capacity)


# ---------------------------------------------------------------------- #
# Recording results rank by rank
# ---------------------------------------------------------------------- #
def _rows(out, key, dt):
    """Each held rank's row count and every slot of a port ``DistTable``
    (a member's rank of its gang, or every stacked rank)."""
    held = dt.comm.rank().tolist() if dt.comm is not None else \
        range(dt.parallelism)
    counts = dt.row_counts.cpu().numpy()
    for j, r in enumerate(held):
        out[f"{key}/{r}/__count"] = np.array(counts[j])
        for c, v in dt.columns.items():
            out[f"{key}/{r}/{c}"] = v[j].cpu().numpy()


def _batches(out, key, table):
    from repro_torch.data import batches_from_table
    it = batches_from_table(table, BATCH, SEQ, seed=0)
    for i in range(N_BATCHES):
        for c, v in next(it).items():
            out[f"{key}/{i}/{c}"] = v


def _pipeline(out, ex, store, pool=None):
    """``preprocess`` on ``ex``'s gang, ``get`` at 4 and at 2 (onto
    ``pool``'s next gang over a group), the first batches of each."""
    from repro_torch.data import (CorpusConfig, preprocess, source_weights,
                                  synth_corpus)
    cfg = CorpusConfig(**CORPUS)
    comm = ex.env.comm if ex.is_member else None
    corpus = weights = None
    if ex.is_member:
        corpus = synth_corpus(cfg, GANG, device="cpu", comm=comm)
        weights = source_weights(cfg.num_sources, GANG, device="cpu",
                                 comm=comm)
    res = preprocess(ex, corpus, weights, store=store)
    if res is not None:
        _rows(out, "pipe/out", res)
    got4 = store.get("train_corpus", target_parallelism=P)
    _rows(out, "pipe/get4", got4)
    _batches(out, "pipe/batch4", got4)
    other = pool.reserve(GANG) if pool is not None else None
    got2 = store.get("train_corpus", target_parallelism=GANG,
                     lease=other) if other is not None else \
        store.get("train_corpus", target_parallelism=GANG)
    if got2 is not None:
        _rows(out, "pipe/get2", got2)
        _batches(out, "pipe/batch2", got2)
    if other is not None:
        other.release()
    return other.indices if other is not None else None


def _stacked_train():
    """The stacked driver (one process): its batches and losses."""
    from repro_torch.launch import train
    return _recording_train(train)


def _recording_train(train):
    seen = []
    orig = train.batches_from_table

    def record(*a, **kw):
        for b in orig(*a, **kw):
            seen.append(b)
            yield b
    train.batches_from_table = record
    try:
        losses = train.main(TRAIN_ARGS)
    finally:
        train.batches_from_table = orig
    out = {"train/losses": np.asarray(losses)}
    for i, b in enumerate(seen):
        for c, v in b.items():
            out[f"train/batch{i}/{c}"] = v
    return out


# ---------------------------------------------------------------------- #
# The group of 4
# ---------------------------------------------------------------------- #
class _FailsAfter:
    """A query whose member on world rank ``rank`` raises once the query
    has run, past its last fault site: the gang's other member ends done
    on its own."""

    def __init__(self, frame, rank):
        self.frame, self.rank = frame, rank

    def on_gang(self, comm):
        return _FailsAfter(self.frame.on_gang(comm), self.rank)

    def collect(self, **kw):
        import torch.distributed as dist
        res = self.frame.collect(**kw)
        if dist.get_rank() == self.rank:
            raise ArithmeticError(f"planted on process {self.rank}")
        return res


def _outcome(h):
    """(state, exception type, gang) of a handle, after it ends."""
    try:
        h.result(timeout=120)
        exc = None
    except BaseException as e:      # the outcome under test
        exc = type(e).__name__
    return [h.stats["state"], exc, h.stats.get("devices")]


def _group_cases(rank, d):
    import torch.distributed as dist
    import repro_torch.df as rdf
    from repro_torch.core import (CylonExecutor, CylonStore, DevicePool,
                                  PoolExhausted)
    from repro_torch.launch.fig9 import prewarm
    from repro_torch.serve import (AdmissionRejected, ProgramCache,
                                   QueryScheduler)
    out, log = {}, {}
    pool = DevicePool(process_group=dist.group.WORLD, device="cpu")
    a, b = pool.reserve(GANG), pool.reserve(GANG)
    try:
        pool.reserve(1)
        exhausted = False
    except PoolExhausted:
        exhausted = True
    first = a.group() if a.is_member else b.group()
    comm = (a if a.is_member else b).communicator()
    a.release()
    c = pool.reserve(GANG)
    mine = c if c.is_member else b
    log["pool"] = {"leases": [a.indices, b.indices], "exhausted": exhausted,
                   "recarved": c.indices,
                   "group_reused": mine.group() is first,
                   "comm_reused": mine.communicator() is comm}
    c.release()
    b.release()
    log["pool"]["available"] = pool.available

    queries = _port_queries(rdf)
    shared = ProgramCache(registry=False)
    for k, res in prewarm(pool, GANG, queries, shared).items():
        _rows(out, f"warm/{k}", res)
    warm = (len(shared), shared.misses)
    for inflight in (1, 2):
        sched = QueryScheduler(pool=pool, gang_size=GANG,
                               max_inflight=inflight, max_queue=16,
                               program_cache=shared, name=f"x{inflight}")
        names = [KINDS[i % 3] for i in range(6)]
        handles = [sched.submit(queries[n](), label=f"x{inflight}-{i}")
                   for i, n in enumerate(names)]
        recs = []
        for i, (n, h) in enumerate(zip(names, handles)):
            res = h.result(timeout=120)
            if res is not None:
                _rows(out, f"x{inflight}/{n}/{i // 3}", res)
            recs.append([n, h.stats["devices"], h.stats["state"],
                         h.stats["cache_misses"], res is None,
                         h.stats["started_monotonic"],
                         h.stats["finished_monotonic"]])
        sched.close()
        log[f"x{inflight}"] = {"handles": recs, "stats": {
            k: v for k, v in sched.stats().items()
            if k not in ("program_cache", "control")}}
    log["cache"] = [warm, [len(shared), shared.misses]]

    sched = QueryScheduler(pool=pool, gang_size=GANG, program_cache=shared,
                           name="session")
    with rdf.session(scheduler=sched):
        from repro_torch.expr import col
        l2 = rdf.read_numpy(_data(0, "v0"))
        r2 = rdf.read_numpy(_data(1, "w"))
        cap = next(iter(l2.sources.values())).capacity
        for n, q in _queries(col, l2, r2, cap).items():
            res = q().collect()
            if res is not None:
                _rows(out, f"session/{n}", res)
    sched.close()

    sched = QueryScheduler(pool=pool, gang_size=GANG, max_inflight=1,
                           max_queue=2, program_cache=shared, name="ctl")
    hang = sched.submit(queries["groupby"](), label="hang",
                        faults="stage:launch@0=hang", timeout=2.0)
    expires = sched.submit(queries["filter"](), label="expires",
                           timeout=0.3)
    cancelled = sched.submit(queries["join"](), label="cancelled")
    try:
        sched.submit(queries["filter"](), label="rejected")
        rejected = None
    except AdmissionRejected as e:
        rejected = type(e).__name__
    if rank == 2:
        cancelled.cancel("from process 2")
    ctl = {"rejected": rejected}
    for name, h in (("hang", hang), ("expires", expires),
                    ("cancelled", cancelled)):
        ctl[name] = _outcome(h)
    failing = sched.submit(queries["groupby"](), label="failing",
                           faults="stage:launch@0=raise", retries=0)
    ctl["failing"] = _outcome(failing)
    for planted in (1, 0):
        h = sched.submit(_FailsAfter(queries["groupby"](), planted),
                         label=f"planted{planted}")
        ctl[f"planted{planted}"] = _outcome(h)
    after = sched.submit(queries["groupby"](), label="after")
    res = after.result(timeout=120)
    if res is not None:
        _rows(out, "after/groupby", res)
    ctl["after"] = _outcome(after)
    sched.close()
    ctl["stats"] = {k: v for k, v in sched.stats().items()
                    if k not in ("program_cache", "control")}
    log["ctl"] = ctl

    ex = CylonExecutor(GANG, pool=pool)
    store = CylonStore(pool=pool)
    log["pipe"] = {"gang": ex.lease.indices,
                   "other": _pipeline(out, ex, store, pool)}
    ex.release()

    from repro_torch.launch import train
    out.update(_recording_train(train))
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)
    with open(os.path.join(d, f"rank{rank}.json"), "w") as f:
        json.dump(log, f)


def _group_child(rank, world, d):
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"file://{d}/rendezvous",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    try:
        from repro_torch.comm.process_group import barrier_before_teardown
        _group_cases(rank, d)
        barrier_before_teardown()
    finally:
        dist.destroy_process_group()


def _group_main(world, d):
    import torch.multiprocessing as mp
    mp.start_processes(_group_child, args=(world, d), nprocs=world,
                       start_method="spawn")


# ---------------------------------------------------------------------- #
# The JAX package's side (4 host devices)
# ---------------------------------------------------------------------- #
def _reference_main(path):
    import jax
    import repro.df as rdf
    from repro.core import (CylonExecutor, CylonStore, DevicePool,
                            DistTable)
    from repro.data import (CorpusConfig, batches_from_table, preprocess,
                            source_weights, synth_corpus)
    from repro.expr import col
    from repro.serve import ProgramCache, QueryScheduler
    assert len(jax.devices()) == P
    out = {}

    def rows(key, dt):
        counts = np.asarray(dt.row_counts)
        p = len(counts)
        for r in range(p):
            out[f"{key}/{r}/__count"] = np.array(counts[r])
            for c, v in dt.columns.items():
                out[f"{key}/{r}/{c}"] = np.asarray(v).reshape(
                    (p, dt.capacity) + v.shape[1:])[r]

    lt = DistTable.from_numpy(_data(0, "v0"), GANG)
    rt = DistTable.from_numpy(_data(1, "w"), GANG)
    queries = _queries(col, rdf.from_table(lt, name="l"),
                       rdf.from_table(rt, name="r"), lt.capacity)
    sched = QueryScheduler(pool=DevicePool(), gang_size=GANG,
                           max_inflight=1,
                           program_cache=ProgramCache(registry=False))
    for n in KINDS:
        rows(f"jax/{n}", sched.submit(queries[n]()).result(timeout=300))
    sched.close()
    cfg = CorpusConfig(**CORPUS)
    ex = CylonExecutor(parallelism=GANG, pool=DevicePool())
    store = CylonStore()
    rows("pipe/out", preprocess(ex, synth_corpus(cfg, GANG),
                                source_weights(cfg.num_sources, GANG),
                                store=store))
    got4 = store.get("train_corpus", target_parallelism=P)
    rows("pipe/get4", got4)
    it = batches_from_table(got4, BATCH, SEQ, seed=0)
    for i in range(N_BATCHES):
        for c, v in next(it).items():
            out[f"pipe/batch4/{i}/{c}"] = v
    np.savez(path, **out)


# ---------------------------------------------------------------------- #
# Fixtures
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the group of 4 and the JAX side at once."""
    gdir = str(tmp_path_factory.mktemp("pgs_group"))
    ref = str(tmp_path_factory.mktemp("pgs_ref") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.abspath(SRC), HERE]), JAX_PLATFORMS="cpu")
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    group = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "group", str(P), gdir],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env)
    jax = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "ref", ref],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    yield group, gdir, jax, ref
    for proc in (group, jax):
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def stacked(runs):
    """Every case on the stacked port gang (while the others run)."""
    import repro_torch.df as rdf
    from repro_torch.core import CylonEnv, CylonExecutor, CylonStore
    out = {}
    queries = _port_queries(rdf)
    env = CylonEnv(GANG, device="cpu")
    for n in KINDS:
        _rows(out, n, queries[n]().collect(env=env))
    _pipeline(out, CylonExecutor(GANG, device="cpu"), CylonStore())
    assert "WORLD_SIZE" not in os.environ
    out.update(_stacked_train())
    return out


@pytest.fixture(scope="module")
def ranks(runs, stacked):
    group, gdir = runs[0], runs[1]
    log = group.communicate(timeout=600)[0]
    assert group.returncode == 0, log[-4000:]
    out = []
    for r in range(P):
        with open(os.path.join(gdir, f"rank{r}.json")) as f:
            out.append((dict(np.load(os.path.join(gdir, f"rank{r}.npz"))),
                        json.load(f)))
    return out


@pytest.fixture(scope="module")
def reference(runs, stacked):
    jax, path = runs[2], runs[3]
    log = jax.communicate(timeout=600)[0]
    assert jax.returncode == 0, log[-4000:]
    return dict(np.load(path))


def _rank_keys(res, key, r):
    pre = f"{key}/{r}/"
    return {k[len(pre):]: v for k, v in res.items() if k.startswith(pre)}


def _same_rank(got, want, gkey, wkey, r, valid_only=False):
    g, w = _rank_keys(got, gkey, r), _rank_keys(want, wkey, r)
    assert sorted(g) == sorted(w) and w, (gkey, r, sorted(g), sorted(w))
    n = int(w["__count"])
    for c in w:
        assert g[c].dtype == w[c].dtype, (gkey, r, c)
        a, b = (g[c][:n], w[c][:n]) if valid_only and c != "__count" \
            else (g[c], w[c])
        np.testing.assert_array_equal(a, b, err_msg=f"{gkey} {r} {c}")


def _gang_rank(got, key):
    """The gang ranks whose rows a process recorded under ``key``."""
    return sorted({int(k.split("/")[-2]) for k in got
                   if k.startswith(key + "/") and k.endswith("/__count")})


# ---------------------------------------------------------------------- #
# Tests
# ---------------------------------------------------------------------- #
def test_pool_over_a_process_group(ranks):
    for r, (_, log) in enumerate(ranks):
        pool = log["pool"]
        assert pool["leases"] == [[0, 1], [2, 3]] and pool["exhausted"]
        assert pool["recarved"] == [0, 1] and pool["available"] == P
        assert pool["group_reused"] and pool["comm_reused"], r


SERVED = [f"{case}/{n}/{i}" for case in ("x1", "x2") for n in KINDS
          for i in (0, 1)]


@pytest.mark.parametrize("key", [f"warm/{n}" for n in KINDS] + SERVED
                         + [f"session/{n}" for n in KINDS]
                         + ["after/groupby"])
def test_member_holds_stacked_rank(ranks, stacked, key):
    kind = next(n for n in KINDS if f"/{n}" in f"/{key}")
    members = 0
    for got, _ in ranks:
        for r in _gang_rank(got, key):
            _same_rank(got, stacked, key, kind, r)
            members += 1
    want = {"warm": P}.get(key.split("/")[0], GANG)
    assert members == want, (key, members)


@pytest.mark.parametrize("kind", KINDS)
def test_stacked_gang_equals_jax(reference, stacked, kind):
    for r in range(GANG):
        _same_rank(stacked, reference, kind, f"jax/{kind}", r)


@pytest.mark.parametrize("case", ("x1", "x2"))
def test_every_process_sees_the_same_submissions(ranks, case):
    logs = [log[case] for _, log in ranks]
    for rec in zip(*[lg["handles"] for lg in logs]):
        # kind, gang, state and cache traffic alike on every process
        assert len({json.dumps(x[:4]) for x in rec}) == 1, rec
        assert rec[0][2] == "done" and len(rec[0][1]) == GANG
        # only the gang's members hold a result
        assert [x[4] for x in rec] == [i not in rec[0][1] for i in range(P)]
    stats = [lg["stats"] for lg in logs]
    assert all(s == stats[0] for s in stats)
    assert stats[0]["completed"] == 6 and stats[0]["rejected"] == 0
    assert stats[0]["pool_available"] == P


def test_repeats_on_recarved_gangs_build_nothing(ranks):
    for _, log in ranks:
        # a process builds its own gang's three stages, once
        warm, end = log["cache"]
        assert warm == end and warm[0] == len(KINDS)
        for case in ("x1", "x2"):
            assert all(h[3] == 0 for h in log[case]["handles"])


def test_concurrent_queries_hold_disjoint_gangs(ranks):
    recs = ranks[0][1]["x2"]["handles"]
    pairs = 0
    for i, a in enumerate(recs):
        for b in recs[i + 1:]:
            if a[5] < b[6] and b[5] < a[6]:
                pairs += 1
                assert not set(a[1]) & set(b[1])
    assert pairs > 0
    gangs = {tuple(h[1]) for h in recs}
    assert gangs == {(0, 1), (2, 3)}
    assert {tuple(h[1]) for h in ranks[0][1]["x1"]["handles"]} == {(0, 1)}


@pytest.mark.parametrize("name,state,exc", [
    ("hang", "timeout", "QueryTimeout"),
    ("expires", "timeout", "QueryTimeout"),
    ("cancelled", "cancelled", "QueryCancelled"),
    ("failing", "failed", "InjectedFault"),
    ("planted1", "failed", "ArithmeticError"),
    ("planted0", "failed", "ArithmeticError"),
    ("after", "done", None)])
def test_control_outcomes_alike_on_every_process(ranks, name, state, exc):
    got = [log["ctl"][name] for _, log in ranks]
    assert all(g[:2] == [state, exc] for g in got), got
    gangs = {json.dumps(g[2]) for g in got}
    assert len(gangs) == 1
    if name in ("expires", "cancelled"):
        assert got[0][2] is None        # never ran
    else:
        assert got[0][2] == [0, 1]


def test_admission_rejected_on_every_process(ranks):
    assert [log["ctl"]["rejected"] for _, log in ranks] == \
        ["AdmissionRejected"] * P
    stats = [log["ctl"]["stats"] for _, log in ranks]
    assert all(s == stats[0] for s in stats)
    assert stats[0]["rejected"] == 1 and stats[0]["cancelled"] == 1
    assert stats[0]["completed"] == 1 and stats[0]["failed"] == 5


@pytest.mark.parametrize("key,valid_only", [("pipe/out", False),
                                            ("pipe/get4", False),
                                            ("pipe/get2", True)])
def test_handoff_holds_stacked_rank(ranks, stacked, key, valid_only):
    held = []
    for w, (got, log) in enumerate(ranks):
        assert log["pipe"]["gang"] == [0, 1]
        assert log["pipe"]["other"] == [2, 3]
        for r in _gang_rank(got, key):
            _same_rank(got, stacked, key, key, r, valid_only)
            held.append((w, r))
    want = {"pipe/out": [(0, 0), (1, 1)],
            "pipe/get4": [(r, r) for r in range(P)],
            "pipe/get2": [(2, 0), (3, 1)]}[key]
    assert held == want


@pytest.mark.parametrize("key", ("pipe/batch4", "pipe/batch2"))
def test_batches_equal_the_stacked_run(ranks, stacked, key):
    want = {k: v for k, v in stacked.items() if k.startswith(key + "/")}
    assert len(want) == 2 * N_BATCHES
    procs = range(P) if key.endswith("4") else (2, 3)
    for w in procs:
        got = ranks[w][0]
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=f"{w} {k}")
    if key.endswith("2"):
        assert not any(k.startswith(key) for k in ranks[0][0])


@pytest.mark.parametrize("key", ("pipe/out", "pipe/get4"))
def test_stacked_pipeline_equals_jax(reference, stacked, key):
    for r in range(GANG if key.endswith("out") else P):
        _same_rank(stacked, reference, key, key, r)


def test_stacked_batches_equal_jax(reference, stacked):
    for i in range(N_BATCHES):
        for c in ("tokens", "labels"):
            k = f"pipe/batch4/{i}/{c}"
            np.testing.assert_array_equal(stacked[k], reference[k])


def test_train_driver_under_the_group(ranks, stacked):
    want = {k: v for k, v in stacked.items() if k.startswith("train/batch")}
    assert len(want) == 2 * 2
    for got, _ in ranks:
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        np.testing.assert_allclose(got["train/losses"],
                                   stacked["train/losses"], rtol=2e-3)


def test_pool_takes_only_the_world(tmp_path):
    import torch.distributed as dist
    from repro_torch.core import DevicePool
    assert not dist.is_initialized()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/rv",
                            rank=0, world_size=1)
    try:
        with pytest.raises(TypeError, match="world"):
            DevicePool(process_group=dist.new_group([0]), device="cpu")
    finally:
        dist.destroy_process_group()


def test_gang_groups_follow_a_new_world(tmp_path):
    """A world destroyed and made again: the gangs' groups are the new
    world's, and a collective over them runs."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import DevicePool
    assert not dist.is_initialized()
    groups = []
    try:
        for i in range(2):
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp_path}/rv{i}", rank=0,
                world_size=1)
            pool = DevicePool(process_group=dist.group.WORLD, device="cpu")
            group = pool.reserve(1).group()
            t = torch.ones(2)
            dist.all_reduce(t, group=group)
            assert t.tolist() == [1.0, 1.0]
            groups.append(group)
            # nothing of this process holds the old world after this
            del pool
            dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert groups[0] is not groups[1]


if __name__ == "__main__":
    if sys.argv[1] == "group":
        _group_main(int(sys.argv[2]), sys.argv[3])
    else:
        _reference_main(sys.argv[2])
