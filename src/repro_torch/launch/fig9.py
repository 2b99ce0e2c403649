"""The paper's Fig-9 pipeline (join -> groupby(sum) -> sort -> add a
scalar) over a ``torch.distributed`` process group, one rank per process.

Start it with ``torchrun``, which gives each process its rank, the
world size and the rendezvous:

  # N cards, NCCL: rank r on cuda:r
  torchrun --standalone --nproc_per_node=N -m repro_torch.launch.fig9 \\
      --backend nccl

  # N processes on one card, gloo (NCCL takes one rank per device):
  # every collective goes through pinned host buffers
  torchrun --standalone --nproc_per_node=8 -m repro_torch.launch.fig9 \\
      --backend gloo --device cuda:0

  # the CPU
  torchrun --standalone --nproc_per_node=4 -m repro_torch.launch.fig9 \\
      --backend gloo --device cpu --rows 65536

  # out-of-core: each rank's rows stream in morsels of --morsel-rows
  # (the left table a host dict, the right on the card), from Parquet
  # files, under a fault plan and a deadline
  torchrun --standalone --nproc_per_node=8 -m repro_torch.launch.fig9 \
      --backend gloo --device cuda:0 --morsel-rows 524288 \
      --capacity-factor 4 --parquet /tmp/fig9 \
      --faults 'spill:append@1=raise' --timeout 120

Each process builds the rows its rank holds of two tables from
``--seed`` (the JAX package's ``benchmarks/common.py`` recipe: uniform
int32 keys at 90% cardinality, float32 values), runs the plan ``--runs``
times in ``--mode`` under ``--communicator``, and rank 0 prints each
run's wall (the slowest process's), rows shuffled and the share of the
wall spent in host-staged collectives and host exchanges.
``--parquet DIR`` reads both tables from ``DIR/l/*.parquet`` and
``DIR/r/*.parquet`` instead (rank 0 writes 8 files a side there from the
seed first when DIR holds none); every process reads the same files and
keeps the batches of its rank.  ``--morsel-rows`` streams the plan
out-of-core (``--capacity-factor`` sets the working capacity);
``--faults`` arms a fault plan (``REPRO_FAULTS`` syntax) and
``--timeout`` a deadline, both agreed over the group at every fault
site.  ``--check`` gathers the result on every process and holds it to
numpy on rank 0.

``--gang-size G`` serves queries instead (the JAX package's
``benchmarks/bench_pipeline.py::run_serving``): a ``QueryScheduler`` over
a ``DevicePool`` of the group's processes carves gangs of ``G``
processes; two ``--rows``-row tables (integer-valued payloads, seeds
``--seed`` and ``--seed + 1``) are given whole to every process, every
gang is pre-warmed, and ``--queries`` of the three query kinds (join +
filter + groupby + sort, groupby sum / mean + sort, filter + sort) go
through a serial sweep (``max_inflight=1``) and a concurrent one
(``--inflight``, default every gang); rank 0 prints each sweep's
queries/s, p50 and largest latency and the speedup:

  torchrun --standalone --nproc_per_node=8 -m repro_torch.launch.fig9 \
      --backend gloo --device cuda:0 --rows 16777216 --gang-size 2 \
      --queries 24
"""

from __future__ import annotations

import argparse
import os
import time
from datetime import timedelta
from typing import Dict, Optional, Sequence

import numpy as np
import torch


def table_data(rows: int, seed: int) -> Dict[str, np.ndarray]:
    """``benchmarks/common.py::make_table_data``: uniform int32 keys at 90%
    cardinality, float32 values in [0, 1)."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, max(1, int(rows * 0.9)), rows).astype(np.int32)
    return {"k": keys, "v0": rng.random(rows).astype(np.float32)}


def fig9_plan(Plan, capacity: int):
    return (Plan.scan("l")
            .join(Plan.scan("r"), on="k", out_capacity=capacity * 4)
            .groupby(["k"], {"v0": ["sum"]}).sort(["k"])
            .add_scalar(1.0, cols=["v0_sum"]))


def host_reference(ld, rd):
    """Fig-9's keys and sums from numpy."""
    n = int(max(ld["k"].max(), rd["k"].max())) + 1
    cnt_r = np.bincount(rd["k"], minlength=n)
    sum_l = np.bincount(ld["k"], weights=ld["v0"].astype(np.float64),
                        minlength=n)
    both = (np.bincount(ld["k"], minlength=n) * cnt_r) > 0
    return np.nonzero(both)[0].astype(np.int32), (sum_l * cnt_r)[both] + 1


def write_parquet(d: str, ld, rd, nfiles: int = 8) -> None:
    """The two tables as ``nfiles`` Parquet files a side under ``d/l``
    and ``d/r`` (row groups of 2^20 rows)."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    for side, data in (("l", ld), ("r", rd)):
        os.makedirs(os.path.join(d, side), exist_ok=True)
        n = len(data["k"])
        per = -(-n // nfiles)
        for f in range(nfiles):
            part = {c: v[f * per:(f + 1) * per] for c, v in data.items()}
            pq.write_table(pa.table(part),
                           os.path.join(d, side, f"part{f}.parquet"),
                           row_group_size=1 << 20)


def read_tables(env, d: str):
    """Both tables from ``d``'s Parquet files, as each process's spills."""
    import glob
    from ..io import read_parquet
    return {side: read_parquet(sorted(glob.glob(os.path.join(
        d, side, "*.parquet"))), env.parallelism, dict_cache=None,
        comm=env.comm if env.ranks_held < env.parallelism else None)
        for side in "lr"}


def serving_queries(left, right):
    """``benchmarks/bench_pipeline.py::run_serving``'s three queries, with
    its join capacities: name -> a function making the frame."""
    from ..expr import col
    cap = next(iter(left.sources.values())).capacity
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


def prewarm(pool, gang: int, queries, programs) -> Dict[str, object]:
    """Run each query once on every gang of ``gang`` processes carved
    from ``pool`` (all gangs at once, each on its own processes), through
    the shared stage cache ``programs``; returns this process's results
    by query name.  Every process calls it."""
    from ..core import CylonEnv
    leases = [pool.reserve(gang) for _ in range(pool.size // gang)]
    out = {}
    try:
        for lease in leases:
            if lease.is_member:
                env = CylonEnv(devices=lease, program_cache=programs)
                for name, q in queries.items():
                    out[name] = q().on_gang(env.comm).collect(env=env)
                env.synchronize()
    finally:
        for lease in leases:
            lease.release()
    return out


def serve(args, device) -> None:
    """The serving sweeps of ``--gang-size`` (see the module)."""
    import torch.distributed as dist
    import repro_torch.df as rdf
    from ..core import DevicePool, DistTable
    from ..serve import ProgramCache, QueryScheduler
    pool = DevicePool(process_group=dist.group.WORLD, device=device)
    g, rank = args.gang_size, dist.get_rank()
    if pool.size % g:
        raise SystemExit(f"--gang-size {g} must divide the {pool.size} "
                         f"processes")
    rng = [np.random.default_rng(args.seed + i) for i in (0, 1)]
    data = [{"k": r.integers(0, max(1, int(args.rows * 0.9)),
                             args.rows).astype(np.int32),
             "v": r.integers(0, 256, args.rows).astype(np.float32)}
            for r in rng]
    left = rdf.from_table(DistTable.from_numpy(
        {"k": data[0]["k"], "v0": data[0]["v"]}, g, device=pool.device),
        name="l")
    right = rdf.from_table(DistTable.from_numpy(
        {"k": data[1]["k"], "w": data[1]["v"]}, g, device=pool.device),
        name="r")
    queries = serving_queries(left, right)
    names = sorted(queries)
    shared = ProgramCache(registry=False)
    prewarm(pool, g, queries, shared)
    walls = {}
    for inflight in (1, args.inflight or pool.size // g):
        sched = QueryScheduler(pool=pool, gang_size=g,
                               max_inflight=inflight,
                               max_queue=args.queries, program_cache=shared,
                               name=f"fig9-x{inflight}")
        t = time.perf_counter()
        handles = [sched.submit(queries[names[i % 3]](), label=f"q{i}")
                   for i in range(args.queries)]
        for h in handles:
            h.result()
        wall = time.perf_counter() - t
        sched.close()
        walls[inflight] = wall
        lat = sorted(h.stats["finished_monotonic"]
                     - h.stats["submitted_monotonic"] for h in handles)
        misses = sum(h.stats.get("cache_misses", 0) for h in handles)
        if rank == 0:
            print(f"[fig9-serve] {pool.size} processes, gangs of {g}, "
                  f"x{inflight}: {args.queries} queries in {wall:.3f} s, "
                  f"{args.queries / wall:.3f} queries/s, latency p50 "
                  f"{lat[len(lat) // 2] * 1e3:.1f} ms, largest "
                  f"{lat[-1] * 1e3:.1f} ms, {misses} stages built",
                  flush=True)
    if rank == 0 and len(walls) == 2:
        a, b = walls.values()
        print(f"[fig9-serve] concurrent / serial {a / b:.3f}x", flush=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--device", default=None,
                    help="cuda:LOCAL_RANK by default, or cpu")
    ap.add_argument("--communicator", default="xla",
                    choices=("xla", "ring", "bruck"))
    ap.add_argument("--mode", default="bsp",
                    choices=("bsp", "bsp_staged", "amt"))
    ap.add_argument("--rows", type=int, default=1 << 25,
                    help="rows per input table")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--morsel-rows", type=int, default=None,
                    help="stream out-of-core in morsels of this many rows "
                         "a rank")
    ap.add_argument("--capacity-factor", type=float, default=2.0,
                    help="out-of-core working capacity over morsel rows")
    ap.add_argument("--parquet", default=None, metavar="DIR",
                    help="read the tables from DIR/{l,r}/*.parquet "
                         "(written from --seed when absent)")
    ap.add_argument("--faults", default=None, metavar="PLAN",
                    help="a fault plan in REPRO_FAULTS syntax")
    ap.add_argument("--timeout", type=float, default=None,
                    help="a deadline in seconds for each run")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--gang-size", type=int, default=None,
                    help="serve queries on gangs of this many processes")
    ap.add_argument("--queries", type=int, default=24,
                    help="queries a serving sweep")
    ap.add_argument("--inflight", type=int, default=None,
                    help="the concurrent sweep's max_inflight (default: "
                         "every gang)")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from ..comm.process_group import barrier_before_teardown
    from ..core import CylonEnv, Plan, execute
    dist.init_process_group(args.backend, timeout=timedelta(seconds=120))
    try:
        if args.gang_size:
            device = args.device or \
                f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
            serve(args, device)
            barrier_before_teardown(device)
            return
        env = CylonEnv(communicator=args.communicator,
                       process_group=dist.group.WORLD, device=args.device)
        p, rank = env.parallelism, dist.get_rank()
        per = -(-args.rows // p)
        cap = -(-(per + per // 8) // 8) * 8     # share + 1/8 headroom
        ld = table_data(args.rows, args.seed)
        rd = table_data(args.rows, args.seed + 1)
        kw = dict(faults=args.faults, timeout=args.timeout)
        if args.parquet:
            if rank == 0 and not os.path.isdir(os.path.join(args.parquet,
                                                            "l")):
                write_parquet(args.parquet, ld, rd)
            env.comm.gather_ints([0])    # the files are written
            tables = read_tables(env, args.parquet)
            kw["scan_capacity"] = cap
        elif args.morsel_rows:
            # the streamed side stays a host dict: each process streams
            # the rows of its rank
            tables = {"l": ld, "r": env.from_numpy(rd, cap)}
        else:
            tables = {"l": env.from_numpy(ld, cap),
                      "r": env.from_numpy(rd, cap)}
        if args.morsel_rows:
            kw = dict(kw, morsel_rows=args.morsel_rows,
                      capacity_factor=args.capacity_factor)
            kw.pop("scan_capacity", None)
        plan = fig9_plan(Plan, cap)
        for run in range(args.runs):
            stats0 = dict(env.comm.stats)
            env.synchronize()
            t = time.perf_counter()
            res, st = execute(plan, env, tables, mode=args.mode,
                              collect_stats=True, **kw)
            env.synchronize()
            wall = time.perf_counter() - t
            share = sum(env.comm.stats[k] - stats0[k]
                        for k in ("staged_s", "host_s")) / wall
            slowest = env.comm.all_reduce_max(
                torch.tensor([wall, share], dtype=torch.float64,
                             device=env.device)[None])[0].tolist()
            if rank == 0:
                print(f"[fig9] {args.backend} {args.communicator} "
                      f"{args.mode} run {run}: 2 x {args.rows} rows over "
                      f"{p} processes, wall {slowest[0]:.3f} s, rows "
                      f"shuffled {st.rows_shuffled}, dropped "
                      f"{st.rows_dropped}, morsels {st.morsels}, retries "
                      f"{st.retries}, host-staged collectives and host "
                      f"exchanges up to {100 * slowest[1]:.1f}% of a "
                      f"process's wall", flush=True)
        if args.check:
            out = res.gather_numpy()
            if rank == 0:
                keys, sums = host_reference(ld, rd)
                ok = (np.array_equal(out["k"], keys) and np.allclose(
                    out["v0_sum"], sums, rtol=1e-3))
                print(f"[fig9] {len(keys)} groups, "
                      f"{'equal to' if ok else 'DIFFERENT from'} numpy",
                      flush=True)
                if not ok:
                    raise SystemExit(1)
        barrier_before_teardown(env.device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
