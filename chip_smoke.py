#!/usr/bin/env python3
"""Proof that the PyTorch port (``src/repro_torch``) runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and PyTorch built for
CUDA; imports nothing of JAX or of the JAX package.  Phases, each of which
ends the run with a non-zero exit code if it fails:

1. builds every CUDA kernel of the port from the sources in the checkout;
2. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, exactly, at the main path's shapes and edge cases, timed
   with CUDA events;
3. main path: the paper's Fig-9 pipeline (join -> groupby(sum) -> sort ->
   add_scalar) through ``execute`` at 2 x 2**25 rows over 8 ranks stacked
   on the card, in ``bsp``, ``bsp_staged`` and ``amt``, twice each, with
   kernel launch counts reset just before each run and read just after
   it (each shuffle of ``bsp`` and ``bsp_staged`` launches the radix
   kernel once; ``amt`` shuffles by all-gather and launches it never);
   results are held against a numpy computation on the host;
4. parity: the same plan at 2**16 rows, optimizer on and off, on the card
   and on the CPU (plain kernels), compared slot for slot.

The last lines are the card's ``nvidia-smi`` name and power limit, one
JSON object describing each kernel, and ``{"ok": true, "device": ...}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FULL_ROWS = 1 << 25      # rows per input table on the main path
PARITY_ROWS = 1 << 16
P = 8                    # ranks stacked on the card
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
L2_BYTES = 50 * 1024 * 1024


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def make_table_data(rows, seed, cardinality=0.9):
    """The paper's §V data recipe (``benchmarks/common.py``): uniform int32
    keys at 90% cardinality, float32 values."""
    rng = np.random.default_rng(seed)
    n_unique = max(1, int(rows * cardinality))
    return {"k": rng.integers(0, n_unique, rows).astype(np.int32),
            "v0": rng.random(rows).astype(np.float32)}


def capacity_for(rows, p):
    """Per-rank capacity: the balanced share plus 1/8 headroom, so the
    hash shuffles' receive tables (capacity = input capacity) hold the
    spread of a uniform hash without dropping rows."""
    per = -(-rows // p)
    return -(-(per + per // 8) // 8) * 8


def fig9_plan(Plan, capacity, bench_capacities=False):
    """``benchmarks/bench_pipeline.py:40-48``.  The explicit bucket
    capacities there exist for the unoptimized re-shuffle; the full-size
    run keeps only the join's ``out_capacity``."""
    if not bench_capacities:
        return (Plan.scan("l")
                .join(Plan.scan("r"), on="k", out_capacity=capacity * 4)
                .groupby(["k"], {"v0": ["sum"]}).sort(["k"])
                .add_scalar(1.0, cols=["v0_sum"]))
    return (Plan.scan("l")
            .join(Plan.scan("r"), on="k", out_capacity=capacity * 4,
                  bucket_capacity=capacity)
            .groupby(["k"], {"v0": ["sum"]}, bucket_capacity=capacity * 4)
            .sort(["k"], bucket_capacity=capacity * 4)
            .add_scalar(1.0, cols=["v0_sum"]))


def time_cuda(torch, fn, iters, flush):
    """Median milliseconds of ``fn`` over ``iters`` launches, each timed
    with CUDA events after overwriting a buffer larger than L2 (the
    caller finds its input cold)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_phase(torch, cap):
    from repro_torch.kernels import radix_partition_cuda, radix_partition_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device=dev)
    # (p, n, nb): the join's shuffles (n = cap) and the sort's (n = 4 cap)
    # on the main path, then a wide case, a large bucket count and n = 0
    cases = [("main:join", P, cap, P + 1), ("main:sort", P, 4 * cap, P + 1),
             ("p8", P, 4_194_304, P + 1), ("nb4096", 1, 1_000_003, 4096),
             ("empty", P, 0, P + 1)]
    out = []
    for name, p, n, nb in cases:
        dest = torch.randint(0, nb, (p, n), generator=gen, device=dev,
                             dtype=torch.int32)
        ranks, hist = radix_partition_cuda(dest, nb)
        want_r, want_h = radix_partition_ref(dest, nb)
        torch.cuda.synchronize()
        check(torch.equal(ranks, want_r) and torch.equal(hist, want_h),
              f"radix_partition CUDA != plain at {name} {(p, n, nb)}")
        err = max(int((ranks - want_r).abs().max()) if n else 0,
                  int((hist - want_h).abs().max()))
        ms = time_cuda(torch, lambda: radix_partition_cuda(dest, nb), 20,
                       flush)
        plain_ms = time_cuda(torch, lambda: radix_partition_ref(dest, nb),
                             3, flush)
        # bytes the function must move: dest read once, ranks and the
        # histogram written once; it does no arithmetic worth counting
        nbytes = 4 * p * n * 2 + 4 * p * nb
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out.append(dict(case=name, p=p, n=n, nb=nb, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        max_abs_err=err))
        print(f"kernel radix_partition {name:10s} p={p} n={n} nb={nb}: "
              f"{ms:.4f} ms (plain {plain_ms:.3f} ms, bound {bound_ms:.4f} "
              f"ms), exact", flush=True)
    return out


def host_reference(ld, rd):
    """What the Fig-9 result must be, from numpy on the host."""
    n_keys = int(max(ld["k"].max(), rd["k"].max())) + 1
    cnt_l = np.bincount(ld["k"], minlength=n_keys).astype(np.int64)
    cnt_r = np.bincount(rd["k"], minlength=n_keys).astype(np.int64)
    sum_l = np.bincount(ld["k"], weights=ld["v0"].astype(np.float64),
                        minlength=n_keys)
    both = (cnt_l * cnt_r) > 0
    keys = np.nonzero(both)[0].astype(np.int32)
    # the join keeps the left v0; each left row meets cnt_r partners
    sums = (sum_l * cnt_r)[both] + 1.0
    return int((cnt_l * cnt_r).sum()), keys, sums


def check_fig9(res, stats, ref, label):
    _, keys, sums = ref
    out = res.to_numpy()
    check(stats.rows_dropped == 0, f"{label}: {stats.rows_dropped} rows "
          f"dropped")
    check(len(out["k"]) == len(keys), f"{label}: {len(out['k'])} groups, "
          f"want {len(keys)}")
    check(bool(np.all(np.diff(out["k"]) > 0)), f"{label}: keys not in "
          f"global order")
    check(np.array_equal(out["k"], keys), f"{label}: group keys differ")
    got = out["v0_sum"].astype(np.float64)
    check(abs(got.sum() - sums.sum()) <= 1e-3 * abs(sums.sum()),
          f"{label}: v0_sum total {got.sum()} vs {sums.sum()}")
    rel = np.abs(got - sums) / np.maximum(np.abs(sums), 1.0)
    check(float(rel.max()) <= 1e-3, f"{label}: v0_sum off by {rel.max()}")
    join_out = [r for r in stats.shuffle_records
                if r.label == "join(k):overflow"]
    check(bool(join_out) and join_out[0].dropped == 0,
          f"{label}: join output overflowed")


def main_path_phase(torch, rows=FULL_ROWS, device=None):
    """Fig-9 at ``rows`` per table; returns (kernel launches per run,
    wall times), both keyed by ``"<mode>/<first|cached>"``.
    ``device=None`` is the card, as a user calling the port gets it."""
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    from repro_torch.kernels import CUDA_KERNELS, reset_launches
    t0 = time.perf_counter()
    ld, rd = make_table_data(rows, 0), make_table_data(rows, 1)
    cap = capacity_for(rows, P)
    env = CylonEnv(P, device=device)
    tables = {"l": DistTable.from_numpy(ld, P, capacity=cap, device=device),
              "r": DistTable.from_numpy(rd, P, capacity=cap, device=device)}
    ref = host_reference(ld, rd)
    env.synchronize()
    on_card = env.device.type == "cuda"
    print(f"main path: 2 x {rows} rows over {P} stacked ranks, "
          f"capacity {cap}/rank; set-up {time.perf_counter() - t0:.2f} s; "
          f"expect {ref[0]} join rows, {len(ref[1])} groups", flush=True)
    plan = fig9_plan(Plan, cap)
    print(plan.explain(tables), flush=True)
    walls, launches = {}, {}
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for mode in ("bsp", "bsp_staged", "amt"):
        for run in ("first", "cached"):
            env.synchronize()
            reset_launches()
            t = time.perf_counter()
            res, st = execute(plan, env, tables, mode=mode,
                              collect_stats=True)
            env.synchronize()
            wall = time.perf_counter() - t
            counts = {k.name: k.launches for k in CUDA_KERNELS}
            walls[f"{mode}/{run}"] = wall
            launches[f"{mode}/{run}"] = counts
            # one radix launch per direct shuffle on the card; none on
            # amt's all-gather, nor on the CPU (plain version)
            want = st.num_shuffles if on_card and mode != "amt" else 0
            check(counts["radix_partition"] == want,
                  f"{mode}/{run}: radix_partition launched "
                  f"{counts['radix_partition']} times, want {want}")
            if run == "cached":
                check(st.cache_misses == 0, f"{mode}: {st.cache_misses} "
                      f"cache misses on the repeat run")
            stages = ", ".join(f"{n}={s * 1e3:.1f}ms"
                               for n, s in st.stage_times)
            print(f"fig9 {mode:10s} {run:6s} wall {wall * 1e3:9.2f} ms  "
                  f"dispatches={st.dispatches} shuffles={st.num_shuffles} "
                  f"rows_shuffled={st.rows_shuffled} "
                  f"cache_hits={st.cache_hits} "
                  f"cache_misses={st.cache_misses} launches={counts} "
                  f"[{stages}]", flush=True)
            check_fig9(res, st, ref, f"{mode}/{run}")
            del res
    # the join's row count, from the join alone (after the counts are read)
    joined = execute(Plan.scan("l").join(Plan.scan("r"), on="k",
                                         out_capacity=4 * cap),
                     env, tables, collect_stats=True)[0]
    check(joined.total_rows() == ref[0], f"join: {joined.total_rows()} "
          f"rows, want {ref[0]}")
    peak = (f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
            if on_card else "not measured")
    print(f"peak device memory {peak}", flush=True)
    if on_card:
        profile_bsp(env, plan, tables)
    return launches, walls


def profile_bsp(env, plan, tables, top=10):
    """One more cached ``bsp`` run under ``torch.profiler``: device time by
    PyTorch operator and by kernel, and the device's busy share of the
    run's wall time (the profiler's own overhead is in that wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import execute
    env.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        execute(plan, env, tables, mode="bsp")
        env.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3

    def dev_ms(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0)) / 1e3
    events = [e for e in prof.key_averages() if dev_ms(e) > 0]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    # host-side rows other than aten operators (e.g. the profiler's
    # "Command Buffer Full", a wait on a full launch queue) are not work
    ops = [e for e in events if e.key.startswith("aten::")]
    busy = sum(dev_ms(e) for e in kernels)
    if not busy:
        print("profile bsp: the profiler recorded no device time; device "
              "busy share not measured", flush=True)
        return
    print(f"profile bsp (cached run under the profiler): wall "
          f"{wall_ms:.1f} ms, device busy {busy:.1f} ms "
          f"({100 * busy / wall_ms:.1f}%, idle "
          f"{100 - 100 * busy / wall_ms:.1f}%)", flush=True)
    for title, rows in (("by operator", ops), ("by kernel", kernels)):
        print(f"profile bsp, device time {title}:")
        for e in sorted(rows, key=dev_ms, reverse=True)[:top]:
            print(f"  {dev_ms(e):9.2f} ms {100 * dev_ms(e) / busy:5.1f}% "
                  f"{e.count:5d}x  {e.key[:100]}")


def parity_phase(devices=("cuda", "cpu")):
    from repro_torch.core import CylonEnv, DistTable, Plan, execute
    ld, rd = make_table_data(PARITY_ROWS, 0), make_table_data(PARITY_ROWS, 1)
    cap = capacity_for(PARITY_ROWS, P)
    plan = fig9_plan(Plan, cap, bench_capacities=True)
    results = {}
    for device in devices:
        env = CylonEnv(P, device=device)
        tables = {n: DistTable.from_numpy(d, P, capacity=cap, device=device)
                  for n, d in (("l", ld), ("r", rd))}
        for mode in ("bsp", "bsp_staged", "amt"):
            for opt in (True, False):
                res, st = execute(plan, env, tables, mode=mode,
                                  optimize=opt, collect_stats=True)
                check(st.rows_dropped == 0, f"parity {device} {mode}: drops")
                results[(device, mode, opt)] = res.to_reference()
    for mode in ("bsp", "bsp_staged", "amt"):
        for opt in (True, False):
            (gc, gn), (cc, cn) = (results[(devices[0], mode, opt)],
                                  results[(devices[-1], mode, opt)])
            tag = f"parity {mode} optimize={opt}"
            check(np.array_equal(gn, cn), f"{tag}: row counts differ")
            check(sorted(gc) == sorted(cc), f"{tag}: columns differ")
            check(np.array_equal(gc["k"], cc["k"]), f"{tag}: keys differ")
            check(np.allclose(gc["v0_sum"], cc["v0_sum"], rtol=1e-5,
                              atol=0), f"{tag}: v0_sum differs beyond 1e-5")
            print(f"{tag}: card == cpu ({int(gn.sum())} rows)", flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import CUDA_KERNELS
    from repro_torch.kernels.build import build, build_log
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t = time.perf_counter()
    for k in CUDA_KERNELS:
        build(k.name)
    print(f"built {[k.name for k in CUDA_KERNELS]} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for k in CUDA_KERNELS:
        print(build_log(k.name).strip(), flush=True)

    cap = capacity_for(FULL_ROWS, P)
    cases = kernel_phase(torch, cap)
    launches, walls = main_path_phase(torch)
    for k in CUDA_KERNELS:
        check(launches["bsp/first"][k.name] > 0, f"kernel {k.name} never "
              f"launched on the main path")
    parity_phase()

    from repro_torch.kernels import radix_partition_cuda as rp
    main_case = cases[0]
    kernels = [{
        "name": rp.name, "route": "cuda", "source": rp.source,
        "replaces": rp.replaces,
        # the main path is the first bsp run; every run's count beside it
        "launches": launches["bsp/first"][rp.name],
        "launches_by_run": {run: c[rp.name] for run, c in launches.items()},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "shape": [main_case["p"], main_case["n"], main_case["nb"]],
        "cases": cases,
    }]
    print(json.dumps({"fig9_wall_s": walls}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
