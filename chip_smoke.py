#!/usr/bin/env python3
"""Proof that the PyTorch port (``src/repro_torch``) runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and PyTorch built for
CUDA; imports nothing of JAX or of the JAX package.  Phases, each of which
ends the run with a non-zero exit code if it fails:

1. builds every CUDA kernel of the port from the sources in the checkout
   (one nvcc per source, all started together);
2. kernels: each kernel's wrapper against its plain PyTorch version on
   the card, at the main paths' shapes and edge cases, timed with CUDA
   events (L2 overwritten before each launch), beside its bound and, where
   one PyTorch call computes the same function, that call's time
   (``scatter_add_`` and ``index_add_`` for the segmented sum,
   ``scaled_dot_product_attention`` for flash attention);
3. Fig-9: the paper's pipeline (join -> groupby(sum) -> sort ->
   add_scalar) through ``execute`` at 2 x 2**25 rows over 8 ranks stacked
   on the card, in ``bsp``, ``bsp_staged`` and ``amt``, twice each, with
   kernel launch counts reset just before each run and read just after
   it: each shuffle of ``bsp`` and ``bsp_staged`` launches the radix
   kernel once (``amt`` shuffles by all-gather and launches it never), and
   every sum, count and size of every local groupby launches the
   segmented-sum kernel once, in every mode (the count is read off the
   lowered plan); results are held against a numpy computation on the
   host, and one cached ``bsp`` run is profiled;
4. frontend: the same pipeline with a mean, written against
   ``repro_torch.df`` on the same data, in every mode, twice each, with
   the same launch checks; held to the host reference and to the
   ``Plan``-built pipeline (equal EXPLAIN, equal result, no stage built
   anew); then a string-keyed run (2 x 2**22 ``<U12`` keys from 2**18
   words, two dictionaries, so EXPLAIN shows ``recode[...]``) held to
   numpy on the host, one cached run of it profiled;
5. Fig-9 parity: the plan at 2**16 rows, optimizer on and off, on the
   card and on the CPU (plain kernels), compared slot for slot;
6. serving: qwen3-8b and mamba2-780m at full width (float32 weights from
   a seeded generator, batch 4, prompt 4096, 32 new tokens, greedy)
   through ``ServeEngine``, twice each; launch counts reset just before
   each prefill and each decode step and read just after it (flash
   attention once per qwen3-8b layer in prefill, the SSD scan once per
   mamba2 layer, neither in decode); time to first token, decode time per
   step, tokens per second and peak device memory;
7. serving parity: both SMOKE configs with the same weights on the card
   (kernels forced, prompts longer than a tile) and on the CPU (plain
   versions): prefill logits within 1e-3, greedy tokens equal.

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
F32_FLOPS = 67e12           # float32 outside the tensor cores, H100 SXM
BF16_FLOPS = 989e12         # dense bf16 tensor cores, H100 SXM
L2_BYTES = 50 * 1024 * 1024
#: the serving phase's full-width cases: arch, batch, prompt, new tokens
SERVE_CASES = (("qwen3-8b", 4, 4096, 32), ("mamba2-780m", 4, 4096, 32))
#: the CUDA kernel each served arch's prefill must launch once per layer
SERVE_KERNEL = {"qwen3-8b": "flash_attention", "mamba2-780m": "ssd_scan"}
#: the impl that forces that kernel in the serving parity phase
KERNEL_IMPL = {"qwen3-8b": "flash", "mamba2-780m": "kernel"}


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


def radix_phase(torch, cap, flush):
    from repro_torch.kernels import radix_partition_cuda, radix_partition_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
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
                        bound_by="bytes", library_ms=None,
                        max_abs_err=err))
        print(f"kernel radix_partition {name:10s} p={p} n={n} nb={nb}: "
              f"{ms:.4f} ms (plain {plain_ms:.3f} ms, bound {bound_ms:.4f} "
              f"ms), exact", flush=True)
    return out


def fig9_join_ids(torch, rows, p, cap, gen, dev):
    """Segment ids and values of the Fig-9 groupby's own ``segmented_sum``
    call, made on the card: per rank, the join output of ``rows / p`` left
    and right rows over ``0.9 rows / p`` keys (each key repeated
    ``cnt_l * cnt_r`` times, sorted), then padding rows at ``cap - 1``
    with value 0, as ``groupby_local`` hands them to the kernel."""
    per, keys = rows // p, int(0.9 * rows) // p
    seg = torch.full((p, cap), cap - 1, dtype=torch.int32, device=dev)
    vals = torch.zeros((p, cap), dtype=torch.float32, device=dev)
    for r in range(p):
        cl, cr = (torch.bincount(torch.randint(0, keys, (per,), generator=gen,
                                               device=dev), minlength=keys)
                  for _ in range(2))
        mult = cl * cr
        hit = torch.nonzero(mult).flatten()
        ids = torch.repeat_interleave(
            torch.arange(hit.numel(), dtype=torch.int32, device=dev),
            mult[hit])
        seg[r, :ids.numel()] = ids
        vals[r, :ids.numel()] = torch.rand(ids.numel(), generator=gen,
                                           device=dev)
    return seg, vals


def segsum_phase(torch, cap, flush):
    """Segmented-sum kernel vs ``segmented_sum_ref`` on the card; the first
    case is the Fig-9 groupby's call (n = S = the join's out_capacity),
    timed beside ``scatter_add_`` and ``index_add_`` at that shape."""
    from repro_torch.kernels import segmented_sum_cuda, segmented_sum_ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)

    def sorted_ids(p, n, s):
        return torch.sort(torch.randint(0, s, (p, n), generator=gen,
                                        device=dev, dtype=torch.int32),
                          dim=1).values

    def floats(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    main_seg, main_vals = fig9_join_ids(torch, FULL_ROWS, P, 4 * cap, gen,
                                        dev)
    # (name, ids, values, S): the main path's call, then unsorted ids, C=4,
    # int32 (exact), a row count off the 8192-row tile, n = 0, ids outside
    # [0, S), and the small sweep of tests/test_kernels.py:17-37
    cases = [("main", main_seg, main_vals, 4 * cap),
             ("unsorted", torch.randint(0, 1 << 20, (P, 1 << 22),
                                        generator=gen, device=dev,
                                        dtype=torch.int32),
              floats(P, 1 << 22), 1 << 20),
             ("c4", sorted_ids(P, 1 << 20, 1 << 18), floats(P, 1 << 20, 4),
              1 << 18),
             ("int32", main_seg, torch.randint(
                 -50, 50, main_seg.shape, generator=gen, device=dev,
                 dtype=torch.int32) * (main_seg < 4 * cap - 1), 4 * cap),
             ("ragged", sorted_ids(3, 1_000_003, 50_000),
              floats(3, 1_000_003), 50_000),
             ("empty", torch.zeros((P, 0), dtype=torch.int32, device=dev),
              floats(P, 0), 16),
             ("oob", torch.randint(-5, 1005, (2, 1 << 20), generator=gen,
                                   device=dev, dtype=torch.int32),
              floats(2, 1 << 20), 1000)]
    for n, segs, cols in ((64, 5, 1), (500, 37, 3), (1024, 512, 2),
                          (300, 1, 4)):
        ids = sorted_ids(1, n, segs)
        cases.append((f"sweep{n}f", ids, floats(1, n, cols), segs))
        cases.append((f"sweep{n}i", ids, torch.randint(
            -50, 50, (1, n, cols), generator=gen, device=dev,
            dtype=torch.int32), segs))
    out = []
    for name, seg, vals, s in cases:
        got = segmented_sum_cuda(seg, vals, s)
        want = segmented_sum_ref(seg, vals, s)
        torch.cuda.synchronize()
        if vals.dtype == torch.int32:
            ok, tol = torch.equal(got, want), "exact"
            err = float((got - want).abs().max()) if got.numel() else 0.0
        else:
            # tests/test_kernels.py's tolerance: float sums in another order
            diff = (got - want).abs()
            ok = bool((diff <= 1e-5 * want.abs() + 1e-5).all())
            tol, err = "1e-5 |want| + 1e-5", (float(diff.max())
                                               if got.numel() else 0.0)
        check(ok, f"segmented_sum CUDA != plain at {name}: max |err| {err} "
              f"beyond {tol}")
        main = name in ("main", "unsorted", "int32")
        ms = time_cuda(torch, lambda: segmented_sum_cuda(seg, vals, s),
                       20 if main else 5, flush)
        plain_ms = time_cuda(torch, lambda: segmented_sum_ref(seg, vals, s),
                             3 if main else 2, flush)
        lib = None
        if name == "main":
            # one PyTorch call each over the same inputs (zero-filled
            # output included, as the kernel's launcher zero-fills)
            idx = seg.to(torch.int64)
            flat = (idx + torch.arange(seg.shape[0], device=dev)[:, None]
                    * s).flatten()
            lib = {"scatter_add_": time_cuda(
                       torch, lambda: torch.zeros_like(vals).scatter_add_(
                           1, idx, vals), 5, flush),
                   "index_add_": time_cuda(
                       torch, lambda: torch.zeros(
                           seg.shape[0] * s, device=dev).index_add_(
                           0, flat, vals.flatten()), 5, flush)}
            del idx, flat
        p, n = seg.shape
        c = vals.shape[2] if vals.dim() == 3 else 1
        # bytes the function must move: ids and values read once, the sums
        # written once; one addition per value is far below the f32 peak
        nbytes = 4 * p * n + vals.element_size() * c * (p * n + p * s)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        valid = int((seg < s - 1).sum()) if name == "main" else None
        out.append(dict(case=name, p=p, n=n, segments=s, cols=c,
                        dtype=str(vals.dtype).split(".")[-1], ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by="bytes",
                        library_ms=lib["scatter_add_"] if lib else None,
                        library=lib, max_abs_err=err))
        extra = (f", scatter_add_ {lib['scatter_add_']:.3f} ms, index_add_ "
                 f"{lib['index_add_']:.3f} ms, {valid} valid rows of "
                 f"{p * n}" if lib else "")
        print(f"kernel segmented_sum {name:10s} p={p} n={n} S={s} C={c} "
              f"{out[-1]['dtype']}: {ms:.4f} ms (plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms{extra}), max |err| {err:.2e} "
              f"({tol})", flush=True)
        del got, want
    del cases, main_seg, main_vals
    torch.cuda.empty_cache()
    return out


def segsum_launches_expected(pplan, mode):
    """``segmented_sum`` launches one run of ``pplan`` makes on the card:
    one per sum, count and size aggregate of every ``groupby_local`` call.
    A groupby calls it once, or twice when it shuffles with
    pre-aggregation (``bsp`` / ``bsp_staged`` only; ``amt`` ships raw
    rows)."""
    from repro_torch.dataframe.groupby import _normalize
    total = 0
    for n in pplan.order:
        if n.op != "groupby":
            continue
        physical, _ = _normalize(n.params["aggs"])
        sums = sum(a in ("sum", "count", "size")
                   for names in physical.values() for a in names)
        two = (mode != "amt" and not n.params.get("elide_shuffle")
               and n.params.get("pre_aggregate", False))
        total += sums * (2 if two else 1)
    return total


def check_launches(counts, pplan, mode, st, on_card, label):
    """One radix launch per direct shuffle (none on ``amt``'s all-gather)
    and one segmented_sum launch per sum / count / size aggregate of every
    ``groupby_local`` call (``amt`` included), on the card; none on the CPU
    (plain versions)."""
    want = st.num_shuffles if on_card and mode != "amt" else 0
    check(counts["radix_partition"] == want, f"{label}: radix_partition "
          f"launched {counts['radix_partition']} times, want {want}")
    want = segsum_launches_expected(pplan, mode) if on_card else 0
    check(counts["segmented_sum"] == want and (want or not on_card),
          f"{label}: segmented_sum launched {counts['segmented_sum']} "
          f"times, want {want} > 0")


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
    from repro_torch.planner import compile_plan
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
    pplan = compile_plan(plan, tables)
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
            check_launches(counts, pplan, mode, st, on_card, f"{mode}/{run}")
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
        profile_run(env, lambda: execute(plan, env, tables, mode="bsp"),
                    "bsp (cached run under the profiler)")
    return launches, walls


def fig9_frontend(l_df, r_df, cap):
    """The Fig-9 pipeline written against ``repro_torch.df`` (the shape of
    ``tests/test_df_frontend.py::fig9_frontend``, without its filter)."""
    from repro_torch.expr import col
    return (l_df.merge(r_df, on="k", out_capacity=4 * cap)
            .groupby("k").agg({"v0": ["sum", "mean"]})
            .sort_values("k")
            .assign(v0_sum=col("v0_sum") + 1.0))


def fig9_with_plan(Plan, cap):
    """The same pipeline built with ``Plan``."""
    from repro_torch.expr import col
    return (Plan.scan("l").join(Plan.scan("r"), on="k", out_capacity=4 * cap)
            .groupby(["k"], {"v0": ["sum", "mean"]}).sort(["k"])
            .with_columns({"v0_sum": col("v0_sum") + 1.0}))


def frontend_phase(torch, rows=FULL_ROWS, device=None):
    """Fig-9 through ``repro_torch.df`` at ``rows`` per table over ``P``
    stacked ranks, with the main path's data and capacities, in every mode,
    first and cached; held to the host reference, and to the same
    pipeline built with ``Plan`` and run through ``execute`` (equal
    EXPLAIN, equal result, and no stage built anew).  Returns (launches,
    wall times) by ``"<mode>/<run>"``."""
    import repro_torch.df as rdf
    from repro_torch.core import Plan, execute
    from repro_torch.kernels import CUDA_KERNELS, reset_launches
    from repro_torch.planner import compile_plan
    t0 = time.perf_counter()
    ld, rd = make_table_data(rows, 0), make_table_data(rows, 1)
    cap = capacity_for(rows, P)
    ref = host_reference(ld, rd)
    cnt_l = np.bincount(ld["k"])[ref[1]]
    means = np.bincount(ld["k"], weights=ld["v0"].astype(np.float64)
                        )[ref[1]] / cnt_l
    walls, launches = {}, {}
    with rdf.session(parallelism=P, device=device) as env:
        front = fig9_frontend(rdf.read_numpy(ld, capacity=cap, name="l"),
                              rdf.read_numpy(rd, capacity=cap, name="r"), cap)
        env.synchronize()
        on_card = env.device.type == "cuda"
        print(f"frontend: 2 x {rows} rows over {P} stacked ranks through "
              f"repro_torch.df; set-up {time.perf_counter() - t0:.2f} s",
              flush=True)
        text = front.explain()
        print(text, flush=True)
        plan = fig9_with_plan(Plan, cap)
        check(plan.explain(front.sources) == text,
              "frontend EXPLAIN differs from the Plan-built pipeline's")
        pplan = compile_plan(front.plan, front.sources)
        for mode in ("bsp", "bsp_staged", "amt"):
            for run in ("first", "cached"):
                env.synchronize()
                reset_launches()
                t = time.perf_counter()
                res, st = front.collect(mode=mode, collect_stats=True)
                env.synchronize()
                wall = time.perf_counter() - t
                counts = {k.name: k.launches for k in CUDA_KERNELS}
                label = f"frontend {mode}/{run}"
                walls[f"{mode}/{run}"], launches[f"{mode}/{run}"] = \
                    wall, counts
                check_launches(counts, pplan, mode, st, on_card, label)
                if run == "cached":
                    check(st.cache_misses == 0, f"{label}: "
                          f"{st.cache_misses} cache misses")
                print(f"fig9 frontend {mode:10s} {run:6s} wall "
                      f"{wall * 1e3:9.2f} ms  dispatches={st.dispatches} "
                      f"cache_hits={st.cache_hits} "
                      f"cache_misses={st.cache_misses} launches={counts}",
                      flush=True)
                check_fig9(res, st, ref, label)
                got = res.to_numpy()
                rel = (np.abs(got["v0_mean"] - means)
                       / np.maximum(np.abs(means), 1.0))
                check(float(rel.max()) <= 1e-3, f"{label}: v0_mean off by "
                      f"{rel.max()}")
                del res
            # the Plan-built pipeline reuses the frontend's stages
            built, st = execute(plan, env, front.sources, mode=mode,
                                collect_stats=True)
            check(st.cache_misses == 0, f"Plan-built {mode}: "
                  f"{st.cache_misses} stages built anew")
            want = built.to_numpy()
            check(sorted(want) == sorted(got) and all(
                np.array_equal(got[c], want[c]) for c in got),
                f"frontend {mode}: result differs from the Plan-built one")
            print(f"fig9 frontend {mode}: equal to the Plan-built pipeline "
                  f"({len(got['k'])} groups)", flush=True)
            del built, want, got
    return launches, walls


def strings_phase(torch, rows=1 << 22, vocab=1 << 18, device=None):
    """A string-keyed run through ``repro_torch.df``: two tables of
    ``rows`` fixed-width ``<U12`` keys drawn from ``vocab`` words, whose
    dictionaries differ (left from the first 3/4 of the words, right from
    the last 3/4), merged (EXPLAIN shows ``recode[...]``), grouped with
    sum and count, sorted, and held to numpy on the host.  Returns
    (launches, wall times) by run."""
    import repro_torch.df as rdf
    from repro_torch.kernels import CUDA_KERNELS, reset_launches
    from repro_torch.planner import compile_plan
    rng = np.random.default_rng(5)
    words = np.array([f"w{i:011d}" for i in range(vocab)])
    li = rng.integers(0, 3 * vocab // 4, rows)
    ri = rng.integers(vocab // 4, vocab, rows)
    ld = {"s": words[li], "v": rng.random(rows).astype(np.float32)}
    rd = {"s": words[ri], "w": rng.random(rows).astype(np.float32)}
    # the host reference works on the word indices, not on the encoder's
    # codes: the words sort as their indices do
    cnt_l = np.bincount(li, minlength=vocab)
    cnt_r = np.bincount(ri, minlength=vocab)
    pairs = cnt_l * cnt_r
    both = pairs > 0
    keys, sizes = words[both], pairs[both]
    sums = (np.bincount(li, weights=ld["v"].astype(np.float64),
                        minlength=vocab) * cnt_r)[both]
    cap, out_cap = capacity_for(rows, P), capacity_for(int(pairs.sum()), P)
    walls, launches = {}, {}
    with rdf.session(parallelism=P, device=device) as env:
        t = time.perf_counter()
        l_df = rdf.read_numpy(ld, capacity=cap, name="ls")
        r_df = rdf.read_numpy(rd, capacity=cap, name="rs")
        env.synchronize()
        print(f"strings: 2 x {rows} {ld['s'].dtype} keys from {vocab} words "
              f"over {P} stacked ranks; host encode + copy "
              f"{time.perf_counter() - t:.2f} s; expect {int(pairs.sum())} "
              f"join rows, {len(keys)} groups", flush=True)
        on_card = env.device.type == "cuda"
        q = (l_df.merge(r_df, on="s", out_capacity=out_cap)
             .groupby("s").agg({"v": ["sum", "count"]}).sort_values("s"))
        text = q.explain()
        print(text, flush=True)
        check("recode[s:|D|=" in text and "recode: join(s)" in text,
              "strings: EXPLAIN shows no recode")
        pplan = compile_plan(q.plan, q.sources)
        for run in ("first", "cached"):
            env.synchronize()
            reset_launches()
            t = time.perf_counter()
            res, st = q.collect(collect_stats=True)
            env.synchronize()
            wall = time.perf_counter() - t
            counts = {k.name: k.launches for k in CUDA_KERNELS}
            walls[run], launches[run] = wall, counts
            label = f"strings bsp/{run}"
            check_launches(counts, pplan, "bsp", st, on_card, label)
            check(st.rows_dropped == 0, f"{label}: {st.rows_dropped} rows "
                  f"dropped")
            if run == "cached":
                check(st.cache_misses == 0, f"{label}: {st.cache_misses} "
                      f"cache misses")
            t = time.perf_counter()
            out = res.to_numpy()
            decode = time.perf_counter() - t
            check(res.dictionaries["s"] == tuple(
                words[(cnt_l + cnt_r) > 0]), f"{label}: the result's "
                f"dictionary is not the merged one")
            check(np.array_equal(out["s"], keys), f"{label}: group keys "
                  f"differ")
            check(np.array_equal(out["v_count"], sizes), f"{label}: "
                  f"counts differ")
            rel = np.abs(out["v_sum"] - sums) / np.maximum(np.abs(sums), 1.0)
            check(float(rel.max()) <= 1e-3, f"{label}: v_sum off by "
                  f"{rel.max()}")
            print(f"strings {run:6s} wall {wall * 1e3:9.2f} ms "
                  f"(decode {decode * 1e3:.1f} ms) dispatches="
                  f"{st.dispatches} cache_misses={st.cache_misses} "
                  f"launches={counts}: {len(keys)} groups equal to numpy",
                  flush=True)
            del res, out
        # the host's share of a run: planning alone (every collect
        # compiles the plan, dictionaries and recode tables included)
        t = time.perf_counter()
        compile_plan(q.plan, q.sources)
        print(f"strings: compile_plan (host) {time.perf_counter() - t:.3f} s "
              f"of the cached run's {walls['cached']:.3f} s", flush=True)
        if on_card:
            profile_run(env, q.collect,
                        "strings bsp (cached run under the profiler)")
    return launches, walls


def profile_run(env, run, title, top=10):
    """One more cached run, ``run()``, under ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile
    env.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        env.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    report_profile(prof, wall_ms, title, top)


def report_profile(prof, wall_ms, title, top=10):
    """Device time by PyTorch operator and by kernel, and the device's
    busy share of the window's wall time (the profiler's own overhead is
    in that wall time)."""
    from torch.autograd import DeviceType

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
        print(f"profile {title}: the profiler recorded no device time; "
              f"device busy share not measured", flush=True)
        return
    print(f"profile {title}: wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.1f}%, idle "
          f"{100 - 100 * busy / wall_ms:.1f}%), {sum(e.count for e in kernels)}"
          f" kernel launches", flush=True)
    for name, rows in (("by operator", ops), ("by kernel", kernels)):
        print(f"profile {title}, device time {name}:")
        for e in sorted(rows, key=dev_ms, reverse=True)[:top]:
            print(f"  {dev_ms(e):9.2f} ms {100 * dev_ms(e) / busy:5.1f}% "
                  f"{e.count:5d}x  {e.key[:100]}")


def profile_serve(torch, engine, prompts, arch, steps=8, top=8):
    """One prefill, then ``steps`` greedy decode steps, each window under
    ``torch.profiler``: where the device time goes and how much of the
    wall time the device is idle."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    tokens = torch.as_tensor(prompts, dtype=torch.long, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        logits, caches = engine.prefill(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    report_profile(prof, wall_ms, f"{arch} prefill", top)
    s0 = tokens.shape[1]
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        for step in range(steps):
            tok = torch.argmax(logits, dim=-1)
            pos = torch.full((tokens.shape[0],), s0 + step,
                             dtype=torch.int32, device="cuda")
            logits = engine.decode_step(caches, tok[:, None], pos)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    report_profile(prof, wall_ms, f"{arch} decode x{steps}", top)


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


def flash_flops(sq, sk, d, bhq, causal):
    """FLOPs the attention needs: 4 D per visible (query, key) pair (Q K^T
    and P V); a causal query i sees keys <= i + Sk - Sq."""
    if causal:
        vis = np.minimum(np.arange(sq) + (sk - sq) + 1, sk).sum()
    else:
        vis = sq * sk
    return 4.0 * d * bhq * float(vis)


def flash_phase(torch, flush):
    """Flash-attention kernel vs ``attention_ref`` on the card; returns the
    per-case records (the first is the main path's shape, f32)."""
    import torch.nn.functional as F
    from repro_torch.kernels import attention_ref, flash_attention_cuda
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    # (b, hq, hkv, sq, sk, d, causal, dtype): the qwen3-8b prefill at a
    # 4096-token prompt in f32 and bf16, Sq != Sk, a length off the 64-row
    # tile, non-causal over ragged keys
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [("main", 4, 32, 8, 4096, 4096, 128, True, f32),
             ("main:bf16", 4, 32, 8, 4096, 4096, 128, True, bf16),
             ("sq<sk", 4, 32, 8, 1024, 4096, 128, True, f32),
             ("ragged", 2, 32, 8, 4000, 4000, 128, True, f32),
             ("noncausal", 2, 32, 8, 1000, 3001, 128, False, f32)]
    out = []
    for name, b, hq, hkv, sq, sk, d, causal, dt in cases:
        q = torch.randn(b, hq, sq, d, generator=gen, device=dev).to(dt)
        k = torch.randn(b, hkv, sk, d, generator=gen, device=dev).to(dt)
        v = torch.randn(b, hkv, sk, d, generator=gen, device=dev).to(dt)
        got = flash_attention_cuda(q, k, v, causal)
        want = attention_ref(q, k, v, causal)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        # tests/test_kernels.py's tolerances: 2e-3 in f32; 2e-2 in bf16,
        # held relative to each output (plus 2e-3), since the outputs of
        # late query rows are an order of magnitude under those of the
        # first rows and an absolute 2e-2 would pass a dropped key tile
        if dt == f32:
            ok, tol = err <= 2e-3, "2e-3"
        else:
            ok = bool((diff <= 2e-2 * want.float().abs() + 2e-3).all())
            tol = "2e-2 |want| + 2e-3"
        check(ok, f"flash_attention CUDA != plain at {name}: max |err| "
              f"{err} beyond {tol}")
        del got, want
        ms = time_cuda(torch, lambda: flash_attention_cuda(q, k, v, causal),
                       10, flush)
        plain_ms = time_cuda(torch, lambda: attention_ref(q, k, v, causal),
                             3, flush)
        lib_ms = None
        if name.startswith("main"):
            lib_ms = time_cuda(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 10, flush)
        flops = flash_flops(sq, sk, d, b * hq, causal)
        nbytes = (q.numel() * 2 + 2 * k.numel()) * q.element_size()
        peak = F32_FLOPS if dt == f32 else BF16_FLOPS
        bound_ms = max(flops / peak, nbytes / HBM_BYTES_PER_S) * 1e3
        out.append(dict(case=name, shape=[b, hq, hkv, sq, sk, d],
                        causal=causal, dtype=str(dt).split(".")[-1], ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=("operations" if flops / peak
                                  >= nbytes / HBM_BYTES_PER_S else "bytes"),
                        peak=("f32 67 TFLOP/s" if dt == f32
                              else "bf16 dense 989 TFLOP/s"),
                        library_ms=lib_ms, max_abs_err=err))
        lib = f", sdpa {lib_ms:.3f} ms" if lib_ms is not None else ""
        print(f"kernel flash_attention {name:9s} {out[-1]['dtype']} "
              f"b={b} hq={hq} hkv={hkv} sq={sq} sk={sk} d={d} "
              f"causal={causal}: {ms:.3f} ms (plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.3f} ms{lib}), max |err| {err:.2e}",
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    return out


def ssd_counts(bh, t, p, n, chunk):
    """(FLOPs, bytes) the SSD scan needs: per chunk of length l, the
    lower triangle of C B^T (l(l+1)/2 N) and of M X (l(l+1)/2 P), C h and
    B^T X (l N P each), two FLOPs per multiply-add; each input read and
    each output written once, float32."""
    ch = min(chunk, -(-t // 8) * 8)
    macs = 0
    for t0 in range(0, t, ch):
        ln = min(ch, t - t0)
        macs += ln * (ln + 1) // 2 * (n + p) + 2 * ln * n * p
    nbytes = 4 * bh * (t * p + t + 1 + 2 * t * n + t * p + n * p)
    return 2.0 * bh * macs, nbytes


def ssd_phase(torch, flush):
    """SSD-scan kernel vs ``ssd_scan_chunked`` on the card; the first case
    is the mamba2-780m prefill at a 4096-token prompt (B*nh = 4*48)."""
    from repro_torch.kernels import ssd_scan, ssd_scan_chunked
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    cases = [("main", 192, 4096, 64, 128, 128),
             ("ragged", 192, 4000, 64, 128, 128),    # last chunk 32 rows
             ("short", 48, 13, 64, 128, 128),        # T < chunk, off 8
             ("smoke", 8, 100, 16, 16, 32)]          # the SMOKE dims
    out = []
    for name, bh, t, p, n, chunk in cases:
        x = torch.randn(bh, t, p, generator=gen, device=dev)
        dt = torch.rand(bh, t, 1, generator=gen, device=dev) * 0.1 + 0.01
        a = -torch.rand(bh, 1, generator=gen, device=dev) - 0.05
        b = torch.randn(bh, t, n, generator=gen, device=dev)
        c = torch.randn(bh, t, n, generator=gen, device=dev)
        ch = min(chunk, -(-t // 8) * 8)
        y, h = ssd_scan(x, dt, a, b, c, chunk=chunk)
        y_p, h_p = ssd_scan_chunked(x, dt, a, b, c, chunk=ch)
        torch.cuda.synchronize()
        err = max(float((y - y_p).abs().max()), float((h - h_p).abs().max()))
        check(err <= 3e-3, f"ssd_scan CUDA != plain at {name}: {err} > 3e-3")
        ms = time_cuda(torch, lambda: ssd_scan(x, dt, a, b, c, chunk=chunk),
                       10, flush)
        plain_ms = time_cuda(torch, lambda: ssd_scan_chunked(
            x, dt, a, b, c, chunk=ch), 3, flush)
        flops, nbytes = ssd_counts(bh, t, p, n, chunk)
        op_ms, byte_ms = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
        out.append(dict(case=name, shape=[bh, t, p, n, chunk], ms=ms,
                        plain_ms=plain_ms, bound_ms=max(op_ms, byte_ms),
                        bound_by="operations" if op_ms >= byte_ms else "bytes",
                        library_ms=None, max_abs_err=err))
        print(f"kernel ssd_scan {name:6s} bh={bh} t={t} p={p} n={n} "
              f"chunk={chunk}: {ms:.3f} ms (plain {plain_ms:.3f} ms, bound "
              f"{max(op_ms, byte_ms):.3f} ms by {out[-1]['bound_by']}), "
              f"max |err| {err:.2e}", flush=True)
        del x, dt, a, b, c, y, h, y_p, h_p
        torch.cuda.empty_cache()
    return out


def instrument(torch, engine, rec):
    """Wrap the engine's prefill and decode step: kernel launch counts are
    reset just before each call and read just after it; the prefill is
    timed to its end on the device (time to first token) and its logits
    are checked finite."""
    from repro_torch.kernels import CUDA_KERNELS, reset_launches
    prefill, decode = engine.prefill, engine.decode_step

    def counts():
        return {k.name: k.launches for k in CUDA_KERNELS}

    def counted_prefill(tokens):
        reset_launches()
        t = time.perf_counter()
        logits, caches = prefill(tokens)
        torch.cuda.synchronize()
        rec["prefill_s"] = time.perf_counter() - t
        rec["prefill"] = counts()
        check(bool(torch.isfinite(logits[:, :engine.cfg.vocab_size]).all()),
              "prefill logits are not finite")
        return logits, caches

    def counted_decode(caches, tokens, pos):
        reset_launches()
        logits = decode(caches, tokens, pos)
        rec["decode"].append(counts())
        rec["last_logits"] = logits
        return logits

    engine.prefill, engine.decode_step = counted_prefill, counted_decode


def serve_phase(torch, smi, seed=0):
    """qwen3-8b and mamba2-780m at full width through ``ServeEngine``;
    returns per-arch records of the first and the cached run."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.serve import ServeEngine
    dev = torch.device("cuda")
    results = {}
    for arch, batch, prompt, new in SERVE_CASES:
        cfg = get_config(arch)
        t = time.perf_counter()
        gen = torch.Generator(device=dev).manual_seed(seed)
        model = transformer.init_params(cfg, gen, torch.float32, dev)
        torch.cuda.synchronize()
        n_params = sum(p.numel() for p in model.parameters())
        print(f"serve {arch}: {n_params / 1e9:.3f} B float32 parameters "
              f"({n_params * 4 / 2**30:.2f} GiB) made on the card in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        engine = ServeEngine(cfg, model, cache_len=prompt + new)
        prompts = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (batch, prompt)).astype(np.int32)
        kname = SERVE_KERNEL[arch]
        runs = {}
        for run in ("first", "cached"):
            rec = {"decode": []}
            instrument(torch, engine, rec)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            res = engine.generate(prompts, max_new_tokens=new)
            total = time.perf_counter() - t
            del engine.prefill, engine.decode_step   # the unwrapped methods
            peak = torch.cuda.max_memory_allocated()
            toks = res.tokens
            check(res.steps == new and toks.shape == (batch, new),
                  f"{arch}/{run}: {toks.shape} tokens in {res.steps} steps")
            check(int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size,
                  f"{arch}/{run}: token ids outside [0, {cfg.vocab_size})")
            check(bool(torch.isfinite(
                rec["last_logits"][:, :cfg.vocab_size]).all()),
                f"{arch}/{run}: decode logits are not finite")
            pre = rec["prefill"][kname]
            check(pre == cfg.num_layers, f"{arch}/{run}: {kname} launched "
                  f"{pre} times in prefill, want {cfg.num_layers}")
            dec = [c[kname] for c in rec["decode"]]
            check(len(dec) == new and not any(dec), f"{arch}/{run}: "
                  f"{kname} launched in decode: {dec}")
            decode_s = total - rec["prefill_s"]
            r = dict(ttft_s=rec["prefill_s"], total_s=total,
                     decode_ms_per_step=decode_s / len(dec) * 1e3,
                     tok_per_s=batch * res.steps / total,
                     decode_tok_per_s=batch * len(dec) / decode_s,
                     peak_gib=peak / 2**30, prefill_launches=rec["prefill"],
                     decode_launches=sum(c[kname] for c in rec["decode"]),
                     launches=pre + sum(dec))
            runs[run] = r
            print(f"serve {arch} {run:6s} batch={batch} prompt={prompt} "
                  f"new={new}: time to first token {r['ttft_s']:.3f} s, "
                  f"decode {r['decode_ms_per_step']:.2f} ms/step "
                  f"({r['decode_tok_per_s']:.1f} tok/s), overall "
                  f"{r['tok_per_s']:.1f} tok/s, peak device memory "
                  f"{r['peak_gib']:.2f} GiB; {kname} launches: prefill "
                  f"{pre}, decode {sum(dec)} over {len(dec)} steps [{smi}]",
                  flush=True)
            print(f"serve {arch} {run} first sequence: "
                  f"{toks[0, :12].tolist()}...", flush=True)
        results[arch] = runs
        profile_serve(torch, engine, prompts, arch)
        del engine, model
        torch.cuda.empty_cache()
    return results


def serve_parity_phase(torch, devices=("cuda", "cpu"), prompt=160, new=8):
    """The SMOKE configs with the same weights on ``devices``: the card
    forces the kernels (``flash`` / ``kernel``) at a prompt longer than
    the flash tile (64) and the smoke chunk (32); the CPU runs the plain
    versions.  Prefill logits within 1e-3, greedy tokens equal."""
    import copy
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import CUDA_KERNELS, reset_launches
    from repro_torch.models import transformer
    for arch, _, _, _ in SERVE_CASES:
        cfg = get_smoke_config(arch)
        base = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                       torch.float32, "cpu")
        prompts = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (2, prompt)).astype(np.int32)
        logits, tokens = {}, {}
        for device in devices:
            model = copy.deepcopy(base).to(device)
            reset_launches()
            lg, caches = transformer.prefill(
                model, torch.as_tensor(prompts, dtype=torch.long,
                                       device=device),
                prompt + new, KERNEL_IMPL[arch])
            counts = {k.name: k.launches for k in CUDA_KERNELS}
            want = cfg.num_layers if device != "cpu" else 0
            check(counts[SERVE_KERNEL[arch]] == want, f"parity {arch} "
                  f"{device}: {counts} launches, want {want}")
            logits[device] = lg.cpu()
            # greedy decoding after the forced-kernel prefill, as
            # ServeEngine.generate does after its own
            out = []
            for step in range(new):
                tok = torch.argmax(lg, dim=-1)
                out.append(tok)
                pos = torch.full((tok.shape[0],), prompt + step,
                                 dtype=torch.int32, device=device)
                lg = transformer.decode_step(model, caches, tok[:, None],
                                             pos)
            tokens[device] = torch.stack(out, dim=1).cpu().numpy()
        err = float((logits[devices[0]] - logits[devices[-1]]).abs().max())
        check(err <= 1e-3, f"parity {arch}: prefill logits differ by {err}")
        check(np.array_equal(tokens[devices[0]], tokens[devices[-1]]),
              f"parity {arch}: greedy tokens differ")
        print(f"serve parity {arch} smoke, prompt {prompt}, impl "
              f"{KERNEL_IMPL[arch]}: card == cpu (prefill logits max |err| "
              f"{err:.2e}, {new} greedy tokens equal)", flush=True)


def build_all():
    """Build every kernel: one nvcc per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import CUDA_KERNELS
    from repro_torch.kernels.build import build, build_log
    t = time.perf_counter()
    with ThreadPoolExecutor(len(CUDA_KERNELS)) as pool:
        for done in [pool.submit(build, k.name) for k in CUDA_KERNELS]:
            done.result()
    print(f"built {[k.name for k in CUDA_KERNELS]} in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for k in CUDA_KERNELS:
        print(build_log(k.name).strip(), flush=True)


def kernel_record(k, cases, launches, launches_by_run=None):
    """The kernels-line entry of wrapper ``k``: the main-shape case's
    numbers, the main path's launch count and every case beside them."""
    main = cases[0]
    rec = {"name": k.name, "route": "cuda", "source": k.source,
           "replaces": k.replaces, "launches": launches,
           "max_abs_err": max(c["max_abs_err"] for c in cases),
           "ms": main["ms"], "plain_ms": main["plain_ms"],
           "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
           "library_ms": main["library_ms"]}
    if launches_by_run is not None:
        rec["launches_by_run"] = launches_by_run
    rec["cases"] = cases
    return rec


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import (flash_attention_cuda,
                                     radix_partition_cuda,
                                     segmented_sum_cuda, ssd_scan_cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    t0 = time.perf_counter()
    build_all()

    def phase_done(name):
        torch.cuda.empty_cache()
        print(f"phase {name} done at {time.perf_counter() - t0:.1f} s",
              flush=True)

    flush = torch.empty(2 * L2_BYTES, dtype=torch.uint8, device="cuda")
    cap = capacity_for(FULL_ROWS, P)
    radix_cases = radix_phase(torch, cap, flush)
    segsum_cases = segsum_phase(torch, cap, flush)
    flash_cases = flash_phase(torch, flush)
    ssd_cases = ssd_phase(torch, flush)
    del flush
    phase_done("kernels")
    launches, walls = main_path_phase(torch)
    for k in ("radix_partition", "segmented_sum"):
        check(launches["bsp/first"][k] > 0, f"{k} never launched on the "
              f"Fig-9 path")
    phase_done("fig9")
    front_launches, front_walls = frontend_phase(torch)
    phase_done("frontend")
    str_launches, str_walls = strings_phase(torch)
    phase_done("strings")
    parity_phase()
    phase_done("fig9 parity")
    served = serve_phase(torch, smi)
    phase_done("serve")
    serve_parity_phase(torch)
    phase_done("serve parity")

    rp, ss = radix_partition_cuda, segmented_sum_cuda
    kernels = [
        # the Fig-9 path is the first bsp run; every run's count beside it
        kernel_record(rp, radix_cases, launches["bsp/first"][rp.name],
                      {run: c[rp.name] for run, c in launches.items()}),
        kernel_record(ss, segsum_cases, launches["bsp/first"][ss.name],
                      {run: c[ss.name] for run, c in launches.items()}),
        # the serving paths are the first run of each arch
        kernel_record(flash_attention_cuda, flash_cases,
                      served["qwen3-8b"]["first"]["launches"]),
        kernel_record(ssd_scan_cuda, ssd_cases,
                      served["mamba2-780m"]["first"]["launches"]),
    ]
    print(json.dumps({"fig9_wall_s": walls}))
    print(json.dumps({"frontend_wall_s": front_walls,
                      "frontend_launches": front_launches,
                      "strings_wall_s": str_walls,
                      "strings_launches": str_launches}))
    print(json.dumps({"serve": {arch: {run: {k: v for k, v in r.items()
                                             if k != "prefill_launches"}
                                       for run, r in runs.items()}
                                for arch, runs in served.items()}}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
