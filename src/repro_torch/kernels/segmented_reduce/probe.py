"""Both segmented-sum routes at the main paths' shapes, on the card.

    PYTHONPATH=src python -m repro_torch.kernels.segmented_reduce.probe

Needs a CUDA card.  Builds, from a seed, ids laid out as ``groupby_local``
hands them over (sorted per rank, valid rows' ids counting up, padding rows
at S - 1) at the served queries', the served join's, the out-of-core
morsels' and combine's and the fixed-cost shapes, the salted groupby's 99%
segment (whole, and its two parts), and a C = 4 case; holds each route to
the plain version; and prints each route's time in turns (atomic, sorted,
sorted, atomic; CUDA events, L2 overwritten before each call, host enqueue
included as in ``chip_smoke``), the device time of each kernel of a call
(``torch.profiler``) and the wrapper's host time per call, with its parts.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from . import segmented_sum_cuda as kernel
from .ref import segmented_sum_ref

#: bytes overwritten before each timed call (twice the H100's 50 MB L2)
FLUSH_BYTES = 100 << 20
HBM_BYTES_PER_S = 3.35e12


def groupby_ids(gen, p, n, valid, distinct, dev):
    """(p, n) int32 ids and float32 values as ``groupby_local`` hands them
    over: ``valid`` rows a rank of keys uniform over ``distinct`` values,
    sorted, numbered from 0 by key, with values in [0, 1); the other rows
    padding at n - 1 with value 0."""
    keys = torch.sort(torch.randint(0, distinct, (p, valid), generator=gen,
                                    device=dev), dim=1).values
    change = torch.ones_like(keys, dtype=torch.bool)
    change[:, 1:] = keys[:, 1:] != keys[:, :-1]
    ids = torch.full((p, n), n - 1, dtype=torch.int32, device=dev)
    ids[:, :valid] = torch.cumsum(change, dim=1, dtype=torch.int32) - 1
    vals = torch.zeros((p, n), device=dev)
    vals[:, :valid] = torch.rand((p, valid), generator=gen, device=dev)
    return ids, vals


def cases(dev):
    gen = torch.Generator(device=dev).manual_seed(21)
    out = []

    def add(name, ids, vals, s):
        out.append((name, ids, vals, s))

    # served groupby: 2 ranks of 2**23, 6.26 M valid, keys at 90% of 2**24
    add("served", *groupby_ids(gen, 2, 1 << 23, 6_257_000,
                               int(0.9 * (1 << 24)), dev), 1 << 23)
    # served join input: 2 ranks of 2**25, 3.32 M valid
    add("served-join", *groupby_ids(gen, 2, 1 << 25, 3_317_000, 3_317_000,
                                    dev), 1 << 25)
    # out-of-core morsel partials: 8 ranks of 2**21 (the morsel join's
    # capacity), about a quarter valid
    add("morsel", *groupby_ids(gen, 8, 1 << 21, 550_000, 520_000, dev),
        1 << 21)
    # out-of-core combine bucket: 8 ranks of 439,920, 90% valid
    add("combine", *groupby_ids(gen, 8, 439_920, 395_928, 300_000, dev),
        439_920)
    # the salted groupby's 99% segment, int32 values
    n = 4_194_304
    hot = torch.where(
        torch.rand((8, n), generator=gen, device=dev) < 0.99, 7,
        torch.randint(0, n, (8, n), generator=gen, device=dev,
                      dtype=torch.int32)).to(torch.int32)
    hot = torch.sort(hot, dim=1).values
    add("hot", hot, torch.randint(
        0, 100, (8, n), generator=gen, device=dev, dtype=torch.int32), n)
    # its two parts: the run of 7s alone, and the ids after it alone
    add("hot-run", torch.full((8, n), 7, dtype=torch.int32, device=dev),
        torch.randint(0, 100, (8, n), generator=gen, device=dev,
                      dtype=torch.int32), n)
    tail = (hot[:, -41_984:] + 0).contiguous()
    add("hot-tail", tail, torch.randint(0, 100, tail.shape, generator=gen,
                                        device=dev, dtype=torch.int32), n)
    # fixed cost: 4,096 rows at the served S
    add("fixed", (torch.arange(4096, device=dev, dtype=torch.int32) // 2)
        .expand(2, 4096).contiguous(), torch.rand((2, 4096), generator=gen,
                                                  device=dev), 1 << 23)
    # C = 4
    ids = torch.sort(torch.randint(0, 1 << 18, (8, 1 << 20), generator=gen,
                                   device=dev, dtype=torch.int32),
                     dim=1).values
    add("c4", ids, torch.rand((8, 1 << 20, 4), generator=gen, device=dev),
        1 << 18)
    add("sweep64", torch.sort(torch.randint(0, 5, (1, 64), generator=gen,
                                            device=dev, dtype=torch.int32),
                              dim=1).values,
        torch.rand((1, 64), generator=gen, device=dev), 5)
    return out


def time_ms(fn, iters, flush):
    """Milliseconds of each of ``iters`` calls, timed with CUDA events
    after overwriting ``flush``."""
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
    return times


def device_us(fn, calls=5):
    """Mean device microseconds a call, by kernel (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:40]: round(e.device_time_total / calls, 1)
            for e in prof.key_averages() if e.device_time_total > 0}


def host_us(fn, calls=200):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    fixed = None
    for name, ids, vals, s in cases(dev):
        if name == "fixed":
            fixed = ids, vals, s
        p, n = ids.shape
        c = vals.shape[2] if vals.dim() == 3 else 1
        want = segmented_sum_ref(ids, vals, s)
        for route in ("atomic", "sorted"):
            got = kernel(ids, vals, s, sorted_ids=route == "sorted")
            if vals.dtype.is_floating_point:
                ok = bool(((got - want).abs()
                           <= 1e-5 * want.abs() + 1e-5).all())
            else:
                ok = torch.equal(got, want)
            if not ok:
                print(f"{name}: {route} route != plain", flush=True)
                return 1
        samples = {"atomic": [], "sorted": []}
        for route in ("atomic", "sorted", "sorted", "atomic"):
            samples[route] += time_ms(
                lambda r=route: kernel(ids, vals, s,
                                       sorted_ids=r == "sorted"), 10, flush)
        nbytes = 4 * p * n + vals.element_size() * c * (p * n + p * s)
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        ms = {r: float(np.median(v)) for r, v in samples.items()}
        print(f"{name:12s} p={p} n={n} S={s} C={c}: bound {bound:.4f} ms; "
              f"atomic {ms['atomic']:.4f} ms, sorted {ms['sorted']:.4f} ms "
              f"({bound / ms['sorted']:.0%} of bound); sorted device us "
              f"{device_us(lambda: kernel(ids, vals, s, sorted_ids=True))}; "
              f"atomic device us "
              f"{device_us(lambda: kernel(ids, vals, s))}", flush=True)
    ids, vals, s = fixed
    lib = kernel._load()
    out = torch.empty((2, s), device=dev)
    scratch = torch.empty(lib.segmented_sum_sorted_scratch(2, 4096, s, 1, 0),
                          dtype=torch.uint8, device=dev)
    raw = torch._C._cuda_getCurrentRawStream(0)
    parts = {
        "wrapper sorted": lambda: kernel(ids, vals, s, sorted_ids=True),
        "wrapper atomic": lambda: kernel(ids, vals, s),
        "launch sorted": lambda: lib.segmented_sum_sorted(
            ids.data_ptr(), vals.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), 2, 4096, s, 1, 0, raw),
        "launch atomic": lambda: lib.segmented_sum_launch(
            ids.data_ptr(), vals.data_ptr(), out.data_ptr(), 2, 4096, s, 1,
            0, raw),
        "torch.empty": lambda: torch.empty((2, s), device=dev),
        "new_empty": lambda: vals.new_empty((2, s)),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "raw stream": lambda: torch._C._cuda_getCurrentRawStream(0),
        "scratch size": lambda: lib.segmented_sum_sorted_scratch(
            2, 4096, s, 1, 0)}
    print("host us a call at the fixed-cost shape: " + ", ".join(
        f"{k} {host_us(f):.1f}" for k, f in parts.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
