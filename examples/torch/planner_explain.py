"""Query-optimizer demo on the port: EXPLAIN + optimized vs unoptimized
execution, written against the lazy DataFrame frontend
(``examples/planner_explain.py`` in PyTorch).

Builds the paper's Fig-9 pipeline with a dead column, a conjunction
filter whose sides split across the join inputs, and a derived column,
prints both EXPLAIN plans (the JAX package's text), then executes both
and compares wall-clock, shuffle volume, and result parity.

The JAX example's 8 host devices are 8 stacked ranks on one device here
(``rdf.session(parallelism=8)``).  ``--device`` defaults to ``cuda`` and
raises without a card; ``--device cpu`` runs the plain PyTorch path.
``--out FILE`` saves both results and each kernel's launches (npz).

  PYTHONPATH=src python examples/torch/planner_explain.py [--device cpu]
"""

import argparse
import time

import numpy as np

import repro_torch.df as rdf
from repro_torch.core import DistTable, resolve_device
from repro_torch.expr import col
from repro_torch.kernels import CUDA_KERNELS

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda or cpu")
ap.add_argument("--out", default=None, metavar="FILE",
                help="save the results and the kernels' launches (npz)")
args = ap.parse_args()
device = resolve_device(args.device)
P = 8                       # the JAX example's host devices

rng = np.random.default_rng(0)
N = 50_000
left = {"k": rng.integers(0, int(N * 0.9), N).astype(np.int32),
        "v0": rng.random(N).astype(np.float32),
        "junk": rng.random(N).astype(np.float32)}   # never used downstream
right = {"k": rng.integers(0, int(N * 0.9), N).astype(np.int32),
         "w": rng.random(N).astype(np.float32)}

with rdf.session(parallelism=P, device=device) as env:
    lt = DistTable.from_numpy(left, env.parallelism, device=device)
    rt = DistTable.from_numpy(right, env.parallelism, device=device)
    cap = lt.capacity
    l, r = rdf.from_table(lt), rdf.from_table(rt)

    # one conjunction: k-side pushes below the shuffle boundaries, w-side
    # into the join's right input — each conjunct routed independently
    out = (l.merge(r, on="k", out_capacity=cap * 4, bucket_capacity=cap,
                   shuffle_out_capacity=cap * 2)
           [(col("k") % 2 == 0) & (col("w") > 0.05)]
           .assign(vw=col("v0") * col("w"))
           .groupby("k", bucket_capacity=cap * 4)
           .agg({"vw": ["sum", "mean"]})
           .sort_values("k", bucket_capacity=cap * 4))

    print("================ EXPLAIN (unoptimized) ================")
    print(out.explain(optimize=False))
    print()
    print("================ EXPLAIN (optimized) ==================")
    print(out.explain())
    print()

    results = {}
    for opt in (False, True):
        tag = "optimized" if opt else "unoptimized"
        t0 = time.perf_counter()
        res, stats = out.collect(mode="bsp", optimize=opt,
                                 collect_stats=True)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        res, stats = out.collect(mode="bsp", optimize=opt,
                                 collect_stats=True)
        cached = time.perf_counter() - t0
        results[tag] = res.to_numpy()
        print(f"{tag:12s} first={first:7.3f}s cached={cached:7.3f}s "
              f"stages={stats.num_stages} shuffles={stats.num_shuffles} "
              f"rows_shuffled={stats.rows_shuffled} "
              f"bytes_shuffled={stats.bytes_shuffled}")

a, b = results["unoptimized"], results["optimized"]
identical = all(np.array_equal(a[c], b[c]) for c in a)
print(f"\noptimized == unoptimized results (bit-identical): {identical}")
assert identical
if args.out:
    np.savez(args.out, **{f"{t}/{c}": v for t, res in results.items()
                          for c, v in res.items()},
             **{f"launches/{k.name}": k.launches for k in CUDA_KERNELS})
