"""Legacy imperative ``Plan`` builder API on the port
(``examples/legacy_plan_api.py`` in PyTorch).

The lazy DataFrame frontend (``examples/torch/pipeline_ops.py``,
``examples/torch/planner_explain.py``) is the recommended entry point;
this example shows the underlying builder the frontend lowers to — the
two are bit-identical on the same pipeline.  Typed expressions work
here too (``.filter(col("v0") > 0)``).

The JAX example's 8 host devices are 8 stacked ranks on one device here
(``CylonEnv(8)``).  ``--device`` defaults to ``cuda`` and raises without
a card; ``--device cpu`` runs the plain PyTorch path.  ``--out FILE``
saves both results and each kernel's launches (npz).

  PYTHONPATH=src python examples/torch/legacy_plan_api.py [--device cpu]
"""

import argparse

import numpy as np

import repro_torch.df as rdf
from repro_torch.core import (CylonEnv, DistTable, Plan, execute,
                              resolve_device)
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
N = 20_000
left = {"k": rng.integers(0, int(N * 0.9), N).astype(np.int32),
        "v0": rng.integers(0, 256, N).astype(np.float32)}
right = {"k": rng.integers(0, int(N * 0.9), N).astype(np.int32),
         "w": rng.integers(0, 256, N).astype(np.float32)}

env = CylonEnv(P, device=device)
lt = DistTable.from_numpy(left, env.parallelism, device=device)
rt = DistTable.from_numpy(right, env.parallelism, device=device)
tables = {"l": lt, "r": rt}

plan = (Plan.scan("l")
        .join(Plan.scan("r"), on="k", out_capacity=lt.capacity * 4)
        .filter(col("w") > 4)
        .groupby(["k"], {"v0": ["sum", "mean"]})
        .sort(["k"])
        .add_scalar(1.0, cols=["v0_sum"]))
print(plan.explain(tables))
out = execute(plan, env, tables).to_numpy()
print(f"rows={len(out['k'])}")

# the frontend path is the same physical plan, bit-for-bit
front = (rdf.from_table(lt).merge(rdf.from_table(rt), on="k",
                                  out_capacity=lt.capacity * 4)
         [col("w") > 4]
         .groupby("k").agg({"v0": ["sum", "mean"]})
         .sort_values("k")
         .assign(v0_sum=col("v0_sum") + 1.0))
got = front.collect(env=env).to_numpy()
identical = all(np.array_equal(out[c], got[c]) for c in out)
print(f"frontend == builder (bit-identical): {identical}")
assert identical
if args.out:
    np.savez(args.out, **{f"builder/{c}": v for c, v in out.items()},
             **{f"frontend/{c}": v for c, v in got.items()},
             **{f"launches/{k.name}": k.launches for k in CUDA_KERNELS})
