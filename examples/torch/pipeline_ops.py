"""Paper Fig 9's operator pipeline via the port's lazy DataFrame frontend
(``examples/pipeline_ops.py`` in PyTorch).

Ordinary dataframe code — merge -> groupby.agg -> sort_values — while the
planner + pseudo-BSP execution run underneath, in three modes:
  bsp        one coalesced BSP program (CylonFlow),
  bsp_staged one dispatch per communication stage,
  amt        per-operator dispatch + allgather shuffle (Dask-DDF-style),
with wall-time comparison and result parity check.

The JAX example's 8 host devices are 8 stacked ranks on one device here
(``rdf.session(parallelism=8)``).  On the card every shuffle's
bucketize runs the radix-partition kernel and every groupby sum the
segmented-sum kernel.  ``--device`` defaults to ``cuda`` and raises
without a card; ``--device cpu`` runs the plain PyTorch path.  ``--out
FILE`` saves each mode's result and each kernel's launches (npz).

  PYTHONPATH=src python examples/torch/pipeline_ops.py [--device cpu]
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
        "v0": rng.random(N).astype(np.float32)}
right = {"k": rng.integers(0, int(N * 0.9), N).astype(np.int32),
         "w": rng.random(N).astype(np.float32)}

with rdf.session(parallelism=P, device=device) as env:
    lt = DistTable.from_numpy(left, env.parallelism, device=device)
    l = rdf.from_table(lt)
    r = rdf.read_numpy(right)

    out = (l.merge(r, on="k", out_capacity=lt.capacity * 4)
           .groupby("k").agg({"v0": ["sum", "mean"]})
           .sort_values("k")
           .assign(v0_sum=col("v0_sum") + 1.0))
    print(f"plan stages (1 + comm boundaries): {out.num_stages()}")

    results = {}
    for mode in ("bsp", "bsp_staged", "amt"):
        t0 = time.perf_counter()
        res = out.collect(mode=mode)
        env.synchronize()
        dt0 = time.perf_counter() - t0          # includes building stages
        t0 = time.perf_counter()
        res = out.collect(mode=mode)
        env.synchronize()
        dt = time.perf_counter() - t0           # cached stages (stateful env)
        results[mode] = res.to_numpy()
        print(f"{mode:10s} first={dt0:7.3f}s cached={dt:7.3f}s "
              f"rows={len(results[mode]['k'])}")

bsp, amt = results["bsp"], results["amt"]
parity = all(np.allclose(np.sort(bsp[c]), np.sort(amt[c]), rtol=1e-4)
             for c in bsp)
print(f"bsp == amt results: {parity}")
assert parity
if args.out:
    np.savez(args.out, **{f"{m}/{c}": v for m, res in results.items()
                          for c, v in res.items()},
             **{f"launches/{k.name}": k.launches for k in CUDA_KERNELS})
