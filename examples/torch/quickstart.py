"""Quickstart: the paper's example code, on the port
(``examples/quickstart.py`` in PyTorch).

The paper's §IV-A snippet:

    def foo(env: CylonEnv = None):
        df1 = read_parquet(..., env=env)
        df2 = read_parquet(..., env=env)
        write_parquet(df1.merge(df2, ...), env=env)
    init()
    wait(CylonExecutor(parallelism=4).run_Cylon(foo))

Here: reserve a 4-rank gang from the pool, run a distributed merge under
the stateful pseudo-BSP environment, pull the result to the host.

The JAX example's pool holds its 8 host devices; here it is 8 rank slots
on one device (``DevicePool(slots=8)``: a pool's default is one slot).
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the plain PyTorch path.  ``--out FILE`` saves the joined rows
and each kernel's launches (npz).

  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core import (CylonExecutor, DevicePool, DistTable,
                              resolve_device)
from repro_torch.dataframe import join
from repro_torch.kernels import CUDA_KERNELS

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda or cpu")
ap.add_argument("--out", default=None, metavar="FILE",
                help="save the joined rows and the kernels' launches (npz)")
args = ap.parse_args()
device = resolve_device(args.device)

rng = np.random.default_rng(0)
N = 20_000
left = {"k": rng.integers(0, 5000, N).astype(np.int32),
        "x": rng.random(N).astype(np.float32)}
right = {"k": rng.integers(0, 5000, N).astype(np.int32),
         "y": rng.random(N).astype(np.float32)}


def foo(env, df1, df2):
    """User code sees the communicator-bearing env + local Table views."""
    out, l_stats, r_stats = join(df1, df2, env.comm, on="k",
                                 out_capacity=df1.capacity * 8)
    return out, l_stats.send_dropped


executor = CylonExecutor(parallelism=4, pool=DevicePool(slots=8,
                                                        device=device))
df1 = DistTable.from_numpy(left, executor.parallelism, device=device)
df2 = DistTable.from_numpy(right, executor.parallelism, device=device)

result, dropped = executor.run_cylon(foo, df1, df2)
rows = result.to_numpy()
print(f"gang parallelism : {executor.parallelism}")
print(f"joined rows      : {len(rows['k'])}")
print(f"dropped (capacity): {int(np.asarray(dropped.cpu()).sum())}")
print({k: v[:5] for k, v in rows.items()})
if args.out:
    np.savez(args.out, **{f"joined/{c}": v for c, v in rows.items()},
             dropped=np.asarray(dropped.cpu()),
             **{f"launches/{k.name}": k.launches for k in CUDA_KERNELS})
