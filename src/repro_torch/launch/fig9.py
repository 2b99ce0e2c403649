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

Each process builds the rows its rank holds of two tables from
``--seed`` (the JAX package's ``benchmarks/common.py`` recipe: uniform
int32 keys at 90% cardinality, float32 values), runs the plan ``--runs``
times in ``--mode`` under ``--communicator``, and rank 0 prints each
run's wall (the slowest process's), rows shuffled and the share of the
wall spent in host-staged collectives.  ``--check`` gathers the result
on every process and holds it to numpy on rank 0.
"""

from __future__ import annotations

import argparse
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
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args(argv)

    import torch.distributed as dist
    from ..core import CylonEnv, Plan, execute
    dist.init_process_group(args.backend, timeout=timedelta(seconds=120))
    try:
        env = CylonEnv(communicator=args.communicator,
                       process_group=dist.group.WORLD, device=args.device)
        p, rank = env.parallelism, dist.get_rank()
        per = -(-args.rows // p)
        cap = -(-(per + per // 8) // 8) * 8     # share + 1/8 headroom
        ld = table_data(args.rows, args.seed)
        rd = table_data(args.rows, args.seed + 1)
        tables = {"l": env.from_numpy(ld, cap), "r": env.from_numpy(rd, cap)}
        plan = fig9_plan(Plan, cap)
        for run in range(args.runs):
            staged0 = env.comm.stats["staged_s"]
            env.synchronize()
            t = time.perf_counter()
            res, st = execute(plan, env, tables, mode=args.mode,
                              collect_stats=True)
            env.synchronize()
            wall = time.perf_counter() - t
            share = (env.comm.stats["staged_s"] - staged0) / wall
            slowest = env.comm.all_reduce_max(
                torch.tensor([wall, share], dtype=torch.float64,
                             device=env.device)[None])[0].tolist()
            if rank == 0:
                print(f"[fig9] {args.backend} {args.communicator} "
                      f"{args.mode} run {run}: 2 x {args.rows} rows over "
                      f"{p} processes, wall {slowest[0]:.3f} s, rows "
                      f"shuffled {st.rows_shuffled}, dropped "
                      f"{st.rows_dropped}, host-staged collectives up to "
                      f"{100 * slowest[1]:.1f}% of a process's wall",
                      flush=True)
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
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
