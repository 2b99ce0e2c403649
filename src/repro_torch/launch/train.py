"""End-to-end training driver (ports ``repro/launch/train.py``).

Wires the layers together: the DDF preprocessing application (on a
``CylonExecutor`` gang of stacked ranks) -> ``CylonStore`` hand-off ->
``batches_from_table`` -> the train step, with asynchronous checkpoints
and ``--resume``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-780m \\
      --steps 50 --batch 8 --seq 1024 --ckpt-dir /tmp/ckpt --resume

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path (use
``--smoke`` there).  As in the reference, the driver trains the token-LM
archs and exits for the vlm and audio ones, whose batches the §IV-C
corpus does not make (``train.make_train_step`` takes them).

Sharded training: started by ``torchrun`` with more than one process,
the driver joins the process group (NCCL on cards, one card a process;
gloo with ``--device cpu``), builds a ``(world // M, M)`` ``("data",
"model")`` mesh (``--model-axis M``) with ``rules_for_mesh``, and places
the state by ``state_specs``.  The §IV-C preprocessing then runs once,
on a gang of ``min(--data-parallelism, world)`` processes carved from a
``DevicePool`` over the group (the lowest ranks), which ``put``s its table
into a ``CylonStore`` over the group; every process ``get``s it at the
world's size and draws the same batches from the seed (the table is
gathered over the trainer processes).  ``--resume`` restores onto the current mesh,
whatever mesh wrote the checkpoint.  At world size 1 the rules are
``NO_SHARDING``, as in the reference.

  python -m torch.distributed.run --nproc-per-node 4 \\
      -m repro_torch.launch.train --arch llama3.2-3b --model-axis 2
"""

from __future__ import annotations

import argparse
import time
from datetime import timedelta
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..core import CylonExecutor, CylonStore, DevicePool
from ..core.env import resolve_device
from ..data import (CorpusConfig, batches_from_table, preprocess,
                    source_weights, synth_corpus)
from ..models.layers import NO_SHARDING, set_mesh
from ..train import (AdamWConfig, AsyncCheckpointer, init_train_state,
                     latest_step, make_train_step, place_state, restore,
                     state_specs)
from .mesh import make_local_mesh, rules_for_mesh

#: how long a collective of the torchrun group waits before it fails: a
#: rank that falls out of step (a mismatched collective) ends the job
#: instead of hanging it.  The other ranks wait out a checkpoint's write
#: on the writer rank inside it.
PG_TIMEOUT = timedelta(seconds=300)


def join_group(device: Optional[str], group_of_one: bool = False):
    """(device, world size, rank, whether the group was made here): the
    ``torchrun`` process group when there is one of more than one
    process (NCCL on cards, gloo on the CPU; a group the caller already
    made is joined as it is), else one process: with no group, or with
    ``group_of_one`` (for a mesh, which spans the current group) in a
    group of one made here when there is none."""
    import os
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and not group_of_one:
        return resolve_device(device), 1, 0, False
    import torch.distributed as dist
    cpu = device is not None and torch.device(device).type == "cpu"
    if cpu:
        dev = torch.device("cpu")
    elif world == 1:
        dev = resolve_device(device)
    else:
        dev = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    made = not dist.is_initialized()
    if made:
        backend = "gloo" if cpu else "nccl"
        if world == 1:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1, timeout=PG_TIMEOUT)
        else:
            dist.init_process_group(backend, timeout=PG_TIMEOUT)
    return dev, dist.get_world_size(), dist.get_rank(), made


def main(argv: Optional[Sequence[str]] = None) -> List[float]:
    """Run the training driver; returns the losses of the steps it took."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--data-parallelism", type=int, default=8,
                    help="stacked ranks of the DDF preprocessing gang")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="model-axis size of the mesh under torchrun")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("train driver covers token-LM archs; see the "
                         "smoke tests for vlm/audio steps")
    dev, world, rank, made = join_group(args.device)
    mesh, rules = None, NO_SHARDING
    if world > 1:
        mesh = make_local_mesh(model=args.model_axis)
        rules = rules_for_mesh(mesh)

    def say(msg: str) -> None:
        if rank == 0:
            print(msg, flush=True)

    # ---- DDF preprocessing application (paper §IV-C) ------------------ #
    corpus_cfg = CorpusConfig(num_docs=2048, payload_tokens=args.seq,
                              vocab_size=cfg.vocab_size, seed=args.seed)
    if world > 1:
        # once, on a gang of processes; handed to every process
        import torch.distributed as dist
        pool = DevicePool(process_group=dist.group.WORLD, device=dev)
        gang = CylonExecutor(min(args.data_parallelism, world), pool=pool)
        store = CylonStore(pool=pool)
        comm = gang.env.comm if gang.is_member else None
    else:
        gang = CylonExecutor(parallelism=args.data_parallelism, device=dev)
        store, comm = CylonStore(), None
    corpus = weights = None
    if gang.is_member:
        corpus = synth_corpus(corpus_cfg, gang.parallelism, device=dev,
                              comm=comm)
        weights = source_weights(8, gang.parallelism, device=dev, comm=comm)
    t0 = time.time()
    preprocess(gang, corpus, weights, store=store)
    table = store.get("train_corpus",
                      target_parallelism=world if world > 1 else None)
    say(f"[data] preprocessed {table.total_rows()} docs "
        f"on gang={gang.parallelism} in {time.time() - t0:.2f}s")
    batches = batches_from_table(table, args.batch, args.seq, seed=args.seed)
    del corpus, table

    # ---- training application ----------------------------------------- #
    opt_cfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                          total_steps=args.steps)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    state = init_train_state(cfg, gen, torch.float32, dev)
    start_step = 0
    ckpt = AsyncCheckpointer()
    if args.resume and args.ckpt_dir:
        last = latest_step(args.ckpt_dir)
        if last is not None:
            path = f"{args.ckpt_dir}/ckpt_{last}"
            if mesh is None:
                state = restore(path, state)
            else:
                with set_mesh(mesh):
                    state = restore(path, state,
                                    shardings=state_specs(cfg, rules))
            start_step = last
            say(f"[ckpt] resumed from step {last} (onto {world} "
                f"process{'es' if world > 1 else ''})")
    if mesh is not None and start_step == 0:
        state = place_state(state, cfg, rules, mesh)

    step_fn = make_train_step(cfg, opt_cfg, rules, ce_chunk=64)
    losses = []
    for step in range(start_step, args.steps):
        batch = next(batches)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % 5 == 0 or step == args.steps - 1:
            say(f"step {step:4d} loss {loss:8.4f} "
                f"gnorm {float(metrics['grad_norm']):7.3f} "
                f"lr {float(metrics['lr']):.2e} "
                f"dt {time.time() - t0:.3f}s")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(f"{args.ckpt_dir}/ckpt_{step + 1}", state, step + 1)
    ckpt.wait()
    if len(losses) > 10:
        a, b = np.mean(losses[:5]), np.mean(losses[-5:])
        say(f"[loss] first5={a:.3f} last5={b:.3f} "
            f"({'improved' if b < a else 'NOT improved'})")
    if made:
        import torch.distributed as dist
        from ..comm.process_group import barrier_before_teardown
        barrier_before_teardown(dev)
        dist.destroy_process_group()
    return losses


if __name__ == "__main__":
    main()
