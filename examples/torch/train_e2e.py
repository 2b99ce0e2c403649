"""End-to-end §IV-C on the port: DDF preprocessing application ->
CylonStore -> distributed training application (~100M-param
llama-family model) (``examples/train_e2e.py`` in PyTorch).

Two "applications" on separate gang reservations of the same pool:
  1. preprocessing: dedup -> quality filter -> weights join -> sample-based
     balance, producing the training corpus into the CylonStore,
  2. training: gets the corpus (repartitioning to its own parallelism),
     packs batches, and trains a ~100M-param model for a few hundred steps
     under FSDP+SP sharding rules.

The JAX example's pool holds its 8 host devices; here it is 8 rank slots
on one device (``DevicePool(slots=8)``), and the preprocessing gang takes
4 of them.  The JAX example's (data, model) = (4, 2) mesh spans 8 host
devices; here a mesh spans the processes of a ``torch.distributed``
group, one rank a process.  Started by ``torchrun`` the example joins
its group and uses a model axis of 2 when the world size is even and
above 1; alone it makes a group of one in this process (NCCL on the
card, gloo on the CPU) and trains on a (1, 1) mesh.  At ``--seq`` 256
attention is ``dense`` (up to 2,048 keys), as the JAX example's.
``--device`` defaults to ``cuda`` and raises without a card; ``--device
cpu`` runs the plain PyTorch path.  ``--out FILE`` saves the losses, the
seconds of each step and each kernel's launches (npz).

  PYTHONPATH=src python examples/torch/train_e2e.py [--steps 300] \\
      [--device cpu]
"""

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm.process_group import barrier_before_teardown
from repro_torch.core import CylonExecutor, CylonStore, DevicePool
from repro_torch.data import (CorpusConfig, batches_from_table, preprocess,
                              source_weights, synth_corpus)
from repro_torch.kernels import CUDA_KERNELS
from repro_torch.launch.mesh import make_local_mesh, rules_for_mesh
from repro_torch.launch.train import join_group
from repro_torch.models.config import ModelConfig
from repro_torch.train import (AdamWConfig, init_train_state,
                               make_train_step, place_state)

ap = argparse.ArgumentParser()
ap.add_argument("--steps", type=int, default=300)
ap.add_argument("--batch", type=int, default=8)
ap.add_argument("--seq", type=int, default=256)
ap.add_argument("--device", default="cuda", help="cuda or cpu")
ap.add_argument("--out", default=None, metavar="FILE",
                help="save the losses, the step seconds and the kernels' "
                     "launches (npz)")
args = ap.parse_args()

# ~100M params: 8L x 768d, llama-style
CFG = ModelConfig(name="llama-100m", family="dense", num_layers=8,
                  d_model=768, num_heads=12, num_kv_heads=4, d_ff=2048,
                  vocab_size=32000, head_dim=64, tie_embeddings=True)

# the process group the mesh spans: torchrun's, else one of this process
device, world, rank, made = join_group(args.device, group_of_one=True)


def say(msg):
    if rank == 0:
        print(msg, flush=True)


try:
    pool = DevicePool(slots=8, device=device)
    prep_gang = CylonExecutor(parallelism=4, pool=pool)
    store = CylonStore()

    t0 = time.time()
    corpus = synth_corpus(CorpusConfig(num_docs=8192,
                                       payload_tokens=args.seq,
                                       vocab_size=CFG.vocab_size),
                          prep_gang.parallelism, device=device)
    weights = source_weights(8, prep_gang.parallelism, device=device)
    preprocess(prep_gang, corpus, weights, store=store)
    say(f"[prep] gang={prep_gang.parallelism} done in "
        f"{time.time() - t0:.1f}s")

    # training application on the group's mesh (data x model)
    table = store.get("train_corpus", target_parallelism=8)
    mesh = make_local_mesh(model=2 if world > 1 and world % 2 == 0 else 1)
    rules = rules_for_mesh(mesh)
    batches = batches_from_table(table, args.batch, args.seq)

    opt = AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    state = init_train_state(CFG, torch.Generator(device=device)
                             .manual_seed(0), torch.bfloat16, device)
    state = place_state(state, CFG, rules, mesh)

    n_params = sum(x.numel() for x in state["params"].values())
    say(f"[train] params={n_params / 1e6:.1f}M "
        f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    step_fn = make_train_step(CFG, opt, rules, ce_chunk=128)
    losses, step_s = [], []
    for step in range(args.steps):
        batch = next(batches)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.time() - t0)
        if step % 25 == 0 or step == args.steps - 1:
            say(f"step {step:4d} loss {losses[-1]:8.4f} "
                f"({step_s[-1]:.2f}s/step)")

    first, last = np.mean(losses[:10]), np.mean(losses[-10:])
    say(f"[result] loss {first:.3f} -> {last:.3f} "
        f"({'OK: improved' if last < first - 0.5 else 'WARN: flat'})")
    if args.out and rank == 0:
        np.savez(args.out, losses=np.array(losses), step_s=np.array(step_s),
                 **{f"launches/{k.name}": k.launches for k in CUDA_KERNELS})
    barrier_before_teardown(device)
finally:
    if made:
        dist.destroy_process_group()
