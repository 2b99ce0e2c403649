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
corpus does not make (``train.make_train_step`` takes them).  The
reference's ``--model-axis`` and its mesh wait for ROADMAP item 13.6.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..core import CylonExecutor, CylonStore
from ..core.env import resolve_device
from ..data import (CorpusConfig, batches_from_table, preprocess,
                    source_weights, synth_corpus)
from ..train import (AdamWConfig, AsyncCheckpointer, init_train_state,
                     latest_step, make_train_step, restore)


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit("train driver covers token-LM archs; see the "
                         "smoke tests for vlm/audio steps")
    dev = resolve_device(args.device)

    # ---- DDF preprocessing application (paper §IV-C) ------------------ #
    gang = CylonExecutor(parallelism=args.data_parallelism, device=dev)
    store = CylonStore()
    corpus = synth_corpus(CorpusConfig(num_docs=2048, payload_tokens=args.seq,
                                       vocab_size=cfg.vocab_size,
                                       seed=args.seed),
                          gang.parallelism, device=dev)
    weights = source_weights(8, gang.parallelism, device=dev)
    t0 = time.time()
    preprocess(gang, corpus, weights, store=store)
    table = store.get("train_corpus")
    print(f"[data] preprocessed {table.total_rows()} docs "
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
            state = restore(f"{args.ckpt_dir}/ckpt_{last}", state)
            start_step = last
            print(f"[ckpt] resumed from step {last}")

    step_fn = make_train_step(cfg, opt_cfg, ce_chunk=64)
    losses = []
    for step in range(start_step, args.steps):
        batch = next(batches)
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {loss:8.4f} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"dt {time.time() - t0:.3f}s", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(f"{args.ckpt_dir}/ckpt_{step + 1}", state, step + 1)
    ckpt.wait()
    if len(losses) > 10:
        a, b = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"[loss] first5={a:.3f} last5={b:.3f} "
              f"({'improved' if b < a else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
