"""Batched serving from the command line: random f32 weights from
``--seed``, random prompts, greedy or temperature decoding (ports
``repro/launch/serve.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
      --batch 4 --prompt-len 4096 --max-new 32

runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path (use
``--smoke`` there: the full-width configs need tens of GB).  An audio
arch (musicgen-large) gets prompts of K codebook ids a position; a vlm
(llava-next-34b) exits, as in the reference: its patch embeddings come
through ``transformer.prefill``, not through token prompts.
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import ARCHS, get_config, get_smoke_config
from ..core.env import resolve_device
from ..models import transformer
from ..serve import ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family == "vlm":
        raise SystemExit("serve driver covers token-LM archs")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    model = transformer.init_params(cfg, gen, torch.float32, dev)
    cache_len = args.prompt_len + args.max_new
    engine = ServeEngine(cfg, model, cache_len)

    rng = np.random.default_rng(args.seed)
    shape = ((args.batch, args.prompt_len, cfg.num_codebooks)
             if cfg.family == "audio" else (args.batch, args.prompt_len))
    prompts = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)

    t0 = time.time()
    res = engine.generate(prompts, max_new_tokens=args.max_new,
                          temperature=args.temperature, seed=args.seed)
    dt = time.time() - t0
    toks = res.tokens.reshape(args.batch, res.steps, -1)
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prefill={res.prefill_len} decoded={res.steps} tokens "
          f"in {dt:.2f}s ({args.batch * res.steps / dt:.1f} tok/s)")
    print("first sequence:", toks[0, :, 0].tolist())


if __name__ == "__main__":
    main()
