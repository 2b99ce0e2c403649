"""Batched serving example on the port: prefill + synchronized decode on a
small model (``examples/serve_batch.py`` in PyTorch).

Loads a reduced qwen3-family config, runs batched generation (greedy and
sampled), and verifies the decode path against a full-forward replay.
The weights are drawn from a ``torch.Generator`` seeded 0 (the JAX
example's ``PRNGKey(0)`` draws other numbers), and the sampled run's
draws are the port's own.  ``--device`` defaults to ``cuda`` and raises
without a card; ``--device cpu`` runs the plain PyTorch path.  ``--out
FILE`` saves the greedy tokens, the replay's verdict and each kernel's
launches (npz).

  PYTHONPATH=src python examples/torch/serve_batch.py [--device cpu]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import resolve_device
from repro_torch.kernels import CUDA_KERNELS
from repro_torch.models import transformer
from repro_torch.serve import ServeEngine

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda", help="cuda or cpu")
ap.add_argument("--out", default=None, metavar="FILE",
                help="save the greedy tokens, the replay's verdict and "
                     "the kernels' launches (npz)")
args = ap.parse_args()
device = resolve_device(args.device)

cfg = get_smoke_config("qwen3-8b")
model = transformer.init_params(
    cfg, torch.Generator(device=device).manual_seed(0), torch.float32,
    device)

B, S0, NEW = 8, 32, 48
engine = ServeEngine(cfg, model, cache_len=S0 + NEW)
rng = np.random.default_rng(0)
prompts = rng.integers(0, cfg.vocab_size, (B, S0)).astype(np.int32)

t0 = time.time()
res = engine.generate(prompts, max_new_tokens=NEW, temperature=0.0)
dt = time.time() - t0
print(f"greedy: {B}x{res.steps} tokens in {dt:.2f}s "
      f"({B * res.steps / dt:.1f} tok/s incl. compile)")

t0 = time.time()
res2 = engine.generate(prompts, max_new_tokens=NEW, temperature=0.8, seed=1)
dt = time.time() - t0
print(f"sampled: {B}x{res2.steps} tokens in {dt:.2f}s "
      f"({B * res2.steps / dt:.1f} tok/s cached)")

# verify: greedy decode must match argmax of a full forward at each step;
# the head's weight is rounded to bf16 and contracted in f32, as the JAX
# example's bf16 x f32 einsum promotes
full = np.concatenate([prompts, res.tokens[:, :, 0]
                       if res.tokens.ndim == 3 else res.tokens], axis=1)
with torch.no_grad():
    h = transformer.forward(model, torch.as_tensor(full, device=device))
    w = model.unembed()
    logits = torch.einsum("bsd,vd->bsv", h,
                          w.to(torch.bfloat16).to(h.dtype)).float()
ok = True
for t in range(res.steps):
    expect = torch.argmax(logits[:, S0 - 1 + t], -1).cpu().numpy()
    got = res.tokens[:, t, 0] if res.tokens.ndim == 3 else res.tokens[:, t]
    ok &= bool((expect == got).all())
print(f"greedy decode == full-forward argmax replay: {ok}")
if args.out:
    np.savez(args.out, tokens=res.tokens, replay=ok,
             **{f"launches/{k.name}": k.launches for k in CUDA_KERNELS})
