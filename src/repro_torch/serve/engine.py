"""Minimal batched serving engine: prefill -> synchronized decode (ports
``repro/serve/engine.py``).

A host-side loop over the model's ``prefill`` / ``decode_step``:

* fixed-size request batches with one prompt length per batch (the
  uniform-position decode contract of ``transformer.decode_step``);
* greedy or temperature sampling, the latter from a ``torch.Generator``
  seeded by ``seed`` (reproducible within the port; it cannot give
  ``jax.random.categorical``'s draws);
* stop on EOS or ``max_new_tokens``: a row has finished once it produced
  EOS at any step (on codebook 0 for audio), generation stops when every
  row has, and rows that finished earlier decode on until then;
* audio prompts (B, S0, K): each step samples a token per codebook.

A vlm takes its patch embeddings through ``transformer.prefill``, not
through the engine, whose requests are token prompts as the reference's.

The engine runs on the model's device; the KV caches live there and are
updated in place by each decode step.

With ``rules`` (``launch.mesh.serve_rules_for_mesh``) and a model whose
parameters are DTensors (``transformer.shard_model``), prefill and decode
run on the model's mesh: tokens batch-sharded, the caches placed by
``transformer.cache_specs`` (KV sequence-sharded over ``model``), and
the logits gathered before sampling.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models import transformer
from ..models.config import ModelConfig
from ..models.layers import NO_SHARDING, ShardingRules, full, mesh_scope


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, <=max_new_tokens[, K])
    steps: int
    prefill_len: int


class ServeEngine:
    def __init__(self, cfg: ModelConfig, model: transformer.Transformer,
                 cache_len: int, rules: ShardingRules = NO_SHARDING,
                 eos_id: Optional[int] = None):
        self.cfg = cfg
        self.model = model
        self.cache_len = cache_len
        self.rules = rules
        self.eos_id = eos_id

    @property
    def device(self) -> torch.device:
        return self.model.device

    def prefill(self, prompts: torch.Tensor):
        """(last-position logits (B, V) or (B, K, V), caches) of prompts
        (B, S0) or (B, S0, K)."""
        with mesh_scope(self.model.embed):
            return transformer.prefill(self.model, prompts, self.cache_len,
                                       rules=self.rules)

    def decode_step(self, caches, tokens: torch.Tensor,
                    pos: torch.Tensor) -> torch.Tensor:
        """Logits (B, V) or (B, K, V) after ``tokens`` (B, 1) or (B, 1, K)
        at ``pos`` (B,); the caches are updated in place."""
        with mesh_scope(self.model.embed):
            return transformer.decode_step(self.model, caches, tokens, pos,
                                           self.rules)

    @staticmethod
    def _sample(logits: torch.Tensor, gen: torch.Generator,
                temperature: float) -> torch.Tensor:
        """A token per row (and codebook) of logits (..., V)."""
        if temperature == 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / temperature, dim=-1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=gen).reshape(
            probs.shape[:-1])

    def generate(self, prompts: np.ndarray, max_new_tokens: int = 32,
                 temperature: float = 0.0, seed: int = 0
                 ) -> GenerationResult:
        """prompts: (B, S0) int token ids, or (B, S0, K) for audio."""
        b, s0 = prompts.shape[0], prompts.shape[1]
        if s0 + max_new_tokens > self.cache_len:
            raise ValueError(f"prompt {s0} + {max_new_tokens} new tokens "
                             f"exceed cache_len {self.cache_len}")
        dev = self.device
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                                 device=dev)
        logits, caches = self.prefill(tokens)
        gen = torch.Generator(device=dev).manual_seed(seed)

        out: List[torch.Tensor] = []
        finished = np.zeros((b,), bool)
        for step in range(max_new_tokens):
            tok = self._sample(full(logits), gen, temperature)  # (B,)/(B, K)
            out.append(tok)
            if self.eos_id is not None:
                finished |= tok.reshape(b, -1)[:, 0].cpu().numpy() == \
                    self.eos_id
                if finished.all():
                    break
            pos = torch.full((b,), s0 + step, dtype=torch.int32, device=dev)
            logits = self.decode_step(caches, tok[:, None], pos)
        toks = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        return GenerationResult(tokens=toks, steps=len(out), prefill_len=s0)
