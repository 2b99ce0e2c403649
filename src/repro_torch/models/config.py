"""Model configuration dataclasses for the assigned architecture pool."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0            # shared (always-on) experts
    every_k_layers: int = 1        # MoE every k-th layer (jamba: 2)
    first_dense_d_ff: Optional[int] = None  # deepseek: layer 0 is dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    #: collective schedule for the dispatch shuffle (paper §IV-B modular
    #: communicator): "xla" | "ring" | "bruck"
    communicator: str = "xla"


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    d_conv: int = 4
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | ssm | moe | vlm | hybrid | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads (gemma: 256)
    qk_norm: bool = False           # qwen3
    act: str = "silu"               # silu (SwiGLU) | gelu (GeGLU, gemma)
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    #: per-layer kind pattern, cycled over layers: "a"=attention, "m"=mamba
    layer_pattern: str = "a"
    num_codebooks: int = 1          # musicgen: EnCodec codebooks
    embed_inputs: bool = False      # vlm: consumes precomputed embeddings
    #: True if any layer is attention-free or sub-quadratic (long_500k eligible)
    sub_quadratic: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows: vocab rounded up to a multiple of 256 so
        the vocab axis divides any production model-axis size (GPT-NeoX
        style padding; padded logits are masked to -inf in the loss)."""
        return -(-self.vocab_size // 256) * 256

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % len(self.layer_pattern)]

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        if self.moe.first_dense_d_ff is not None and i == 0:
            return False
        return (i % self.moe.every_k_layers) == (self.moe.every_k_layers - 1) \
            if self.moe.every_k_layers > 1 else True

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for roofline."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        total = v * d * (1 if self.tie_embeddings else 2) * (
            self.num_codebooks if self.family == "audio" else 1)
        for i in range(self.num_layers):
            kind = self.layer_kind(i)
            if kind == "a":
                if self.mla is not None:
                    m = self.mla
                    qd = m.qk_nope_head_dim + m.qk_rope_head_dim
                    total += d * self.num_heads * qd                      # q
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)    # down
                    total += m.kv_lora_rank * self.num_heads * (
                        m.qk_nope_head_dim + m.v_head_dim)                # up
                    total += self.num_heads * m.v_head_dim * d            # o
                else:
                    total += d * self.num_heads * hd * 2                  # q, o
                    total += d * self.num_kv_heads * hd * 2               # k, v
            else:  # mamba
                s = self.ssm
                d_in = s.expand * d
                total += d * (2 * d_in + 2 * s.d_state + d_in // s.head_dim)
                total += d_in * s.d_conv + d_in * d
            if self.is_moe_layer(i):
                m = self.moe
                total += (m.num_experts + m.num_shared) * 3 * d * m.d_ff_expert
                total += d * m.num_experts                                 # router
            elif kind == "a" or self.family in ("ssm",):
                if kind == "a":
                    ff = (self.moe.first_dense_d_ff
                          if (self.moe and self.moe.first_dense_d_ff and i == 0)
                          else self.d_ff)
                    if ff:
                        total += 3 * d * ff
            total += 2 * d                                                 # norms
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        n_moe_layers = sum(1 for i in range(self.num_layers)
                           if self.is_moe_layer(i))
        inactive = (m.num_experts - m.top_k) * 3 * self.d_model \
            * m.d_ff_expert * n_moe_layers
        return full - inactive


# The four assigned input-shape cells (per-arch eligibility in launch/shapes).
SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}
