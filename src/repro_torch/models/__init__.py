"""Model stack of the port (ports ``repro/models`` for serving and
training).

``config``      -- ModelConfig / MoEConfig / MLAConfig / SSMConfig + SHAPES
                   (a copy of the JAX package's)
``layers``      -- RMSNorm, RoPE, gated MLP, initializers, cross-entropy,
                   sharding rules
``attention``   -- GQA (+qk-norm), full-sequence (dense / chunked / flash)
                   and decode
``mamba2``      -- SSD mixer, full-sequence (chunked / kernel) and decode
``moe``         -- Mixture-of-Experts: router, capacity dispatch (ranks
                   from the radix-partition kernel), the dataframe-shuffle
                   dispatch over stacked ranks, the one-hot oracle
``transformer`` -- stack assembly, prefill / decode, the training
                   forward and chunked CE loss, weights and train states
                   carried across from the JAX package
"""

from .config import MLAConfig, ModelConfig, MoEConfig, SHAPES, SSMConfig
from .layers import NO_SHARDING, ShardingRules
from .moe import (expert_capacity, moe_apply, moe_apply_einsum,
                  moe_apply_grouped, moe_apply_shuffle, moe_init)
from . import transformer

__all__ = ["MLAConfig", "ModelConfig", "MoEConfig", "SHAPES", "SSMConfig",
           "NO_SHARDING", "ShardingRules",
           "expert_capacity", "moe_apply", "moe_apply_einsum",
           "moe_apply_grouped", "moe_apply_shuffle", "moe_init",
           "transformer"]
