"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf].

16L d_model=2048 16H (GQA kv=16) expert d_ff=1024 vocab=50304,
MoE 64e top-8 on every layer, no shared experts, qk-norm.
"""

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,              # expert width (spec line)
    vocab_size=50304,
    qk_norm=True,
    moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024, num_shared=0,
                  every_k_layers=1),
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="olmoe-1b-7b-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=32,
    vocab_size=256,
    qk_norm=True,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=32, num_shared=0,
                  every_k_layers=1, capacity_factor=4.0),
    rope_theta=10_000.0,
)
