"""qwen3-32b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936, head_dim=128,
qk-norm, SwiGLU.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    d_ff=25600,
    vocab_size=151936,
    head_dim=128,
    qk_norm=True,
    act="silu",
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-32b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    qk_norm=True,
    act="silu",
    rope_theta=1_000_000.0,
)
