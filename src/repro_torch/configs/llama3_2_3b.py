"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B; unverified].

28L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=128256, SwiGLU, RoPE 500k,
tied embeddings.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128256,
    head_dim=128,
    act="silu",
    rope_theta=500_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="llama3.2-3b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    act="silu",
    rope_theta=500_000.0,
    tie_embeddings=True,
)
