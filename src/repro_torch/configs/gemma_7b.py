"""gemma-7b [dense] — GeGLU, head_dim=256 [arXiv:2403.08295; hf].

28L d_model=3072 16H (GQA kv=16, i.e. MHA on the 7b; MQA is the 2b)
d_ff=24576 vocab=256000, GeGLU activation, head_dim=256, tied embeddings.
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    d_ff=24576,
    vocab_size=256000,
    head_dim=256,
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="gemma-7b-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=192,
    vocab_size=512,
    head_dim=32,
    act="gelu",
    rope_theta=10_000.0,
    tie_embeddings=True,
)
