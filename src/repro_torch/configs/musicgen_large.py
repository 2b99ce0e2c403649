"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048 per codebook, K=4 EnCodec
codebooks.  The backbone sums the K codebook embeddings and emits K logit
heads; the EnCodec frontend + delay-pattern interleave is a STUB per the
assignment (``input_specs()`` provides the token streams directly).
"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    head_dim=64,
    act="silu",
    num_codebooks=4,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="musicgen-large-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=64,
    head_dim=16,
    act="silu",
    num_codebooks=2,
    rope_theta=10_000.0,
)
