"""llava-next-34b [vlm] — anyres tiling [hf:llava-hf/llava-v1.6; unverified].

Backbone only (Yi-34B-class decoder): 60L d_model=7168 56H (GQA kv=8)
d_ff=20480 vocab=64000.  The vision frontend is a STUB per the assignment:
``input_specs()`` provides precomputed anyres patch embeddings (B, P, D)
that are concatenated ahead of the text embeddings.
"""

from ..models.config import ModelConfig

#: anyres tiling: 4 tiles + 1 base image × 576 CLIP patches (24×24)
PATCHES_LARGE = 5 * 576  # 2880
PATCHES_SMALL = 576

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    head_dim=128,
    act="silu",
    rope_theta=5_000_000.0,
    embed_inputs=True,
)

SMOKE = ModelConfig(
    name="llava-next-34b-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    act="silu",
    rope_theta=5_000_000.0,
    embed_inputs=True,
)
