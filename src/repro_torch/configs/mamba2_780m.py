"""mamba2-780m [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified].

48L d_model=1536 (attention-free) vocab=50280, ssm_state=128, expand=2,
head_dim=64.  Sub-quadratic: eligible for the long_500k cell.
"""

from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=24,          # unused (attention-free); kept for accounting
    num_kv_heads=24,
    d_ff=0,                # pure SSM blocks, no FF
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, expand=2, head_dim=64, d_conv=4, chunk=128),
    layer_pattern="m",
    sub_quadratic=True,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-780m-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=256,
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, d_conv=4, chunk=32),
    layer_pattern="m",
    sub_quadratic=True,
    tie_embeddings=True,
)
