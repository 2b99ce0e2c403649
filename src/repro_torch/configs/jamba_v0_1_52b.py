"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE [arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2.
Layer layout per the paper/HF config: attention at layer i%8==4
(attn_layer_period=8, offset=4), MoE at i%2==1 (expert_layer_period=2,
offset=1).  The Mamba mixer is modelled with the SSD block (d_state=16,
conv=4, expand=2 — Jamba's Mamba hyperparameters).  Hybrid: the 4 attention
layers make 500k-context decode feasible (sequence-sharded KV), so the
long_500k cell runs.
"""

from ..models.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    head_dim=128,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=14336, num_shared=0,
                  every_k_layers=2),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=64, d_conv=4, chunk=128),
    layer_pattern="mmmmammm",
    sub_quadratic=True,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="jamba-v0.1-52b-smoke",
    family="hybrid",
    num_layers=8,           # one full pattern period
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    head_dim=16,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=128, num_shared=0,
                  every_k_layers=2, capacity_factor=4.0),
    ssm=SSMConfig(d_state=16, expand=2, head_dim=16, d_conv=4, chunk=32),
    layer_pattern="mmmmammm",
    sub_quadratic=True,
    rope_theta=10_000.0,
)
