"""deepseek-v2-lite-16b [moe] — MLA + DeepSeek-MoE [arXiv:2405.04434; hf].

27L d_model=2048 16H, MLA kv_lora=512 (rope head 64, nope 128, v 128),
vocab=102400.  MoE: 64 routed experts top-6 + 2 shared, expert d_ff=1408,
layer 0 dense with d_ff=10944 (the assignment's "2 shared + 160 routed"
note describes full V2; the -Lite config it names has 64 routed experts,
matching its "MoE 64e top-6" spec line).
"""

from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,              # expert width (spec line)
    vocab_size=102400,
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408, num_shared=2,
                  every_k_layers=1, first_dense_d_ff=10944),
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="deepseek-v2-lite-16b-smoke",
    family="moe",
    num_layers=3,           # 1 dense prefix + 2 MoE
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=48,
    vocab_size=256,
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=48, num_shared=2,
                  every_k_layers=1, first_dense_d_ff=96,
                  capacity_factor=4.0),
    rope_theta=10_000.0,
)
