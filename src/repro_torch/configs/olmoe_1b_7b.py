"""OLMoE-1B-7B [arXiv:2409.02060; MoE 64 experts top-8].

16L d_model=2048 16H (GQA kv=16) d_ff=1024(per expert) vocab=50304.
"""

from repro_torch.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab_size=50304, head_dim=128,
    rope_theta=10000.0, mlp="swiglu",
    moe=MoEConfig(num_experts=64, experts_per_token=8),
    supports_long_context=False,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=32, vocab_size=512,
    moe=MoEConfig(num_experts=8, experts_per_token=2),
)
