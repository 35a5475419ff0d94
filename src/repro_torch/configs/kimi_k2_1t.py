"""Kimi K2 1T-A32B [arXiv:2501.kimi2; trillion-param MoE].

61L d_model=7168 64H (GQA kv=8) d_ff=2048(per expert) vocab=163840,
MoE 384 experts top-8, head_dim=112. Adafactor optimizer + FSDP param
sharding, as in the reference.
"""

from repro_torch.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=2048, vocab_size=163840, head_dim=112,
    rope_theta=50000.0, mlp="swiglu",
    moe=MoEConfig(num_experts=384, experts_per_token=8),
    optimizer="adafactor", fsdp_params=True,
    supports_long_context=False,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=32, vocab_size=512,
    moe=MoEConfig(num_experts=8, experts_per_token=2),
    optimizer="adamw", fsdp_params=False,
)
