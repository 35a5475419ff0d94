"""Qwen1.5-4B [hf:Qwen/Qwen1.5-0.5B family; dense, QKV bias].

40L d_model=2560 20H (GQA kv=20) d_ff=6912 vocab=151936, head_dim=128.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
    d_ff=6912, vocab_size=151936, head_dim=128,
    qkv_bias=True, rope_theta=1e6, mlp="swiglu",
    supports_long_context=False,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
)
