"""Phi-3-mini 3.8B [arXiv:2404.14219; dense, RoPE SwiGLU GQA].

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064, head_dim=96.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064, head_dim=96,
    rope_theta=10000.0, mlp="swiglu",
    supports_long_context=False,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512,
)
