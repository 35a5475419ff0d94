"""Qwen2-VL-7B [arXiv:2409.12191; VLM backbone, M-RoPE].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064, head_dim=128.
Backbone only: vision patches arrive as precomputed embeddings via the
batch's optional ``positions`` [3, B, S] (M-RoPE t/h/w sections 16/24/24).
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4,
    d_ff=18944, vocab_size=152064, head_dim=128,
    rope_style="mrope", rope_theta=1e6, mlp="swiglu",
    supports_long_context=False,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=256, num_heads=2, num_kv_heads=2, head_dim=128,
    d_ff=256, vocab_size=512,
)
