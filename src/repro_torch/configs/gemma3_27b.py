"""Gemma3-27B [hf:google/gemma-3 family; dense, 5:1 local:global, 128k].

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144, head_dim=128.
62 = 10 units of (5 local + 1 global) + 2 tail local layers.
Sliding window 1024; tied embeddings with sqrt(d) scaling.
long_500k applies (sliding-window layers dominate).
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b", family="dense",
    num_layers=62, d_model=5376, num_heads=32, num_kv_heads=16,
    d_ff=21504, vocab_size=262144, head_dim=128,
    rope_theta=1e6, mlp="gelu", sliding_window=1024, local_global_ratio=5,
    tie_embeddings=True, scale_embed=True, fsdp_params=True,
    supports_long_context=True,
)

SMOKE = CONFIG.replace(
    num_layers=8,            # 1 unit (5+1) + 2 tail locals
    d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, sliding_window=32, fsdp_params=False,
)
