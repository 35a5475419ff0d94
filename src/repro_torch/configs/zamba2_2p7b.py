"""Zamba2-2.7B [arXiv:2411.15242; Mamba2 + shared attention blocks].

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.
Unit = 6 Mamba2 blocks + the shared attention/FFN block (one weight copy
applied at every unit — Zamba2's parameter-sharing scheme; the
concat-with-embedding LoRA path is simplified away, as in the reference).
Recurrent state + bounded attention cache → long_500k runs.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000, head_dim=80,
    hybrid_attn_every=6, ssm_state=64, ssm_expand=2, ssm_conv=4,
    supports_long_context=True,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=128, num_heads=2, num_kv_heads=2, head_dim=64,
    d_ff=256, vocab_size=512, hybrid_attn_every=2, ssm_state=16,
)
