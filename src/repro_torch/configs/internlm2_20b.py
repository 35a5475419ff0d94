"""InternLM2-20B [arXiv:2403.17297; dense GQA].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544, head_dim=128.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    num_layers=48, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=16384, vocab_size=92544, head_dim=128,
    rope_theta=1e6, mlp="swiglu", fsdp_params=True,
    supports_long_context=False,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=512, fsdp_params=False,
)
