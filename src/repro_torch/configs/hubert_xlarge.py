"""HuBERT X-Large [arXiv:2106.07447; audio encoder-only].

48L d_model=1280 16H d_ff=5120 vocab=504 (cluster units). The conv
waveform frontend is a STUB: input_specs provides precomputed frame
embeddings [B, S, d_model]; training uses HuBERT-style masked unit
prediction. No decode shapes (encoder-only).
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504, head_dim=80,
    mlp="gelu", frontend="audio_frames", encoder_only=True,
    supports_decode=False, supports_long_context=False,
)

SMOKE = CONFIG.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=64,
)
