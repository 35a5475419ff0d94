"""xLSTM-1.3B [arXiv:2405.04517; sLSTM + mLSTM blocks].

48L d_model=2048 4H d_ff=0 (mixers carry their own up/down projections)
vocab=50304. Unit = 8 blocks (7 mLSTM + 1 sLSTM). Recurrent state decode
→ long_500k runs.
"""

from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
    d_ff=0, vocab_size=50304,
    xlstm_slstm_every=8, ssm_expand=2, tie_embeddings=True,
    supports_long_context=True,
)

SMOKE = CONFIG.replace(
    num_layers=4, d_model=64, num_heads=2, num_kv_heads=2,
    vocab_size=512, xlstm_slstm_every=2,
)
