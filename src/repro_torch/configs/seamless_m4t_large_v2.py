"""seamless-m4t-large-v2 [audio] — enc-dec multimodal [arXiv:2308.11596].

Backbone only: the mel-spectrogram/conv frontend is stubbed; the engine's
``extra_inputs`` provide precomputed frame embeddings (B, T_frames,
d_model).  24 encoder + 24 decoder layers per the model card.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=48, n_enc_layers=24, n_dec_layers=24,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206, tie_embeddings=True,
    act="silu", dtype=torch.bfloat16,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=4, n_enc_layers=2, n_dec_layers=2,
                          d_model=128, n_heads=4, n_kv_heads=4, head_dim=32,
                          d_ff=256, vocab_size=512, dtype=torch.float32)
