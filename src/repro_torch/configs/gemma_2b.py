"""gemma-2b [dense] — GeGLU, head_dim=256, MQA [arXiv:2403.08295]."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000, tie_embeddings=True,
    act="gelu", scale_embed=True, dtype=torch.bfloat16,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
                          head_dim=32, d_ff=256, vocab_size=512,
                          dtype=torch.float32)
