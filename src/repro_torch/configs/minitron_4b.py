"""minitron-4b [dense] — pruned nemotron [arXiv:2407.14679]."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256000, tie_embeddings=False,
    act="silu", dtype=torch.bfloat16,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=192, n_heads=6, n_kv_heads=2,
                          head_dim=32, d_ff=384, vocab_size=512,
                          dtype=torch.float32)
