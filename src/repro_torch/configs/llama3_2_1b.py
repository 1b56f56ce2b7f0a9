"""llama3.2-1b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B]."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=128256, rope_theta=500000.0, dtype=torch.bfloat16,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=2,
                          head_dim=32, d_ff=512, vocab_size=512,
                          dtype=torch.float32)
