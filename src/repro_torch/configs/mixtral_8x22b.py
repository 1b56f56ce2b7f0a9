"""mixtral-8x22b [moe] — 8 experts top-2, SWA [arXiv:2401.04088]."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=32768,
    n_experts=8, top_k=2, d_ff_expert=16384, capacity_factor=1.25,
    sliding_window=4096, tie_embeddings=False, act="silu",
    dtype=torch.bfloat16,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          head_dim=32, d_ff=256, vocab_size=512,
                          n_experts=4, top_k=2, d_ff_expert=128,
                          capacity_factor=4.0,
                          sliding_window=64, dtype=torch.float32)
