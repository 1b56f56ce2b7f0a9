"""paligemma-3b [vlm] — SigLIP + gemma decoder [arXiv:2407.07726].

Backbone only: the SigLIP vision tower + projector are stubbed; the
engine's ``extra_inputs`` provide 256 precomputed patch embeddings (B,
256, d_model) consumed as a bidirectional prefix (prefix-LM masking).
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216, tie_embeddings=True,
    act="gelu", scale_embed=True, n_prefix_tokens=256, dtype=torch.bfloat16,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=1,
                          head_dim=32, d_ff=256, vocab_size=512,
                          n_prefix_tokens=16, dtype=torch.float32)
