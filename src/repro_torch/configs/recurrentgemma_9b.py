"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1 attn : 2 recurrent
[arXiv:2402.19427].  38 layers = 12 (rec,rec,attn) groups + 2 recurrent tail."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000, rg_lru_width=4096, local_window=2048,
    tie_embeddings=True, act="gelu", scale_embed=True, dtype=torch.bfloat16,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=5, d_model=128, n_heads=4, n_kv_heads=1,
                          head_dim=32, d_ff=256, vocab_size=512,
                          rg_lru_width=128, local_window=64,
                          dtype=torch.float32)
