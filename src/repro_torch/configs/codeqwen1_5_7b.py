"""codeqwen1.5-7b [dense] — qwen1.5 arch (QKV bias, MHA)
[hf:Qwen/CodeQwen1.5-7B]."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416, rope_theta=1000000.0,
    tie_embeddings=False, qkv_bias=True, act="silu", dtype=torch.bfloat16,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=256, n_heads=8, n_kv_heads=8,
                          head_dim=32, d_ff=512, vocab_size=512,
                          dtype=torch.float32)
