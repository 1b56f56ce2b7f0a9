"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512, 2 shared + 64 routed top-6
[arXiv:2405.04434].  The source paper's Lite config is 64 routed experts
(the assignment line's "160 routed" belongs to the full V2); layer 0 is a
dense MLP (d_ff 10944), experts use d_ff 1408.
"""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab_size=102400,
    n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408,
    capacity_factor=1.25, first_dense_layers=1,
    use_mla=True, kv_lora_rank=512, qk_nope_head_dim=128,
    qk_rope_head_dim=64, v_head_dim=128,
    tie_embeddings=False, act="silu", dtype=torch.bfloat16,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, n_heads=4, d_ff=256,
                          vocab_size=512, n_experts=4, n_shared_experts=1,
                          top_k=2, d_ff_expert=64, first_dense_layers=1,
                          capacity_factor=4.0,
                          kv_lora_rank=32, qk_nope_head_dim=16,
                          qk_rope_head_dim=8, v_head_dim=16,
                          dtype=torch.float32)
