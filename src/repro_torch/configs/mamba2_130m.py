"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060]."""
import torch

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_conv_width=4,
    ssm_chunk=128, ssm_n_groups=1, dtype=torch.bfloat16,
)


def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=128, vocab_size=512,
                          ssm_state=16, ssm_head_dim=32, ssm_chunk=16,
                          dtype=torch.float32)
