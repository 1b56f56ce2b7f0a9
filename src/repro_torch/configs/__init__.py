"""Architecture config registry: ``--arch <id>`` resolution.

The port serves every config of ``repro.configs``: the dense
llama3.2-1b, codeqwen1.5-7b, minitron-4b and gemma-2b, the Mamba-2 SSM
mamba2-130m, the MoE mixtral-8x22b and deepseek-v2-lite-16b, the RG-LRU
hybrid recurrentgemma-9b, the encoder-decoder seamless-m4t-large-v2 and
the prefix-LM VLM paligemma-3b (these two take their frontends'
embeddings as the engine's ``extra_inputs``, so the serve launcher
refuses them, as the JAX one does).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (codeqwen1_5_7b, deepseek_v2_lite_16b,
                                 gemma_2b, llama3_2_1b, mamba2_130m,
                                 minitron_4b, mixtral_8x22b, paligemma_3b,
                                 recurrentgemma_9b, seamless_m4t_large_v2)
from repro_torch.configs.shapes import (SHAPES, InputShape, TensorSpec,
                                        effective_window, token_specs)
from repro_torch.models.common import ModelConfig

_MODULES = {
    "llama3.2-1b": llama3_2_1b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "minitron-4b": minitron_4b,
    "gemma-2b": gemma_2b,
    "mamba2-130m": mamba2_130m,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "mixtral-8x22b": mixtral_8x22b,
    "recurrentgemma-9b": recurrentgemma_9b,
    "seamless-m4t-large-v2": seamless_m4t_large_v2,
    "paligemma-3b": paligemma_3b,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = _MODULES[arch]
    return mod.reduced() if reduced else mod.CONFIG


def all_configs(reduced: bool = False) -> Dict[str, ModelConfig]:
    """Every arch's config (reduced where asked), by arch id."""
    return {a: get_config(a, reduced) for a in ARCHS}
