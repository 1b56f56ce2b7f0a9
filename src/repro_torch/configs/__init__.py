"""Architecture config registry: ``--arch <id>`` resolution.

The port serves the dense llama3.2-1b, codeqwen1.5-7b, minitron-4b and
gemma-2b and the Mamba-2 SSM mamba2-130m; the other families of
``repro.configs`` come with their model code.
"""
from __future__ import annotations

from repro_torch.configs import (codeqwen1_5_7b, gemma_2b, llama3_2_1b,
                                 mamba2_130m, minitron_4b)
from repro_torch.models.common import ModelConfig

_MODULES = {
    "llama3.2-1b": llama3_2_1b,
    "codeqwen1.5-7b": codeqwen1_5_7b,
    "minitron-4b": minitron_4b,
    "gemma-2b": gemma_2b,
    "mamba2-130m": mamba2_130m,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = _MODULES[arch]
    return mod.reduced() if reduced else mod.CONFIG
