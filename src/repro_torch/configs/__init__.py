"""Architecture config registry: ``--arch <id>`` resolution.

This slice of the port serves the one dense model on the main path;
the other families of ``repro.configs`` come with their model code.
"""
from __future__ import annotations

from repro_torch.configs import llama3_2_1b
from repro_torch.models.common import ModelConfig

_MODULES = {
    "llama3.2-1b": llama3_2_1b,
}

ARCHS = tuple(_MODULES)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    mod = _MODULES[arch]
    return mod.reduced() if reduced else mod.CONFIG
