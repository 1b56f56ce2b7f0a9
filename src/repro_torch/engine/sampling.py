"""Token sampling for the serving engines."""
from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Index of the first maximal logit, int32 — ``jnp.argmax``'s rule."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
