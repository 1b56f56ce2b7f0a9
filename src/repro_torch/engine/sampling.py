"""Token sampling for the serving engines."""
from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Index of the first maximal logit, int32 — ``jnp.argmax``'s rule."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(logits: torch.Tensor, temperature: float = 1.0,
                       top_k: int = 0,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Categorical sampling with optional top-k truncation, int32 — the
    rule of JAX's ``temperature_sample``: logits in float32 over
    ``max(temperature, 1e-6)``, every logit below the k-th largest
    masked (ties at the k-th all kept).  The draw comes from
    ``generator`` (an explicit ``torch.Generator`` on the logits'
    device; ``None``: torch's default one), so it is reproducible but
    not JAX's PRNG stream."""
    x = logits.float() / max(temperature, 1e-6)
    if top_k:
        kth = torch.sort(x, dim=-1).values[..., -top_k, None]
        x = torch.where(x < kth, float("-inf"), x)
    probs = torch.softmax(x, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    draw = torch.multinomial(flat, 1, generator=generator)
    return draw.reshape(probs.shape[:-1]).to(torch.int32)
