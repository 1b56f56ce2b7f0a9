"""The train step and the serve steps shared by the trainer and the
server (counterpart of ``repro.launch.steps``)."""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamWConfig, AdamWState, adamw_update


def make_train_step(model: Model, opt_cfg: AdamWConfig):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    loss)``: the loss and its gradient by autograd (the parameters
    require grad for the step only, so the model serves as before), then
    ``adamw_update`` in place.  ``loss`` is a detached scalar tensor."""
    def train_step(params: torch.nn.Module, opt_state: AdamWState,
                   batch: Dict[str, Any]):
        named = list(params.named_parameters())
        was = [p.requires_grad for _, p in named]
        try:
            for _, p in named:
                p.requires_grad_(True)
            with torch.enable_grad():
                loss = model.loss(params, batch)
                grads = torch.autograd.grad(loss, [p for _, p in named],
                                            allow_unused=True)
        finally:
            for (_, p), flag in zip(named, was):
                p.requires_grad_(flag)
        params, opt_state = adamw_update(
            opt_cfg, {n: g for (n, _), g in zip(named, grads)}, opt_state,
            params)
        return params, opt_state, loss.detach()

    return train_step


def make_prefill_step(model: Model, cache_window: int,
                      window: Optional[int] = None):
    @torch.no_grad()
    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_window, window=window)

    return prefill_step


def make_decode_step(model: Model, window: Optional[int] = None):
    @torch.no_grad()
    def decode_step(params, cache, tokens, step):
        return model.decode_step(params, cache, tokens, step, window=window)

    return decode_step
