"""AdamW + cosine schedule (counterpart of ``repro.optim.adamw``).

The reference's arithmetic, not a ``torch.optim`` class: float32 moments,
a global-norm clip at ``grad_clip / (gnorm + 1e-9)``, bias correction,
decoupled weight decay on every leaf, and the update computed in float32
and rounded to the parameter's type.  The moments are kept in the JAX
tree's layout (nested dicts keyed by its leaf names, a stacked tensor a
leaf: ``mu["layers"]["attn"]["wq"]["w"]`` is ``(n_layers, d, d)``), so
``checkpoint.store`` writes them under the reference's keys; a layer's
parameter is updated through its view into the stacked moment.  The
parameters (an ``nn.Module``) and the moments are updated in place, on
the parameters' device; ``adamw_update`` returns them, as the reference
returns its new trees.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.weights import jax_path, stack_tree


class AdamWState(NamedTuple):
    step: torch.Tensor  # () int32, on the parameters' device
    mu: Any             # first moment: the JAX tree's layout, float32
    nu: Any             # second moment


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def init_adamw(params: nn.Module) -> AdamWState:
    """Zero float32 moments for every parameter of ``params``, stacked as
    the JAX tree stacks its leaves, on the parameters' device."""
    def zeros(t: torch.Tensor) -> torch.Tensor:
        return torch.zeros(t.shape, dtype=torch.float32, device=t.device)
    mu = stack_tree(params, zeros)
    nu = stack_tree(params, zeros)
    dev = next(params.parameters()).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=mu, nu=nu)


def lr_schedule(cfg: AdamWConfig,
                step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine decay
    to ``min_lr_frac · lr`` at ``total_steps``, in float32."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def global_norm(grads: Mapping[str, Optional[torch.Tensor]]
                ) -> torch.Tensor:
    """sqrt of the sum of every gradient's squares, in float32 (``grads``
    by parameter name; None counts as zero)."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads.values()
                          if g is not None))


def bias_corrections(cfg: AdamWConfig, step: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1 - b1^t, 1 - b2^t) at the 1-based step ``t``, in float32."""
    t = step.float()
    return 1 - cfg.b1 ** t, 1 - cfg.b2 ** t


def _at(tree: Mapping[str, Any], path: Tuple[str, ...]) -> torch.Tensor:
    for key in path:
        tree = tree[key]
    return tree


@torch.no_grad()
def adamw_update(cfg: AdamWConfig,
                 grads: Mapping[str, Optional[torch.Tensor]],
                 state: AdamWState, params: nn.Module
                 ) -> Tuple[nn.Module, AdamWState]:
    """One AdamW step of ``params`` under ``grads`` (a dict by parameter
    name; a missing or None gradient counts as zero), in place; returns
    (params, the state after the step)."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1c, b2c = bias_corrections(cfg, step)
    for name, p in params.named_parameters():
        path, index = jax_path(name)
        m = _at(state.mu, path)[index]
        n = _at(state.nu, path)[index]
        g = grads.get(name)
        g = (torch.zeros_like(m) if g is None else g.float() * clip)
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        n.copy_(cfg.b2 * n + (1 - cfg.b2) * g * g)
        p32 = p.float()
        delta = (m / b1c) / (torch.sqrt(n / b2c) + cfg.eps) \
            + cfg.weight_decay * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu)
