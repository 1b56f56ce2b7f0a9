"""Shared building blocks of the dense transformer.

PyTorch counterpart of ``repro.models.common``.  Parameters live in
``nn.Module`` containers whose attribute names follow the JAX parameter
tree (``embed.table``, ``attn.wq.w``, ``mlp.gate.w``, ``ln_attn`` …), so
``repro_torch.weights.params_from_jax`` maps one onto the other by name.
The maths stays in plain functions on tensors, with the JAX package's
conventions kept exactly:

* a dense weight is stored ``(d_in, d_out)`` and applied as ``x @ w``;
* ``rms_norm`` computes in float32 and scales by ``(1 + w)``;
* RoPE is the Llama half rotation; the MLP is SwiGLU;
* embeddings are tied (``unembed = h @ table.T``).

The config carries the fields of the one family this slice serves (dense
llama: no QKV bias, no embedding scale, tied embeddings, SiLU).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Config of a dense decoder-only model (the fields this slice uses)."""

    name: str = "model"
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    sliding_window: Optional[int] = None
    dtype: torch.dtype = torch.float32

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# parameter containers
# ---------------------------------------------------------------------------
def normal_(t: torch.Tensor, generator: torch.Generator,
            scale: float) -> None:
    """In-place ``scale * N(0, 1)`` drawn in float32, then cast — the
    JAX ``normal_init`` recipe."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=torch.float32) * scale)


class Dense(nn.Module):
    """``y = x @ w`` with ``w`` stored ``(d_in, d_out)``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype,
                                          device=device), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.w, generator, self.w.shape[0] ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w


class MLP(nn.Module):
    """SwiGLU MLP: ``down(silu(gate(x)) * up(x))``."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.gate = Dense(d_model, d_ff, dtype, device)
        self.up = Dense(d_model, d_ff, dtype, device)
        self.down = Dense(d_ff, d_model, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.gate, self.up, self.down):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class Embed(nn.Module):
    """Token table ``(vocab, d_model)``; tied with the unembedding."""

    def __init__(self, vocab: int, d_model: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d_model, dtype=dtype,
                                              device=device),
                                  requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.table, generator, 0.02)


def rms_weight(d: int, dtype: torch.dtype,
               device: torch.device) -> nn.Parameter:
    """RMSNorm gain stored as ``scale - 1`` (zeros), added back in
    ``rms_norm``."""
    return nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + weight.float())).to(dt)


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., T, H, D); positions broadcastable to (..., T)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].float() * freqs             # (..., T, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_apply(embed: Embed, tokens: torch.Tensor) -> torch.Tensor:
    return embed.table[tokens]


def unembed_apply(embed: Embed, h: torch.Tensor) -> torch.Tensor:
    return h @ embed.table.T
