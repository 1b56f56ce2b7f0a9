"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060).

PyTorch counterpart of ``repro.models.mamba2``.  The temporal mixer is
the SSD chunked algorithm: quadratic attention-like computation *within*
chunks of ``Q = cfg.ssm_chunk`` tokens plus a cheap inter-chunk recurrence
over (H, P, N) states, and the exact recurrence token by token at decode
time.  The parameters are an ``nn.Module`` (``Mamba2``) whose attribute
names follow the JAX parameter tree (``layers.<i>.mixer.in_proj.w``,
``…mixer.A_log``, ``layers.<i>.ln``, ``ln_f``), so
``repro_torch.weights.params_from_jax`` maps one onto the other.

The serving paths' chunked scan (``prefill``) goes through
``kernels.ops.ssd_chunked_scan``: the ``ssd_scan`` kernel for CUDA
tensors, its plain version for CPU tensors.  ``forward`` (the training
loss's) calls the plain version ``kernels.ref.ssd_scan_ref`` directly on
every device, as the JAX forward calls its oracle: the kernel has no
backward.  Both compute the Pallas kernel's function, which equals the
JAX model's oracle wherever the oracle is finite (ROADMAP C2).

Casts and roundings sit where the JAX model puts them: x, B, C and dt
enter the scan in float32, ``y + x·D`` is float32 and is cast to the
model's type before the gate ``y·silu(z)``; ``A_log``, ``D`` and
``dt_bias`` are float32 in every model type.

Left-padding convention: pad tokens contribute nothing (inputs and dt
are masked to zero, giving an identity state transition), so the SSM
state after prefill is exactly the state after the real tokens.  The
decode cache is per layer (conv window, SSD state) of constant size:
``prefill`` ignores ``cache_window`` and ``decode_step`` ignores
``step``, as in JAX.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch import nn

from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.models.common import (Dense, Embed, ModelConfig, constrain,
                                       embed_apply, normal_, pad, remat_layer,
                                       rms_norm, rms_weight, softplus,
                                       unembed_apply)


class MambaCache(NamedTuple):
    conv: torch.Tensor     # (L, B, W-1, conv_dim) — last W-1 conv inputs
    state: torch.Tensor    # (L, B, H, P, N) SSD state, float32
    lengths: torch.Tensor  # (B,) int32


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_d_inner
    H, P, N, G = (cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state,
                  cfg.ssm_n_groups)
    conv_dim = d_in + 2 * G * N
    return d_in, H, P, N, G, conv_dim


def _f32(n: int, device: torch.device) -> nn.Parameter:
    return nn.Parameter(torch.empty(n, dtype=torch.float32, device=device),
                        requires_grad=False)


class Mixer(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        d_in, H, P, N, G, conv_dim = _dims(cfg)
        zxbcdt = 2 * d_in + 2 * G * N + H
        self.in_proj = Dense(cfg.d_model, zxbcdt, cfg.dtype, device)
        self.conv_w = nn.Parameter(torch.empty(cfg.ssm_conv_width, conv_dim,
                                               dtype=cfg.dtype,
                                               device=device),
                                   requires_grad=False)
        self.conv_b = nn.Parameter(torch.empty(conv_dim, dtype=cfg.dtype,
                                               device=device),
                                   requires_grad=False)
        self.A_log = _f32(H, device)
        self.D = _f32(H, device)
        self.dt_bias = _f32(H, device)
        self.norm = rms_weight(d_in, cfg.dtype, device)
        self.out_proj = Dense(d_in, cfg.d_model, cfg.dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.in_proj.reset_parameters(generator)
        normal_(self.conv_w, generator, 0.2)
        with torch.no_grad():
            self.conv_b.zero_()
            self.A_log.zero_()  # A = -exp(A_log) = -1 at init
            self.D.fill_(1.0)
            self.dt_bias.zero_()
            self.norm.zero_()
        self.out_proj.reset_parameters(generator)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.mixer = Mixer(cfg, device)
        self.ln = rms_weight(cfg.d_model, cfg.dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.mixer.reset_parameters(generator)
        with torch.no_grad():
            self.ln.zero_()


class Mamba2(nn.Module):
    """Parameters of the Mamba-2 LM; names follow the JAX parameter
    tree."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, device)
        self.layers = nn.ModuleList([Block(cfg, device)
                                     for _ in range(cfg.n_layers)])
        self.ln_f = rms_weight(cfg.d_model, cfg.dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        with torch.no_grad():
            self.ln_f.zero_()


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device) -> Mamba2:
    """Random weights drawn from ``generator`` (which must live on
    ``device``) with the JAX package's recipe: N(0, 0.02) embeddings,
    N(0, d_in^-1) projections, N(0, 0.2²) conv taps, zero conv bias,
    ``A_log`` 0, ``D`` 1, ``dt_bias`` 0, zero norm gains."""
    params = Mamba2(cfg, device)
    params.reset_parameters(generator)
    return params


def _split_zxbcdt(p: Mixer, u: torch.Tensor, cfg: ModelConfig):
    d_in, H, P, N, G, conv_dim = _dims(cfg)
    return torch.split(p.in_proj(u), [d_in, conv_dim, H], dim=-1)


def _causal_conv(p: Mixer, xBC: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width W as the sum of W shifted products,
    in JAX's order (no cuDNN). xBC (B,T,C) with pads already zeroed."""
    W = p.conv_w.shape[0]
    T = xBC.shape[1]
    x = pad(xBC, (0, 0, W - 1, 0))
    out = sum(x[:, i:i + T, :] * p.conv_w[i][None, None] for i in range(W))
    return F.silu(out + p.conv_b)


def mixer_forward(p: Mixer, u: torch.Tensor, valid: torch.Tensor,
                  cfg: ModelConfig, plain: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """u (B,T,d_model) with T a multiple of ``cfg.ssm_chunk``; valid (B,T)
    bool.  Returns (out, final_state, conv_tail).  The scan is
    ``kernels.ops.ssd_chunked_scan`` (the kernel on the card: prefill's),
    or with ``plain`` its plain version ``kernels.ref.ssd_scan_ref`` on
    every device (``forward``'s, which carries gradients)."""
    d_in, H, P, N, G, conv_dim = _dims(cfg)
    B_, T, _ = u.shape
    z, xBC, dt = _split_zxbcdt(p, u, cfg)
    xBC = torch.where(valid[..., None], xBC, torch.zeros((), dtype=xBC.dtype,
                                                         device=u.device))
    xBC_conv = _causal_conv(p, xBC)
    x, Bmat, Cmat = torch.split(xBC_conv, [d_in, G * N, G * N], dim=-1)
    x = x.reshape(B_, T, H, P)
    Bmat = Bmat.reshape(B_, T, G, N)
    Cmat = Cmat.reshape(B_, T, G, N)
    dt = softplus(dt.float() + p.dt_bias)
    dt = torch.where(valid[..., None], dt, 0.0)  # identity transition at pads
    A = -torch.exp(p.A_log)
    args = (x.float().contiguous(), dt.contiguous(), A.contiguous(),
            Bmat.float().contiguous(), Cmat.float().contiguous())
    if plain and isinstance(u, DTensor):  # the plain scan on local rows
        y, final = kernel_ops.on_local_rows(
            lambda *t: ssd_scan_ref(*t, cfg.ssm_chunk), B_, *args)
    elif plain:
        y, final = ssd_scan_ref(*args, cfg.ssm_chunk)
    else:
        y, final = kernel_ops.ssd_chunked_scan(*args, cfg.ssm_chunk)
    y = y + x.float() * p.D[None, None, :, None]
    y = y.reshape(B_, T, d_in).to(u.dtype)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    conv_tail = xBC[:, -(cfg.ssm_conv_width - 1):, :]  # last W-1 raw inputs
    return p.out_proj(y), final, conv_tail


def mixer_decode(p: Mixer, u: torch.Tensor, conv_state: torch.Tensor,
                 ssm_state: torch.Tensor, cfg: ModelConfig):
    """One-token recurrence. u (B,1,d); conv_state (B,W-1,conv_dim);
    ssm_state (B,H,P,N).  Returns (out, new conv window, new state)."""
    d_in, H, P, N, G, conv_dim = _dims(cfg)
    B_ = u.shape[0]
    z, xBC, dt = _split_zxbcdt(p, u, cfg)
    xBC = xBC[:, 0]  # (B, conv_dim)
    window = torch.cat([conv_state, xBC[:, None]], dim=1)  # (B,W,conv)
    conv_out = torch.einsum("bwc,wc->bc", window, p.conv_w) + p.conv_b
    conv_out = F.silu(conv_out)
    x, Bmat, Cmat = torch.split(conv_out, [d_in, G * N, G * N], dim=-1)
    x = x.reshape(B_, H, P).float()
    Bmat = Bmat.reshape(B_, G, N).repeat_interleave(H // G, dim=1).float()
    Cmat = Cmat.reshape(B_, G, N).repeat_interleave(H // G, dim=1).float()
    dt = softplus(dt[:, 0].float() + p.dt_bias)  # (B,H)
    A = -torch.exp(p.A_log)
    a = torch.exp(dt * A)  # (B,H)
    dBx = torch.einsum("bh,bhn,bhp->bhpn", dt, Bmat, x)
    new_state = ssm_state * a[:, :, None, None] + dBx
    y = torch.einsum("bhn,bhpn->bhp", Cmat, new_state) \
        + x * p.D[None, :, None]
    y = y.reshape(B_, 1, d_in).to(u.dtype)
    y = rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    return p.out_proj(y), window[:, 1:], new_state


def _pad_to_chunk(h: torch.Tensor, valid: torch.Tensor, Q: int):
    """Left-pad the sequence to a multiple of ``Q`` (pads invalid)."""
    T = h.shape[1]
    lead = (-T) % Q
    if lead:
        h = pad(h, (0, 0, lead, 0))
        valid = pad(valid, (lead, 0))
    return h, valid, lead


def _zero_pads(h: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return torch.where(valid[..., None], h, torch.zeros((), dtype=h.dtype,
                                                        device=h.device))


def forward(params: Mamba2, cfg: ModelConfig, tokens: torch.Tensor,
            valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward (no cache) -> logits (B,T,V), the training
    loss's: pads (``valid`` false; default none) are zeroed, the sequence
    is left-padded to a whole chunk, the mixers run with ``valid`` and the
    lead is dropped before ``ln_f`` and the head.  The scan is the plain
    ``ssd_scan_ref`` on every device, as JAX's forward calls its oracle,
    so no kernel runs and gradients flow through it; each layer runs under
    ``remat_layer``."""
    B, T = tokens.shape
    if valid is None:
        valid = torch.ones((B, T), dtype=torch.bool, device=tokens.device)
    h = _zero_pads(embed_apply(params.embed, tokens, cfg), valid)
    h, valid_p, lead = _pad_to_chunk(h, valid, cfg.ssm_chunk)
    for layer in params.layers:
        h = constrain(h)
        h = remat_layer(cfg, _block_forward, layer, h, valid_p, cfg)
    h = h[:, lead:]
    return unembed_apply(params.embed, rms_norm(h, params.ln_f, cfg.norm_eps))


def _block_forward(layer: Block, h: torch.Tensor, valid: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    o, _, _ = mixer_forward(layer.mixer, rms_norm(h, layer.ln, cfg.norm_eps),
                            valid, cfg, plain=True)
    return h + o


def prefill(params: Mamba2, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor, cache_window: int = 0,
            ) -> Tuple[torch.Tensor, MambaCache]:
    """Left-padded prefill; returns the last token's logits (B, vocab) and
    the decode cache.  ``cache_window`` is ignored (constant-size state),
    kept for API parity."""
    B, T = tokens.shape
    idx = torch.arange(T, device=tokens.device)[None]
    valid = idx >= (T - lengths.to(idx.dtype)[:, None])
    h = _zero_pads(embed_apply(params.embed, tokens, cfg), valid)
    h, valid_p, _ = _pad_to_chunk(h, valid, cfg.ssm_chunk)
    states, tails = [], []
    for layer in params.layers:
        h = constrain(h)
        o, st, conv_tail = mixer_forward(
            layer.mixer, rms_norm(h, layer.ln, cfg.norm_eps), valid_p, cfg)
        h = h + o
        states.append(st)
        tails.append(conv_tail)
    logits = unembed_apply(params.embed,
                           rms_norm(h[:, -1:], params.ln_f, cfg.norm_eps))
    cache = MambaCache(conv=torch.stack(tails), state=torch.stack(states),
                       lengths=lengths.to(torch.int32))
    return logits[:, 0], cache


def decode_step(params: Mamba2, cfg: ModelConfig, cache: MambaCache,
                tokens: torch.Tensor, step: Optional[int] = None
                ) -> Tuple[torch.Tensor, MambaCache]:
    """One decode iteration. tokens (B,); ``step`` is ignored (the cache
    carries the state)."""
    h = embed_apply(params.embed, tokens[:, None], cfg)
    convs, states = [], []
    for l, layer in enumerate(params.layers):
        h = constrain(h)
        o, conv, state = mixer_decode(
            layer.mixer, rms_norm(h, layer.ln, cfg.norm_eps), cache.conv[l],
            cache.state[l], cfg)
        h = h + o
        convs.append(conv)
        states.append(state)
    logits = unembed_apply(params.embed,
                           rms_norm(h, params.ln_f, cfg.norm_eps))[:, 0]
    return logits, cache._replace(conv=torch.stack(convs),
                                  state=torch.stack(states))
