"""Multi-head Latent Attention (DeepSeek-V2, arXiv:2405.04434).

PyTorch counterpart of ``repro.models.mla``.  KV is compressed to a
per-token latent ``c_kv`` (kv_lora_rank) plus one shared rope key
(qk_rope_head_dim): the cache stores only those.  At attention time
k_nope and v are re-expanded from the latent through the up projections
(the "non-absorbed" formulation), at every prefill and decode step.

The attention itself is plain torch (``attention.gqa_attend`` and its
q-blocked forms) on every device, by design: q·k runs over
qk_nope + qk_rope dims and P·V over v_head_dim, which differ, and in the
JAX package it is ``jnp`` too, with no Pallas kernel behind it; the port's
flash_prefill and decode_attention kernels take equal dims only.  It is a
candidate for later kernel work (ROADMAP B).

As everywhere in the port, caches are written in place: ``mla_decode``
writes the step's latent and rope key into the layer's cache tensors at
``slot`` and returns only the layer output.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.common import (Dense, ModelConfig, apply_rope, pad,
                                       rms_norm, rms_weight, split_heads)


class MLACache(NamedTuple):
    ckv: torch.Tensor       # (L, B, W, r)
    kr: torch.Tensor        # (L, B, W, dr)
    slot_pos: torch.Tensor  # (B, W) int32 absolute position per slot
    write_idx: int          # next global slot counter
    lengths: torch.Tensor   # (B,) int32

    @property
    def window(self) -> int:
        return self.ckv.shape[2]


class MLA(nn.Module):
    """MLA's parameters; names follow the JAX tree (``wq``, ``w_dkv``,
    ``ckv_norm``, ``k_up``, ``v_up``, ``wo``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        H = cfg.n_heads
        dn, dr, dv, r = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                         cfg.v_head_dim, cfg.kv_lora_rank)
        self.wq = Dense(cfg.d_model, H * (dn + dr), cfg.dtype, device)
        self.w_dkv = Dense(cfg.d_model, r + dr, cfg.dtype, device)
        self.ckv_norm = rms_weight(r, cfg.dtype, device)
        self.k_up = Dense(r, H * dn, cfg.dtype, device)
        self.v_up = Dense(r, H * dv, cfg.dtype, device)
        self.wo = Dense(H * dv, cfg.d_model, cfg.dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.wq, self.w_dkv, self.k_up, self.v_up, self.wo):
            m.reset_parameters(generator)
        with torch.no_grad():
            self.ckv_norm.zero_()


def _q_proj(p: MLA, x: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    B, T, _ = x.shape
    H, dn, dr = cfg.n_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    q = split_heads(p.wq(x), B, T, H, dn + dr)
    qn, qr = q[..., :dn], q[..., dn:]
    qr = apply_rope(qr, positions.clamp(min=0), cfg.rope_theta)
    return torch.cat([qn, qr], dim=-1)  # (B,T,H,dn+dr)


def _compress(p: MLA, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_kv (B,T,r) normalised, the rotated shared rope key (B,T,dr))."""
    r = cfg.kv_lora_rank
    dkv = p.w_dkv(x)
    ckv = rms_norm(dkv[..., :r], p.ckv_norm, cfg.norm_eps)
    kr = dkv[..., r:][:, :, None, :]  # (B,T,1,dr) one shared rope head
    kr = apply_rope(kr, positions.clamp(min=0), cfg.rope_theta)[:, :, 0]
    return ckv, kr


def _expand_attend(p: MLA, q: torch.Tensor, ckv: torch.Tensor,
                   kr: torch.Tensor, mask: Optional[torch.Tensor],
                   cfg: ModelConfig, positions: Optional[torch.Tensor] = None,
                   window: Optional[int] = None) -> torch.Tensor:
    """q (B,T,H,dn+dr); ckv (B,S,r); kr (B,S,dr); mask (B,1,T,S) or None
    (None: the q-blocked path with per-block masks from ``positions``)."""
    B, T, H, _ = q.shape
    S = ckv.shape[1]
    dn, dv = cfg.qk_nope_head_dim, cfg.v_head_dim
    kn = split_heads(p.k_up(ckv), B, S, H, dn)
    v = split_heads(p.v_up(ckv), B, S, H, dv)
    k = torch.cat([kn, kr[:, :, None, :].expand(B, S, H, kr.shape[-1])],
                  dim=-1)
    scale = (dn + cfg.qk_rope_head_dim) ** -0.5
    if mask is None:
        o = attn.gqa_attend_chunked(q, k, v, scale, positions, window)
    else:
        o = attn.gqa_attend_blocked(q, k, v, mask, scale)  # H == Hkv here
    return p.wo(o.reshape(B, T, H * dv))


def _prefill_mask(positions: torch.Tensor, window: Optional[int]
                  ) -> Optional[torch.Tensor]:
    """The full mask below ``CHUNK_THRESHOLD`` tokens, else None (the
    q-blocked path), as the JAX callers choose."""
    if positions.shape[1] >= attn.CHUNK_THRESHOLD:
        return None
    return attn.prefill_mask(positions, window)


def mla_forward(p: MLA, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, window: Optional[int]) -> torch.Tensor:
    """Full-sequence MLA without a cache (the plain forward)."""
    q = _q_proj(p, x, positions, cfg)
    ckv, kr = _compress(p, x, positions, cfg)
    return _expand_attend(p, q, ckv, kr, _prefill_mask(positions, window),
                          cfg, positions, window)


def mla_prefill(p: MLA, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig, window: Optional[int], cache_window: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill that also returns the layer's (ckv, kr) cache of width
    ``cache_window`` (zero-padded, or its last W entries: a ring)."""
    T = x.shape[1]
    q = _q_proj(p, x, positions, cfg)
    ckv, kr = _compress(p, x, positions, cfg)
    out = _expand_attend(p, q, ckv, kr, _prefill_mask(positions, window),
                         cfg, positions, window)
    W = cache_window
    if W >= T:
        ckv_c = pad(ckv, (0, 0, 0, W - T))
        kr_c = pad(kr, (0, 0, 0, W - T))
    else:
        ckv_c, kr_c = ckv[:, T - W:], kr[:, T - W:]
    return out, ckv_c, kr_c


def mla_decode(p: MLA, x: torch.Tensor, q_pos: torch.Tensor,
               ckv_cache: torch.Tensor, kr_cache: torch.Tensor,
               slot_pos: torch.Tensor, slot: int, cfg: ModelConfig,
               window: Optional[int]) -> torch.Tensor:
    """x (B,1,d); ckv_cache (B,W,r) and kr_cache (B,W,dr) of one layer,
    written in place at ``slot``; ``slot_pos`` already marks the current
    token."""
    q = _q_proj(p, x, q_pos[:, None], cfg)
    ckv, kr = _compress(p, x, q_pos[:, None], cfg)
    attn.write_slot(ckv_cache, slot, ckv[:, 0])
    attn.write_slot(kr_cache, slot, kr[:, 0])
    mask = attn.decode_mask(q_pos, slot_pos, window)
    return _expand_attend(p, q, ckv_cache, kr_cache, mask, cfg)
