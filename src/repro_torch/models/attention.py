"""Attention layers with KV caches for static-batch serving.

PyTorch counterpart of ``repro.models.attention``.  The cache conventions
are the JAX package's: static batches are left-padded, ``slot_pos``
(B, W) holds the absolute position stored in each slot (-1 = empty), and
the paged layout addresses logical slot ``s`` of row ``b`` as page
``block_table[b, s // pg]``, offset ``s % pg``.

Caches and page pools are updated **in place**: the JAX functions return
new arrays (with buffer donation under ``jit``), the port writes into the
tensors it is given and returns only the layer output.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import Dense, ModelConfig, apply_rope

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

#: prompts at or above this many tokens take the q-blocked path
CHUNK_THRESHOLD = 2048
_DEFAULT_BLOCK_Q = 512

_FUSED_TODO = ("attn_impl='fused' (the fused RoPE + paged-KV kernels) is "
               "not ported yet: ROADMAP queue B3/B4")


class KVCache(NamedTuple):
    """Dense per-model KV cache; k/v carry a leading layer axis."""

    k: torch.Tensor         # (L, B, W, Hkv, D)
    v: torch.Tensor         # (L, B, W, Hkv, D)
    slot_pos: torch.Tensor  # (B, W) int32 absolute position per slot, -1 empty
    write_idx: int          # next global slot counter
    lengths: torch.Tensor   # (B,) int32 real (unpadded) input lengths

    @property
    def window(self) -> int:
        return self.k.shape[2]


# ---------------------------------------------------------------------------
# core attention math (plain torch; the kernels mirror it)
# ---------------------------------------------------------------------------
def gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,T,Hq,D), k/v (B,S,Hkv,D), mask (B,1,T,S) bool -> (B,T,Hq,D).

    Scores and softmax in float32; the probabilities are rounded to V's
    type before the PV product, as in the JAX reference."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qr = q.reshape(B, T, Hkv, G, D).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qr, k.float()) * scale
    scores = torch.where(mask[:, :, None], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, T, Hq, v.shape[-1]).to(q.dtype)


#: most float32 scores one ``gqa_attend`` call builds at once (1 GiB): a
#: prefill batch of 32 rows of 1024 tokens at 32 heads would otherwise
#: hold 4 GiB of scores, and several copies of them, beside a page pool
#: sized to most of the card
_SCORE_BUDGET = 1 << 28


def gqa_attend_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor, scale: float) -> torch.Tensor:
    """``gqa_attend`` over blocks of queries whose scores fit
    ``_SCORE_BUDGET``; each query row's maths is unchanged.  mask
    (B,1,T,S)."""
    B, T, Hq, _ = q.shape
    bq = max(1, _SCORE_BUDGET // (B * Hq * k.shape[1]))
    if bq >= T:
        return gqa_attend(q, k, v, mask, scale)
    return torch.cat([gqa_attend(q[:, s:s + bq], k, v, mask[:, :, s:s + bq],
                                 scale) for s in range(0, T, bq)], dim=1)


def prefill_mask(positions: torch.Tensor,
                 window: Optional[int]) -> torch.Tensor:
    """Causal mask over left-padded prefill. positions (B,T) with pads < 0."""
    pq = positions[:, :, None]
    pk = positions[:, None, :]
    m = (pk >= 0) & (pk <= pq)
    if window is not None:
        m = m & (pq - pk < window)
    # pad query rows would be fully masked -> allow the diagonal
    T = positions.shape[1]
    m = m | torch.eye(T, dtype=torch.bool, device=positions.device)[None]
    return m[:, None]


def decode_mask(q_pos: torch.Tensor, slot_pos: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """q_pos (B,), slot_pos (B,W) -> (B,1,1,W)."""
    m = (slot_pos >= 0) & (slot_pos <= q_pos[:, None])
    if window is not None:
        m = m & (q_pos[:, None] - slot_pos < window)
    return m[:, None, None]


def gqa_attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, positions: torch.Tensor,
                       window: Optional[int],
                       block_q: int = _DEFAULT_BLOCK_Q) -> torch.Tensor:
    """Causal, left-pad-masked attention over blocks of queries, so the
    (T, S) score matrix is never built whole.  Shapes as ``gqa_attend``."""
    B, T, Hq, _ = q.shape
    bq = max(1, min(block_q, _SCORE_BUDGET // (B * Hq * k.shape[1])))
    pk = positions[:, None, :]
    outs = []
    for s in range(0, T, bq):
        pq = positions[:, s:s + bq, None]
        m = (pk >= 0) & (pk <= pq)
        if window is not None:
            m = m & (pq - pk < window)
        m = m | ((pq < 0) & (pk < 0))  # pads attend pads (NaN guard)
        outs.append(gqa_attend(q[:, s:s + bq], k, v, m[:, None], scale))
    return torch.cat(outs, dim=1)


# ---------------------------------------------------------------------------
# attention layer
# ---------------------------------------------------------------------------
class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        D, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
        self.wq = Dense(cfg.d_model, Hq * D, cfg.dtype, device)
        self.wk = Dense(cfg.d_model, Hkv * D, cfg.dtype, device)
        self.wv = Dense(cfg.d_model, Hkv * D, cfg.dtype, device)
        self.wo = Dense(Hq * D, cfg.d_model, cfg.dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.wq, self.wk, self.wv, self.wo):
            m.reset_parameters(generator)


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    B, T, _ = x.shape
    q = p.wq(x).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = p.wk(x).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = p.wv(x).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def check_impl(impl: str) -> None:
    """Raise unless ``impl`` is the ported ``"unfused"`` path."""
    if impl == "fused":
        raise NotImplementedError(_FUSED_TODO)
    if impl != "unfused":
        raise ValueError(f"unknown attention impl {impl!r}")


def attention_prefill(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig, window: Optional[int],
                      cache_window: int,
                      mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill that also returns the layer's (k_cache, v_cache) of width W."""
    B, T, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    rp = positions.clamp(min=0)
    q = apply_rope(q, rp, cfg.rope_theta)
    k = apply_rope(k, rp, cfg.rope_theta)
    scale = cfg.head_dim ** -0.5
    if T >= CHUNK_THRESHOLD:
        o = gqa_attend_chunked(q, k, v, scale, positions, window)
    else:
        if mask is None:
            mask = prefill_mask(positions, window)
        o = gqa_attend_blocked(q, k, v, mask, scale)
    out = p.wo(o.reshape(B, T, -1))
    W = cache_window
    if W >= T:
        pad = (0, 0, 0, 0, 0, W - T)
        kc = torch.nn.functional.pad(k, pad)
        vc = torch.nn.functional.pad(v, pad)
    else:  # ring: keep the last W entries (window-limited decode)
        kc, vc = k[:, T - W:], v[:, T - W:]
    return out, kc, vc


def attention_prefill_paged(p: Attention, x: torch.Tensor,
                            positions: torch.Tensor, cfg: ModelConfig,
                            window: Optional[int], k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_table: torch.Tensor,
                            mask: Optional[torch.Tensor] = None,
                            impl: str = "unfused") -> torch.Tensor:
    """Prefill that lands K/V in the paged pool, in place.

    The attention maths is ``attention_prefill``'s; each valid token's
    K/V is then written to page ``block_table[b, pos // pg]`` at offset
    ``pos % pg`` by ``kernels.ops.paged_prefill_write``.  k/v_pages
    (P,pg,Hkv,D) are one layer's pools.  Returns the layer output."""
    check_impl(impl)
    B, T, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    rp = positions.clamp(min=0)
    q = apply_rope(q, rp, cfg.rope_theta)
    k = apply_rope(k, rp, cfg.rope_theta)
    scale = cfg.head_dim ** -0.5
    if T >= CHUNK_THRESHOLD:
        o = gqa_attend_chunked(q, k, v, scale, positions, window)
    else:
        if mask is None:
            mask = prefill_mask(positions, window)
        o = gqa_attend_blocked(q, k, v, mask, scale)
    out = p.wo(o.reshape(B, T, -1))
    kernel_ops.paged_prefill_write(k.contiguous(), v.contiguous(), positions,
                                   block_table, k_pages, v_pages)
    return out


def attention_prefill_tail_paged(p: Attention, x: torch.Tensor,
                                 positions: torch.Tensor, cfg: ModelConfig,
                                 window: Optional[int],
                                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                                 block_table: torch.Tensor,
                                 slot_pos: torch.Tensor,
                                 impl: str = "unfused") -> torch.Tensor:
    """Tail prefill over a paged pool whose head KV is already resident.

    ``x`` (B,T,d) holds each row's novel tail (left-padded, pad positions
    < 0); ``positions`` are absolute (prefix_len .. total_len-1) and double
    as the destination slots; ``slot_pos`` (B, nb·pg) covers the whole
    logical window including the tail.  The tail K/V is written into the
    pages first, then every tail query attends to the gathered window
    under ``slot_pos <= q_pos``.  Shared prefix pages are only read."""
    check_impl(impl)
    B, T, _ = x.shape
    pg = k_pages.shape[1]
    nb = block_table.shape[1]
    q, k, v = _qkv(p, x, cfg)
    rp = positions.clamp(min=0)
    q = apply_rope(q, rp, cfg.rope_theta)
    k = apply_rope(k, rp, cfg.rope_theta)
    kernel_ops.paged_prefill_write(k.contiguous(), v.contiguous(), positions,
                                   block_table, k_pages, v_pages)
    Hkv = k_pages.shape[2]
    bt = block_table.long()
    kw = k_pages[bt].reshape(B, nb * pg, Hkv, k_pages.shape[-1])
    vw = v_pages[bt].reshape(B, nb * pg, Hkv, v_pages.shape[-1])
    pq = positions[:, :, None]
    pk = slot_pos[:, None, :]
    m = (pk >= 0) & (pk <= pq)
    if window is not None:
        m = m & (pq - pk < window)
    # pad query rows would be fully masked -> attend slot 0 (output unused)
    first = torch.arange(nb * pg, device=x.device)[None, None, :] == 0
    m = m | ((pq < 0) & first)
    o = gqa_attend_blocked(q, kw, vw, m[:, None], cfg.head_dim ** -0.5)
    return p.wo(o.reshape(B, T, -1))


def attention_decode(p: Attention, x: torch.Tensor, q_pos: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     slot_pos: torch.Tensor, slot: int, cfg: ModelConfig,
                     window: Optional[int]) -> torch.Tensor:
    """One-token decode over a dense cache. x (B,1,d); k/v_cache
    (B,W,Hkv,D) of one layer, written in place at ``slot``; ``slot_pos``
    already includes the current token's position."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, q_pos[:, None], cfg.rope_theta)
    k = apply_rope(k, q_pos[:, None], cfg.rope_theta)
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    mask = decode_mask(q_pos, slot_pos, window)
    o = gqa_attend(q, k_cache, v_cache, mask, cfg.head_dim ** -0.5)
    return p.wo(o.reshape(B, 1, -1))


def attention_decode_paged(p: Attention, x: torch.Tensor, q_pos: torch.Tensor,
                           k_pages: torch.Tensor, v_pages: torch.Tensor,
                           block_table: torch.Tensor, slot_pos: torch.Tensor,
                           slots: torch.Tensor, cfg: ModelConfig,
                           window: Optional[int],
                           impl: str = "unfused") -> torch.Tensor:
    """Decode over a paged KV cache with per-row write slots.

    x (B,1,d); k/v_pages (P,pg,Hkv,D) one layer's pools; block_table
    (B,nb); slot_pos (B,nb·pg) already marking the current token; slots
    (B,) logical write slots.  The new K/V is scattered into its page in
    place (rows of the null page write there harmlessly), then attention
    runs through ``kernels.ops.paged_decode_attention``."""
    check_impl(impl)
    B = x.shape[0]
    pg = k_pages.shape[1]
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, q_pos[:, None], cfg.rope_theta)
    k = apply_rope(k, q_pos[:, None], cfg.rope_theta)
    slots = slots.long()
    pages = torch.gather(block_table.long(), 1, (slots // pg)[:, None])[:, 0]
    offs = slots % pg
    k_pages[pages, offs] = k[:, 0]
    v_pages[pages, offs] = v[:, 0]
    o = kernel_ops.paged_decode_attention(q[:, 0].contiguous(), k_pages,
                                          v_pages, block_table, slot_pos,
                                          q_pos, window=window)
    return p.wo(o.reshape(B, 1, -1))


# ---------------------------------------------------------------------------
# dense cache bookkeeping
# ---------------------------------------------------------------------------
def prefill_slot_pos(positions: torch.Tensor, cache_window: int
                     ) -> torch.Tensor:
    """slot_pos after prefill of T left-padded tokens into W slots."""
    B, T = positions.shape
    W = cache_window
    pos = positions.to(torch.int32)
    if W >= T:
        pad = torch.full((B, W - T), -1, dtype=torch.int32,
                         device=positions.device)
        return torch.cat([pos, pad], dim=1)
    return pos[:, T - W:]


def decode_slot(cache: KVCache) -> int:
    """Ring slot of the next decode write."""
    return cache.write_idx % cache.window


def decode_slot_pos(cache: KVCache, q_pos: torch.Tensor) -> torch.Tensor:
    slot_pos = cache.slot_pos.clone()
    slot_pos[:, decode_slot(cache)] = q_pos.to(torch.int32)
    return slot_pos
