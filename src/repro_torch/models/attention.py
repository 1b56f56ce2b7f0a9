"""Attention layers with KV caches for static-batch serving.

PyTorch counterpart of ``repro.models.attention``.  The cache conventions
are the JAX package's: static batches are left-padded, ``slot_pos``
(B, W) holds the absolute position stored in each slot (-1 = empty), and
the paged layout addresses logical slot ``s`` of row ``b`` as page
``block_table[b, s // pg]``, offset ``s % pg``.

Caches and page pools are updated **in place**: the JAX functions return
new arrays (with buffer donation under ``jit``), the port writes into the
tensors it is given and returns only the layer output.

Dense attention goes through ``kernels.ops``: ``flash_prefill`` for every
prefill (the JAX package's ``prefill_attention`` switch, whose Pallas
kernel is meant to carry this path on a chip; a VLM's bidirectional image
prefix and an encoder's bidirectional frames by its ``prefix_len``) and
``decode_attention`` for every dense decode step, and for an
encoder-decoder model's cross-attention decode over the source frames
(``cross_decode_attend``).  ``ops`` launches the kernel for CUDA tensors
and runs its plain version for CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.common import (Dense, ModelConfig, apply_rope,
                                       pad, split_heads)

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)

#: prompts at or above this many tokens take the q-blocked path
CHUNK_THRESHOLD = 2048
_DEFAULT_BLOCK_Q = 512

#: the paged paths' attention implementations: "unfused" rotates K with
#: torch and writes / attends through paged_prefill_write and
#: paged_decode_attention; "fused" hands the unrotated K (and q at decode)
#: to fused_rope_prefill_write and fused_rope_decode_append
ATTN_IMPLS = ("unfused", "fused")


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
    type before the PV product, as in the JAX reference.  DTensors attend
    on each rank's local rows and heads (``kernels.ops.on_local_heads``)."""
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        return kernel_ops.on_local_heads(
            lambda q, k, v, m: gqa_attend(q, k, v, m, scale), q, (k, v),
            (mask,), 2, 2)
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
    (B,1,T,S); DTensors as ``gqa_attend``."""
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        return kernel_ops.on_local_heads(
            lambda q, k, v, m: gqa_attend_blocked(q, k, v, m, scale), q,
            (k, v), (mask,), 2, 2)
    B, T, Hq, _ = q.shape
    bq = max(1, _SCORE_BUDGET // (B * Hq * k.shape[1]))
    if bq >= T:
        return gqa_attend(q, k, v, mask, scale)
    return torch.cat([gqa_attend(q[:, s:s + bq], k, v, mask[:, :, s:s + bq],
                                 scale) for s in range(0, T, bq)], dim=1)


def prefill_mask(positions: torch.Tensor, window: Optional[int],
                 prefix_len: int = 0) -> torch.Tensor:
    """Causal mask over left-padded prefill. positions (B,T) with pads < 0.
    With ``prefix_len``, every valid query also sees the valid keys at
    positions below it (the JAX package's ``_mask_with_prefix``: a VLM's
    bidirectional image prefix, which overrides the window)."""
    pq = positions[:, :, None]
    pk = positions[:, None, :]
    m = (pk >= 0) & (pk <= pq)
    if window is not None:
        m = m & (pq - pk < window)
    if prefix_len:
        m = m | ((pk >= 0) & (pk < prefix_len) & (pq >= 0))
    # pad query rows would be fully masked -> allow the diagonal
    T = positions.shape[1]
    m = m | torch.eye(T, dtype=torch.bool, device=positions.device)[None]
    return m[:, None]


def decode_mask(q_pos: torch.Tensor, slot_pos: torch.Tensor,
                window: Optional[int]) -> torch.Tensor:
    """q_pos (B,), slot_pos (B,W) -> (B,1,1,W): the live slots of a
    one-token query, for the torch paths that attend without a decode
    kernel (MLA) and for an SDPA call over a dense or ring cache."""
    qp = q_pos[:, None]
    m = (slot_pos >= 0) & (slot_pos <= qp)
    if window is not None:
        m = m & (qp - slot_pos < window)
    return m[:, None, None]


def gqa_attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float, positions: torch.Tensor,
                       window: Optional[int], prefix_len: int = 0,
                       block_q: int = _DEFAULT_BLOCK_Q) -> torch.Tensor:
    """Causal, left-pad-masked attention over blocks of queries, so the
    (T, S) score matrix is never built whole; with ``prefix_len`` the JAX
    ``_chunk_mask``'s bidirectional prefix term.  Shapes as
    ``gqa_attend``; DTensors as there."""
    if isinstance(q, DTensor) or isinstance(k, DTensor):
        return kernel_ops.on_local_heads(
            lambda q, k, v, pos: gqa_attend_chunked(
                q, k, v, scale, pos, window, prefix_len, block_q),
            q, (k, v), (positions,), 2, 2)
    B, T, Hq, _ = q.shape
    bq = max(1, min(block_q, _SCORE_BUDGET // (B * Hq * k.shape[1])))
    pk = positions[:, None, :]
    outs = []
    for s in range(0, T, bq):
        pq = positions[:, s:s + bq, None]
        m = (pk >= 0) & (pk <= pq)
        if window is not None:
            m = m & (pq - pk < window)
        if prefix_len:
            m = m | ((pk >= 0) & (pk < prefix_len) & (pq >= 0))
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
        bias = cfg.qkv_bias
        self.wq = Dense(cfg.d_model, Hq * D, cfg.dtype, device, bias=bias)
        self.wk = Dense(cfg.d_model, Hkv * D, cfg.dtype, device, bias=bias)
        self.wv = Dense(cfg.d_model, Hkv * D, cfg.dtype, device, bias=bias)
        self.wo = Dense(Hq * D, cfg.d_model, cfg.dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.wq, self.wk, self.wv, self.wo):
            m.reset_parameters(generator)


def _qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig):
    """q, k and v of x (B,T,d), each with its bias where the config has
    one, unrotated: every path rotates q and k (or hands them to a fused
    kernel that does) after this."""
    B, T, _ = x.shape
    q = split_heads(p.wq(x), B, T, cfg.n_heads, cfg.head_dim)
    k = split_heads(p.wk(x), B, T, cfg.n_kv_heads, cfg.head_dim)
    v = split_heads(p.wv(x), B, T, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def check_impl(impl: str) -> None:
    """Raise ``ValueError`` unless ``impl`` is one of ``ATTN_IMPLS``."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r} (expected one of "
                         f"{ATTN_IMPLS})")


def _gather_window(pages: torch.Tensor, block_table: torch.Tensor
                   ) -> torch.Tensor:
    """A row's logical window (B, nb·pg, Hkv, D) gathered from one layer's
    pool through its block table."""
    B, nb = block_table.shape
    return pages[block_table.long()].reshape(
        B, nb * pages.shape[1], pages.shape[2], pages.shape[3])


def prefill_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, window: Optional[int],
                   scale: float, prefix_len: int = 0) -> torch.Tensor:
    """Causal, left-pad-masked prefill attention; valid queries also see
    the valid keys at positions below ``prefix_len`` (a bidirectional
    prefix; 0: none). q (B,T,Hq,D), k/v (B,T,Hkv,D), positions (B,T) int32
    with pads < 0 -> (B,T,Hq,D).

    Goes through ``kernels.ops.flash_prefill`` (the kernel on the card, its
    plain version on the CPU) for every T, with one CPU exception: from
    ``CHUNK_THRESHOLD`` tokens the CPU takes the chunked path, so that it
    never builds (B,Hq,T,T) scores.  That path's pad-row rule (pads attend
    pads) differs from the kernel's diagonal only on pad query rows, which
    no real token reads.  DTensors take the same path on each rank's
    local rows and heads (``kernels.ops.on_local_heads``)."""
    if isinstance(q, DTensor):
        return kernel_ops.on_local_heads(
            lambda q, k, v, pos: prefill_attend(q, k, v, pos, window, scale,
                                                prefix_len),
            q, (k, v), (positions,), 2, 2)
    T = q.shape[1]
    if q.is_cuda or T < CHUNK_THRESHOLD:
        return kernel_ops.flash_prefill(q.contiguous(), k.contiguous(),
                                        v.contiguous(), positions,
                                        window=window, prefix_len=prefix_len)
    return gqa_attend_chunked(q, k, v, scale, positions, window, prefix_len)


def dense_decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                        v_cache: torch.Tensor, slot_pos: torch.Tensor,
                        q_pos: torch.Tensor,
                        window: Optional[int]) -> torch.Tensor:
    """One query token per row over a dense cache. q (B,1,Hq,D), k/v_cache
    (B,W,Hkv,D) -> (B,1,Hq,D), through ``kernels.ops.decode_attention``."""
    return kernel_ops.decode_attention(
        q[:, 0].contiguous(), k_cache, v_cache, slot_pos,
        q_pos.to(torch.int32), window=window)[:, None]


def attention_forward(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig, window: Optional[int],
                      prefix_len: int = 0) -> torch.Tensor:
    """Full-sequence attention without a cache, in plain torch: no kernel
    runs here on any device (``transformer.forward``, the reference the
    serving paths' kernels are held against).  x (B,T,d), positions (B,T)
    with pads < 0; ``prefix_len`` as ``prefill_mask``; from
    ``CHUNK_THRESHOLD`` tokens the q-blocked path.  DTensors attend on
    each rank's local rows and heads."""
    B, T, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    rp = positions.clamp(min=0)
    q = apply_rope(q, rp, cfg.rope_theta)
    k = apply_rope(k, rp, cfg.rope_theta)
    scale = cfg.head_dim ** -0.5

    def attend(q, k, v, positions):
        if T >= CHUNK_THRESHOLD:
            return gqa_attend_chunked(q, k, v, scale, positions, window,
                                      prefix_len)
        return gqa_attend_blocked(
            q, k, v, prefill_mask(positions, window, prefix_len), scale)

    if isinstance(q, DTensor):
        o = kernel_ops.on_local_heads(attend, q, (k, v), (positions,), 2, 2)
    else:
        o = attend(q, k, v, positions)
    return p.wo(o.reshape(B, T, -1))


def attention_prefill(p: Attention, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig, window: Optional[int],
                      cache_window: int, prefix_len: int = 0
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill that also returns the layer's (k_cache, v_cache) of width W.
    The attention is ``prefill_attend``'s (``prefix_len`` as there)."""
    B, T, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    rp = positions.clamp(min=0)
    q = apply_rope(q, rp, cfg.rope_theta)
    k = apply_rope(k, rp, cfg.rope_theta)
    o = prefill_attend(q, k, v, positions, window, cfg.head_dim ** -0.5,
                       prefix_len=prefix_len)
    out = p.wo(o.reshape(B, T, -1))
    W = cache_window
    if W >= T:
        widths = (0, 0, 0, 0, 0, W - T)
        kc, vc = pad(k, widths), pad(v, widths)
    else:  # ring: keep the last W entries (window-limited decode)
        kc, vc = k[:, T - W:], v[:, T - W:]
    return out, kc, vc


def attention_prefill_paged(p: Attention, x: torch.Tensor,
                            positions: torch.Tensor, cfg: ModelConfig,
                            window: Optional[int], k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_table: torch.Tensor,
                            impl: str = "unfused") -> torch.Tensor:
    """Prefill that lands K/V in the paged pool, in place.

    The attention is ``attention_prefill``'s (``prefill_attend``: the
    ``flash_prefill`` kernel on the card); each valid token's K/V is then
    written to page ``block_table[b, pos // pg]`` at offset ``pos % pg``
    by ``kernels.ops.paged_prefill_write``.  k/v_pages (P,pg,Hkv,D) are
    one layer's pools.  Returns the layer output.

    ``impl="fused"`` hands the unrotated K to
    ``kernels.ops.fused_rope_prefill_write``, which rotates it while it
    writes the pages, and the queries attend to the rotated K/V gathered
    back from the pages (a window whose length is not the queries', so not
    ``flash_prefill``'s function).  Prompts of ``CHUNK_THRESHOLD`` tokens
    or more take the unfused path either way."""
    check_impl(impl)
    B, T, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    rp = positions.clamp(min=0)
    q = apply_rope(q, rp, cfg.rope_theta)
    scale = cfg.head_dim ** -0.5
    if impl == "fused" and T < CHUNK_THRESHOLD:
        kernel_ops.fused_rope_prefill_write(
            k.contiguous(), v.contiguous(), positions, block_table, k_pages,
            v_pages, theta=cfg.rope_theta)
        kw = _gather_window(k_pages, block_table)
        vw = _gather_window(v_pages, block_table)
        W = kw.shape[1]
        lengths = (positions >= 0).sum(dim=1)
        slots = torch.arange(W, dtype=torch.int32, device=x.device)[None]
        pk = torch.where(slots < lengths[:, None], slots, -1)[:, None, :]
        pq = positions[:, :, None]
        m = (pk >= 0) & (pk <= pq)
        if window is not None:
            m = m & (pq - pk < window)
        # pad query rows would be fully masked -> attend slot 0 (output
        # unused)
        m = m | ((pq < 0) & (slots[:, None, :] == 0))
        o = gqa_attend_blocked(q, kw, vw, m[:, None], scale)
        return p.wo(o.reshape(B, T, -1))
    k = apply_rope(k, rp, cfg.rope_theta)
    o = prefill_attend(q, k, v, positions, window, scale)
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
    under ``slot_pos <= q_pos``.  Shared prefix pages are only read.
    ``impl="fused"`` rotates the tail K inside the page write
    (``kernels.ops.fused_rope_prefill_write``)."""
    check_impl(impl)
    B, T, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    rp = positions.clamp(min=0)
    q = apply_rope(q, rp, cfg.rope_theta)
    if impl == "fused":
        kernel_ops.fused_rope_prefill_write(
            k.contiguous(), v.contiguous(), positions, block_table, k_pages,
            v_pages, theta=cfg.rope_theta)
    else:
        k = apply_rope(k, rp, cfg.rope_theta)
        kernel_ops.paged_prefill_write(k.contiguous(), v.contiguous(),
                                       positions, block_table, k_pages,
                                       v_pages)
    kw = _gather_window(k_pages, block_table)
    vw = _gather_window(v_pages, block_table)
    W = kw.shape[1]
    pq = positions[:, :, None]
    pk = slot_pos[:, None, :]
    m = (pk >= 0) & (pk <= pq)
    if window is not None:
        m = m & (pq - pk < window)
    # pad query rows would be fully masked -> attend slot 0 (output unused)
    first = torch.arange(W, device=x.device)[None, None, :] == 0
    m = m | ((pq < 0) & first)
    o = gqa_attend_blocked(q, kw, vw, m[:, None], cfg.head_dim ** -0.5)
    return p.wo(o.reshape(B, T, -1))


def cross_slot_pos(src_valid: torch.Tensor) -> torch.Tensor:
    """(B,S) int32 ``slot_pos`` of a cross-attention over source frames
    for ``cross_decode_attend``: 0 for a valid frame, -1 for an invalid
    one."""
    return torch.where(src_valid, 0, -1).to(torch.int32)


def cross_decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        slot_pos: torch.Tensor) -> torch.Tensor:
    """One query token per row over the source frames: q (B,1,Hq,D), k/v
    (B,S,Hkv,D) contiguous, slot_pos (B,S) from ``cross_slot_pos`` ->
    (B,1,Hq,D).  Through ``kernels.ops.decode_attention`` (B6) with every
    query at position 0 and no window, so a frame is seen exactly where
    it is valid: JAX's mask ``src_valid[:, None, None, :]``
    (``repro.models.encdec._cross_attend``); a row without a valid frame
    weighs every frame alike, as JAX's fully masked softmax does."""
    B = q.shape[0]
    q_pos = torch.zeros((B,), dtype=torch.int32, device=q.device)
    return kernel_ops.decode_attention(q[:, 0].contiguous(), k, v, slot_pos,
                                       q_pos)[:, None]


def attention_decode(p: Attention, x: torch.Tensor, q_pos: torch.Tensor,
                     k_cache: torch.Tensor, v_cache: torch.Tensor,
                     slot_pos: torch.Tensor, slot: int, cfg: ModelConfig,
                     window: Optional[int]) -> torch.Tensor:
    """One-token decode over a dense cache. x (B,1,d); k/v_cache
    (B,W,Hkv,D) of one layer, written in place at ``slot``; ``slot_pos``
    already includes the current token's position.  The attention is
    ``dense_decode_attend``'s."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, q_pos[:, None], cfg.rope_theta)
    k = apply_rope(k, q_pos[:, None], cfg.rope_theta)
    write_slot(k_cache, slot, k[:, 0])
    write_slot(v_cache, slot, v[:, 0])
    o = dense_decode_attend(q, k_cache, v_cache, slot_pos, q_pos, window)
    return p.wo(o.reshape(B, 1, -1))


def attention_decode_rowslots(p: Attention, x: torch.Tensor,
                              q_pos: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, slot_pos: torch.Tensor,
                              slots: torch.Tensor, cfg: ModelConfig,
                              window: Optional[int]) -> torch.Tensor:
    """Decode with *per-row* write slots (continuous batching: each row of
    the engine is at its own position).  x (B,1,d); k/v_cache (B,W,Hkv,D)
    of one layer, row b written in place at ``slots[b]`` (the values of the
    JAX one-hot blend); ``slot_pos`` already marks the current tokens."""
    B = x.shape[0]
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, q_pos[:, None], cfg.rope_theta)
    k = apply_rope(k, q_pos[:, None], cfg.rope_theta)
    rows = torch.arange(B, device=x.device)
    slots = slots.long()
    k_cache[rows, slots] = k[:, 0]
    v_cache[rows, slots] = v[:, 0]
    o = dense_decode_attend(q, k_cache, v_cache, slot_pos, q_pos, window)
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
    runs through ``kernels.ops.paged_decode_attention``.

    ``impl="fused"`` hands the unrotated q/k/v to
    ``kernels.ops.fused_rope_decode_append``: one launch rotates the new
    token, appends its K/V and attends over the pool after the append."""
    check_impl(impl)
    B = x.shape[0]
    pg = k_pages.shape[1]
    q, k, v = _qkv(p, x, cfg)
    if impl == "fused":
        o = kernel_ops.fused_rope_decode_append(
            q[:, 0].contiguous(), k[:, 0].contiguous(), v[:, 0].contiguous(),
            block_table, slot_pos, slots, q_pos, k_pages, v_pages,
            theta=cfg.rope_theta, window=window)
        return p.wo(o.reshape(B, 1, -1))
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


def write_slot(cache: torch.Tensor, slot: int, value: torch.Tensor) -> None:
    """``cache[:, slot] = value``, in place.  On a DTensor whose dim 1 is
    sharded (the reference's cache rule shards a window that happens to
    equal the KV head count) an indexed write would land in a
    redistributed copy and be lost, so the slot is written through a
    mask over the whole window instead."""
    if isinstance(cache, DTensor) and Shard(1) in cache.placements:
        mesh = cache.device_mesh
        hit = torch.arange(cache.shape[1], device=cache.device) == slot
        hit = DTensor.from_local(hit.view(1, -1, *(1,) * (cache.ndim - 2)),
                                 mesh, [Replicate()] * mesh.ndim)
        cache.copy_(torch.where(hit, value.unsqueeze(1), cache))
        return
    cache[:, slot] = value


def decode_slot(cache: KVCache) -> int:
    """Ring slot of the next decode write."""
    return cache.write_idx % cache.window


def decode_slot_pos(cache: KVCache, q_pos: torch.Tensor) -> torch.Tensor:
    slot_pos = cache.slot_pos.clone()
    write_slot(slot_pos, decode_slot(cache), q_pos.to(torch.int32))
    return slot_pos
