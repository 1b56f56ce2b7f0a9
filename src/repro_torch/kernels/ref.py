"""Plain PyTorch versions of the port's CUDA kernels.

Counterparts of ``repro.kernels.ref``: the kernel wrappers run these on
CPU tensors, the tests hold them against the JAX oracles, and
``chip_smoke.py`` holds each kernel against them on the card.  Nothing on
the main path calls them when the tensors lie on a CUDA device.
"""
from __future__ import annotations

from typing import Optional

import torch

#: finite "minus infinity": a fully masked row softmaxes to a uniform
#: distribution instead of NaN, exactly as in the JAX oracles
NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


def paged_prefill_write_ref(k_new: torch.Tensor, v_new: torch.Tensor,
                            dest_slot: torch.Tensor,
                            block_table: torch.Tensor,
                            k_pages: torch.Tensor,
                            v_pages: torch.Tensor) -> None:
    """Scatter prefill K/V into a paged pool through block tables, in place.

    k/v_new (B,T,Hkv,D); dest_slot (B,T) — the logical cache slot each
    token lands in (< 0 = pad, skipped); block_table (B,nb);
    k/v_pages (P,pg,Hkv,D).  Token (b,t) is written to page
    ``block_table[b, dest_slot//pg]`` at offset ``dest_slot % pg``.
    The JAX oracle routes pads to the null page 0, whose slots are always
    masked; skipping them leaves every observable slot identical.
    """
    B, T, Hkv, D = k_new.shape
    pg = k_pages.shape[1]
    nb = block_table.shape[1]
    valid = dest_slot >= 0
    slot = dest_slot.clamp(0, nb * pg - 1).long()
    page = torch.gather(block_table.long(), 1, slot // pg)
    page, off = page[valid], (slot % pg)[valid]
    k_pages[page, off] = k_new[valid].to(k_pages.dtype)
    v_pages[page, off] = v_new[valid].to(v_pages.dtype)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor,
                               block_table: torch.Tensor,
                               slot_pos: torch.Tensor, q_pos: torch.Tensor,
                               window: Optional[int] = None,
                               scale: Optional[float] = None
                               ) -> torch.Tensor:
    """Single-token GQA decode over a paged KV cache.

    q (B,Hq,D); k/v_pages (P,pg,Hkv,D); block_table (B,nb) physical page
    per logical block; slot_pos (B,nb·pg) (-1 empty); q_pos (B,).
    Materialises the per-row gather that the kernel streams page by page.
    """
    B = q.shape[0]
    pg, Hkv, D = k_pages.shape[1], k_pages.shape[2], k_pages.shape[3]
    nb = block_table.shape[1]
    bt = block_table.long()
    k_cache = k_pages[bt].reshape(B, nb * pg, Hkv, D)
    v_cache = v_pages[bt].reshape(B, nb * pg, Hkv, v_pages.shape[-1])
    return decode_attention_ref(q, k_cache, v_cache, slot_pos, q_pos,
                                window=window, scale=scale)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, slot_pos: torch.Tensor,
                         q_pos: torch.Tensor, window: Optional[int] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Single-token GQA decode over a contiguous KV cache.

    q (B,Hq,D); k/v_cache (B,W,Hkv,D); slot_pos (B,W) (-1 empty);
    q_pos (B,).  Scores and the softmax are float32; the probabilities
    are rounded to V's type before the PV product, as in the JAX oracle.
    Returns (B,Hq,D) in q's type.
    """
    B, Hq, D = q.shape
    Hkv = k_cache.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    qp = q_pos[:, None]
    mask = (slot_pos >= 0) & (slot_pos <= qp)
    if window is not None:
        mask = mask & (qp - slot_pos < window)
    qr = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bwhd->bhgw", qr, k_cache.float()) * scale
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgw,bwhd->bhgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, Hq, v_cache.shape[-1]).to(q.dtype)
