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


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor, window: Optional[int] = None,
                      scale: Optional[float] = None,
                      prefix_len: int = 0) -> torch.Tensor:
    """Causal + left-pad-masked GQA attention with an optional
    bidirectional prefix.

    q (B,T,Hq,D); k/v (B,T,Hkv,D); positions (B,T) with pads < 0.  Query
    token i attends to key token j where the positions allow it: causally
    (within ``window``), or, for a valid query, to every valid key at a
    position below ``prefix_len`` (the JAX package's prefix-LM mask, which
    overrides the window); and always to itself (the diagonal by index
    keeps the pad rows finite).  Scores
    and the softmax are float32; the probabilities are rounded to V's type
    before the PV product, as in the JAX oracle.  Returns (B,T,Hq,D) in q's
    type.
    """
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    pq = positions[:, :, None]
    pk = positions[:, None, :]
    mask = (pk >= 0) & (pk <= pq)
    if window is not None:
        mask = mask & (pq - pk < window)
    if prefix_len:
        mask = mask | ((pk >= 0) & (pk < prefix_len) & (pq >= 0))
    mask = mask | torch.eye(T, dtype=torch.bool, device=q.device)[None]
    qr = q.reshape(B, T, Hkv, G, D).float()
    s = torch.einsum("bthgd,bshd->bhgts", qr, k.float()) * scale
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, T, Hq, v.shape[-1]).to(q.dtype)


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


def _rope_ref(x: torch.Tensor, positions: torch.Tensor,
              theta: float) -> torch.Tensor:
    """Llama half-rotation RoPE, the arithmetic of
    ``models.common.apply_rope`` kept local so this module imports no
    model code.  x (..., T, H, D); positions (..., T)."""
    D = x.shape[-1]
    exps = torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D
    freqs = 1.0 / (theta ** exps)
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def fused_rope_prefill_write_ref(k_new: torch.Tensor, v_new: torch.Tensor,
                                 positions: torch.Tensor,
                                 block_table: torch.Tensor,
                                 k_pages: torch.Tensor, v_pages: torch.Tensor,
                                 theta: float = 10000.0) -> None:
    """Rotate prefill K at its absolute positions, then scatter K/V into
    the paged pool, in place.

    k/v_new (B,T,Hkv,D) *unrotated*; positions (B,T) (pads < 0, real
    tokens at their absolute position == destination logical slot);
    block_table (B,nb); k/v_pages (P,pg,Hkv,D).  V is written unrotated;
    slots that no token names (a shared prefix below a tail) are left as
    they were."""
    kr = _rope_ref(k_new, positions.clamp(min=0), theta)
    paged_prefill_write_ref(kr, v_new, positions, block_table, k_pages,
                            v_pages)


def fused_rope_decode_append_ref(q: torch.Tensor, k_new: torch.Tensor,
                                 v_new: torch.Tensor,
                                 block_table: torch.Tensor,
                                 slot_pos: torch.Tensor, slots: torch.Tensor,
                                 q_pos: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor,
                                 theta: float = 10000.0,
                                 window: Optional[int] = None,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """Rotate the new q/k token at ``q_pos``, append its K/V to logical
    slot ``slots`` of the pool in place, then run paged decode attention
    over the pool after the append.

    q (B,Hq,D) and k/v_new (B,Hkv,D) *unrotated*; slot_pos (B,nb·pg)
    already marks the new token's slot (it attends to itself); slots (B,);
    q_pos (B,).  Returns out (B,Hq,D)."""
    qr = _rope_ref(q[:, None], q_pos[:, None], theta)[:, 0]
    knr = _rope_ref(k_new[:, None], q_pos[:, None], theta)[:, 0]
    pg = k_pages.shape[1]
    slots = slots.long()
    page = torch.gather(block_table.long(), 1, (slots // pg)[:, None])[:, 0]
    off = slots % pg
    k_pages[page, off] = knr.to(k_pages.dtype)
    v_pages[page, off] = v_new.to(v_pages.dtype)
    return paged_decode_attention_ref(qr, k_pages, v_pages, block_table,
                                      slot_pos, q_pos, window=window,
                                      scale=scale)


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


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 B: torch.Tensor, C: torch.Tensor, Q: int,
                 init_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan (Mamba-2, arXiv:2405.21060): the plain version of
    the ``ssd_scan`` kernel.

    x (B,T,H,P); dt (B,T,H) >= 0 (0 at pads); A (H,) negative; B,C
    (B,T,G,N), group g serving heads g·H/G .. (g+1)·H/G - 1.  Returns
    (y (B,T,H,P), final_state (B,H,P,N)).  T % Q must be 0.

    Line for line the JAX oracle ``ssd_scan_ref``, but for one change: the
    decay exponent ``cum_t - cum_s`` is masked to -inf above the diagonal
    *before* ``exp``.  The oracle exponentiates every (t, s) and masks
    afterwards by multiplying; where one chunk's sum of dt·|A| passes
    ln(float32 max) ≈ 88.7, ``exp`` of the upper triangle overflows to inf
    and ``inf · 0`` gives NaN (ROADMAP C2; the full-width mamba2-130m hits
    it at its first 128-token chunk).  The Pallas kernel masks with
    ``where`` and stays finite; this version computes its function, which
    equals the oracle's wherever the oracle is finite.
    """
    Bsz, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    nc = T // Q
    rep = H // G
    xc = x.reshape(Bsz, nc, Q, H, P)
    dtc = dt.reshape(Bsz, nc, Q, H)
    Bc = B.reshape(Bsz, nc, Q, G, N)
    Cc = C.reshape(Bsz, nc, Q, G, N)

    log_a = dtc * A  # (B,nc,Q,H), <= 0
    cum = torch.cumsum(log_a, dim=2)  # inclusive cumsum within chunk
    # intra-chunk: y[t] += sum_{s<=t} (C_t.B_s) e^{cum_t-cum_s} dt_s x_s
    CB = torch.einsum("bcqgn,bckgn->bcgqk", Cc, Bc)  # (B,nc,G,Q,Q)
    CB = CB.repeat_interleave(rep, dim=2)  # (B,nc,H,Q,Q)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,nc,Q,Q,H) t,s
    decay = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                  float("-inf")))
    w = CB * decay.permute(0, 1, 4, 2, 3) * causal[None, None, None]
    w = w * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]  # dt_s
    y_intra = torch.einsum("bchqk,bckhp->bcqhp", w, xc)
    # chunk states: S_c = sum_s e^{cum_end - cum_s} dt_s B_s (x) x_s
    seg = torch.exp(cum[:, :, -1:, :] - cum) * dtc  # (B,nc,Q,H)
    Bh = Bc.repeat_interleave(rep, dim=3)  # (B,nc,Q,H,N)
    S = torch.einsum("bcqh,bcqhn,bcqhp->bchpn", seg, Bh, xc)
    # inter-chunk recurrence, emitting the state *entering* each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,nc,H)
    h = (init_state if init_state is not None
         else torch.zeros((Bsz, H, P, N), dtype=S.dtype, device=x.device))
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S[:, c]
    h_in = torch.stack(h_in, dim=1)  # (B,nc,H,P,N)
    # inter-chunk contribution: y[t] += C_t . (e^{cum_t} * h_in)
    Ch = Cc.repeat_interleave(rep, dim=3)  # (B,nc,Q,H,N)
    y_inter = torch.einsum("bcqhn,bchpn->bcqhp", Ch, h_in) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, T, H, P)
    return y, h


def graph_loop_ref(step: torch.Tensor, done: torch.Tensor,
                   limit: int) -> torch.Tensor:
    """The decode loop's condition (the JAX engines' ``while_loop``
    ``cond``): ``step < limit and not all(done)`` for a 0-d int64 step
    counter and (B,) bool flags, as a 0-d bool tensor."""
    return (step < limit) & ~done.all()
