"""Decoder-only transformer LM (dense archs).

PyTorch counterpart of ``repro.models.transformer``.  The parameters are
an ``nn.Module`` (``Transformer``) with one ``Block`` per layer; the JAX
package's stacked leading layer axis becomes a loop over ``layers``.  The
serving functions keep the JAX signatures:

  prefill(params, cfg, tokens, lengths, cache_window)      -> (logits, KVCache)
  decode_step(params, cfg, cache, tokens, step)            -> (logits, KVCache)
  prefill_paged(params, cfg, tokens, lengths, cache)       -> (logits, PagedKVCache)
  prefill_tail_paged(params, cfg, tokens, start, lengths, cache)
  decode_step_paged(params, cfg, cache, tokens, q_pos, slots)

Left-padding convention: ``positions[b, t] < 0`` marks pad tokens.  KV
caches and page pools are written in place; the returned cache carries
the refreshed ``slot_pos``/``lengths``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (MLP, Embed, ModelConfig,
                                       embed_apply, rms_norm, rms_weight,
                                       unembed_apply)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.attn = attn.Attention(cfg, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.dtype, device)
        self.ln_attn = rms_weight(cfg.d_model, cfg.dtype, device)
        self.ln_mlp = rms_weight(cfg.d_model, cfg.dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        with torch.no_grad():
            self.ln_attn.zero_()
            self.ln_mlp.zero_()


class Transformer(nn.Module):
    """Parameters of the dense LM; names follow the JAX parameter tree."""

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
         device: torch.device) -> Transformer:
    """Random weights drawn from ``generator`` (which must live on
    ``device``): N(0, 0.02) embeddings, N(0, d_in^-1) dense layers,
    zero norm gains — the JAX package's recipe."""
    params = Transformer(cfg, device)
    params.reset_parameters(generator)
    return params


def _logits(params: Transformer, cfg: ModelConfig,
            h: torch.Tensor) -> torch.Tensor:
    return unembed_apply(params.embed, rms_norm(h, params.ln_f, cfg.norm_eps))


def _mlp_residual(layer: Block, h: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    return h + layer.mlp(rms_norm(h, layer.ln_mlp, cfg.norm_eps))


def make_positions(tokens: torch.Tensor, lengths: torch.Tensor
                   ) -> torch.Tensor:
    """Left-padded int32 position ids: pads get -1, real tokens
    0..len-1."""
    B, T = tokens.shape
    idx = torch.arange(T, dtype=torch.int32, device=tokens.device)[None]
    pad = T - lengths.to(torch.int32)[:, None]
    return torch.where(idx < pad, -1, idx - pad).to(torch.int32)


def _compact_slot_pos(lengths: torch.Tensor, W: int) -> torch.Tensor:
    """slot s holds position s below the row's length, -1 beyond."""
    slots = torch.arange(W, dtype=torch.int32, device=lengths.device)[None]
    return torch.where(slots < lengths[:, None], slots, -1).to(torch.int32)


# ---------------------------------------------------------------------------
# dense cache (profiling path)
# ---------------------------------------------------------------------------
def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor, cache_window: int,
            window: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
    """Run the prefill phase and build a dense KV cache of width
    ``cache_window``."""
    window = window if window is not None else cfg.sliding_window
    positions = make_positions(tokens, lengths)
    h = embed_apply(params.embed, tokens)
    T = positions.shape[1]
    mask = (None if T >= attn.CHUNK_THRESHOLD
            else attn.prefill_mask(positions, window))
    ks, vs = [], []
    for layer in params.layers:
        x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
        a, kc, vc = attn.attention_prefill(layer.attn, x, positions, cfg,
                                           window, cache_window, mask=mask)
        h = _mlp_residual(layer, h + a, cfg)
        ks.append(kc)
        vs.append(vc)
    logits = _logits(params, cfg, h[:, -1:, :])
    cache = KVCache(k=torch.stack(ks), v=torch.stack(vs),
                    slot_pos=attn.prefill_slot_pos(positions, cache_window),
                    write_idx=T if cache_window >= T else cache_window,
                    lengths=lengths.to(torch.int32))
    return logits[:, 0], cache


def decode_step(params: Transformer, cfg: ModelConfig, cache: KVCache,
                tokens: torch.Tensor, step: int,
                window: Optional[int] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """One decode iteration over a dense cache. tokens (B,); step 0-based."""
    window = window if window is not None else cfg.sliding_window
    q_pos = cache.lengths + step
    slot = attn.decode_slot(cache)
    slot_pos = attn.decode_slot_pos(cache, q_pos)
    h = embed_apply(params.embed, tokens[:, None])
    for l, layer in enumerate(params.layers):
        x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
        a = attn.attention_decode(layer.attn, x, q_pos, cache.k[l],
                                  cache.v[l], slot_pos, slot, cfg, window)
        h = _mlp_residual(layer, h + a, cfg)
    logits = _logits(params, cfg, h)[:, 0]
    return logits, cache._replace(slot_pos=slot_pos,
                                  write_idx=cache.write_idx + 1)


# ---------------------------------------------------------------------------
# persistent paged cache (serving path)
# ---------------------------------------------------------------------------
def prefill_paged(params: Transformer, cfg: ModelConfig,
                  tokens: torch.Tensor, lengths: torch.Tensor,
                  cache: PagedKVCache, window: Optional[int] = None,
                  attn_impl: str = "unfused"
                  ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Prefill that writes K/V straight into the paged pool.

    Same left-padded attention maths as ``prefill``; each layer's K/V
    lands in ``cache.k_pages[l]``/``v_pages[l]`` through the block table
    (``kernels.ops.paged_prefill_write``).  Layout: logical slot ==
    absolute position.  Returns the last token's logits and the cache
    with ``slot_pos``/``lengths`` of the prefilled rows."""
    window = window if window is not None else cfg.sliding_window
    positions = make_positions(tokens, lengths)
    h = embed_apply(params.embed, tokens)
    T = positions.shape[1]
    mask = (None if T >= attn.CHUNK_THRESHOLD
            else attn.prefill_mask(positions, window))
    for l, layer in enumerate(params.layers):
        x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
        a = attn.attention_prefill_paged(
            layer.attn, x, positions, cfg, window, cache.k_pages[l],
            cache.v_pages[l], cache.block_table, mask=mask, impl=attn_impl)
        h = _mlp_residual(layer, h + a, cfg)
    logits = _logits(params, cfg, h[:, -1:, :])
    lengths = lengths.to(torch.int32)
    return logits[:, 0], cache._replace(
        slot_pos=_compact_slot_pos(lengths, cache.window), lengths=lengths)


def prefill_tail_paged(params: Transformer, cfg: ModelConfig,
                       tokens: torch.Tensor, start: torch.Tensor,
                       lengths: torch.Tensor, cache: PagedKVCache,
                       window: Optional[int] = None,
                       attn_impl: str = "unfused"
                       ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Prefill only the novel tail of rows whose first ``start[b]`` tokens
    already live in pages reachable through ``cache.block_table``.

    ``tokens`` holds the left-padded tails; their K/V goes to absolute
    slots ``start..lengths-1`` and the tail queries attend to the whole
    gathered window (``attention.attention_prefill_tail_paged``)."""
    window = window if window is not None else cfg.sliding_window
    start = start.to(torch.int32)
    lengths = lengths.to(torch.int32)
    base = make_positions(tokens, lengths - start)
    positions = torch.where(base >= 0, base + start[:, None],
                            -1).to(torch.int32)
    h = embed_apply(params.embed, tokens)
    slot_pos = _compact_slot_pos(lengths, cache.window)
    for l, layer in enumerate(params.layers):
        x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
        a = attn.attention_prefill_tail_paged(
            layer.attn, x, positions, cfg, window, cache.k_pages[l],
            cache.v_pages[l], cache.block_table, slot_pos, impl=attn_impl)
        h = _mlp_residual(layer, h + a, cfg)
    logits = _logits(params, cfg, h[:, -1:, :])
    return logits[:, 0], cache._replace(slot_pos=slot_pos, lengths=lengths)


def decode_step_paged(params: Transformer, cfg: ModelConfig,
                      cache: PagedKVCache, tokens: torch.Tensor,
                      q_pos: torch.Tensor, slots: torch.Tensor,
                      window: Optional[int] = None,
                      attn_impl: str = "unfused"
                      ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Decode one token per row over the paged cache, with per-row
    positions ``q_pos`` (B,) int32 and logical write ``slots`` (B,)."""
    window = window if window is not None else cfg.sliding_window
    slot_pos = cache.slot_pos.clone()
    slot_pos.scatter_(1, slots.long()[:, None],
                      q_pos.to(torch.int32)[:, None])
    h = embed_apply(params.embed, tokens[:, None])
    for l, layer in enumerate(params.layers):
        x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
        a = attn.attention_decode_paged(
            layer.attn, x, q_pos, cache.k_pages[l], cache.v_pages[l],
            cache.block_table, slot_pos, slots, cfg, window, impl=attn_impl)
        h = _mlp_residual(layer, h + a, cfg)
    logits = _logits(params, cfg, h)[:, 0]
    return logits, cache._replace(slot_pos=slot_pos)
