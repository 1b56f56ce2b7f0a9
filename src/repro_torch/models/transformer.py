"""Decoder-only transformer LM (dense archs + PaliGemma-style prefix VLM).

PyTorch counterpart of ``repro.models.transformer``.  The parameters are
an ``nn.Module`` (``Transformer``) with one ``Block`` per layer; the JAX
package's stacked leading layer axis becomes a loop over ``layers``.  The
functions keep the JAX signatures (``forward``, without a cache, is the
plain reference; the others serve):

  forward(params, cfg, tokens, positions, prefix_embeds)   -> logits
  prefill(params, cfg, tokens, lengths, cache_window, prefix_embeds)
                                                           -> (logits, KVCache)
  decode_step(params, cfg, cache, tokens, step)            -> (logits, KVCache)
  decode_step_rowslots(params, cfg, cache, tokens, q_pos, slots)
  prefill_paged(params, cfg, tokens, lengths, cache)       -> (logits, PagedKVCache)
  prefill_tail_paged(params, cfg, tokens, start, lengths, cache)
  decode_step_paged(params, cfg, cache, tokens, q_pos, slots)

Left-padding convention: ``positions[b, t] < 0`` marks pad tokens.  KV
caches and page pools are written in place; the returned cache carries
the refreshed ``slot_pos``/``lengths``.

The VLM (``n_prefix_tokens``) takes its image's patch embeddings
``prefix_embeds`` (B, P, d) ahead of the text, unscaled by
``scale_embed``, at positions 0..P-1; the left-padded text follows at
positions + P (its pads stay -1, between the prefix and the text), and
every valid token sees the whole prefix both ways (``flash_prefill``'s
``prefix_len``).  Decode is the dense model's.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.kvcache.paged import PagedKVCache
from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (Dense, Embed, MLP, ModelConfig,
                                       constrain, embed_apply, remat_layer,
                                       rms_norm, rms_weight, unembed_apply)


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.attn = attn.Attention(cfg, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.dtype, device, act=cfg.act)
        self.ln_attn = rms_weight(cfg.d_model, cfg.dtype, device)
        self.ln_mlp = rms_weight(cfg.d_model, cfg.dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        with torch.no_grad():
            self.ln_attn.zero_()
            self.ln_mlp.zero_()


class Transformer(nn.Module):
    """Parameters of the dense LM; names follow the JAX parameter tree
    (an untied head is ``unembed.w``, JAX's ``unembed/w``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, device)
        self.layers = nn.ModuleList([Block(cfg, device)
                                     for _ in range(cfg.n_layers)])
        self.ln_f = rms_weight(cfg.d_model, cfg.dtype, device)
        self.unembed = (None if cfg.tie_embeddings else
                        Dense(cfg.d_model, cfg.vocab_size, cfg.dtype, device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        with torch.no_grad():
            self.ln_f.zero_()
        if self.unembed is not None:
            self.unembed.reset_parameters(generator)


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device) -> Transformer:
    """Random weights drawn from ``generator`` (which must live on
    ``device``): N(0, 0.02) embeddings, N(0, d_in^-1) dense layers (an
    untied head too), zero biases and norm gains — the JAX package's
    recipe."""
    params = Transformer(cfg, device)
    params.reset_parameters(generator)
    return params


def _logits(params: Transformer, cfg: ModelConfig,
            h: torch.Tensor) -> torch.Tensor:
    h = rms_norm(h, params.ln_f, cfg.norm_eps)
    if params.unembed is None:
        return unembed_apply(params.embed, h)
    return params.unembed(h)


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


def forward(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            prefix_embeds: Optional[torch.Tensor] = None,
            window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence forward (no cache) -> logits (B,T,V).  Its attention
    is plain torch (``attention.attention_forward``) on every device, so
    on the card it is the reference that the serving paths, whose
    attention runs the kernels, are held against.  For the VLM,
    ``prefix_embeds`` (B,P,d) is prepended (the logits then cover P + T
    tokens) and ``tokens`` holds the text only.  ``positions`` cover the
    whole sequence and default to 0..P+T-1; left pads carry positions
    < 0.  It is also the training loss's forward: it carries gradients,
    each layer under ``remat_layer``."""
    window = window if window is not None else cfg.sliding_window
    h = embed_apply(params.embed, tokens, cfg)
    if prefix_embeds is not None:
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
    B, T, _ = h.shape
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, T)
    for layer in params.layers:
        h = constrain(h)
        h = remat_layer(cfg, _block_forward, layer, h, positions, cfg, window)
    return _logits(params, cfg, h)


def _block_forward(layer: Block, h: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, window: Optional[int]) -> torch.Tensor:
    x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
    a = attn.attention_forward(layer.attn, x, positions, cfg, window,
                               cfg.n_prefix_tokens)
    return _mlp_residual(layer, h + a, cfg)


# ---------------------------------------------------------------------------
# dense cache (profiling path)
# ---------------------------------------------------------------------------
def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor, cache_window: int,
            prefix_embeds: Optional[torch.Tensor] = None,
            window: Optional[int] = None) -> Tuple[torch.Tensor, KVCache]:
    """Run the prefill phase and build a dense KV cache of width
    ``cache_window`` (for the VLM, which prepends ``prefix_embeds``
    (B,P,d), the caller counts the prefix in it; the cache's lengths then
    include the P prefix tokens)."""
    window = window if window is not None else cfg.sliding_window
    positions = make_positions(tokens, lengths)
    h = embed_apply(params.embed, tokens, cfg)
    if prefix_embeds is not None:
        B, P = prefix_embeds.shape[:2]
        h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
        prefix = torch.arange(P, dtype=torch.int32, device=h.device)
        positions = torch.cat(
            [prefix[None].expand(B, P),
             torch.where(positions >= 0, positions + P, -1)],
            dim=1).to(torch.int32)
        lengths = lengths + P
    T = positions.shape[1]
    ks, vs = [], []
    for layer in params.layers:
        h = constrain(h)
        x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
        a, kc, vc = attn.attention_prefill(layer.attn, x, positions, cfg,
                                           window, cache_window,
                                           cfg.n_prefix_tokens)
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
                tokens: torch.Tensor, step: Union[int, torch.Tensor],
                window: Optional[int] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """One decode iteration over a dense cache. tokens (B,); step
    0-based.  ``step`` and ``cache.write_idx`` are ints, or 0-d int64
    tensors (an engine's captured step, ``engine.graphs``: read on the
    device, so that a replay advances them)."""
    window = window if window is not None else cfg.sliding_window
    q_pos = cache.lengths + step
    slot = attn.decode_slot(cache)
    slot_pos = attn.decode_slot_pos(cache, q_pos)
    h = embed_apply(params.embed, tokens[:, None], cfg)
    for l, layer in enumerate(params.layers):
        h = constrain(h)
        x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
        a = attn.attention_decode(layer.attn, x, q_pos, cache.k[l],
                                  cache.v[l], slot_pos, slot, cfg, window)
        h = _mlp_residual(layer, h + a, cfg)
    logits = _logits(params, cfg, h)[:, 0]
    return logits, cache._replace(slot_pos=slot_pos,
                                  write_idx=cache.write_idx + 1)


def decode_step_rowslots(params: Transformer, cfg: ModelConfig,
                         cache: KVCache, tokens: torch.Tensor,
                         q_pos: torch.Tensor, slots: torch.Tensor,
                         window: Optional[int] = None
                         ) -> Tuple[torch.Tensor, KVCache]:
    """Continuous-batching decode over a dense cache: per-row positions
    ``q_pos`` and write ``slots`` (B,) int32, tracked by the caller
    (``ContinuousEngine``).  ``slot_pos`` is updated at the rows' slots
    once, shared across layers."""
    window = window if window is not None else cfg.sliding_window
    slot_pos = cache.slot_pos.clone()
    slot_pos.scatter_(1, slots.long()[:, None],
                      q_pos.to(torch.int32)[:, None])
    h = embed_apply(params.embed, tokens[:, None], cfg)
    for l, layer in enumerate(params.layers):
        h = constrain(h)
        x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
        a = attn.attention_decode_rowslots(layer.attn, x, q_pos, cache.k[l],
                                           cache.v[l], slot_pos, slots, cfg,
                                           window)
        h = _mlp_residual(layer, h + a, cfg)
    logits = _logits(params, cfg, h)[:, 0]
    return logits, cache._replace(slot_pos=slot_pos)


# ---------------------------------------------------------------------------
# persistent paged cache (serving path)
# ---------------------------------------------------------------------------
def prefill_paged(params: Transformer, cfg: ModelConfig,
                  tokens: torch.Tensor, lengths: torch.Tensor,
                  cache: PagedKVCache, window: Optional[int] = None,
                  attn_impl: str = "unfused"
                  ) -> Tuple[torch.Tensor, PagedKVCache]:
    """Prefill that writes K/V straight into the paged pool.

    Same left-padded attention maths as ``prefill`` (unfused: through
    ``kernels.ops.flash_prefill``); each layer's K/V lands in
    ``cache.k_pages[l]``/``v_pages[l]`` through the block table
    (``kernels.ops.paged_prefill_write``).  Layout: logical slot ==
    absolute position.  Returns the last token's logits and the cache
    with ``slot_pos``/``lengths`` of the prefilled rows."""
    window = window if window is not None else cfg.sliding_window
    positions = make_positions(tokens, lengths)
    h = embed_apply(params.embed, tokens, cfg)
    for l, layer in enumerate(params.layers):
        h = constrain(h)
        x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
        a = attn.attention_prefill_paged(
            layer.attn, x, positions, cfg, window, cache.k_pages[l],
            cache.v_pages[l], cache.block_table, impl=attn_impl)
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
    h = embed_apply(params.embed, tokens, cfg)
    slot_pos = _compact_slot_pos(lengths, cache.window)
    for l, layer in enumerate(params.layers):
        h = constrain(h)
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
    h = embed_apply(params.embed, tokens[:, None], cfg)
    for l, layer in enumerate(params.layers):
        h = constrain(h)
        x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
        a = attn.attention_decode_paged(
            layer.attn, x, q_pos, cache.k_pages[l], cache.v_pages[l],
            cache.block_table, slot_pos, slots, cfg, window, impl=attn_impl)
        h = _mlp_residual(layer, h + a, cfg)
    logits = _logits(params, cfg, h)[:, 0]
    return logits, cache._replace(slot_pos=slot_pos)
