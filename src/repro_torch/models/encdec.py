"""Encoder-decoder transformer (SeamlessM4T-v2 text/audio backbone).

PyTorch counterpart of ``repro.models.encdec``.  The audio frontend
(mel-spectrogram + conv feature extractor) is a stub, as in the JAX
package: the encoder consumes precomputed frame embeddings ``src_embeds``
(B, S, d_model), valid where ``src_valid`` (B, S) is true.  The decoder is
a causal transformer with cross-attention; SCLS slices schedule decoder
iterations, and each re-schedule re-runs the encoder (the enc-dec
analogue of prefill re-computation).

  forward(params, cfg, src_embeds, tokens, src_valid)          -> logits
  encode(params, cfg, src_embeds, src_valid)                   -> (B,S,d)
  prefill(params, cfg, src_embeds, tokens, lengths, cache_window, src_valid)
                                                               -> (logits, EncDecCache)
  decode_step(params, cfg, cache, tokens, step)                -> (logits, EncDecCache)

Kernels (``kernels.ops``: the kernel on the card, its plain version on
the CPU):

* the encoder's bidirectional self-attention runs on ``flash_prefill``
  (B5) with masking positions ``where(src_valid, arange(S), -1)`` and
  ``prefix_len = S``: every valid frame sees every valid frame.  RoPE
  still rotates every frame by ``arange(S)``, as in JAX, so the rotation
  positions and the masking positions are two tensors.  An invalid
  frame's row attends its own frame only (JAX's mask leaves it fully
  masked); no reader sees it, since cross-attention masks it out;
* the decoder's self-attention runs on ``flash_prefill`` at prefill and
  on ``decode_attention`` (B6) at decode, as the dense model's;
* cross-attention at decode runs on ``decode_attention`` over the source
  frames (``attention.cross_decode_attend``); cross-attention at prefill
  (T queries over S frames, no causality) is plain torch on every device,
  as it is ``jnp`` in JAX: B5 takes keys of its queries' own length only.

``forward`` is plain torch throughout (no kernel on any device): the
reference the served path is held against.  Cross-attention applies no
RoPE, to q or k.  The decoder's self-attention KV cache is written in
place; the cross-KV is one contiguous (B, S, Hkv, D) tensor a layer,
stacked as (L, B, S, Hkv, D).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (Embed, MLP, ModelConfig, apply_rope,
                                       constrain, embed_apply, remat_layer,
                                       rms_norm, rms_weight, split_heads,
                                       unembed_apply)
from repro_torch.models.transformer import Block, _mlp_residual, make_positions


class EncDecCache(NamedTuple):
    self_cache: KVCache
    cross_k: torch.Tensor    # (L, B, S, Hkv, D)
    cross_v: torch.Tensor
    src_valid: torch.Tensor  # (B, S) bool


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.self_attn = attn.Attention(cfg, device)
        self.cross_attn = attn.Attention(cfg, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.dtype, device, act=cfg.act)
        self.ln_self = rms_weight(cfg.d_model, cfg.dtype, device)
        self.ln_cross = rms_weight(cfg.d_model, cfg.dtype, device)
        self.ln_mlp = rms_weight(cfg.d_model, cfg.dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.self_attn.reset_parameters(generator)
        self.cross_attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        with torch.no_grad():
            for w in (self.ln_self, self.ln_cross, self.ln_mlp):
                w.zero_()


class EncDecModel(nn.Module):
    """Parameters of the encoder-decoder; names follow the JAX tree (an
    encoder block is the dense model's ``Block``: ``attn``, ``mlp``,
    ``ln_attn``, ``ln_mlp``)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, device)
        self.enc_layers = nn.ModuleList([Block(cfg, device)
                                         for _ in range(cfg.n_enc_layers)])
        self.dec_layers = nn.ModuleList([DecBlock(cfg, device)
                                         for _ in range(cfg.n_dec_layers)])
        self.ln_enc = rms_weight(cfg.d_model, cfg.dtype, device)
        self.ln_f = rms_weight(cfg.d_model, cfg.dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for layer in (*self.enc_layers, *self.dec_layers):
            layer.reset_parameters(generator)
        with torch.no_grad():
            self.ln_enc.zero_()
            self.ln_f.zero_()


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device) -> EncDecModel:
    """Random weights drawn from ``generator`` (on ``device``), the JAX
    package's recipe: N(0, 0.02) embeddings, N(0, d_in^-1) dense layers,
    zero norm gains."""
    params = EncDecModel(cfg, device)
    params.reset_parameters(generator)
    return params


def _valid(src_embeds: torch.Tensor,
           src_valid: Optional[torch.Tensor]) -> torch.Tensor:
    if src_valid is None:
        return torch.ones(src_embeds.shape[:2], dtype=torch.bool,
                          device=src_embeds.device)
    return src_valid.to(torch.bool)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------
def _encode(params: EncDecModel, cfg: ModelConfig, src_embeds: torch.Tensor,
            src_valid: torch.Tensor, plain: bool) -> torch.Tensor:
    """The encoder over (B,S,d) frames: bidirectional self-attention among
    the valid frames, through ``flash_prefill`` (``prefix_len = S``), or
    in plain torch under JAX's mask ``valid_q & valid_k`` where
    ``plain``."""
    B, S, _ = src_embeds.shape
    frames = torch.arange(S, dtype=torch.int32, device=src_embeds.device)
    rope_pos = frames[None].expand(B, S)
    mask_pos = torch.where(src_valid, rope_pos, -1).to(torch.int32)
    mask = ((src_valid[:, None, :] & src_valid[:, :, None])[:, None]
            if plain else None)
    h = src_embeds.to(cfg.dtype)
    for layer in params.enc_layers:
        h = constrain(h)
        h = remat_layer(cfg, _enc_block, layer, h, rope_pos, mask, mask_pos,
                        cfg)
    return rms_norm(h, params.ln_enc, cfg.norm_eps)


def _enc_block(layer: Block, h: torch.Tensor, rope_pos: torch.Tensor,
               mask: Optional[torch.Tensor], mask_pos: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """One encoder layer: plain torch attention under ``mask`` where it
    is given, else ``flash_prefill`` over ``mask_pos``."""
    B, S, _ = h.shape
    scale = cfg.head_dim ** -0.5
    x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
    q, k, v = attn._qkv(layer.attn, x, cfg)
    q = apply_rope(q, rope_pos, cfg.rope_theta)
    k = apply_rope(k, rope_pos, cfg.rope_theta)
    if mask is not None:
        o = attn.gqa_attend_blocked(q, k, v, mask, scale)
    else:
        o = attn.prefill_attend(q, k, v, mask_pos, None, scale, prefix_len=S)
    return _mlp_residual(layer, h + layer.attn.wo(o.reshape(B, S, -1)), cfg)


def encode(params: EncDecModel, cfg: ModelConfig, src_embeds: torch.Tensor,
           src_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The served encoder (``flash_prefill``): (B,S,d) frames -> (B,S,d).
    Rows of invalid frames attend their own frame only."""
    return _encode(params, cfg, src_embeds, _valid(src_embeds, src_valid),
                   plain=False)


def _cross_kv(layer: DecBlock, enc_out: torch.Tensor, cfg: ModelConfig):
    B, S, _ = enc_out.shape
    k = split_heads(layer.cross_attn.wk(enc_out), B, S, cfg.n_kv_heads,
                    cfg.head_dim)
    v = split_heads(layer.cross_attn.wv(enc_out), B, S, cfg.n_kv_heads,
                    cfg.head_dim)
    return k, v


def _cross_attend(layer: DecBlock, x: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor, src_valid: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention of T queries over the S frames in plain torch (the
    prefill's and ``forward``'s): a frame is seen where it is valid."""
    B, T, _ = x.shape
    q = split_heads(layer.cross_attn.wq(x), B, T, cfg.n_heads,
                    cfg.head_dim)
    mask = src_valid[:, None, None, :].expand(B, 1, T, src_valid.shape[1])
    o = attn.gqa_attend_blocked(q, ck, cv, mask, cfg.head_dim ** -0.5)
    return layer.cross_attn.wo(o.reshape(B, T, -1))


def _cross_decode(layer: DecBlock, x: torch.Tensor, ck: torch.Tensor,
                  cv: torch.Tensor, slot_pos: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Cross-attention of one token per row over the frames, through
    ``decode_attention`` (``attention.cross_decode_attend``)."""
    B = x.shape[0]
    q = split_heads(layer.cross_attn.wq(x), B, 1, cfg.n_heads,
                    cfg.head_dim)
    o = attn.cross_decode_attend(q, ck, cv, slot_pos)
    return layer.cross_attn.wo(o.reshape(B, 1, -1))


# ---------------------------------------------------------------------------
# decoder: forward (plain reference), prefill, decode
# ---------------------------------------------------------------------------
def forward(params: EncDecModel, cfg: ModelConfig, src_embeds: torch.Tensor,
            tokens: torch.Tensor,
            src_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,S,d) source embeddings + (B,T) target tokens -> logits
    (B,T,V), in plain torch on every device (no kernel, no cache).  It is
    also the training loss's forward: it carries gradients, each encoder
    and decoder layer under ``remat_layer``."""
    src_valid = _valid(src_embeds, src_valid)
    enc_out = _encode(params, cfg, src_embeds, src_valid, plain=True)
    B, T = tokens.shape
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, T)
    h = embed_apply(params.embed, tokens, cfg)
    for layer in params.dec_layers:
        h = constrain(h)
        h = remat_layer(cfg, _dec_block, layer, h, positions, enc_out,
                        src_valid, cfg)
    return unembed_apply(params.embed, rms_norm(h, params.ln_f, cfg.norm_eps))


def _dec_block(layer: DecBlock, h: torch.Tensor, positions: torch.Tensor,
               enc_out: torch.Tensor, src_valid: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    x = rms_norm(h, layer.ln_self, cfg.norm_eps)
    h = h + attn.attention_forward(layer.self_attn, x, positions, cfg, None)
    ck, cv = _cross_kv(layer, enc_out, cfg)
    h = h + _cross_attend(layer, rms_norm(h, layer.ln_cross, cfg.norm_eps),
                          ck, cv, src_valid, cfg)
    return _mlp_residual(layer, h, cfg)


def prefill(params: EncDecModel, cfg: ModelConfig, src_embeds: torch.Tensor,
            tokens: torch.Tensor, lengths: torch.Tensor, cache_window: int,
            src_valid: Optional[torch.Tensor] = None,
            window: Optional[int] = None) -> Tuple[torch.Tensor, EncDecCache]:
    """Encode the source, prefill the left-padded decoder prompt into a
    dense self-attention cache of width ``cache_window`` and keep each
    layer's cross-KV.  Returns the last token's logits and the cache."""
    window = window if window is not None else cfg.sliding_window
    src_valid = _valid(src_embeds, src_valid)
    enc_out = encode(params, cfg, src_embeds, src_valid)
    positions = make_positions(tokens, lengths)
    T = positions.shape[1]
    h = embed_apply(params.embed, tokens, cfg)
    ks, vs, cks, cvs = [], [], [], []
    for layer in params.dec_layers:
        h = constrain(h)
        x = rms_norm(h, layer.ln_self, cfg.norm_eps)
        a, kc, vc = attn.attention_prefill(layer.self_attn, x, positions, cfg,
                                           window, cache_window)
        h = h + a
        ck, cv = _cross_kv(layer, enc_out, cfg)
        h = h + _cross_attend(layer, rms_norm(h, layer.ln_cross,
                                              cfg.norm_eps),
                              ck, cv, src_valid, cfg)
        h = _mlp_residual(layer, h, cfg)
        ks.append(kc)
        vs.append(vc)
        cks.append(ck)
        cvs.append(cv)
    logits = unembed_apply(params.embed,
                           rms_norm(h[:, -1:], params.ln_f, cfg.norm_eps))
    self_cache = KVCache(k=torch.stack(ks), v=torch.stack(vs),
                         slot_pos=attn.prefill_slot_pos(positions,
                                                        cache_window),
                         write_idx=T if cache_window >= T else cache_window,
                         lengths=lengths.to(torch.int32))
    return logits[:, 0], EncDecCache(self_cache, torch.stack(cks),
                                     torch.stack(cvs), src_valid)


def decode_step(params: EncDecModel, cfg: ModelConfig, cache: EncDecCache,
                tokens: torch.Tensor, step: Union[int, torch.Tensor],
                window: Optional[int] = None
                ) -> Tuple[torch.Tensor, EncDecCache]:
    """One decoder iteration: self-attention over the dense cache and
    cross-attention over the source frames, both on ``decode_attention``.
    tokens (B,); step 0-based (an int, or a 0-d int64 tensor, as
    ``transformer.decode_step``'s)."""
    window = window if window is not None else cfg.sliding_window
    sc = cache.self_cache
    q_pos = sc.lengths + step
    slot = attn.decode_slot(sc)
    slot_pos = attn.decode_slot_pos(sc, q_pos)
    cross_pos = attn.cross_slot_pos(cache.src_valid)
    h = embed_apply(params.embed, tokens[:, None], cfg)
    for l, layer in enumerate(params.dec_layers):
        h = constrain(h)
        x = rms_norm(h, layer.ln_self, cfg.norm_eps)
        h = h + attn.attention_decode(layer.self_attn, x, q_pos, sc.k[l],
                                      sc.v[l], slot_pos, slot, cfg, window)
        h = h + _cross_decode(layer, rms_norm(h, layer.ln_cross,
                                              cfg.norm_eps),
                              cache.cross_k[l], cache.cross_v[l], cross_pos,
                              cfg)
        h = _mlp_residual(layer, h, cfg)
    logits = unembed_apply(params.embed,
                           rms_norm(h, params.ln_f, cfg.norm_eps))[:, 0]
    new_self = sc._replace(slot_pos=slot_pos, write_idx=sc.write_idx + 1)
    return logits, cache._replace(self_cache=new_self)
