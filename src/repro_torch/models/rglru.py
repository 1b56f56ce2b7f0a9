"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427): RG-LRU gated linear
recurrences interleaved 2:1 with local sliding-window MQA attention.

PyTorch counterpart of ``repro.models.rglru``.  Layer pattern: groups of
(rec, rec, attn); the ``n_layers % 3`` leftover layers form a recurrent
tail.  Every temporal block is followed by a GeGLU MLP (both pre-norm,
residual).  Parameters follow the JAX tree: ``groups.<g>.rec.<j>`` (the
recurrent blocks: ``w_in``, ``w_gate``, ``w_out``, ``conv_w``, ``conv_b``,
``lru_a``, ``lru_x``, ``lambda`` (float32 in every model type), ``ln``,
``mlp``, ``ln_mlp``), ``groups.<g>.attn`` (``attn``, ``ln``, ``mlp``,
``ln_mlp``), ``tail.<i>``, ``embed``, ``ln_f``.

The RG-LRU gates are float32 (``_RG_C = 8``); pad positions get
``log_a = 0`` and ``b = 0``, an identity step.  Prefill runs the linear
recurrence h_t = e^{log_a_t} h_{t-1} + b_t as a log-depth scan in torch
(``_assoc_scan``: Hillis–Steele over T with the JAX ``combine``), decode
the exact one-step recurrence.  The scan is ``jax.lax.associative_scan``
in the JAX package, with no Pallas kernel behind it, and plain torch in
the port on every device by design; its order of additions differs from
XLA's, so the two agree to float32 rounding, not bit for bit.  It is a
candidate for later kernel work (ROADMAP B).

The attention blocks are ``models.attention``'s with the window
``local_window``: flash_prefill and decode_attention on the card, over a
ring of ``Wloc = min(local_window, cache_window)`` slots.  Decode state is
O(1) in context length (conv tail + h per recurrent layer, the ring per
attention layer); ``decode_step`` writes it in place.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (Dense, Embed, MLP, ModelConfig,
                                       constrain, embed_apply, normal_, pad,
                                       remat_layer, rms_norm, rms_weight,
                                       softplus, unembed_apply)
from repro_torch.models.transformer import make_positions

_RG_C = 8.0  # Griffin's fixed recurrence sharpness constant


class RGCache(NamedTuple):
    conv: torch.Tensor       # (G, 2, B, W-1, d_lru) last W-1 raw inputs
    h: torch.Tensor          # (G, 2, B, d_lru) float32
    attn_k: torch.Tensor     # (G, B, Wloc, Hkv, D)
    attn_v: torch.Tensor
    tail_conv: torch.Tensor  # (Tt, B, W-1, d_lru)
    tail_h: torch.Tensor     # (Tt, B, d_lru) float32
    slot_pos: torch.Tensor   # (B, Wloc)
    write_idx: Union[int, torch.Tensor]  # as KVCache's
    lengths: torch.Tensor    # (B,) int32


def n_groups_tail(cfg: ModelConfig) -> Tuple[int, int]:
    return cfg.n_layers // 3, cfg.n_layers % 3


# ---------------------------------------------------------------------------
# RG-LRU + recurrent block
# ---------------------------------------------------------------------------
class RecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        d, dl = cfg.d_model, cfg.d_lru
        self.w_in = Dense(d, dl, cfg.dtype, device)
        self.w_gate = Dense(d, dl, cfg.dtype, device)
        self.w_out = Dense(dl, d, cfg.dtype, device)
        self.conv_w = nn.Parameter(torch.empty(cfg.ssm_conv_width, dl,
                                               dtype=cfg.dtype, device=device),
                                   requires_grad=False)
        self.conv_b = nn.Parameter(torch.empty(dl, dtype=cfg.dtype,
                                               device=device),
                                   requires_grad=False)
        self.lru_a = Dense(dl, dl, cfg.dtype, device)  # recurrence gate W_a
        self.lru_x = Dense(dl, dl, cfg.dtype, device)  # input gate W_x
        # "lambda" is a Python keyword: registered by name, read by getattr
        self.register_parameter("lambda", nn.Parameter(
            torch.empty(dl, dtype=torch.float32, device=device),
            requires_grad=False))
        self.ln = rms_weight(d, cfg.dtype, device)
        self.mlp = MLP(d, cfg.d_ff, cfg.dtype, device, act=cfg.act)
        self.ln_mlp = rms_weight(d, cfg.dtype, device)

    @property
    def lam(self) -> torch.Tensor:
        return getattr(self, "lambda")

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.w_in, self.w_gate, self.w_out, self.lru_a, self.lru_x,
                  self.mlp):
            m.reset_parameters(generator)
        normal_(self.conv_w, generator, 0.2)
        with torch.no_grad():
            self.conv_b.zero_()
            self.lam.fill_(1.0)  # softplus -> a in (0, 1)
            self.ln.zero_()
            self.ln_mlp.zero_()


def _rglru_coeffs(p: RecBlock, u: torch.Tensor, valid: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """u (B,T,dl) conv output -> (log_a, b), float32, for h_t = e^{log_a}
    h + b; identity (0, 0) at invalid positions."""
    r = torch.sigmoid(p.lru_a(u).float())
    i = torch.sigmoid(p.lru_x(u).float())
    log_a = -_RG_C * softplus(p.lam) * r  # (B,T,dl) <= 0
    log_a = torch.where(valid[..., None], log_a, 0.0)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * i * u.float()
    b = torch.where(valid[..., None], b, 0.0)
    return log_a, b


def _assoc_scan(log_a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """All h_t (B,T,dl) of the linear recurrence, by a Hillis–Steele scan
    over T (ceil(log2 T) steps of the JAX ``combine``: (a1, b1) then (a2,
    b2) is (a1 + a2, e^{a2} b1 + b2)); ``h0`` folds in as a virtual step,
    h_1 = a_1 h0 + b_1."""
    if h0 is not None:
        b = b.clone()
        b[:, 0] += torch.exp(log_a[:, 0]) * h0
    a = log_a
    T = a.shape[1]
    d = 1
    while d < T:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], torch.exp(a[:, d:]) * b_prev + b[:, d:]],
                      dim=1)
        a = torch.cat([a[:, :d], a_prev + a[:, d:]], dim=1)
        d *= 2
    return b


def _conv(p: RecBlock, u: torch.Tensor,
          tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal depthwise conv of width W as the sum of W shifted products,
    in JAX's order; ``tail`` (B,W-1,dl) the inputs before u, else zeros."""
    W = p.conv_w.shape[0]
    if tail is None:
        x = pad(u, (0, 0, W - 1, 0))
    else:
        x = torch.cat([tail, u], dim=1)
    T = u.shape[1]
    out = sum(x[:, i:i + T, :] * p.conv_w[i][None, None] for i in range(W))
    return out + p.conv_b


def _gate(p: RecBlock, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(p.w_gate(x), approximate="tanh")


def rec_block_forward(p: RecBlock, h: torch.Tensor, valid: torch.Tensor,
                      cfg: ModelConfig,
                      conv_tail: Optional[torch.Tensor] = None,
                      h0: Optional[torch.Tensor] = None):
    """Returns (new_h, final LRU state (B,dl) float32, new conv tail: the
    last W-1 un-convolved inputs u)."""
    x = rms_norm(h, p.ln, cfg.norm_eps)
    gate = _gate(p, x)
    u = p.w_in(x)
    u = torch.where(valid[..., None], u, torch.zeros((), dtype=u.dtype,
                                                     device=u.device))
    uc = _conv(p, u, conv_tail)
    log_a, b = _rglru_coeffs(p, uc, valid)
    hs = _assoc_scan(log_a, b, h0)
    h = h + p.w_out(hs.to(h.dtype) * gate)
    h = h + p.mlp(rms_norm(h, p.ln_mlp, cfg.norm_eps))
    W = cfg.ssm_conv_width
    return h, hs[:, -1], u[:, -(W - 1):]


def rec_block_decode(p: RecBlock, h: torch.Tensor, conv_state: torch.Tensor,
                     lru_h: torch.Tensor, cfg: ModelConfig):
    """h (B,1,d); conv_state (B,W-1,dl); lru_h (B,dl) float32.  Returns
    (new h, new conv state, new LRU state)."""
    x = rms_norm(h, p.ln, cfg.norm_eps)
    gate = _gate(p, x)
    u = p.w_in(x)[:, 0]  # (B,dl)
    window = torch.cat([conv_state, u[:, None]], dim=1)
    uc = torch.einsum("bwc,wc->bc", window, p.conv_w) + p.conv_b
    log_a, b = _rglru_coeffs(p, uc[:, None], torch.ones(
        (uc.shape[0], 1), dtype=torch.bool, device=uc.device))
    new_h = torch.exp(log_a[:, 0]) * lru_h + b[:, 0]
    h = h + p.w_out(new_h[:, None].to(h.dtype) * gate)
    h = h + p.mlp(rms_norm(h, p.ln_mlp, cfg.norm_eps))
    return h, window[:, 1:], new_h


# ---------------------------------------------------------------------------
# attention block (local MQA) — models.attention
# ---------------------------------------------------------------------------
class AttnBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.attn = attn.Attention(cfg, device)
        self.ln = rms_weight(cfg.d_model, cfg.dtype, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.dtype, device, act=cfg.act)
        self.ln_mlp = rms_weight(cfg.d_model, cfg.dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        with torch.no_grad():
            self.ln.zero_()
            self.ln_mlp.zero_()


def _attn_mlp(ab: AttnBlock, g: torch.Tensor, a: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    g = g + a
    return g + ab.mlp(rms_norm(g, ab.ln_mlp, cfg.norm_eps))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------
class Group(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.rec = nn.ModuleList([RecBlock(cfg, device) for _ in range(2)])
        self.attn = AttnBlock(cfg, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (*self.rec, self.attn):
            m.reset_parameters(generator)


class RecurrentGemma(nn.Module):
    """Parameters of the hybrid LM; names follow the JAX parameter tree."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        G, Tt = n_groups_tail(cfg)
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, device)
        self.groups = nn.ModuleList([Group(cfg, device) for _ in range(G)])
        self.ln_f = rms_weight(cfg.d_model, cfg.dtype, device)
        self.tail = nn.ModuleList([RecBlock(cfg, device) for _ in range(Tt)])

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for m in (*self.groups, *self.tail):
            m.reset_parameters(generator)
        with torch.no_grad():
            self.ln_f.zero_()


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device) -> RecurrentGemma:
    """Random weights drawn from ``generator`` (on ``device``) with the
    JAX package's recipe: N(0, 0.02) embeddings, N(0, d_in^-1) dense
    layers, N(0, 0.2²) conv taps, zero conv bias, ``lambda`` 1, zero norm
    gains."""
    params = RecurrentGemma(cfg, device)
    params.reset_parameters(generator)
    return params


def _embed(params: RecurrentGemma, cfg: ModelConfig, tokens: torch.Tensor,
           valid: torch.Tensor) -> torch.Tensor:
    h = embed_apply(params.embed, tokens, cfg)
    return torch.where(valid[..., None], h, torch.zeros((), dtype=h.dtype,
                                                        device=h.device))


def _logits(params: RecurrentGemma, cfg: ModelConfig,
            h: torch.Tensor) -> torch.Tensor:
    return unembed_apply(params.embed, rms_norm(h, params.ln_f, cfg.norm_eps))


def forward(params: RecurrentGemma, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward (no cache) -> logits (B,T,V); its attention
    is plain torch on every device (the reference the served paths are
    held against on the card).  It is also the training loss's forward:
    it carries gradients, each group under ``remat_layer`` (the tail's
    blocks outside it, as JAX's ``scan_layers`` remats the groups
    only)."""
    B, T = tokens.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=tokens.device)
    positions = make_positions(tokens, lengths)
    valid = positions >= 0
    h = _embed(params, cfg, tokens, valid)
    for grp in params.groups:
        h = constrain(h)
        h = remat_layer(cfg, _group_forward, grp, h, valid, positions, cfg)
    for rp in params.tail:
        h = constrain(h)
        h, _, _ = rec_block_forward(rp, h, valid, cfg)
    return _logits(params, cfg, h)


def _group_forward(grp: Group, h: torch.Tensor, valid: torch.Tensor,
                   positions: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    for rp in grp.rec:
        h, _, _ = rec_block_forward(rp, h, valid, cfg)
    ab = grp.attn
    a = attn.attention_forward(ab.attn, rms_norm(h, ab.ln, cfg.norm_eps),
                               positions, cfg, cfg.local_window)
    return _attn_mlp(ab, h, a, cfg)


def prefill(params: RecurrentGemma, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor, cache_window: int = 0
            ) -> Tuple[torch.Tensor, RGCache]:
    """``cache_window`` is the total requested width (L_i + S from the
    engine); the recurrent state is O(1) regardless.  Attention layers cache
    ``min(cfg.local_window, cache_window)`` ring slots."""
    B, T = tokens.shape
    positions = make_positions(tokens, lengths)
    valid = positions >= 0
    if cache_window <= 0:
        cache_window = T + 64  # decode headroom fallback
    Wloc = min(cfg.local_window, cache_window)
    h = _embed(params, cfg, tokens, valid)
    hs, convs, ks, vs = [], [], [], []
    for grp in params.groups:
        h = constrain(h)
        st, ct = [], []
        for rp in grp.rec:
            h, s, c = rec_block_forward(rp, h, valid, cfg)
            st.append(s)
            ct.append(c)
        ab = grp.attn
        a, kc, vc = attn.attention_prefill(
            ab.attn, rms_norm(h, ab.ln, cfg.norm_eps), positions, cfg,
            cfg.local_window, Wloc)
        h = _attn_mlp(ab, h, a, cfg)
        hs.append(torch.stack(st))
        convs.append(torch.stack(ct))
        ks.append(kc)
        vs.append(vc)
    tail_h, tail_conv = [], []
    for rp in params.tail:
        h = constrain(h)
        h, s, c = rec_block_forward(rp, h, valid, cfg)
        tail_h.append(s)
        tail_conv.append(c)
    dl, dev = cfg.d_lru, tokens.device
    logits = _logits(params, cfg, h[:, -1:])[:, 0]
    cache = RGCache(
        conv=torch.stack(convs), h=torch.stack(hs), attn_k=torch.stack(ks),
        attn_v=torch.stack(vs),
        tail_conv=(torch.stack(tail_conv) if tail_conv else torch.zeros(
            (0, B, cfg.ssm_conv_width - 1, dl), dtype=cfg.dtype, device=dev)),
        tail_h=(torch.stack(tail_h) if tail_h else torch.zeros(
            (0, B, dl), dtype=torch.float32, device=dev)),
        slot_pos=attn.prefill_slot_pos(positions, Wloc),
        write_idx=T if Wloc >= T else Wloc,
        lengths=lengths.to(torch.int32))
    return logits, cache


def decode_step(params: RecurrentGemma, cfg: ModelConfig, cache: RGCache,
                tokens: torch.Tensor, step: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, RGCache]:
    """One decode iteration; the conv tails, LRU states and attention
    rings are updated in place.  ``step`` (0-based) and ``write_idx`` are
    ints, or 0-d int64 tensors on an engine's captured step."""
    q_pos = cache.lengths + step
    # the group axis leads, so the ring's width is attn_k.shape[2]
    ring = KVCache(cache.attn_k, cache.attn_v, cache.slot_pos,
                   cache.write_idx, cache.lengths)
    slot = attn.decode_slot(ring)
    slot_pos = attn.decode_slot_pos(ring, q_pos)
    h = embed_apply(params.embed, tokens[:, None], cfg)
    for gi, grp in enumerate(params.groups):
        h = constrain(h)
        for j, rp in enumerate(grp.rec):
            h, conv, lru = rec_block_decode(rp, h, cache.conv[gi, j],
                                            cache.h[gi, j], cfg)
            cache.conv[gi, j] = conv
            cache.h[gi, j] = lru
        ab = grp.attn
        a = attn.attention_decode(ab.attn, rms_norm(h, ab.ln, cfg.norm_eps),
                                  q_pos, cache.attn_k[gi], cache.attn_v[gi],
                                  slot_pos, slot, cfg, cfg.local_window)
        h = _attn_mlp(ab, h, a, cfg)
    for i, rp in enumerate(params.tail):
        h = constrain(h)
        h, conv, lru = rec_block_decode(rp, h, cache.tail_conv[i],
                                        cache.tail_h[i], cfg)
        cache.tail_conv[i] = conv
        cache.tail_h[i] = lru
    logits = _logits(params, cfg, h)[:, 0]
    return logits, cache._replace(slot_pos=slot_pos,
                                  write_idx=cache.write_idx + 1)
