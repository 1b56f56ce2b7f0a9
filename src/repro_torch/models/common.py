"""Shared building blocks of the dense transformer.

PyTorch counterpart of ``repro.models.common``.  Parameters live in
``nn.Module`` containers whose attribute names follow the JAX parameter
tree (``embed.table``, ``attn.wq.w``, ``mlp.gate.w``, ``ln_attn`` …), so
``repro_torch.weights.params_from_jax`` maps one onto the other by name.
The maths stays in plain functions on tensors, with the JAX package's
conventions kept exactly:

* a dense weight is stored ``(d_in, d_out)`` and applied as ``x @ w``;
* ``rms_norm`` computes in float32 and scales by ``(1 + w)``;
* a dense layer adds its bias ``b`` after the product where it has one
  (``qkv_bias``: q, k and v of Qwen1.5), rounding the product first;
* RoPE is the Llama half rotation;
* the MLP is gated: SwiGLU (``act="silu"``) or GeGLU (``act="gelu"``,
  the tanh approximation, as ``jax.nn.gelu(approximate=True)``);
* embeddings are tied (``unembed = h @ table.T``) unless
  ``tie_embeddings`` is off, then ``unembed`` is a dense layer of its own;
  ``scale_embed`` (Gemma) multiplies them by sqrt(d_model) rounded to the
  table's type first.

The config carries the fields of the families the port serves: the dense
transformers (llama3.2-1b, codeqwen1.5-7b, minitron-4b, gemma-2b), the
Mamba-2 SSM (``ssm_*``, used by ``models.mamba2``), the MoE models
(mixtral-8x22b, deepseek-v2-lite-16b: the experts' and MLA's fields, used
by ``models.moe`` and ``models.mla``), the RG-LRU hybrid
(recurrentgemma-9b: ``rg_*`` and ``local_window``, used by
``models.rglru``), the encoder-decoder (seamless-m4t-large-v2:
``n_enc_layers`` and ``n_dec_layers``, used by ``models.encdec``) and the
prefix-LM VLM (paligemma-3b: ``n_prefix_tokens``, the bidirectional image
prefix of ``models.transformer``), and the training fields
``router_aux_coef`` (the MoE loss's weight of the load-balance term) and
``remat`` (each layer of a training forward recomputed in the backward
pass, ``remat_layer``: JAX's ``scan_layers(remat=...)``).  The loss is
``softmax_xent``, JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.checkpoint import checkpoint


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Config of a decoder-only model (the fields the port's families
    use)."""

    name: str = "model"
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)
    qkv_bias: bool = False  # qwen1.5
    tie_embeddings: bool = True
    scale_embed: bool = False  # gemma: embeddings * sqrt(d_model)
    sliding_window: Optional[int] = None
    # the window the long_500k shape substitutes on a full-attention arch
    # (configs.shapes.effective_window)
    long_context_window: int = 8192
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    first_dense_layers: int = 0  # deepseek-v2: layer 0 is a dense MLP
    router_aux_coef: float = 0.01
    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 128
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128
    ssm_n_groups: int = 1
    # --- hybrid (recurrentgemma) ---
    rg_lru_width: int = 0  # 0 -> d_model
    local_window: int = 2048
    # --- encoder-decoder (seamless) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    # --- VLM prefix-LM (paligemma) ---
    n_prefix_tokens: int = 0  # image patches; embeddings come pre-computed
    # --- training memory policy ---
    remat: bool = False  # per-layer activation checkpointing (remat_layer)
    dtype: torch.dtype = torch.float32

    @property
    def n_rep(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def d_lru(self) -> int:
        return self.rg_lru_width or self.d_model

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_n_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# parameter containers
# ---------------------------------------------------------------------------
def normal_(t: torch.Tensor, generator: torch.Generator,
            scale: float) -> None:
    """In-place ``scale * N(0, 1)`` drawn in float32, then cast — the
    JAX ``normal_init`` recipe."""
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator, device=t.device,
                            dtype=torch.float32) * scale)


class Dense(nn.Module):
    """``y = x @ w (+ b)`` with ``w`` stored ``(d_in, d_out)``; the bias,
    where there is one, is added to the product already rounded to the
    layer's type, as ``dense_apply`` does in JAX."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype,
                 device: torch.device, bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, dtype=dtype,
                                          device=device), requires_grad=False)
        self.b = (nn.Parameter(torch.empty(d_out, dtype=dtype, device=device),
                               requires_grad=False) if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """N(0, 1/d_in) weights, a zero bias (``dense_param``)."""
        normal_(self.w, generator, self.w.shape[0] ** -0.5)
        if self.b is not None:
            with torch.no_grad():
                self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(x, DTensor):
            x = whole_rows(x)
            y = _WholeRowsGrad.apply(settle(x @ self.w))
        else:
            y = x @ self.w
        return y if self.b is None else y + self.b


def activate(x: torch.Tensor, act: str) -> torch.Tensor:
    """The MLP's gate activation: SiLU, or GELU's tanh approximation."""
    if act == "silu":
        return F.silu(x)
    if act == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown act {act}")


class MLP(nn.Module):
    """Gated MLP: ``down(act(gate(x)) * up(x))`` (SwiGLU or GeGLU)."""

    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype,
                 device: torch.device, act: str = "silu"):
        super().__init__()
        self.act = act
        self.gate = Dense(d_model, d_ff, dtype, device)
        self.up = Dense(d_model, d_ff, dtype, device)
        self.down = Dense(d_ff, d_model, dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.gate, self.up, self.down):
            m.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(activate(self.gate(x), self.act) * self.up(x))


class Embed(nn.Module):
    """Token table ``(vocab, d_model)``; tied with the unembedding unless
    the config unties it."""

    def __init__(self, vocab: int, d_model: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d_model, dtype=dtype,
                                              device=device),
                                  requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.table, generator, 0.02)


def rms_weight(d: int, dtype: torch.dtype,
               device: torch.device) -> nn.Parameter:
    """RMSNorm gain stored as ``scale - 1`` (zeros), added back in
    ``rms_norm``."""
    return nn.Parameter(torch.zeros(d, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------
def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + weight.float())).to(dt)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (log(1 + e^x) with no linear cut-off)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., T, H, D); positions broadcastable to (..., T)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].float() * freqs             # (..., T, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_scale(cfg: ModelConfig, dtype: torch.dtype) -> float:
    """sqrt(d_model) rounded to ``dtype``, as ``jnp.asarray(cfg.d_model **
    0.5, h.dtype)`` rounds it (45.25 for d 2048 in bf16); the product with
    a value of that type then rounds once, as in JAX."""
    return torch.tensor(cfg.d_model ** 0.5, dtype=dtype).item()


def embed_apply(embed: Embed, tokens: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    if isinstance(embed.table, DTensor):
        # DTensor's embedding rule (PyTorch 2.11's rule for the indexing's
        # backward, index_put, fails on a batch-sharded index); a
        # vocab-sharded lookup leaves a partial sum: settle it on the
        # tokens' own placements
        h = F.embedding(tokens, _GradAsParam.apply(embed.table))
        if isinstance(tokens, DTensor):
            h = h.redistribute(h.device_mesh, tokens.placements)
    else:
        h = embed.table[tokens]
    if cfg.scale_embed:
        h = h * embed_scale(cfg, h.dtype)
    return h


def unembed_apply(embed: Embed, h: torch.Tensor) -> torch.Tensor:
    if isinstance(embed.table, DTensor):
        return h @ _GradAsParam.apply(embed.table).T
    return h @ embed.table.T


class _GradAsParam(torch.autograd.Function):
    """Identity on a DTensor parameter whose backward places the gradient
    as the parameter: a tied table's two gradients (the lookup's and the
    head's) then add on one placement (PyTorch 2.11 cannot add a
    ``Partial`` to a ``Shard`` that it would first turn partial)."""

    @staticmethod
    def forward(ctx, t):
        ctx.mesh, ctx.placements = t.device_mesh, t.placements
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.placements)


# ---------------------------------------------------------------------------
# activation sharding
# ---------------------------------------------------------------------------
# Megatron-SP-style sequence sharding of the residual stream (the JAX
# package's ``set_activation_sharding`` / ``_constrain``).  When set -- to
# DTensor placements, one a mesh dim, e.g. (Shard(0), Shard(1)) over
# ("data", "model") -- the residual stream a family carries between
# layers is redistributed to them where the reference constrains its
# scan's carry; plain tensors are never touched.
_ACTIVATION_PLACEMENTS = None


def set_activation_sharding(placements) -> None:
    global _ACTIVATION_PLACEMENTS
    _ACTIVATION_PLACEMENTS = placements


def constrain(h):
    """``h`` redistributed to the activation placements, where they are
    set, ``h`` is a 3-D DTensor and each sharded dim divides evenly (a
    decode step's one token is left whole); else ``h`` unchanged.  The
    families call it on the residual stream at each layer's input."""
    if (_ACTIVATION_PLACEMENTS is None or not isinstance(h, DTensor)
            or h.ndim != 3):
        return h
    ways = [1] * h.ndim
    for i, p in enumerate(_ACTIVATION_PLACEMENTS):
        if isinstance(p, Shard):
            ways[p.dim] *= h.device_mesh.size(i)
    if any(n % w for n, w in zip(h.shape, ways)):
        return h
    return h.redistribute(h.device_mesh, _ACTIVATION_PLACEMENTS)


def whole_rows(x: DTensor) -> DTensor:
    """``x`` with its middle dims (between the batch and the features)
    unsharded: a sequence-sharded residual stream is gathered before a
    dense layer, as Megatron-SP does, and DTensor never has to flatten a
    batch and a sequence sharded together."""
    last = x.ndim - 1
    pl = [Replicate() if isinstance(p, Shard) and 0 < p.dim < last else p
          for p in x.placements]
    return x if pl == list(x.placements) else x.redistribute(
        x.device_mesh, pl)


class _WholeRowsGrad(torch.autograd.Function):
    """Identity whose backward gives the gradient ``whole_rows``: a dense
    layer's weight gradient flattens its output's gradient as its forward
    flattens its input."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return whole_rows(g) if isinstance(g, DTensor) else g


def settle(y: DTensor) -> DTensor:
    """``y`` with its partial sums reduced (to replicated): a
    row-parallel product's all-reduce, where Megatron's TP has it."""
    pl = [Replicate() if p.is_partial() else p for p in y.placements]
    return y if pl == list(y.placements) else y.redistribute(
        y.device_mesh, pl)


def pad(x: torch.Tensor, widths, value=0) -> torch.Tensor:
    """``F.pad(x, widths, value=value)`` (constant padding; ``widths`` as
    F.pad's, last dim first).  A DTensor is padded by concatenating
    filled blocks (``new_full`` and ``cat``): PyTorch 2.11's DTensor rule
    for ``constant_pad_nd`` leaves its output one placement on a mesh of
    several dims."""
    if not isinstance(x, DTensor):
        return F.pad(x, widths, value=value)
    for i in range(len(widths) // 2):
        dim = x.ndim - 1 - i
        before, after = widths[2 * i], widths[2 * i + 1]
        parts = []
        for n in (before, None, after):
            if n is None:
                parts.append(x)
            elif n:
                shape = list(x.shape)
                shape[dim] = n
                parts.append(x.new_full(shape, value))
        if len(parts) > 1:
            x = torch.cat(parts, dim=dim)
    return x


def split_heads(x: torch.Tensor, *shape: int) -> torch.Tensor:
    """``x.reshape(*shape)``, the last dim of ``x`` split into (heads,
    head_dim) = ``shape[-2:]``.  A DTensor whose last dim is sharded over
    mesh dims whose sizes' product does not divide the head count is
    first replicated on them (DTensor cannot split a shard across a head
    boundary); plain tensors are reshaped as they are."""
    if isinstance(x, DTensor):
        last = x.ndim - 1
        on_last = [i for i, p in enumerate(x.placements)
                   if isinstance(p, Shard) and p.dim == last]
        n = 1
        for i in on_last:
            n *= x.device_mesh.size(i)
        if shape[-2] % n:
            x = x.redistribute(x.device_mesh, [
                Replicate() if i in on_last else p
                for i, p in enumerate(x.placements)])
    return x.reshape(*shape)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------
def remat_layer(cfg: ModelConfig, fn: Callable, *args):
    """``fn(*args)``, one layer of a training forward; with ``cfg.remat``
    and grad mode on, under ``torch.utils.checkpoint`` (non-reentrant), so
    that the backward pass recomputes the layer's activations instead of
    keeping them (``scan_layers(remat=True)``'s ``jax.checkpoint``)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in float32. logits (B,T,V); labels
    (B,T) int; ``mask`` (B,T) weighs each token, the mean taken over
    ``max(sum(mask), 1)``."""
    logits = logits.float()
    if isinstance(logits, DTensor):
        # the gather below reads whole rows of the vocab
        last = logits.ndim - 1
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if p.is_partial() or (isinstance(p, Shard)
                                              and p.dim == last) else p
            for p in logits.placements])
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
