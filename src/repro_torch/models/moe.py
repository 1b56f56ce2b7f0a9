"""Mixture-of-Experts layers + MoE decoder models.

PyTorch counterpart of ``repro.models.moe``, for both MoE archs:

  * mixtral-8x22b — GQA attention (SWA 4096) + 8 routed experts, top-2;
  * deepseek-v2-lite — MLA attention (``models.mla``) + (2 shared + 64
    routed, top-6) experts, the first layer dense (arXiv:2405.04434).

Routing is the JAX package's *dropping* dispatch, kept exactly: the B·T
tokens of a call (left pads and the engine's batch-bucket rows included)
are zero-padded to whole groups of ``min(MOE_GROUP, B·T)``; in each group
the router's float32 softmax picks each token's top-k experts (ties to
the lower index, as ``jax.lax.top_k``), the k probabilities are
renormalised (``p / max(sum, 1e-9)``), and token t's k-th choice takes the
next free slot of its expert in the order (token, k-slot).  An expert
holds ``cap = max(1, int(group·top_k·capacity_factor / E))`` slots; a
choice past them is dropped (weighs 0).  The shared experts are added on
top, to every token.  On a mesh (a DTensor ``x``) the groups are still
those of the global stream of B·T tokens, as in the reference's GSPMD
program, and the experts stay sharded on their expert axis
(``_moe_sharded``).

The JAX package moves tokens with one-hot dispatch/combine einsums; the
port gathers and scatters the same tokens into the same (E, cap, d)
slots (``_dispatch`` returns each choice's expert, slot and keep flag),
and runs the experts as batched products over those buffers.  None of this is a kernel: the JAX
package computes it with ``jnp`` (no Pallas kernel), and so does the port,
by design, on every device.

Parameters follow the JAX tree: ``layers.<i>`` (MoE blocks) and
``dense_layers.<i>`` (the first dense blocks), each with ``attn`` (GQA or
MLA), ``ln_attn``, ``ln_mlp`` and ``moe`` (``router`` float32 (d, E),
``experts.{gate,up,down}.w`` stacked (E, d_in, d_out), ``shared``) or
``mlp``.  The head is the embedding table (``unembed_apply``), as in the
JAX model, whatever ``tie_embeddings`` says.
"""
from __future__ import annotations

import math
from typing import (Callable, List, NamedTuple, Optional, Tuple,
                    Union)

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models import attention as attn
from repro_torch.models import mla
from repro_torch.models.attention import KVCache
from repro_torch.models.common import (Embed, MLP, ModelConfig, activate,
                                       constrain, embed_apply, normal_,
                                       remat_layer, rms_norm, rms_weight,
                                       unembed_apply)
from repro_torch.models.transformer import make_positions

MOE_GROUP = 1024  # dispatch group size (tokens); decode uses one group


# ---------------------------------------------------------------------------
# MoE layer
# ---------------------------------------------------------------------------
class StackedDense(nn.Module):
    """E dense layers ``w`` (E, d_in, d_out), each N(0, 1/d_in) at init."""

    def __init__(self, n: int, d_in: int, d_out: int, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        self.w = nn.Parameter(torch.empty(n, d_in, d_out, dtype=dtype,
                                          device=device), requires_grad=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.w, generator, self.w.shape[1] ** -0.5)


class Experts(nn.Module):
    """The routed experts: E gated MLPs stacked on a leading axis."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        E, d, dff = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        self.act = cfg.act
        self.gate = StackedDense(E, d, dff, cfg.dtype, device)
        self.up = StackedDense(E, d, dff, cfg.dtype, device)
        self.down = StackedDense(E, dff, d, cfg.dtype, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for m in (self.gate, self.up, self.down):
            m.reset_parameters(generator)

    def forward(self, xe: torch.Tensor) -> torch.Tensor:
        """xe (E, C, d) -> (E, C, d): expert e's MLP on its C slots."""
        return expert_mlp(xe, self.gate.w, self.up.w, self.down.w, self.act)


def expert_mlp(xe: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
               down: torch.Tensor, act: str) -> torch.Tensor:
    """xe (n, C, d) -> (n, C, d): the gated MLP of each of n experts, whose
    stacked weights are ``gate``/``up`` (n, d, dff) and ``down`` (n, dff,
    d), on its C slots."""
    h = activate(torch.bmm(xe, gate), act) * torch.bmm(xe, up)
    return torch.bmm(h, down)


class MoELayer(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.router = nn.Parameter(torch.empty(cfg.d_model, cfg.n_experts,
                                               dtype=torch.float32,
                                               device=device),
                                   requires_grad=False)
        self.experts = Experts(cfg, device)
        self.shared = (MLP(cfg.d_model, cfg.d_ff_expert * cfg.n_shared_experts,
                           cfg.dtype, device, act=cfg.act)
                       if cfg.n_shared_experts else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        normal_(self.router, generator, 0.02)
        self.experts.reset_parameters(generator)
        if self.shared is not None:
            self.shared.reset_parameters(generator)


class Routing(NamedTuple):
    """Each token's k choices in a group: all (g, K)."""

    expert: torch.Tensor  # int64 expert index, best first
    slot: torch.Tensor    # int64 slot within the expert (the choice's rank)
    keep: torch.Tensor    # bool: slot < capacity (else dropped)
    weight: torch.Tensor  # float32 renormalised top-k probability


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest along the last dim, equal values
    in index order (``jax.lax.top_k``; ``torch.topk`` promises no order
    among ties): a stable descending sort."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch(probs: torch.Tensor, k: int, capacity: int) -> Routing:
    """probs (g, E) -> the group's routing: priority by token order, then
    by k-slot; a choice whose expert already holds ``capacity`` tokens is
    dropped."""
    g, E = probs.shape
    top_p, top_i = top_k(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    flat = F.one_hot(top_i.reshape(-1), E)              # (gK, E)
    before = torch.cumsum(flat, dim=0) - flat           # earlier choices
    slot = before.gather(1, top_i.reshape(-1, 1)).reshape(g, k)
    return Routing(top_i, slot, slot < capacity, top_p)


def _group_apply(experts: Callable[[torch.Tensor], torch.Tensor],
                 xg: torch.Tensor, r: Routing, capacity: int, n: int,
                 span: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """One group's routed output from its n experts, or, given ``span =
    (first, n)``, from the experts ``first`` .. ``first + n - 1`` alone (a
    rank's own on a mesh): each kept choice of theirs has its token copied
    into its expert's slot, ``experts`` runs them over their (n, C, d)
    buffers, and each token's outputs are summed under its combine weights
    (rounded to x's type first, as the JAX combine einsum takes them).  A
    dropped choice, or a choice of another rank's expert, writes into a
    spare slot past the capacity that no expert reads, and weighs 0: no
    host synchronisation."""
    g, d = xg.shape
    k = r.expert.shape[1]
    keep, e = r.keep, r.expert
    if span is not None:
        first, n = span
        keep = keep & (e >= first) & (e < first + n)
        e = (e - first).clamp(0, n - 1)
    slot = torch.where(keep, r.slot, capacity)
    tok = torch.arange(g, device=xg.device)[:, None].expand(g, k)
    xe = xg.new_zeros((n, capacity + 1, d))
    xe[e, slot] = xg[tok]
    he = experts(xe[:, :capacity])                      # (n, C, d)
    hk = he[e, slot.clamp(max=capacity - 1)]            # (g, K, d)
    w = torch.where(keep, r.weight, 0.0).to(xg.dtype).float()
    return (w[..., None] * hk.float()).sum(dim=1).to(xg.dtype)


def capacity(cfg: ModelConfig, group: int) -> int:
    """Slots of each expert in a group of ``group`` tokens, in Python float
    arithmetic as the JAX package computes it."""
    return max(1, int(group * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))


def _router_probs(router: torch.Tensor, xg: torch.Tensor) -> torch.Tensor:
    return torch.softmax(xg.float() @ router, dim=-1)


def route(p: MoELayer, xg: torch.Tensor, cfg: ModelConfig,
          cap: int) -> Routing:
    """xg (g, d) -> the group's routing under the router's float32
    softmax."""
    return _dispatch(_router_probs(p.router, xg), cfg.top_k, cap)


def _balance(probs: torch.Tensor, r: Routing) -> torch.Tensor:
    """One group's ``sum_e f_e * P_e``: f_e the share of the group's g·K
    choices that expert e kept (no gradient, as JAX's dispatch mask),
    P_e the mean router probability of e over the group's tokens (pad
    rows included, as in JAX)."""
    g, E = probs.shape
    kept = F.one_hot(r.expert, E).float() * r.keep[..., None]
    frac = kept.sum(dim=(0, 1)) / (g * r.expert.shape[1])
    return (frac * probs.mean(dim=0)).sum()


def moe_apply(p: MoELayer, x: torch.Tensor, cfg: ModelConfig,
              with_aux: bool = False):
    """x (B,T,d) -> y (B,T,d), or (y, aux) ``with_aux``: the Switch-style
    load-balance loss ``E · mean over groups of sum_e f_e · P_e`` of JAX's
    ``moe_apply``.  The groups run one after another, as JAX's
    ``lax.map`` runs them, so one group's buffers are live at a time.

    A DTensor ``x`` computes what ``x.full_tensor()`` would, with the
    experts left sharded (``_moe_sharded``)."""
    if isinstance(x, DTensor):
        return _moe_sharded(p, x, cfg, with_aux)
    B, T, d = x.shape
    group = min(MOE_GROUP, B * T)
    y, balance = _route_groups(p.router, p.experts, x.reshape(B * T, d),
                               cfg, group, cfg.n_experts, None, with_aux)
    y = y.reshape(B, T, d)
    if p.shared is not None:
        y = y + p.shared(x)
    if not with_aux:
        return y
    return y, cfg.n_experts * torch.stack(balance).mean()


def _route_groups(router: torch.Tensor,
                  experts: Callable[[torch.Tensor], torch.Tensor],
                  xf: torch.Tensor, cfg: ModelConfig, group: int, n: int,
                  span: Optional[Tuple[int, int]], with_aux: bool
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """xf (tokens, d) zero-padded to whole groups of ``group``, each group
    routed with the capacity of ``group`` tokens and run through
    ``experts`` (``_group_apply``'s n and span): (the tokens' outputs,
    each group's balance term ``with_aux``)."""
    n_tok = xf.shape[0]
    pad = (-n_tok) % group
    if pad:
        xf = F.pad(xf, (0, 0, 0, pad))
    cap = capacity(cfg, group)
    ys, balance = [], []
    for xg in xf.split(group):
        probs = _router_probs(router, xg)
        r = _dispatch(probs, cfg.top_k, cap)
        ys.append(_group_apply(experts, xg, r, cap, n, span))
        if with_aux:
            balance.append(_balance(probs, r))
    return torch.cat(ys)[:n_tok], balance


def _whole(t: torch.Tensor) -> torch.Tensor:
    return t.full_tensor() if isinstance(t, DTensor) else t


def _local_experts(p: MoELayer, mesh) -> Tuple[List[torch.Tensor], int,
                                               Tuple[int, ...]]:
    """(this rank's gate, up and down weights (n, ., .), the index of its
    first expert, the mesh dims that shard the expert axis).  Each weight
    keeps its shards of the expert axis (dim 0) and is gathered over every
    other mesh dim (FSDP's dim of each expert)."""
    ws = [m.w for m in (p.experts.gate, p.experts.up, p.experts.down)]
    if not isinstance(ws[0], DTensor):
        return ws, 0, ()
    dims = {tuple(i for i, pl in enumerate(w.placements) if pl == Shard(0))
            for w in ws}
    if len(dims) != 1:
        raise ValueError(f"the expert weights shard their expert axis over "
                         f"different mesh dims: {sorted(dims)}")
    (edims,) = dims
    keep = [Shard(0) if i in edims else Replicate()
            for i in range(mesh.ndim)]
    local = [w.redistribute(mesh, keep).to_local() for w in ws]
    sizes, coord = tuple(mesh.shape), mesh.get_coordinate()
    if local[0].shape[0] * math.prod(sizes[i] for i in edims) \
            != ws[0].shape[0]:
        raise ValueError("the expert axis does not divide its mesh dims")
    index = 0
    for i in edims:  # DTensor's chunk order: the first mesh dim outermost
        index = index * sizes[i] + coord[i]
    return local, index * local[0].shape[0], edims


def _moe_sharded(p: MoELayer, x: DTensor, cfg: ModelConfig, with_aux: bool):
    """``moe_apply`` of a DTensor ``x`` (B,T,d), equal to it on
    ``x.full_tensor()``: the groups are the global stream's, of
    ``min(MOE_GROUP, B·T)`` tokens with the zero padding at its end, and
    each has the capacity of that global group, so the same choices are
    kept and dropped as unsharded.

    The experts stay sharded on their expert axis (``_local_experts``):
    each rank runs only its own experts' slots, on token rows that are
    whole over the expert axis's mesh dims, and the outputs are summed
    over those dims (a ``Partial`` redistributed to the rows: an
    all-reduce, or a reduce-scatter where a row axis shards the experts
    too).  Which token rows a rank routes:

      * its own rows (batch over "pod" / "data" where it divides), when
        they are a whole number of global groups and the stream needs no
        padding (a long prefill): its groups are the global groups;
      * otherwise (decode, a short prefill) the rows all-gathered over
        the row axes -- B x T x d, small where this applies -- and every
        rank routes every global group identically.

    The router's probabilities and the dispatch are computed in full on
    each rank (the router is gathered whole).  The load-balance term is
    the mean over the global groups, ``Replicate`` on every mesh dim (the
    per-rank sums are all-reduced over the row axes where each rank had
    groups of its own).  The shared experts run on the local rows."""
    mesh = x.device_mesh
    B, T, d = x.shape
    n_tok = B * T
    group = min(MOE_GROUP, n_tok)
    rows = kernel_ops.head_placements(mesh, B, ())(None)
    weights, first, edims = _local_experts(p, mesh)
    tok = [Replicate() if i in edims else pl for i, pl in enumerate(rows)]
    shards = math.prod(n for n, pl in zip(tuple(mesh.shape), tok)
                       if isinstance(pl, Shard))
    if n_tok % group or (n_tok // shards) % group:
        tok = [Replicate()] * mesh.ndim
    xl = x.redistribute(mesh, tok).to_local()

    def experts(xe):
        return expert_mlp(xe, *weights, cfg.act)

    n = weights[0].shape[0]
    y, balance = _route_groups(_whole(p.router), experts, xl.reshape(-1, d),
                               cfg, group, n, (first, n), with_aux)
    y = y.reshape(xl.shape)
    summed = [Partial() if i in edims else pl for i, pl in enumerate(tok)]
    y = DTensor.from_local(y, mesh, summed, run_check=False,
                           shape=x.shape, stride=x.stride())
    y = y.redistribute(mesh, rows).to_local()
    if p.shared is not None:
        shared = {name: _whole(t)
                  for name, t in p.shared.named_parameters()}
        xr = x.redistribute(mesh, rows).to_local()
        y = y + torch.func.functional_call(p.shared, shared, (xr,))
    y = DTensor.from_local(y, mesh, rows, run_check=False)
    if not with_aux:
        return y
    groups = -(-n_tok // group)
    own = [Partial() if isinstance(pl, Shard) else Replicate() for pl in tok]
    bal = DTensor.from_local(torch.stack(balance).sum(), mesh, own,
                             run_check=False)
    bal = bal.redistribute(mesh, [Replicate()] * mesh.ndim)
    return y, cfg.n_experts * bal / groups


# ---------------------------------------------------------------------------
# MoE decoder model (mixtral path: GQA; deepseek path: MLA)
# ---------------------------------------------------------------------------
class MoECache(NamedTuple):
    kv: Union[KVCache, mla.MLACache]
    dense_kv: Optional[Union[KVCache, mla.MLACache]]  # first dense layers


class Block(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device, moe: bool):
        super().__init__()
        self.attn = (mla.MLA(cfg, device) if cfg.use_mla
                     else attn.Attention(cfg, device))
        self.ln_attn = rms_weight(cfg.d_model, cfg.dtype, device)
        self.ln_mlp = rms_weight(cfg.d_model, cfg.dtype, device)
        if moe:
            self.moe = MoELayer(cfg, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.dtype, device,
                           act=cfg.act)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn.reset_parameters(generator)
        (self.moe if hasattr(self, "moe") else self.mlp).reset_parameters(
            generator)
        with torch.no_grad():
            self.ln_attn.zero_()
            self.ln_mlp.zero_()


class MoEModel(nn.Module):
    """Parameters of the MoE LM; names follow the JAX parameter tree."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        nf = cfg.first_dense_layers
        self.embed = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, device)
        self.layers = nn.ModuleList([Block(cfg, device, True)
                                     for _ in range(cfg.n_layers - nf)])
        self.ln_f = rms_weight(cfg.d_model, cfg.dtype, device)
        self.dense_layers = nn.ModuleList([Block(cfg, device, False)
                                           for _ in range(nf)])

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embed.reset_parameters(generator)
        for layer in (*self.dense_layers, *self.layers):
            layer.reset_parameters(generator)
        with torch.no_grad():
            self.ln_f.zero_()


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device) -> MoEModel:
    """Random weights drawn from ``generator`` (on ``device``) with the
    JAX package's recipe: N(0, 0.02) embeddings and router, N(0, d_in^-1)
    dense layers and experts, zero norm gains."""
    params = MoEModel(cfg, device)
    params.reset_parameters(generator)
    return params


def _ffn(layer: Block, x: torch.Tensor, cfg: ModelConfig,
         with_aux: bool = False):
    """The block's dense MLP or MoE layer on x: (y, the MoE layer's aux
    loss ``with_aux``, else None)."""
    if not hasattr(layer, "moe"):
        return layer.mlp(x), None
    if not with_aux:
        return moe_apply(layer.moe, x, cfg), None
    return moe_apply(layer.moe, x, cfg, with_aux=True)


def _blocks(params: MoEModel):
    """(dense, index in its stack, layer) of every block in order: the
    dense layers first (their own cache), then the MoE layers."""
    return ([(True, l, layer) for l, layer in enumerate(params.dense_layers)]
            + [(False, l, layer) for l, layer in enumerate(params.layers)])


def _logits(params: MoEModel, cfg: ModelConfig,
            h: torch.Tensor) -> torch.Tensor:
    return unembed_apply(params.embed, rms_norm(h, params.ln_f, cfg.norm_eps))


def _block_forward(layer: Block, h: torch.Tensor, positions: torch.Tensor,
                   cfg: ModelConfig, window: Optional[int], with_aux: bool):
    """One block of ``forward``: (new h, ``_ffn``'s aux loss)."""
    x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
    if cfg.use_mla:
        a = mla.mla_forward(layer.attn, x, positions, cfg, window)
    else:
        a = attn.attention_forward(layer.attn, x, positions, cfg, window)
    h = h + a
    m, aux = _ffn(layer, rms_norm(h, layer.ln_mlp, cfg.norm_eps), cfg,
                  with_aux)
    return h + m, aux


def forward(params: MoEModel, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: Optional[torch.Tensor] = None,
            window: Optional[int] = None, with_aux: bool = False):
    """Full-sequence forward (no cache) -> logits (B,T,V), or (logits,
    aux) ``with_aux``: the MoE layers' mean load-balance loss, which the
    training loss adds (JAX's ``forward`` returns the pair always).  Its
    attention is plain torch on every device (``attention.
    attention_forward`` or MLA's), so on the card it is the reference the
    served paths are held against; it carries gradients, each block under
    ``remat_layer``.  The MoE groups are this call's B·T tokens."""
    window = window if window is not None else cfg.sliding_window
    B, T = tokens.shape
    if lengths is None:
        lengths = torch.full((B,), T, dtype=torch.int32, device=tokens.device)
    positions = make_positions(tokens, lengths)
    h = embed_apply(params.embed, tokens, cfg)
    auxs = []
    for _, _, layer in _blocks(params):
        h = constrain(h)
        h, aux = remat_layer(cfg, _block_forward, layer, h, positions, cfg,
                             window, with_aux)
        if aux is not None:
            auxs.append(aux)
    logits = _logits(params, cfg, h)
    if not with_aux:
        return logits
    return logits, torch.stack(auxs).mean()


def _cache(cfg: ModelConfig, c1: list, c2: list, slot_pos: torch.Tensor,
           write_idx: int, lengths: torch.Tensor):
    if cfg.use_mla:
        return mla.MLACache(ckv=torch.stack(c1), kr=torch.stack(c2),
                            slot_pos=slot_pos, write_idx=write_idx,
                            lengths=lengths)
    return KVCache(k=torch.stack(c1), v=torch.stack(c2), slot_pos=slot_pos,
                   write_idx=write_idx, lengths=lengths)


def prefill(params: MoEModel, cfg: ModelConfig, tokens: torch.Tensor,
            lengths: torch.Tensor, cache_window: int,
            window: Optional[int] = None) -> Tuple[torch.Tensor, MoECache]:
    """Left-padded prefill: the last token's logits and the caches.  A
    sliding-window model keeps ``min(cache_window, window)`` ring slots.
    GQA attention goes through ``attention.attention_prefill`` (the
    flash_prefill kernel on the card), MLA's stays plain torch."""
    window = window if window is not None else cfg.sliding_window
    positions = make_positions(tokens, lengths)
    T = positions.shape[1]
    h = embed_apply(params.embed, tokens, cfg)
    Wc = cache_window if window is None else min(cache_window, window)
    caches = {True: ([], []), False: ([], [])}
    for dense, _, layer in _blocks(params):
        h = constrain(h)
        x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
        if cfg.use_mla:
            a, c1, c2 = mla.mla_prefill(layer.attn, x, positions, cfg, window,
                                        Wc)
        else:
            a, c1, c2 = attn.attention_prefill(layer.attn, x, positions, cfg,
                                               window, Wc)
        h = h + a
        m, _ = _ffn(layer, rms_norm(h, layer.ln_mlp, cfg.norm_eps), cfg)
        h = h + m
        caches[dense][0].append(c1)
        caches[dense][1].append(c2)
    logits = _logits(params, cfg, h[:, -1:])[:, 0]
    slot_pos = attn.prefill_slot_pos(positions, Wc)
    write_idx = T if Wc >= T else Wc
    lengths = lengths.to(torch.int32)
    kv = _cache(cfg, *caches[False], slot_pos, write_idx, lengths)
    dense_kv = (_cache(cfg, *caches[True], slot_pos, write_idx, lengths)
                if cfg.first_dense_layers else None)
    return logits, MoECache(kv=kv, dense_kv=dense_kv)


def decode_step(params: MoEModel, cfg: ModelConfig, cache: MoECache,
                tokens: torch.Tensor, step: int,
                window: Optional[int] = None
                ) -> Tuple[torch.Tensor, MoECache]:
    """One decode iteration over the caches (written in place). tokens
    (B,); step 0-based.  GQA attention goes through
    ``attention.attention_decode`` (the decode_attention kernel on the
    card), MLA's stays plain torch.  The MoE group is the step's B
    tokens."""
    window = window if window is not None else cfg.sliding_window
    kvc = cache.kv
    q_pos = kvc.lengths + step
    slot = attn.decode_slot(kvc)
    slot_pos = attn.decode_slot_pos(kvc, q_pos)
    h = embed_apply(params.embed, tokens[:, None], cfg)
    for dense, l, layer in _blocks(params):
        h = constrain(h)
        c = cache.dense_kv if dense else kvc
        x = rms_norm(h, layer.ln_attn, cfg.norm_eps)
        if cfg.use_mla:
            a = mla.mla_decode(layer.attn, x, q_pos, c.ckv[l], c.kr[l],
                               slot_pos, slot, cfg, window)
        else:
            a = attn.attention_decode(layer.attn, x, q_pos, c.k[l], c.v[l],
                                      slot_pos, slot, cfg, window)
        h = h + a
        m, _ = _ffn(layer, rms_norm(h, layer.ln_mlp, cfg.norm_eps), cfg)
        h = h + m
    logits = _logits(params, cfg, h)[:, 0]

    def advance(c):
        return c._replace(slot_pos=slot_pos, write_idx=c.write_idx + 1)

    return logits, MoECache(kv=advance(kvc),
                            dense_kv=(advance(cache.dense_kv)
                                      if cache.dense_kv is not None
                                      else None))
