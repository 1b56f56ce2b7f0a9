"""Model interface: ``get_model(cfg)`` returns a ``Model`` of functions
sharing one calling convention (counterpart of ``repro.models.registry``,
for every family: dense, vlm, ssm, hybrid, moe and encdec):

  init(seed_or_generator, device=None)        -> params (nn.Module)
  loss(params, batch)                         -> scalar tensor
  prefill(params, batch, cache_window)        -> (last_logits, cache)
  decode_step(params, cache, tokens, step)    -> (logits, cache)
  kv_bytes_per_token(n_model_shards)          -> float  (Δ in Eq. 5)

``batch`` is a dict with tokens (B,T) and lengths (B,) tensors, and the
frontend stubs' embeddings where the family takes them: prefix_embeds
(B,P,d) for the VLM, src_embeds (B,S,d) and src_valid (B,S) bool for the
encoder-decoder.  The loss's batch is tokens (B,T) alone, with an
optional loss_mask (B,T-1), window_override (dense and VLM, MoE) and the
frontend embeddings; the loss runs the family's plain ``forward``, which
carries gradients and launches no kernel.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Union

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import encdec, mamba2, moe, rglru, transformer
from repro_torch.models.common import ModelConfig, softmax_xent


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    kv_bytes_per_token: Callable


def _initialiser(module, cfg: ModelConfig) -> Callable:
    def init(seed: Union[int, torch.Generator] = 0,
             device: DeviceLike = None):
        """Random weights on ``device`` (default: the CUDA card) from a
        seed or a ``torch.Generator`` living on that device."""
        dev = resolve_device(device)
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        return module.init(gen, cfg, dev)
    return init


def _itemsize(cfg: ModelConfig) -> int:
    return torch.empty((), dtype=cfg.dtype).element_size()


def _next_token_xent(logits: torch.Tensor,
                     batch: Dict[str, Any]) -> torch.Tensor:
    return softmax_xent(logits[:, :-1], batch["tokens"][:, 1:],
                        batch.get("loss_mask"))


def _dense(cfg: ModelConfig) -> Model:
    def loss(params, batch):
        window = batch.get("window_override", cfg.sliding_window)
        logits = transformer.forward(params, cfg, batch["tokens"],
                                     prefix_embeds=batch.get("prefix_embeds"),
                                     window=window)
        if cfg.n_prefix_tokens and "prefix_embeds" in batch:
            logits = logits[:, batch["prefix_embeds"].shape[1]:]
        return _next_token_xent(logits, batch)

    def prefill(params, batch, cache_window, window=None):
        return transformer.prefill(params, cfg, batch["tokens"],
                                   batch["lengths"], cache_window,
                                   prefix_embeds=batch.get("prefix_embeds"),
                                   window=window)

    def decode_step(params, cache, tokens, step, window=None):
        return transformer.decode_step(params, cfg, cache, tokens, step,
                                       window=window)

    def kv_bytes(n_shards: int = 1) -> float:
        per_tok = (2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim
                   * _itemsize(cfg))
        return per_tok / min(n_shards, cfg.n_kv_heads)

    return Model(cfg, _initialiser(transformer, cfg), loss, prefill,
                 decode_step, kv_bytes)


def _ssm(cfg: ModelConfig) -> Model:
    def loss(params, batch):
        return _next_token_xent(mamba2.forward(params, cfg, batch["tokens"]),
                                batch)

    def prefill(params, batch, cache_window, window=None):
        return mamba2.prefill(params, cfg, batch["tokens"], batch["lengths"])

    def decode_step(params, cache, tokens, step, window=None):
        return mamba2.decode_step(params, cfg, cache, tokens, step)

    def kv_bytes(n_shards: int = 1) -> float:
        # constant-size state, amortised over the slice: the marginal
        # per-token cost is 0
        return 0.0

    return Model(cfg, _initialiser(mamba2, cfg), loss, prefill, decode_step,
                 kv_bytes)


def _hybrid(cfg: ModelConfig) -> Model:
    def loss(params, batch):
        return _next_token_xent(rglru.forward(params, cfg, batch["tokens"]),
                                batch)

    def prefill(params, batch, cache_window, window=None):
        return rglru.prefill(params, cfg, batch["tokens"], batch["lengths"],
                             cache_window)

    def decode_step(params, cache, tokens, step, window=None):
        return rglru.decode_step(params, cfg, cache, tokens, step)

    def kv_bytes(n_shards: int = 1) -> float:
        # the n_layers // 3 local-attention layers' rings only
        n_attn = cfg.n_layers // 3
        per_tok = (2 * n_attn * cfg.n_kv_heads * cfg.head_dim
                   * _itemsize(cfg))
        return per_tok / min(n_shards, cfg.n_kv_heads)

    return Model(cfg, _initialiser(rglru, cfg), loss, prefill, decode_step,
                 kv_bytes)


def _moe(cfg: ModelConfig) -> Model:
    def loss(params, batch):
        window = batch.get("window_override", cfg.sliding_window)
        logits, aux = moe.forward(params, cfg, batch["tokens"],
                                  batch.get("lengths"), window=window,
                                  with_aux=True)
        return _next_token_xent(logits, batch) + cfg.router_aux_coef * aux

    def prefill(params, batch, cache_window, window=None):
        return moe.prefill(params, cfg, batch["tokens"], batch["lengths"],
                           cache_window, window=window)

    def decode_step(params, cache, tokens, step, window=None):
        return moe.decode_step(params, cfg, cache, tokens, step,
                               window=window)

    def kv_bytes(n_shards: int = 1) -> float:
        b = _itemsize(cfg)
        if cfg.use_mla:  # latent + shared rope key, replicated across heads
            return cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_head_dim) * b
        per_tok = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * b
        return per_tok / min(n_shards, cfg.n_kv_heads)

    return Model(cfg, _initialiser(moe, cfg), loss, prefill, decode_step,
                 kv_bytes)


def _encdec(cfg: ModelConfig) -> Model:
    def loss(params, batch):
        logits = encdec.forward(params, cfg, batch["src_embeds"],
                                batch["tokens"], batch.get("src_valid"))
        return _next_token_xent(logits, batch)

    def prefill(params, batch, cache_window, window=None):
        return encdec.prefill(params, cfg, batch["src_embeds"],
                              batch["tokens"], batch["lengths"], cache_window,
                              batch.get("src_valid"), window=window)

    def decode_step(params, cache, tokens, step, window=None):
        return encdec.decode_step(params, cfg, cache, tokens, step,
                                  window=window)

    def kv_bytes(n_shards: int = 1) -> float:
        # decoder self-attention cache only (the cross-KV is constant over
        # a schedule)
        per_tok = (2 * cfg.n_dec_layers * cfg.n_kv_heads * cfg.head_dim
                   * _itemsize(cfg))
        return per_tok / min(n_shards, cfg.n_kv_heads)

    return Model(cfg, _initialiser(encdec, cfg), loss, prefill, decode_step,
                 kv_bytes)


_FAMILIES = {
    "dense": _dense,
    "vlm": _dense,  # prefix-LM rides the dense path (prefix_embeds in batch)
    "ssm": _ssm,
    "hybrid": _hybrid,
    "moe": _moe,
    "encdec": _encdec,
}


#: each family's parameter module, by family
_PARAMS = {"dense": transformer.Transformer, "vlm": transformer.Transformer,
           "ssm": mamba2.Mamba2, "hybrid": rglru.RecurrentGemma,
           "moe": moe.MoEModel, "encdec": encdec.EncDecModel}


def skeleton(cfg: ModelConfig, device: DeviceLike = "meta") -> torch.nn.Module:
    """The family's parameter module with uninitialised parameters (on
    the meta device by default: shapes and dtypes, no storage), as the
    dry-run places it (``jax.eval_shape(model.init, ...)``'s
    counterpart)."""
    return _PARAMS[cfg.family](cfg, torch.device(device))


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  f"ported yet (see ROADMAP)")
    return _FAMILIES[cfg.family](cfg)
