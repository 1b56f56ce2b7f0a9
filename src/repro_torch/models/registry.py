"""Model interface: ``get_model(cfg)`` returns a ``Model`` of functions
sharing one calling convention (counterpart of ``repro.models.registry``,
dense family only in this slice):

  init(seed_or_generator, device=None)        -> params (nn.Module)
  prefill(params, batch, cache_window)        -> (last_logits, KVCache)
  decode_step(params, cache, tokens, step)    -> (logits, KVCache)
  kv_bytes_per_token(n_model_shards)          -> float  (Δ in Eq. 5)

``batch`` is a dict with tokens (B,T) and lengths (B,) tensors.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.models import transformer
from repro_torch.models.common import ModelConfig


class Model(NamedTuple):
    cfg: ModelConfig
    init: Callable
    prefill: Callable
    decode_step: Callable
    kv_bytes_per_token: Callable


def _dense(cfg: ModelConfig) -> Model:
    def init(seed: Union[int, torch.Generator] = 0,
             device: DeviceLike = None) -> transformer.Transformer:
        """Random weights on ``device`` (default: the CUDA card) from a
        seed or a ``torch.Generator`` living on that device."""
        dev = resolve_device(device)
        if isinstance(seed, torch.Generator):
            gen = seed
        else:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        return transformer.init(gen, cfg, dev)

    def prefill(params, batch, cache_window, window=None):
        return transformer.prefill(params, cfg, batch["tokens"],
                                   batch["lengths"], cache_window,
                                   window=window)

    def decode_step(params, cache, tokens, step, window=None):
        return transformer.decode_step(params, cfg, cache, tokens, step,
                                       window=window)

    def kv_bytes(n_shards: int = 1) -> float:
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        per_tok = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * itemsize
        return per_tok / min(n_shards, cfg.n_kv_heads)

    return Model(cfg, init, prefill, decode_step, kv_bytes)


_FAMILIES = {"dense": _dense}


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(f"model family {cfg.family!r} is not "
                                  f"ported yet (see ROADMAP)")
    return _FAMILIES[cfg.family](cfg)
