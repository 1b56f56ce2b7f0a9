"""Assigned input shapes and their input records for the dry-run
(counterpart of ``repro.configs.shapes``).

Decode shapes run ``decode_step`` (one new token against a KV cache of
``seq_len``); train_4k runs ``train_step``; prefill_32k runs the prefill
step.  long_500k substitutes a sliding window on full-attention archs
(``cfg.long_context_window``).

PyTorch has no ``jax.ShapeDtypeStruct``: ``token_specs`` returns a
``TensorSpec`` record (shape and dtype) for every model input, which
``launch.dryrun`` turns into fake tensors on the mesh and a caller can
turn into real ones (``TensorSpec.empty``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


class TensorSpec(NamedTuple):
    """Shape and dtype of one model input (``jax.ShapeDtypeStruct``'s
    counterpart)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype

    def empty(self, device=None) -> torch.Tensor:
        """An uninitialised tensor of this shape and dtype."""
        return torch.empty(self.shape, dtype=self.dtype, device=device)


def effective_window(cfg: ModelConfig, shape: InputShape) -> Optional[int]:
    """Window override for long-context decode on full-attention archs."""
    if shape.name != "long_500k":
        return cfg.sliding_window
    if cfg.family in ("ssm", "hybrid"):
        return cfg.sliding_window  # native sub-quadratic
    if cfg.sliding_window is not None:
        return cfg.sliding_window  # e.g. mixtral SWA
    return cfg.long_context_window


def token_specs(cfg: ModelConfig, shape: InputShape,
                dtype: torch.dtype = torch.int32) -> Dict[str, TensorSpec]:
    """``TensorSpec`` of every model input of this shape."""
    B, T = shape.global_batch, shape.seq_len
    f = cfg.dtype
    if shape.kind == "train":
        batch: Dict[str, TensorSpec] = {"tokens": TensorSpec((B, T), dtype)}
        if cfg.family == "encdec":
            batch["src_embeds"] = TensorSpec((B, T, cfg.d_model), f)
        if cfg.family == "vlm":
            batch["tokens"] = TensorSpec((B, T - cfg.n_prefix_tokens), dtype)
            batch["prefix_embeds"] = TensorSpec(
                (B, cfg.n_prefix_tokens, cfg.d_model), f)
        return batch
    # serving shapes: prefill input or decode-step token batch
    batch = {"tokens": TensorSpec((B, T), dtype),
             "lengths": TensorSpec((B,), torch.int32)}
    if cfg.family == "encdec":
        # decode against a fixed 4096-frame encoder memory
        batch["src_embeds"] = TensorSpec((B, 4096, cfg.d_model), f)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = TensorSpec(
            (B, cfg.n_prefix_tokens, cfg.d_model), f)
    return batch
