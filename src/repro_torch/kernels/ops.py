"""Dispatch for the port's kernels, by the device of the tensors.

A CUDA tensor launches the hand-written kernel (or the wrapper raises);
a CPU tensor takes the kernel's plain version in ``kernels.ref``.  There
is no switch that sends a CUDA tensor to the plain version.  The engines
and models call through these functions, so the serving stack runs the
kernels whenever its pools live on the card.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import paged_decode_attention as _decode_kernel
from repro_torch.kernels import paged_prefill_write as _write_kernel

#: calls that took a kernel's plain version (CPU tensors), by kernel
plain_calls: Dict[str, int] = {"paged_prefill_write": 0,
                               "paged_decode_attention": 0}


def _on_cpu(t: torch.Tensor, name: str) -> bool:
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for device {t.device}")
    plain_calls[name] += 1
    return True


def launches() -> Dict[str, int]:
    """Kernel launches since the last ``reset_counts``."""
    return {"paged_prefill_write": _write_kernel.launches,
            "paged_decode_attention": _decode_kernel.launches}


def reset_counts() -> None:
    _write_kernel.reset_launches()
    _decode_kernel.reset_launches()
    for k in plain_calls:
        plain_calls[k] = 0


def paged_prefill_write(k_new: torch.Tensor, v_new: torch.Tensor,
                        positions: torch.Tensor, block_table: torch.Tensor,
                        k_pages: torch.Tensor, v_pages: torch.Tensor) -> None:
    """Write prefill K/V into the paged pool through block tables, in place.

    k/v_new (B,T,Hkv,D) in the left-padded layout; positions (B,T) from
    ``models.transformer.make_positions`` (pads < 0, real tokens at their
    absolute position, which is the destination logical slot); block_table
    (B,nb); k/v_pages (P,pg,Hkv,D) of one layer.
    """
    if _on_cpu(k_new, "paged_prefill_write"):
        ref.paged_prefill_write_ref(k_new, v_new, positions, block_table,
                                    k_pages, v_pages)
        return
    _write_kernel.paged_prefill_write(k_new, v_new, positions, block_table,
                                      k_pages, v_pages)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           slot_pos: torch.Tensor, q_pos: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """Single-token GQA decode over a paged KV cache. q (B,Hq,D) ->
    (B,Hq,D)."""
    if _on_cpu(q, "paged_decode_attention"):
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_table, slot_pos, q_pos,
                                              window=window)
    return _decode_kernel.paged_decode_attention(q, k_pages, v_pages,
                                                 block_table, slot_pos,
                                                 q_pos, window=window)
