"""Device-side paged KV cache: a shared page pool + per-row block tables.

PyTorch counterpart of ``repro.kvcache.paged``, same layout:

  * ``k_pages``/``v_pages`` — (L, P, pg, Hkv, D): P physical pages of
    ``pg`` token slots, shared by all batch rows (page 0 is the null page,
    see ``kvcache.allocator``);
  * ``block_table`` — (B, nb) int32: logical block j of row b lives in
    physical page ``block_table[b, j]`` (0 = unused -> null page);
  * ``slot_pos`` — (B, nb·pg) int32: absolute position stored in each
    logical slot, -1 = empty.

The pools are written in place by the model drivers (``layer`` views
``k_pages[l]`` are contiguous), never copied.
"""
from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch


class PagedKVCache(NamedTuple):
    """Per-model paged KV cache; k/v carry a leading layer axis."""

    k_pages: torch.Tensor      # (L, P, pg, Hkv, D)
    v_pages: torch.Tensor      # (L, P, pg, Hkv, D)
    block_table: torch.Tensor  # (B, nb) int32 physical page per logical block
    slot_pos: torch.Tensor     # (B, nb·pg) int32 absolute position, -1 empty
    lengths: torch.Tensor      # (B,) int32 real (unpadded) input lengths

    @property
    def window(self) -> int:
        """Logical cache width per row."""
        return self.block_table.shape[1] * self.k_pages.shape[2]


def init_page_pools(n_layers: int, n_pages: int, page_tokens: int, n_kv: int,
                    head_dim: int, dtype: torch.dtype, device: torch.device):
    """Zeroed (k_pages, v_pages) of ``n_pages`` usable pages plus the
    null page 0."""
    shape = (n_layers, n_pages + 1, page_tokens, n_kv, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def batch_block_table(pages_per_row: List[List[int]], n_blocks: int
                      ) -> np.ndarray:
    """Assemble a (B, nb) block table from per-row page lists (padded with
    the null page)."""
    B = len(pages_per_row)
    bt = np.zeros((B, n_blocks), np.int32)
    for b, pages in enumerate(pages_per_row):
        if len(pages) > n_blocks:
            raise ValueError(f"row {b}: {len(pages)} pages exceed the "
                             f"{n_blocks}-block table")
        bt[b, :len(pages)] = pages
    return bt


def batch_slot_pos(lengths: List[int], n_blocks: int, page_tokens: int
                   ) -> np.ndarray:
    """(B, nb·pg) slot_pos for the compact layout: slot s of row b holds
    absolute position s for s < lengths[b], -1 (masked) beyond."""
    W = n_blocks * page_tokens
    slots = np.arange(W, dtype=np.int32)[None]
    lens = np.asarray(lengths, np.int32)[:, None]
    return np.where(slots < lens, slots, -1).astype(np.int32)
