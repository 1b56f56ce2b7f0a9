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
``k_pages[l]`` are contiguous), never copied.  ``init_paged_kv_cache``,
``write_prefill_pages``, ``append_prefill`` and ``clear_row`` keep a
cache of one row per ``ContinuousEngine`` slot; like the JAX functions
they return the cache, but they update its tensors in place.
``gather_row`` materializes a row's logical K/V for tests.
"""
from __future__ import annotations

from typing import List, NamedTuple, Tuple

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
    def page_tokens(self) -> int:
        return self.k_pages.shape[2]

    @property
    def window(self) -> int:
        """Logical cache width per row."""
        return self.block_table.shape[1] * self.k_pages.shape[2]

    @property
    def n_pages(self) -> int:
        """Physical pages including the null page."""
        return self.k_pages.shape[1]


def init_page_pools(n_layers: int, n_pages: int, page_tokens: int, n_kv: int,
                    head_dim: int, dtype: torch.dtype, device: torch.device
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zeroed (k_pages, v_pages) of ``n_pages`` usable pages plus the
    null page 0."""
    shape = (n_layers, n_pages + 1, page_tokens, n_kv, head_dim)
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def init_paged_kv_cache(n_layers: int, batch: int, n_pages: int,
                        page_tokens: int, max_blocks_per_row: int,
                        n_kv: int, head_dim: int, dtype: torch.dtype,
                        device: torch.device) -> PagedKVCache:
    """A cache of ``batch`` rows over ``n_pages`` usable pages (plus the
    null page 0); every row maps the null page and masks every slot."""
    k_pages, v_pages = init_page_pools(n_layers, n_pages, page_tokens, n_kv,
                                       head_dim, dtype, device)
    return PagedKVCache(
        k_pages, v_pages,
        torch.zeros((batch, max_blocks_per_row), dtype=torch.int32,
                    device=device),
        torch.full((batch, max_blocks_per_row * page_tokens), -1,
                   dtype=torch.int32, device=device),
        torch.zeros((batch,), dtype=torch.int32, device=device))


def write_prefill_pages(cache: PagedKVCache, row: int, page_ids: List[int],
                        k: torch.Tensor, v: torch.Tensor,
                        prefill_slot_pos: torch.Tensor, length: int
                        ) -> PagedKVCache:
    """Scatter one request's prefill K/V (L, T, Hkv, D) into its pages and
    point ``row`` at them, in place.

    ``page_ids`` are the allocator's pages for this row (first block
    first); T must fit in them.  ``prefill_slot_pos`` (T,) carries the
    absolute position per prefill slot (pads -1), as the dense prefill
    produces it.  Slots of the last page past T are zeroed."""
    L, _, pg, Hkv, D = cache.k_pages.shape
    T = k.shape[1]
    n_used = len(page_ids)
    pad = n_used * pg - T
    if pad < 0:
        raise ValueError(f"{T} prefill slots exceed {n_used} pages of {pg}")
    nb = cache.block_table.shape[1]
    if n_used > nb:
        raise ValueError(f"{n_used} pages exceed the {nb}-block table")
    dev = cache.k_pages.device
    ids = torch.tensor(page_ids, dtype=torch.long, device=dev)
    fill = (0, 0, 0, 0, 0, pad)
    cache.k_pages[:, ids] = torch.nn.functional.pad(k, fill).reshape(
        L, n_used, pg, Hkv, D).to(cache.k_pages.dtype)
    cache.v_pages[:, ids] = torch.nn.functional.pad(v, fill).reshape(
        L, n_used, pg, Hkv, D).to(cache.v_pages.dtype)
    cache.block_table[row] = 0
    cache.block_table[row, :n_used] = ids.to(torch.int32)
    cache.slot_pos[row] = -1
    cache.slot_pos[row, :T] = prefill_slot_pos.to(torch.int32)
    cache.lengths[row] = length
    return cache


def append_prefill(cache: PagedKVCache, row: int, page_ids: List[int],
                   k: torch.Tensor, v: torch.Tensor, start: int, n_new: int
                   ) -> PagedKVCache:
    """Append K/V (L, n_new, Hkv, D) for tokens ``[start, start + n_new)``
    of one row, in place, in the compact layout (logical slot == absolute
    position, no pad slots) of the persistent paged engine.

    ``page_ids`` is the row's full page list (first block first).  Slots
    before ``start`` (the retained prefix) are untouched; the row's
    block_table, slot_pos and length are refreshed.  The host-side twin
    of the batched prefill path, for single-row delta prefills and as a
    reference in tests."""
    L, _, pg, Hkv, D = cache.k_pages.shape
    n_total = start + n_new
    if n_total > len(page_ids) * pg:
        raise ValueError(f"{n_total} slots exceed {len(page_ids)} pages "
                         f"of {pg}")
    nb = cache.block_table.shape[1]
    if len(page_ids) > nb:
        raise ValueError(f"{len(page_ids)} pages exceed the {nb}-block table")
    dev = cache.k_pages.device
    slots = torch.arange(start, n_total, device=dev)
    pages = torch.tensor(page_ids, dtype=torch.long, device=dev)[slots // pg]
    cache.k_pages[:, pages, slots % pg] = k[:, :n_new].to(cache.k_pages.dtype)
    cache.v_pages[:, pages, slots % pg] = v[:, :n_new].to(cache.v_pages.dtype)
    cache.block_table[row] = 0
    cache.block_table[row, :len(page_ids)] = torch.tensor(
        page_ids, dtype=torch.int32, device=dev)
    cache.slot_pos[row] = -1
    cache.slot_pos[row, :n_total] = torch.arange(n_total, dtype=torch.int32,
                                                 device=dev)
    cache.lengths[row] = n_total
    return cache


def clear_row(cache: PagedKVCache, row: int) -> PagedKVCache:
    """Evict a row, in place: point its blocks at the null page and mask
    every slot.  The page contents are left dirty: unmapped and masked they
    are unreachable, and the next owner's prefill overwrites them."""
    cache.block_table[row] = 0
    cache.slot_pos[row] = -1
    return cache


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


def gather_row(cache: PagedKVCache, row: int) -> Tuple[np.ndarray, np.ndarray]:
    """Materialize row's logical (L, nb·pg, Hkv, D) K/V as numpy arrays —
    a debug and test helper."""
    L, _, pg, Hkv, D = cache.k_pages.shape
    bt = cache.block_table[row].long()
    k = cache.k_pages[:, bt].reshape(L, -1, Hkv, D)
    v = cache.v_pages[:, bt].reshape(L, -1, Hkv, D)
    return k.float().cpu().numpy(), v.float().cpu().numpy()
