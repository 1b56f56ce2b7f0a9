"""Paged KV-cache subsystem: block-granular allocation for serving engines.

``PageAllocator`` and ``PrefixIndex`` are pure Python, copied from
``repro.kvcache``; ``paged`` holds the device-side page pools.
"""
from repro_torch.kvcache.allocator import PageAllocator
from repro_torch.kvcache.paged import (PagedKVCache, append_prefill,
                                       batch_block_table, batch_slot_pos,
                                       clear_row, gather_row,
                                       init_page_pools, init_paged_kv_cache,
                                       write_prefill_pages)
from repro_torch.kvcache.prefix import PrefixIndex

__all__ = [
    "PageAllocator",
    "PagedKVCache",
    "PrefixIndex",
    "append_prefill",
    "batch_block_table",
    "batch_slot_pos",
    "clear_row",
    "gather_row",
    "init_page_pools",
    "init_paged_kv_cache",
    "write_prefill_pages",
]
