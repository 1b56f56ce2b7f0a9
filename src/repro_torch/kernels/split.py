"""The host side of the split-slot decode loop (``csrc/split_attention.cuh``)
that ``decode_attention``, ``paged_decode_attention`` and
``fused_rope_decode_append`` share: how many slots a split takes, the
float32 workspace of the splits' partial softmaxes, and the card's SM
count the choice reads.
"""
from __future__ import annotations

import torch

#: slots per step of the kernels' loop; a split covers whole steps (a pool
#: page may straddle two splits: each stages its table entry)
PAGE = 16
#: fewest and most slots a split takes (the kernels stage a split's
#: slot_pos in shared memory)
MIN_SPLIT, MAX_SPLIT = 64, 2048

_sm_count = {}


def split_slots(B: int, W: int, Hkv: int, n_sm: int) -> int:
    """Slots per split: a multiple of ``PAGE`` in [``MIN_SPLIT``,
    ``MAX_SPLIT``], small enough that the (split, kv head, row) grid holds
    two blocks per SM where W allows it.  A function of shapes only, never
    of slot_pos, so that a captured launch stays valid."""
    want = -(-2 * n_sm // max(1, B * Hkv))    # splits per (row, kv head)
    chunk = min(MAX_SPLIT, max(MIN_SPLIT, -(-W // want)))
    return -(-chunk // PAGE) * PAGE


def workspace(B: int, W: int, Hq: int, Hkv: int, D: int, chunk: int,
              dev: torch.device) -> torch.Tensor:
    """The splits' float32 partials, (B, Hkv, ceil(W / chunk), G, D + 2):
    each split's running max and sum per query head, then its (G, D)
    accumulator."""
    n_split = -(-W // chunk)
    return torch.empty(B * Hkv * n_split * (Hq // Hkv) * (D + 2),
                       dtype=torch.float32, device=dev)


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of the card ``dev``, read once."""
    if dev.index not in _sm_count:
        _sm_count[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_count[dev.index]
