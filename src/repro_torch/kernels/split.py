"""The host side of the split-slot decode loop (``csrc/split_attention.cuh``)
that ``decode_attention``, ``paged_decode_attention`` and
``fused_rope_decode_append`` share: the head dims and groups the kernels
take (``supports``) and the compiled instance that serves a head dim, the
head blocks of a group, how many slots a split takes, the float32
workspace of the splits' partial softmaxes, and the card's SM count the
choice reads.
"""
from __future__ import annotations

import torch

#: slots per step of the kernels' loop; a split covers whole steps (a pool
#: page may straddle two splits: each stages its table entry)
PAGE = 16
#: fewest and most slots a split takes (the kernels stage a split's
#: slot_pos in shared memory)
MIN_SPLIT, MAX_SPLIT = 64, 2048

#: head dims the attention kernels are compiled for (``kHeadDims`` in
#: ``csrc/paged_attention.cuh``); a call's head dim runs on the smallest
#: at or above it, its loads zero-filled past the call's head dim
HEAD_DIMS = (32, 64, 96, 128, 160, 192, 256)
#: most query heads one block of the split loop holds (``kMaxG``); a
#: larger group runs as ``head_blocks(G)`` blocks
BLOCK_GROUP = 8
#: the shapes the attention kernels (B1, B4, B5, B6) take, as their
#: refusals name them
DOMAIN = ("head dims that are multiples of 16 from 16 to 256, any "
          "number of query heads per KV head, float32 or bfloat16")

_sm_count = {}


def supports(D: int, G: int, dtype: torch.dtype) -> bool:
    """Whether the attention kernels take head dim ``D``, ``G`` query
    heads per KV head and ``dtype``: D a multiple of 16 in [16, 256], any
    G >= 1, float32 or bfloat16.  Needs no card."""
    return (16 <= D <= 256 and D % 16 == 0 and G >= 1
            and dtype in (torch.float32, torch.bfloat16))


def instance_dim(D: int) -> int:
    """The compiled head dim that serves head dim ``D`` (``supports``)."""
    return next(d for d in HEAD_DIMS if d >= D)


def head_blocks(G: int) -> int:
    """Blocks that share a KV head's ``G`` query heads: ceil(G / 8), each
    of ``block_heads(G)`` heads but the last, which holds the rest (1 up
    to 8, 2 at 12 and 16, 9 at 71)."""
    return -(-G // BLOCK_GROUP)


def block_heads(G: int) -> int:
    """Query heads of each head block but the last: ceil(G / rep)."""
    rep = head_blocks(G)
    return -(-G // rep)


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
    """The splits' float32 partials, (B, Hkv * rep, ceil(W / chunk), gb,
    Di + 2) for rep = head_blocks(G), gb = block_heads(G) and Di the
    instance of head dim D: each split's running max and sum per query
    head of its head block, then its (n, Di) accumulator."""
    G = Hq // Hkv
    n_split = -(-W // chunk)
    return torch.empty(B * Hkv * head_blocks(G) * n_split * block_heads(G)
                       * (instance_dim(D) + 2), dtype=torch.float32,
                       device=dev)


def sm_count(dev: torch.device) -> int:
    """Streaming multiprocessors of the card ``dev``, read once."""
    if dev.index not in _sm_count:
        _sm_count[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sm_count[dev.index]
