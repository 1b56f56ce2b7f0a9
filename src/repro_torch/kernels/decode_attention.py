"""Batched GQA decode attention over a dense KV cache — the CUDA kernel's
Python wrapper.

Port of the Pallas kernel ``repro.kernels.decode_attention``.  Source:
``csrc/decode_attention.cu``, on the split-slot loop of
``csrc/split_attention.cuh`` (host side in ``kernels.split``): each row's
slots are split over several blocks (pass 1 writes float32 partial
softmaxes to a workspace that this wrapper allocates, pass 2 merges them);
one call launches both passes and counts one launch.  A group above
``split.BLOCK_GROUP`` (8) query heads per KV head (recurrentgemma-9b's
16, Falcon-7B's 71) runs as ``split.head_blocks(G)`` blocks of at most 8
heads each (the last ragged), every one reading its KV head's slots; any
head dim that is a multiple of 16 up to 256 runs on the smallest
compiled instance at or above it (``split.supports``).  The plain
version is ``kernels.ref.decode_attention_ref``; ``kernels.ops``
dispatches between the two by device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.split import (DOMAIN, head_blocks, sm_count,
                                       split_slots, supports, workspace)

#: launches of the CUDA kernel since the last reset
launches = 0

_fn = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("decode_attention").decode_attention_launch
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def reset_launches() -> None:
    global launches
    launches = 0


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, slot_pos: torch.Tensor,
                     q_pos: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """q (B,Hq,D); k/v_cache (B,W,Hkv,D); slot_pos (B,W) and q_pos (B,)
    int32.  Returns (B,Hq,D) in q's type.  Every tensor must be contiguous
    and on one CUDA device."""
    global launches
    tensors = (q, k_cache, v_cache, slot_pos, q_pos)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("decode_attention kernel: every tensor must be on "
                         "one CUDA device")
    if q.dtype not in _DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel: q and caches must share "
                        f"float32 or bfloat16, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}")
    if slot_pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError("decode_attention kernel: slot_pos and q_pos must "
                        "be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention kernel: tensors must be "
                         "contiguous")
    if q.dim() != 3 or k_cache.dim() != 4:
        raise ValueError(f"decode_attention kernel: q {tuple(q.shape)} must "
                         f"be (B,Hq,D) and k_cache {tuple(k_cache.shape)} "
                         f"(B,W,Hkv,D)")
    B, Hq, D = q.shape
    W, Hkv = k_cache.shape[1], k_cache.shape[2]
    if (k_cache.shape != (B, W, Hkv, D) or v_cache.shape != k_cache.shape
            or Hq % Hkv or slot_pos.shape != (B, W)
            or q_pos.shape != (B,) or W < 1):
        raise ValueError(f"decode_attention kernel: shapes q "
                         f"{tuple(q.shape)}, caches {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)}, slot_pos "
                         f"{tuple(slot_pos.shape)}, q_pos {tuple(q_pos.shape)}")
    if not supports(D, Hq // Hkv, q.dtype):
        raise ValueError(f"decode_attention kernel: head_dim {D} with "
                         f"{Hq // Hkv} query heads per KV head; the kernel "
                         f"takes {DOMAIN}")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention kernel: the caches must be "
                         "16-byte aligned")
    out = torch.empty_like(q)
    rep = head_blocks(Hq // Hkv)
    chunk = split_slots(B, W, Hkv * rep, sm_count(dev))
    ws = workspace(B, W, Hq, Hkv, D, chunk, dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
                 v_cache.data_ptr(), slot_pos.data_ptr(), q_pos.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), B, Hq, Hkv, rep, D, W, chunk,
                 window or 0, D ** -0.5, stream)
        if build.counted("decode_attention"):
            with build.LOCK:
                launches += 1
    if err:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {err}")
    return out
