"""Batched GQA decode attention over a paged KV pool — the CUDA kernel's
Python wrapper.

Port of the Pallas kernel ``repro.kernels.paged_decode_attention``.
Source: ``csrc/paged_decode_attention.cu``.  The plain version is
``kernels.ref.paged_decode_attention_ref``; ``kernels.ops`` dispatches
between the two by device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

#: launches of the CUDA kernel since the last reset
launches = 0

#: shapes the kernel is compiled for (template instances in the source)
HEAD_DIMS = (64, 128)
PAGE_TOKENS = (8, 16)
MAX_GROUP = 8

_fn = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("paged_decode_attention").paged_decode_attention_launch
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def reset_launches() -> None:
    global launches
    launches = 0


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, block_table: torch.Tensor,
                           slot_pos: torch.Tensor, q_pos: torch.Tensor,
                           window: Optional[int] = None) -> torch.Tensor:
    """q (B,Hq,D); k/v_pages (P,pg,Hkv,D); block_table (B,nb), slot_pos
    (B,nb·pg) and q_pos (B,) int32.  Returns (B,Hq,D) in q's type.  Every
    tensor must be contiguous and on one CUDA device."""
    global launches
    tensors = (q, k_pages, v_pages, block_table, slot_pos, q_pos)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("paged_decode_attention kernel: every tensor must "
                         "be on one CUDA device")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"paged_decode_attention kernel: q and pools must "
                        f"share float32 or bfloat16, got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if any(t.dtype != torch.int32 for t in (block_table, slot_pos, q_pos)):
        raise TypeError("paged_decode_attention kernel: block_table, "
                        "slot_pos and q_pos must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention kernel: tensors must be "
                         "contiguous")
    B, Hq, D = q.shape
    P, pg, Hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    nb = block_table.shape[1] if block_table.dim() == 2 else -1
    if (k_pages.shape != (P, pg, Hkv, D) or v_pages.shape != k_pages.shape
            or Hq % Hkv or block_table.shape != (B, nb)
            or slot_pos.shape != (B, nb * pg) or q_pos.shape != (B,)):
        raise ValueError(f"paged_decode_attention kernel: shapes q "
                         f"{tuple(q.shape)}, pools {tuple(k_pages.shape)}/"
                         f"{tuple(v_pages.shape)}, block_table "
                         f"{tuple(block_table.shape)}, slot_pos "
                         f"{tuple(slot_pos.shape)}, q_pos {tuple(q_pos.shape)}")
    if D not in HEAD_DIMS or pg not in PAGE_TOKENS or Hq // Hkv > MAX_GROUP:
        raise ValueError(f"paged_decode_attention kernel: head_dim {D} not "
                         f"in {HEAD_DIMS}, page_tokens {pg} not in "
                         f"{PAGE_TOKENS} or {Hq // Hkv} query heads per KV "
                         f"head above {MAX_GROUP}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode_attention kernel: the page pools "
                         "must be 16-byte aligned")
    out = torch.empty_like(q)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
                 v_pages.data_ptr(), block_table.data_ptr(),
                 slot_pos.data_ptr(), q_pos.data_ptr(), out.data_ptr(), B,
                 Hq, Hkv, D, nb, pg, window or 0, D ** -0.5, stream)
        launches += 1
    if err:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {err}")
    return out
