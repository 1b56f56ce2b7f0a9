"""Fused RoPE + KV append + paged GQA decode attention — the CUDA
kernel's Python wrapper.

Port of the Pallas kernel ``repro.kernels.fused_rope_decode_append``: one
launch rotates the new token's q and k at ``q_pos``, appends its K/V at
logical slot ``slots`` of the pool and runs paged decode attention over
the pool after the append.  Source: ``csrc/fused_rope_decode_append.cu``,
on the split-slot loop and workspace of ``kernels.split`` (pass 1
rotates, appends and writes partials, pass 2 merges them); one call
launches both passes and counts one launch.  The plain version is
``kernels.ref.fused_rope_decode_append_ref``; ``kernels.ops`` dispatches
between the two by device.  Any head dim that is a multiple of 16 up to
256 and any group run (``kernels.split.supports``); with several head
blocks a KV head, each block that holds the new slot appends it itself.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_rope_prefill_write import inv_freq
from repro_torch.kernels.split import (DOMAIN, head_blocks, sm_count,
                                       split_slots, supports, workspace)

#: launches of the CUDA kernel since the last reset
launches = 0

_fn = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load(
            "fused_rope_decode_append").fused_rope_decode_append_launch
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 12 \
            + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def reset_launches() -> None:
    global launches
    launches = 0


def fused_rope_decode_append(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, block_table: torch.Tensor,
                             slot_pos: torch.Tensor, slots: torch.Tensor,
                             q_pos: torch.Tensor, k_pages: torch.Tensor,
                             v_pages: torch.Tensor, theta: float = 10000.0,
                             window: Optional[int] = None) -> torch.Tensor:
    """q (B,Hq,D) and k/v_new (B,Hkv,D) unrotated; block_table (B,nb),
    slot_pos (B,nb·pg) already marking the new slot, slots (B,) and q_pos
    (B,) int32; k/v_pages (P,pg,Hkv,D), appended to in place.  Returns
    (B,Hq,D) in q's type.  Every tensor must be contiguous and on one CUDA
    device."""
    global launches
    tensors = (q, k_new, v_new, block_table, slot_pos, slots, q_pos,
               k_pages, v_pages)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("fused_rope_decode_append kernel: every tensor "
                         "must be on one CUDA device")
    if q.dtype not in _DTYPES or any(
            t.dtype != q.dtype for t in (k_new, v_new, k_pages, v_pages)):
        raise TypeError(f"fused_rope_decode_append kernel: q, k/v_new and "
                        f"pools must share float32 or bfloat16, got "
                        f"{q.dtype}, {k_new.dtype}, {v_new.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if any(t.dtype != torch.int32
           for t in (block_table, slot_pos, slots, q_pos)):
        raise TypeError("fused_rope_decode_append kernel: block_table, "
                        "slot_pos, slots and q_pos must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_rope_decode_append kernel: tensors must be "
                         "contiguous")
    B, Hq, D = q.shape
    P, pg, Hkv = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    nb = block_table.shape[1] if block_table.dim() == 2 else -1
    if (k_pages.shape != (P, pg, Hkv, D) or v_pages.shape != k_pages.shape
            or k_new.shape != (B, Hkv, D) or v_new.shape != k_new.shape
            or Hq % Hkv or nb < 1 or block_table.shape != (B, nb)
            or slot_pos.shape != (B, nb * pg) or slots.shape != (B,)
            or q_pos.shape != (B,)):
        raise ValueError(f"fused_rope_decode_append kernel: shapes q "
                         f"{tuple(q.shape)}, k/v_new {tuple(k_new.shape)}/"
                         f"{tuple(v_new.shape)}, pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
                         f"block_table {tuple(block_table.shape)}, slot_pos "
                         f"{tuple(slot_pos.shape)}, slots "
                         f"{tuple(slots.shape)}, q_pos {tuple(q_pos.shape)}")
    if not supports(D, Hq // Hkv, q.dtype) or pg < 1:
        raise ValueError(f"fused_rope_decode_append kernel: head_dim {D} "
                         f"with {Hq // Hkv} query heads per KV head, "
                         f"page_tokens {pg}; the kernel takes {DOMAIN}, "
                         f"pages of 1 slot or more")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("fused_rope_decode_append kernel: the page pools "
                         "must be 16-byte aligned")
    freqs = inv_freq(D, theta, dev)
    out = torch.empty_like(q)
    rep = head_blocks(Hq // Hkv)
    chunk = split_slots(B, nb * pg, Hkv * rep, sm_count(dev))
    ws = workspace(B, nb * pg, Hq, Hkv, D, chunk, dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k_new.data_ptr(),
                 v_new.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 block_table.data_ptr(), slot_pos.data_ptr(),
                 slots.data_ptr(), q_pos.data_ptr(), freqs.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), B, Hq, Hkv, rep, D, nb, pg,
                 chunk, window or 0, D ** -0.5, stream)
        if build.counted("fused_rope_decode_append"):
            with build.LOCK:
                launches += 1
    if err:
        raise RuntimeError(f"fused_rope_decode_append kernel launch failed: "
                           f"CUDA error {err}")
    return out
