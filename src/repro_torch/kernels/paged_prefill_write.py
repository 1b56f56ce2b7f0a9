"""Prefill K/V page-pool scatter — the CUDA kernel's Python wrapper.

Port of the Pallas kernel ``repro.kernels.paged_prefill_write`` with the
semantics of its oracle (``repro.kernels.ref.paged_prefill_write_ref``):
each token is written to the slot its own position names, so a tail
prefill whose positions start past a shared prefix leaves the prefix
pages untouched.  Source: ``csrc/paged_prefill_write.cu``.  The plain
version is ``kernels.ref.paged_prefill_write_ref``; ``kernels.ops``
dispatches between the two by device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

#: launches of the CUDA kernel since the last reset
launches = 0

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("paged_prefill_write").paged_prefill_write_launch
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def reset_launches() -> None:
    global launches
    launches = 0


def paged_prefill_write(k_new: torch.Tensor, v_new: torch.Tensor,
                        positions: torch.Tensor, block_table: torch.Tensor,
                        k_pages: torch.Tensor, v_pages: torch.Tensor) -> None:
    """Write k/v_new (B,T,Hkv,D) into k/v_pages (P,pg,Hkv,D) in place:
    token (b,t) with ``positions[b,t] >= 0`` lands in page
    ``block_table[b, pos // pg]`` at offset ``pos % pg``; pads are
    skipped.  positions (B,T) and block_table (B,nb) are int32.  Every
    tensor must be contiguous and on one CUDA device."""
    global launches
    tensors = (k_new, v_new, positions, block_table, k_pages, v_pages)
    dev = k_new.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("paged_prefill_write kernel: every tensor must be "
                         "on one CUDA device")
    if k_new.dtype not in (torch.float32, torch.bfloat16) or any(
            t.dtype != k_new.dtype for t in (v_new, k_pages, v_pages)):
        raise TypeError(f"paged_prefill_write kernel: K/V and pools must "
                        f"share float32 or bfloat16, got {k_new.dtype}, "
                        f"{v_new.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if positions.dtype != torch.int32 or block_table.dtype != torch.int32:
        raise TypeError("paged_prefill_write kernel: positions and "
                        "block_table must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_prefill_write kernel: tensors must be "
                         "contiguous")
    B, T, Hkv, D = k_new.shape
    P, pg = k_pages.shape[0], k_pages.shape[1]
    if (v_new.shape != k_new.shape or positions.shape != (B, T)
            or block_table.dim() != 2 or block_table.shape[0] != B
            or k_pages.shape != (P, pg, Hkv, D)
            or v_pages.shape != k_pages.shape):
        raise ValueError(f"paged_prefill_write kernel: shapes k/v_new "
                         f"{tuple(k_new.shape)}/{tuple(v_new.shape)}, "
                         f"positions {tuple(positions.shape)}, block_table "
                         f"{tuple(block_table.shape)}, pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    row_bytes = Hkv * D * k_new.element_size()
    if row_bytes % 16:
        raise ValueError(f"paged_prefill_write kernel: a token row of "
                         f"{row_bytes} bytes is not a multiple of 16")
    if any(t.data_ptr() % 16 for t in (k_new, v_new, k_pages, v_pages)):
        raise ValueError("paged_prefill_write kernel: K/V and the page "
                         "pools must be 16-byte aligned")
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(k_new.data_ptr(), v_new.data_ptr(), positions.data_ptr(),
                 block_table.data_ptr(), k_pages.data_ptr(),
                 v_pages.data_ptr(), B, T, block_table.shape[1], pg,
                 row_bytes, stream)
        if build.counted("paged_prefill_write"):
            with build.LOCK:
                launches += 1
    if err:
        raise RuntimeError(f"paged_prefill_write kernel launch failed: "
                           f"CUDA error {err}")
