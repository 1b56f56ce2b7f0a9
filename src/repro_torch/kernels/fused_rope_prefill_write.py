"""Fused RoPE + prefill K/V page-pool scatter — the CUDA kernel's Python
wrapper.

Port of the Pallas kernel ``repro.kernels.fused_rope_prefill_write`` with
the semantics of its oracle
(``repro.kernels.ref.fused_rope_prefill_write_ref``): each real token's K
is rotated at its own position and lands, with its unrotated V, in the
slot that position names, so the kernel is exact for any first position
of a row (a shared-prefix tail need not start on a page boundary).
Source: ``csrc/fused_rope_prefill_write.cu``.  The plain version is
``kernels.ref.fused_rope_prefill_write_ref``; ``kernels.ops`` dispatches
between the two by device.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.models.common import rope_freqs

#: launches of the CUDA kernel since the last reset
launches = 0

_fn = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_inv_freq: Dict[Tuple[int, float, torch.device], torch.Tensor] = {}


def inv_freq(head_dim: int, theta: float,
             device: torch.device) -> torch.Tensor:
    """RoPE inverse frequencies (D/2,) float32 on ``device``, computed once
    per (D, theta, device) by ``models.common.rope_freqs``, the expression
    the unfused path uses, so fused and unfused K agree bit for bit."""
    key = (head_dim, float(theta), device)
    t = _inv_freq.get(key)
    if t is None:
        t = rope_freqs(head_dim, float(theta), device).contiguous()
        _inv_freq[key] = t
    return t


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load(
            "fused_rope_prefill_write").fused_rope_prefill_write_launch
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def reset_launches() -> None:
    global launches
    launches = 0


def fused_rope_prefill_write(k_new: torch.Tensor, v_new: torch.Tensor,
                             positions: torch.Tensor,
                             block_table: torch.Tensor,
                             k_pages: torch.Tensor, v_pages: torch.Tensor,
                             theta: float = 10000.0) -> None:
    """Rotate k_new (B,T,Hkv,D) at ``positions`` and write it, with v_new
    unrotated, into k/v_pages (P,pg,Hkv,D) in place: token (b,t) with
    ``positions[b,t] >= 0`` lands in page ``block_table[b, pos // pg]`` at
    offset ``pos % pg``; pads are skipped.  positions (B,T) and
    block_table (B,nb) are int32.  Every tensor must be contiguous and on
    one CUDA device."""
    global launches
    tensors = (k_new, v_new, positions, block_table, k_pages, v_pages)
    dev = k_new.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("fused_rope_prefill_write kernel: every tensor "
                         "must be on one CUDA device")
    if k_new.dtype not in _DTYPES or any(
            t.dtype != k_new.dtype for t in (v_new, k_pages, v_pages)):
        raise TypeError(f"fused_rope_prefill_write kernel: K/V and pools "
                        f"must share float32 or bfloat16, got "
                        f"{k_new.dtype}, {v_new.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if positions.dtype != torch.int32 or block_table.dtype != torch.int32:
        raise TypeError("fused_rope_prefill_write kernel: positions and "
                        "block_table must be int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_rope_prefill_write kernel: tensors must be "
                         "contiguous")
    B, T, Hkv, D = k_new.shape
    P, pg = k_pages.shape[0], k_pages.shape[1]
    if (v_new.shape != k_new.shape or positions.shape != (B, T)
            or block_table.dim() != 2 or block_table.shape[0] != B
            or block_table.shape[1] < 1
            or k_pages.shape != (P, pg, Hkv, D)
            or v_pages.shape != k_pages.shape):
        raise ValueError(f"fused_rope_prefill_write kernel: shapes k/v_new "
                         f"{tuple(k_new.shape)}/{tuple(v_new.shape)}, "
                         f"positions {tuple(positions.shape)}, block_table "
                         f"{tuple(block_table.shape)}, pools "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}")
    if (D // 2) * k_new.element_size() % 16:
        raise ValueError(f"fused_rope_prefill_write kernel: half a head of "
                         f"{D // 2} values of {k_new.dtype} is not a "
                         f"multiple of 16 bytes")
    if any(t.data_ptr() % 16 for t in (k_new, v_new, k_pages, v_pages)):
        raise ValueError("fused_rope_prefill_write kernel: K/V and the page "
                         "pools must be 16-byte aligned")
    freqs = inv_freq(D, theta, dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[k_new.dtype], k_new.data_ptr(), v_new.data_ptr(),
                 positions.data_ptr(), block_table.data_ptr(),
                 freqs.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                 B, T, block_table.shape[1], pg, Hkv, D, stream)
        if build.counted("fused_rope_prefill_write"):
            with build.LOCK:
                launches += 1
    if err:
        raise RuntimeError(f"fused_rope_prefill_write kernel launch failed: "
                           f"CUDA error {err}")
