"""Causal, left-pad-masked GQA prefill attention, with an optional
bidirectional prefix — the CUDA kernel's Python wrapper.

Port of the Pallas kernel ``repro.kernels.flash_prefill``.  Source:
``csrc/flash_prefill.cu``.  ``prefix_len`` adds the JAX package's
prefix-LM term (keys at positions below it are seen by every valid
query): a VLM's image prefix, or a whole encoder (``prefix_len = T``).
Any head dim that is a multiple of 16 up to 256 runs on the smallest
compiled instance at or above it, and a group larger than a block holds
as head blocks (``split.supports``).  The plain version is
``kernels.ref.flash_prefill_ref``; ``kernels.ops`` dispatches between the
two by device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.split import DOMAIN, supports

#: launches of the CUDA kernel since the last reset
launches = 0
#: those of them with a bidirectional prefix (``prefix_len > 0``)
prefix_launches = 0

#: head dims the kernel is compiled for (template instances in the
#: source); it takes every head dim of ``supports`` on the smallest at or
#: above it, and a group above 64 query heads a KV head (above 8192 / D
#: in float32) as blocks of at most that many
HEAD_DIMS = (32, 64, 128, 256)

_fn = None
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("flash_prefill").flash_prefill_launch
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def reset_launches() -> None:
    global launches, prefix_launches
    launches = prefix_launches = 0


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  positions: torch.Tensor, window: Optional[int] = None,
                  prefix_len: int = 0) -> torch.Tensor:
    """q (B,T,Hq,D); k/v (B,T,Hkv,D); positions (B,T) int32, pads < 0;
    ``prefix_len`` >= 0 (0: causal).  Returns (B,T,Hq,D) in q's type.
    Every tensor must be contiguous and on one CUDA device."""
    global launches, prefix_launches
    tensors = (q, k, v, positions)
    dev = q.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("flash_prefill kernel: every tensor must be on one "
                         "CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_prefill kernel: q, k and v must share "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if positions.dtype != torch.int32:
        raise TypeError("flash_prefill kernel: positions must be int32")
    if prefix_len < 0:
        raise ValueError(f"flash_prefill kernel: prefix_len {prefix_len} "
                         f"< 0")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_prefill kernel: tensors must be contiguous")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_prefill kernel: q {tuple(q.shape)} must be "
                         f"(B,T,Hq,D) and k {tuple(k.shape)} (B,T,Hkv,D)")
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    if (k.shape != (B, T, Hkv, D) or v.shape != k.shape or Hq % Hkv
            or positions.shape != (B, T)):
        raise ValueError(f"flash_prefill kernel: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}, positions "
                         f"{tuple(positions.shape)}")
    if not supports(D, Hq // Hkv, q.dtype):
        raise ValueError(f"flash_prefill kernel: head_dim {D} with "
                         f"{Hq // Hkv} query heads per KV head; the kernel "
                         f"takes {DOMAIN}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_prefill kernel: q, k and v must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(_DTYPES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 positions.data_ptr(), out.data_ptr(), B, T, Hq, Hkv, D,
                 window or 0, prefix_len, D ** -0.5, stream)
        if build.counted("flash_prefill"):
            with build.LOCK:
                launches += 1
                prefix_launches += prefix_len > 0
    if err:
        raise RuntimeError(f"flash_prefill kernel launch failed: CUDA error "
                           f"{err}")
    return out
