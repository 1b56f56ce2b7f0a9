"""Mamba-2 SSD chunked scan — the CUDA kernel's Python wrapper.

Port of the Pallas kernel ``repro.kernels.ssd_scan``.  Source:
``csrc/ssd_scan.cu``.  The plain version is ``kernels.ref.ssd_scan_ref``;
``kernels.ops`` dispatches between the two by device.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import build

#: launches of the CUDA kernel since the last reset
launches = 0

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("ssd_scan").ssd_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def reset_launches() -> None:
    global launches
    launches = 0


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P); dt (B,T,H); A (H,); B/C (B,T,G,N), read per group (no
    broadcast to the heads is made).  Returns (y (B,T,H,P), final state
    (B,H,P,N)), float32.  Every tensor must be float32, contiguous and on
    one CUDA device; T must be a multiple of ``chunk``, H of G, and
    ``chunk``, P and N of 4."""
    global launches
    tensors = (x, dt, A, B, C)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"ssd_scan kernel: x, dt, A, B and C must be "
                        f"float32, got {[t.dtype for t in tensors]}")
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("ssd_scan kernel: every tensor must be on one CUDA "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan kernel: tensors must be contiguous")
    if x.dim() != 4 or B.dim() != 4:
        raise ValueError(f"ssd_scan kernel: x {tuple(x.shape)} must be "
                         f"(B,T,H,P) and B {tuple(B.shape)} (B,T,G,N)")
    Bsz, T, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if (dt.shape != (Bsz, T, H) or A.shape != (H,)
            or B.shape != (Bsz, T, G, N) or C.shape != B.shape):
        raise ValueError(f"ssd_scan kernel: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if chunk < 4 or T % chunk or H % G:
        raise ValueError(f"ssd_scan kernel: T {T} must be a multiple of the "
                         f"chunk {chunk} and H {H} of G {G}")
    if chunk % 4 or P % 4 or N % 4:
        raise ValueError(f"ssd_scan kernel: chunk {chunk}, P {P} and N {N} "
                         f"must be multiples of 4")
    y = torch.empty_like(x)
    if x.numel() == 0:  # nothing to launch: no token, row, head or channel
        return y, torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), state.data_ptr(), Bsz, T, H, P,
                 N, G, chunk, stream)
        launches += 1
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"(chunk {chunk}, P {P}, N {N} may need more "
                           f"shared memory than a block has)")
    return y, state
