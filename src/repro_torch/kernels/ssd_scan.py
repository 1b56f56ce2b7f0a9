"""Mamba-2 SSD chunked scan — the CUDA kernel's Python wrapper.

Port of the Pallas kernel ``repro.kernels.ssd_scan``.  Source:
``csrc/ssd_scan.cu``.  The plain version is ``kernels.ref.ssd_scan_ref``;
``kernels.ops`` dispatches between the two by device.

One call launches four passes on the current stream, each a kernel, the
last three as programmatic dependents of the one before:

1. ``cb``: C·Bᵀ once per (row, chunk, group), 64 × 64 tiles of the lower
   triangle, into a float32 scratch (B, nc, G, Q, Q);
2. ``state``: per (row, chunk, head) the cumulative sum of dt·A by warp
   scans and the chunk's local state Σ_s e^{cum_last − cum_s} dt_s x_s ⊗
   B_s, into scratches cum (B, nc, H, Q), e^{cum_last} (B, nc, H) and S
   (B, nc, H, P, N);
3. ``pass``: per (row, head) the only serial part, the state entering each
   chunk, written over S, and the final state;
4. ``output``: per (row, chunk, head) and 128-token tile, y = e^{cum_t}
   C_t·S_in + Σ_{s≤t} CB[t, s] e^{cum_t − cum_s} dt_s x_s, the mask applied
   before anything reaches y.

Every product runs on the tensor cores as 3xTF32 (each operand split into
TF32 hi + lo, three products in float32), which keeps float32's accuracy;
no exponent is positive (ROADMAP C2).  :func:`plan` states the host side:
scratch shapes, grids, shared memory per pass and what the kernel refuses.
The scratch comes from ``torch.empty`` and the kernels do not synchronise,
so a call can be captured in a CUDA graph.  One call counts one launch.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

#: launches of the CUDA kernel since the last reset
launches = 0

#: ``csrc/ssd_scan.cu``'s tiles: depth of a staged tile, ring slots, pass
#: 1's CB tile, pass 2's (P, N) tile and warps a block, pass 3's threads
#: (4 entries each), pass 4's (tokens, P) tile
BK, STAGES = 32, 3
CB_TILE = 64
STATE_TILE, STATE_WARPS = (64, 128), 8
PASS_THREADS = 256
OUT_TILE = (128, 64)
#: shared memory a block may have on Hopper; the grid's y extent
MAX_SMEM = 232448
MAX_GRID_Y = 65535
#: the passes, in launch order
PASSES = ("cb", "state", "pass", "output")

_fn = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _round_up(a: int, b: int) -> int:
    return _cdiv(a, b) * b


def smem_bytes(Q: int) -> Dict[str, int]:
    """Dynamic shared memory of each pass's block at chunk ``Q``: the ring
    of staged operand tiles (rows padded by 4 or 8 floats so that fragment
    loads hit every bank once), plus pass 2's dt/weights, cum and warp
    sums and pass 4's cum and dt."""
    sk = BK + 4
    ring = {"cb": 2 * CB_TILE * sk,
            "state": BK * (STATE_TILE[0] + 8) + BK * (STATE_TILE[1] + 8),
            "output": OUT_TILE[0] * sk + OUT_TILE[1] * sk}
    return {"cb": 4 * STAGES * ring["cb"],
            "state": 4 * (STAGES * ring["state"] + 2 * _round_up(Q, BK)
                          + STATE_WARPS),
            "pass": 0,
            "output": 4 * (STAGES * ring["output"]
                           + 2 * _round_up(Q, OUT_TILE[0]))}


def plan(B: int, T: int, H: int, P: int, N: int, G: int, Q: int) -> dict:
    """The host side of one call for x (B,T,H,P), B/C (B,T,G,N) and chunk
    ``Q``: ``nc`` chunks a row, the float32 ``scratch`` shapes, each pass's
    ``grid`` (x, y) and ``smem`` bytes.  Raises ValueError
    for a shape the kernel does not take: T no multiple of Q, H of G, Q,
    P or N no multiple of 4, a block beyond ``MAX_SMEM`` or a grid beyond
    ``MAX_GRID_Y``."""
    if Q < 4 or T % Q or G < 1 or H % G:
        raise ValueError(f"ssd_scan kernel: T {T} must be a multiple of the "
                         f"chunk {Q} and H {H} of G {G}")
    if Q % 4 or P % 4 or N % 4:
        raise ValueError(f"ssd_scan kernel: chunk {Q}, P {P} and N {N} "
                         f"must be multiples of 4")
    nc = T // Q
    nt = _cdiv(Q, CB_TILE)
    grids = {"cb": (B * nc * G, nt * (nt + 1) // 2),
             "state": (B * nc * H,
                       _cdiv(P, STATE_TILE[0]) * _cdiv(N, STATE_TILE[1])),
             "pass": (B * H, _cdiv(P * N, 4 * PASS_THREADS)),
             "output": (B * nc * H,
                        _cdiv(Q, OUT_TILE[0]) * _cdiv(P, OUT_TILE[1]))}
    smem = smem_bytes(Q)
    if max(smem.values()) > MAX_SMEM:
        raise ValueError(f"ssd_scan kernel: chunk {Q} needs {smem} bytes of "
                         f"shared memory, beyond {MAX_SMEM} a block")
    if max(g[1] for g in grids.values()) > MAX_GRID_Y:
        raise ValueError(f"ssd_scan kernel: grids {grids} pass "
                         f"{MAX_GRID_Y} blocks in y")
    scratch = {"cb": (B, nc, G, Q, Q), "state": (B, nc, H, P, N),
               "cum": (B, nc, H, Q), "decay": (B, nc, H)}
    return dict(nc=nc, scratch=scratch, grids=grids, smem=smem)


def _launcher():
    global _fn
    if _fn is None:
        fn = build.load("ssd_scan").ssd_scan_launch
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def kernel_smem_bytes(Q: int) -> Dict[str, int]:
    """Each pass's shared memory as the built kernel reckons it (for
    holding :func:`smem_bytes` to it on the card)."""
    fn = build.load("ssd_scan").ssd_scan_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return {name: int(fn(i + 1, Q)) for i, name in enumerate(PASSES)}


def reset_launches() -> None:
    global launches
    launches = 0


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor,
             chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,T,H,P); dt (B,T,H); A (H,); B/C (B,T,G,N), read per group (no
    broadcast to the heads is made).  Returns (y (B,T,H,P), final state
    (B,H,P,N)), float32.  Every tensor must be float32, contiguous and on
    one CUDA device, x, B and C 16-byte aligned; the shapes must be ones
    :func:`plan` takes."""
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
    pl = plan(Bsz, T, H, P, N, G, chunk)
    if any(t.data_ptr() % 16 for t in (x, B, C)):
        raise ValueError("ssd_scan kernel: x, B and C must be 16-byte "
                         "aligned (the passes stage them by cp.async)")
    y = torch.empty_like(x)
    if x.numel() == 0:  # nothing to launch: no token, row, head or channel
        return y, torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=dev)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    scratch = {k: torch.empty(shape, dtype=torch.float32, device=dev)
               for k, shape in pl["scratch"].items()}
    fn = _launcher()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), state.data_ptr(),
                 scratch["cb"].data_ptr(), scratch["state"].data_ptr(),
                 scratch["cum"].data_ptr(), scratch["decay"].data_ptr(),
                 Bsz, T, H, P, N, G, chunk, stream)
        if build.counted("ssd_scan"):
            with build.LOCK:
                launches += 1
    if err:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err} "
                           f"(plan {pl['grids']}, shared memory "
                           f"{pl['smem']})")
    return y, state
