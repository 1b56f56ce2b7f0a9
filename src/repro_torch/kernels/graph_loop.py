"""A decode slice's loop on the device — the host side of
``csrc/graph_loop.cu``.

No Pallas kernel's port: the counterpart of the JAX engines'
``lax.while_loop`` over a slice's decode steps, whose ``cond`` is ``(step <
slice_len) & ~all(done)``.  ``build_loop`` rewrites the raw graph of a
``torch.cuda.CUDAGraph`` captured with ``keep_graph=True`` (one decode
step) into a condition-kernel node and a WHILE conditional node whose body
is the step followed by the condition kernel, optionally after a ``head``
graph run once (a captured prefill); the caller then instantiates it, and
one replay runs the whole loop.  ``graph_loop`` launches the condition's
predicate alone and returns it, for holding the kernel against its plain
version ``kernels.ref.graph_loop_ref``; ``kernels.ops`` dispatches between
the two by device.  The condition kernel's launches inside a replay are
counted by the replay (``engine.graphs.Loop``): one before the loop and one
after each step.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

#: launches of the CUDA kernel since the last reset
launches = 0

_eval = None
_build = None


def _lib():
    global _eval, _build
    if _eval is None:
        lib = build.load("graph_loop")
        fn = lib.graph_loop_eval
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        b = lib.graph_loop_build
        b.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
        b.restype = ctypes.c_int
        _eval, _build = fn, b
    return _eval, _build


def reset_launches() -> None:
    global launches
    launches = 0


def _check(step: torch.Tensor, done: torch.Tensor) -> None:
    dev = step.device
    if dev.type != "cuda" or done.device != dev:
        raise ValueError("graph_loop kernel: step and done must be on one "
                         "CUDA device")
    if step.dtype != torch.int64 or step.dim() != 0:
        raise TypeError(f"graph_loop kernel: step must be a 0-d int64 "
                        f"tensor, got {step.dtype} {tuple(step.shape)}")
    if done.dtype != torch.bool or done.dim() != 1 or done.numel() < 1 \
            or not done.is_contiguous():
        raise TypeError(f"graph_loop kernel: done must be a contiguous "
                        f"(B,) bool tensor, B >= 1, got {done.dtype} "
                        f"{tuple(done.shape)}")


def graph_loop(step: torch.Tensor, done: torch.Tensor,
               limit: int) -> torch.Tensor:
    """The loop's condition ``step < limit and not all(done)`` for a 0-d
    int64 ``step`` and (B,) bool ``done`` on one CUDA device, as a 0-d
    bool tensor on that device (no host read)."""
    global launches
    _check(step, done)
    dev = step.device
    out = torch.empty((), dtype=torch.int32, device=dev)
    fn, _ = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(step.data_ptr(), done.data_ptr(), done.numel(), int(limit),
                 out.data_ptr(), stream)
        if build.counted("graph_loop"):
            with build.LOCK:
                launches += 1
    if err:
        raise RuntimeError(f"graph_loop kernel launch failed: CUDA error "
                           f"{err}")
    return out.bool()


def build_loop(graph: torch.cuda.CUDAGraph, step: torch.Tensor,
               done: torch.Tensor, limit: int,
               head: Optional[torch.cuda.CUDAGraph] = None) -> None:
    """Rewrite ``graph`` (captured with ``keep_graph=True``: one loop
    body, which advances ``step`` and sets ``done``) into ``[head] -> cond
    -> WHILE { body -> cond }`` and instantiate it, so that one
    ``graph.replay()`` runs the body while ``step < limit and not
    all(done)``.  ``head`` (also kept) runs once first.  Raises on any
    CUDA error; the graph is then unusable."""
    _check(step, done)
    _, fn = _lib()
    head_ptr = head.raw_cuda_graph() if head is not None else None
    with torch.cuda.device(step.device):
        err = fn(graph.raw_cuda_graph(), head_ptr, step.data_ptr(),
                 done.data_ptr(), done.numel(), int(limit))
    if err:
        raise RuntimeError(f"graph_loop: building the WHILE graph failed: "
                           f"CUDA error {err}")
    graph.instantiate()
