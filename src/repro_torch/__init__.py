"""repro_torch — the SCLS serving system on PyTorch with hand-written
CUDA kernels for Hopper (sm_90a).

The package mirrors ``repro``'s layout (``configs``, ``models``,
``kvcache``, ``kernels``, ``engine``, ``core``, ``cluster``, ``serving``,
``launch``) so every module has a counterpart of the same name.  It
imports ``torch`` and numpy only: the JAX package is its reference in the
tests, never a dependency.

Entry points take an explicit ``device``.  Left unset it is ``cuda``; a
missing card is an error, never a silent fall-back to the CPU.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA
    card and raises when there is none (pass ``device="cpu"`` to run on
    the CPU).  A CUDA device always carries its index, as the tensors
    placed on it report theirs."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the port on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is "
                               f"unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
