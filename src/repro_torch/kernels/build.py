"""Build the port's CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into its own shared library for ``sm_90a``; no PyTorch header is
included, so a build takes seconds.  Libraries go to
``build/repro_torch_kernels/`` at the repository root, named by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header is rebuilt and an unchanged one is reused.  ``build_all`` starts one ``nvcc`` per source, all at once.
A failed build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("paged_prefill_write", "paged_decode_attention",
           "fused_rope_prefill_write", "fused_rope_decode_append",
           "flash_prefill", "decode_attention", "ssd_scan", "graph_loop")

_loaded: Dict[str, ctypes.CDLL] = {}

#: guards ``load`` and every wrapper's ``launches += 1``: engines whose
#: event loops run on threads of one process (several serving instances)
#: share the libraries and the launch counts, and a count must lose no
#: increment
LOCK = threading.RLock()

_capture = threading.local()


def counted(name: str) -> bool:
    """Whether a wrapper's launch of kernel ``name`` counts now.  While
    this thread captures a CUDA graph (``capturing``) the launch is only
    recorded into the graph, not made: the capture's tally keeps it, and
    each replay of the graph adds it to the count
    (``repro_torch.engine.graphs``), so that a count is always the
    launches the card ran."""
    tally = getattr(_capture, "tally", None)
    if tally is None:
        return True
    tally[name] = tally.get(name, 0) + 1
    return False


@contextlib.contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """Inside ``with``, this thread's kernel launches go to the yielded
    tally (kernel name -> launches) and not to the wrappers' counts."""
    tally: Dict[str, int] = {}
    _capture.tally = tally
    try:
        yield tally
    finally:
        _capture.tally = None


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _command(name: str, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Sequence[str] = KERNELS) -> Dict[str, str]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together; raises if any build fails.  Returns
    each compiled kernel's ``nvcc`` output (``ptxas`` registers, shared
    memory and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    errors, logs = [], {}
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with LOCK:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib
