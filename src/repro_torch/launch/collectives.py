"""Collective traffic of a step on a ``DeviceMesh`` (counterpart of
``repro.launch.hlo_analysis``).

The reference compiles its step and parses the post-SPMD HLO text for
all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute ops, summing each one's per-device output bytes.
PyTorch has no HLO: a DTensor step desugars into the functional
collectives (``torch.ops._c10d_functional``) as it runs, so
``CollectiveRecorder``, a ``TorchDispatchMode``, records them there --
each with the bytes of its output on this rank (the per-device shape,
what per-card link traffic needs) -- together with the name of every
other aten op that ran on the local shards (``count_op``).

The mode lets DTensor's own dispatch run first (it answers
``NotImplemented`` to an op on DTensors), so that it sees the
collectives DTensor issues to redistribute, and the local ops they
surround, rather than the DTensor op itself.  It books nothing while
DTensor's sharding propagation runs an op on global-shape stand-ins to
learn its output's shape (``ShardingPropagator._propagate_tensor_meta_
non_cached``, wrapped while a recorder is active): that op is no work of
the step.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from collections import Counter
from typing import Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: aten-level collective -> the reference's name of its HLO op
_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "broadcast": "all-gather",  # one contributor's tensor on every rank
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
_NAMESPACES = ("_c10d_functional", "c10d_functional",
               "_c10d_functional_autograd", "c10d")


def collective_kind(func) -> str:
    """The reference's name of the collective ``func`` is, or ""."""
    packet = getattr(func, "_overloadpacket", None)
    if packet is None or func.namespace not in _NAMESPACES:
        return ""
    return _KIND.get(packet.__name__, "")


def tensor_bytes(out) -> int:
    """Bytes of every tensor in ``out`` (a tensor or a nest of them)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(out)
               if isinstance(t, torch.Tensor))


_STATE = threading.local()


def _in_propagation() -> bool:
    return getattr(_STATE, "depth", 0) > 0


@contextlib.contextmanager
def _shape_propagation_marked():
    """Mark DTensor's shape-only runs of an op while the block runs."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = ShardingPropagator.__dict__.get(name)
    if orig is None:  # another PyTorch: nothing to mark
        yield False
        return

    @functools.wraps(orig)
    def marked(*args, **kwargs):
        _STATE.depth = getattr(_STATE, "depth", 0) + 1
        try:
            return orig(*args, **kwargs)
        finally:
            _STATE.depth -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        yield True
    finally:
        setattr(ShardingPropagator, name, orig)


class CollectiveRecorder(TorchDispatchMode):
    """Record, while active, each collective (kind, per-device output
    bytes) and the name of every aten op run on local tensors."""

    def __init__(self) -> None:
        super().__init__()
        self.records: List[Tuple[str, int]] = []
        self.ops: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor desugar it first
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _in_propagation():
            self.observe(func, args, kwargs, out)
        return out

    def __enter__(self):
        self._marks = _shape_propagation_marked()
        #: whether DTensor's shape-only runs are left out (False on a
        #: PyTorch without the propagator method this wraps)
        self.propagation_excluded = self._marks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._marks.__exit__(*exc)

    def observe(self, func, args, kwargs, out) -> None:
        """Book one local op (subclasses add their own accounts)."""
        packet = getattr(func, "_overloadpacket", None)
        if packet is not None:
            self.ops[packet.__name__] += 1
        kind = collective_kind(func)
        if kind:
            self.records.append((kind, tensor_bytes(out)))

    def collectives(self) -> Dict[str, Tuple[int, int]]:
        """{kind: (count, total per-device output bytes)}, kinds that
        occurred only (``parse_collectives``' result)."""
        return summarise(self.records)


def summarise(records) -> Dict[str, Tuple[int, int]]:
    """(kind, bytes) records -> {kind: (count, total bytes)}."""
    out: Dict[str, Tuple[int, int]] = {k: (0, 0) for k in COLLECTIVES}
    for kind, b in records:
        c, t = out[kind]
        out[kind] = (c + 1, t + b)
    return {k: v for k, v in out.items() if v[0] > 0}


def total_collective_bytes(collectives: Dict[str, Tuple[int, int]]) -> int:
    return sum(b for _, b in collectives.values())


def count_op(recorder: CollectiveRecorder, opname: str) -> int:
    """Times the aten op ``opname`` (e.g. "mm", "all_reduce") ran."""
    return recorder.ops.get(opname, 0)
