"""Captured decode steps, one per bucket: the port's counterpart of the JAX
engines' compiled executables (``repro.engine.static_engine``'s
``_compiled`` cache of jitted serve functions, one per slice length and
traced anew per input shape, and ``repro.engine.continuous_engine``'s
jitted decode).

A ``Step`` is one decode iteration written as a closure over *static*
tensors (``Step.bufs``): every input the iteration reads and every
output it writes lives in a buffer that the engine fills with ``copy_``
before its loop and reads after it, the step counter and a dense cache's
ring index are 0-d device tensors that the iteration advances, and every
new cache leaf the model returns is copied back into its buffer inside
the iteration, so that the next call reads it.

On a CUDA device the first call of a bucket runs the closure on a side
stream, eagerly (the warm-up: it is that call's real step, so the
kernels' first-use build, cuBLAS's handles and the allocator's blocks
never land inside a capture), then captures it into a
``torch.cuda.CUDAGraph``; every later call replays the graph.  A capture
that fails raises: nothing retries eagerly.  All graphs of one
``GraphCache`` share one memory pool, which is safe because an engine
replays one graph at a time and each iteration leaves its results in the
static buffers, outside the pool.  On a CPU device the same closure runs
on the same buffers, uncaptured, so the CPU tests exercise the code the
card replays.

The engines keep their eager loops (a decode step op by op over per-step
tensors and a Python step counter) for three cases, named by
``eager_reason``: inside ``disabled()``, the counterpart of
``jax.disable_jit()``, which ``chip_smoke.py`` and the tests use to hold
the two against each other; parameters that are DTensors (sharded
serving: the JAX engines take no mesh, and capturing collectives is not
ported); and a family of ``EAGER_FAMILIES`` (none: every family's decode
step is captured).
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Hashable, Iterator, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import build
from repro_torch.kernels import ops as kernel_ops

#: families whose engines decode eagerly on every device (none)
EAGER_FAMILIES: frozenset = frozenset()

#: this thread's depth of ``disabled()``
_local = threading.local()
#: one capture at a time in the process (engines on several threads)
_CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def disabled() -> Iterator[None]:
    """Inside ``with``, the engines that this thread drives run their eager
    loops (the counterpart of ``jax.disable_jit()``): for comparing the
    two, never for serving."""
    _local.depth = getattr(_local, "depth", 0) + 1
    try:
        yield
    finally:
        _local.depth -= 1


def eager_reason(params: torch.nn.Module, family: str) -> Optional[str]:
    """Why an engine over ``params`` of ``family`` runs its eager loop now,
    or None: it runs its ``Step`` (captured on a CUDA device)."""
    if getattr(_local, "depth", 0):
        return "graphs.disabled()"
    if isinstance(params.embed.table, DTensor):
        return "DTensor parameters (sharded serving is not captured)"
    if family in EAGER_FAMILIES:
        return f"family {family!r} is in EAGER_FAMILIES"
    return None


@contextlib.contextmanager
def _no_gc() -> Iterator[None]:
    """Python's cyclic collector held off: an engine and its steps form
    cycles (a step's closure holds its engine), and a dead engine's graph
    destroyed by a collection that runs inside another capture
    invalidates that capture."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class Step:
    """One bucket's decode iteration: ``fn()`` over the static tensors
    ``bufs`` (name -> tensor, or a tree of tensors for a cache).  Call it
    once per iteration."""

    def __init__(self, cache: "GraphCache", fn: Callable[[], None],
                 bufs: Dict[str, object]):
        self._cache, self.fn, self.bufs = cache, fn, bufs
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: kernel launches one replay makes (the capture's tally)
        self.launches: Dict[str, int] = {}

    def __call__(self) -> None:
        if not self._cache.capture:
            self.fn()
        elif self.graph is None:
            self._capture()
        else:
            self.graph.replay()
            kernel_ops.add_launches(self.launches)

    def _capture(self) -> None:
        owner = self._cache
        main = torch.cuda.current_stream(owner.device)
        side = owner.side_stream()
        side.wait_stream(main)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            self.fn()  # the warm-up is this call's step
            graph = torch.cuda.CUDAGraph()
            with _CAPTURE_LOCK, _no_gc(), build.capturing() as tally:
                graph.capture_begin(pool=owner.pool(),
                                    capture_error_mode="thread_local")
                try:
                    self.fn()
                except BaseException:
                    with contextlib.suppress(Exception):
                        graph.capture_end()  # leave the stream usable
                    raise
                graph.capture_end()
        main.wait_stream(side)
        self.graph, self.launches = graph, dict(tally)
        owner.n_captures += 1
        owner.capture_seconds += time.perf_counter() - t0


class GraphCache:
    """bucket key -> ``Step``, for one engine on ``device`` (the JAX
    engine's ``_compiled``).  ``capture`` is whether steps are captured:
    on a CUDA device, not on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.capture = device.type == "cuda"
        self._steps: Dict[Hashable, Step] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        #: graphs captured and the wall seconds spent capturing them, warm-up
        #: steps included
        self.n_captures = 0
        self.capture_seconds = 0.0

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def get(self, key: Hashable) -> Optional[Step]:
        return self._steps.get(key)

    def add(self, key: Hashable, fn: Callable[[], None],
            bufs: Dict[str, object]) -> Step:
        step = self._steps[key] = Step(self, fn, bufs)
        return step

    def keys(self) -> List[Hashable]:
        return list(self._steps)

    def clear(self) -> None:
        """Drop every step (and its graph) and the memory pool: once its
        last graph is gone the allocator frees the pool and takes its id
        no more, so the next capture opens a new one."""
        self._steps.clear()
        self._pool = None

    def pool_bytes(self) -> Optional[int]:
        """Bytes the caching allocator holds in this cache's graph pool
        (its segments' sizes), or None without a pool or where the
        allocator's snapshot does not name a segment's pool."""
        if self._pool is None:
            return None
        want = tuple(self._pool)
        total, named = 0, False
        for seg in torch.cuda.memory_snapshot():
            pool = seg.get("segment_pool_id")
            if pool is None:
                continue
            named = True
            if tuple(pool) == want:
                total += seg["total_size"]
        return total if named else None


# ---------------------------------------------------------------------------
# static buffers
# ---------------------------------------------------------------------------
def _leaves(tree) -> List[object]:
    """The leaves of a cache: tensors and ints of nested tuples (a
    NamedTuple cache, a ``MoECache`` or ``EncDecCache`` of caches), None
    nodes left out."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _rebuild(tree, leaves: Iterator[object]):
    if tree is None:
        return None
    if isinstance(tree, tuple):
        parts = [_rebuild(t, leaves) for t in tree]
        return type(tree)(*parts) if hasattr(tree, "_fields") \
            else type(tree)(parts)
    return next(leaves)


#: byte alignment of every leaf in an ``Arena``
_ALIGN = 256


class Arena:
    """One byte buffer that holds a dense engine's static cache.  Each
    bucket's cache leaves are views at fixed offsets from its base (an int
    leaf, a ring index, becomes a 0-d int64 view), so a graph captured over
    them stays valid while the buffer does; the buffer is sized by the
    largest bucket served so far.  Memory stays at one cache, not one a
    bucket."""

    def __init__(self, device: torch.device):
        self.device = device
        self._buf: Optional[torch.Tensor] = None

    @property
    def nbytes(self) -> int:
        return 0 if self._buf is None else self._buf.numel()

    @staticmethod
    def _layout(cache) -> Tuple[list, int]:
        """(offset, bytes, shape, dtype) of each leaf, and the bytes of
        all."""
        spans, off = [], 0
        for leaf in _leaves(cache):
            if isinstance(leaf, torch.Tensor):
                shape, dtype = tuple(leaf.shape), leaf.dtype
            else:
                shape, dtype = (), torch.int64
            n = torch.Size(shape).numel() * torch.empty(
                (), dtype=dtype).element_size()
            spans.append((off, n, shape, dtype))
            off += -(-n // _ALIGN) * _ALIGN
        return spans, off

    def fits(self, cache) -> bool:
        """Whether ``cache``'s leaves fit the buffer as it is."""
        return self._layout(cache)[1] <= self.nbytes

    def views(self, cache):
        """``cache``'s tree with every leaf a view of the arena, which
        grows first where it must: the caller drops every step captured
        over the old buffer before (``fits``)."""
        spans, size = self._layout(cache)
        if size > self.nbytes:
            self._buf = None
            self._buf = torch.empty(size, dtype=torch.uint8,
                                    device=self.device)
        views = iter([self._buf[o:o + n].view(dtype).view(shape)
                      for o, n, shape, dtype in spans])
        return _rebuild(cache, views)


def fill(static, cache) -> None:
    """Copy ``cache``'s leaves into ``static``'s (an ``Arena.views``
    tree of the same structure)."""
    for dst, src in zip(_leaves(static), _leaves(cache)):
        if isinstance(src, torch.Tensor):
            dst.copy_(src)
        else:
            dst.fill_(src)


def copy_back(static, new) -> None:
    """Inside a step: copy each leaf of the model's returned cache ``new``
    that is not already ``static``'s leaf (a cloned ``slot_pos``, an
    advanced ring index, Mamba-2's new states) into ``static``'s."""
    for dst, src in zip(_leaves(static), _leaves(new)):
        if src is dst:
            continue
        if not isinstance(dst, torch.Tensor):
            if src == dst:
                continue  # an int leaf the step left alone
            raise TypeError(f"a step advanced the int cache leaf {dst}; it "
                            f"must be a tensor (graphs.Arena)")
        dst.copy_(src)
