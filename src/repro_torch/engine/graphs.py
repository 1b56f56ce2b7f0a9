"""Captured work, one per bucket: the port's counterpart of the JAX
engines' compiled executables (``repro.engine.static_engine``'s
``_compiled`` cache of jitted serve functions, one per slice length and
traced anew per input shape, its jitted paged prefills, and
``repro.engine.continuous_engine``'s jitted join prefill and decode).

Three kinds of captured work, each a closure over *static* tensors
(``bufs``): every input it reads and every output it writes lives in a
buffer that the engine fills with ``copy_`` before the call and reads
after it; the step counter and a dense cache's ring index are 0-d device
tensors that an iteration advances, and every new cache leaf the model
returns is copied back into its buffer inside the closure.

  * ``Step``: one decode iteration per call (``ContinuousEngine``'s step,
    the profiler's decode timing);
  * ``Prefill``: one prefill per call (the paged engines' prefill and tail
    prefill, ``ContinuousEngine``'s join, the profiler's prefill timing);
  * ``Loop``: a slice's whole decode loop per call, the counterpart of
    ``lax.while_loop``: on the card one replay of a graph whose WHILE
    conditional node runs the body while ``step < S and not all(done)``,
    the condition set on the device by ``kernels.graph_loop``'s kernel, so
    the host waits once per slice; the dense engine's loop runs its
    ``Prefill`` first, in the same graph.

On a CUDA device the first call of a bucket runs the closures on a side
stream, eagerly (the warm-up: it is that call's real work, so the
kernels' first-use build, cuBLAS's handles and the allocator's blocks
never land inside a capture), then captures them into
``torch.cuda.CUDAGraph``s; every later call replays.  A capture, an edit
of a loop's graph or an instantiation that fails raises: nothing retries
eagerly.  All graphs of one ``GraphCache`` share one memory pool, which
is safe because an engine replays one graph at a time and each call leaves
its results in the static buffers, outside the pool.  On a CPU device the
same closures run on the same buffers, uncaptured, so the CPU tests
exercise the code the card replays.

The engines keep their eager paths (a prefill and a decode step op by op
over per-call tensors and a Python step counter) for three cases, named
by ``eager_reason``: inside ``disabled()``, the counterpart of
``jax.disable_jit()``, which ``chip_smoke.py`` and the tests use to hold
the two against each other; parameters that are DTensors (sharded
serving: the JAX engines take no mesh, so there is nothing of theirs to
port); and a family of ``EAGER_FAMILIES`` (none: every family's prefill
and decode step are captured).
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Callable, Dict, Hashable, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.kernels import build, graph_loop
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


def _capture(owner: "GraphCache", fn: Callable[[], None],
             keep_graph: bool = False
             ) -> Tuple[torch.cuda.CUDAGraph, Dict[str, int]]:
    """``fn()`` captured on ``owner``'s side stream into a new graph of its
    pool (``keep_graph``: the raw graph is kept for editing and the graph is
    not instantiated), with the kernel launches the capture recorded.  The
    caller has warmed ``fn`` up.  A capture that fails raises."""
    main = torch.cuda.current_stream(owner.device)
    side = owner.side_stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph(keep_graph=keep_graph)
        with _CAPTURE_LOCK, _no_gc(), build.capturing() as tally:
            graph.capture_begin(pool=owner.pool(),
                                capture_error_mode="thread_local")
            try:
                fn()
            except BaseException:
                with contextlib.suppress(Exception):
                    graph.capture_end()  # leave the stream usable
                raise
            graph.capture_end()
    main.wait_stream(side)
    return graph, dict(tally)


@contextlib.contextmanager
def _on_side(owner: "GraphCache") -> Iterator[None]:
    """Inside ``with``, work runs on ``owner``'s side stream, ordered
    after and before the current stream's (a warm-up before a capture:
    the allocator's blocks and cuBLAS's workspace are the side stream's,
    as the capture's will be)."""
    main = torch.cuda.current_stream(owner.device)
    side = owner.side_stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        yield
    main.wait_stream(side)


def _kind(key: Hashable) -> str:
    return str(key[0] if isinstance(key, tuple) else key)


class Step:
    """One bucket's captured work: ``fn()`` over the static tensors
    ``bufs`` (name -> tensor, or a tree of tensors for a cache).  Each call
    runs it once: a decode iteration (``ContinuousEngine``'s, the
    profiler's) or, as a ``Prefill``, a prefill."""

    def __init__(self, cache: "GraphCache", fn: Callable[[], None],
                 bufs: Dict[str, object], key: Hashable = "step"):
        self._cache, self.fn, self.bufs = cache, fn, bufs
        #: the bucket's key, and its kind (the key's first element)
        self.key, self.kind = key, _kind(key)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: kernel launches one replay makes (the capture's tally)
        self.launches: Dict[str, int] = {}

    def __call__(self) -> None:
        owner = self._cache
        if not owner.capture:
            self.fn()
        elif self.graph is None:
            t0 = time.perf_counter()
            with _on_side(owner):
                self.fn()  # the warm-up is this call's work
            self.graph, self.launches = _capture(owner, self.fn)
            owner.captured(self.kind, time.perf_counter() - t0)
        else:
            self.graph.replay()
            kernel_ops.add_launches(self.launches)


class Prefill(Step):
    """A bucket's prefill, captured: the model's prefill over static
    inputs (tokens, lengths, start, block table, extra inputs) whose every
    output that the host or another graph reads afterwards (the first
    tokens, a dense cache, ``ContinuousEngine``'s single-row cache) the
    closure copies into a buffer allocated outside the graphs' pool.  One
    call is one prefill; a replay adds its capture's launches once."""


class Loop:
    """A bucket's decode loop on the device: the counterpart of the JAX
    engines' ``lax.while_loop``.  ``fn()`` is one iteration (the body) over
    the static ``bufs``, which hold the 0-d int64 counter ``step`` that it
    advances and the (B,) bool ``done`` that it sets; the loop runs the
    body while ``step < limit and not all(done)`` (``kernels.ops.
    graph_loop``), from ``step`` 0.  ``head`` (a ``Prefill``) runs once
    before the loop: the dense engine's prefill, in the same graph.

    On a CUDA device the first call runs the head and one body eagerly
    (the warm-up, which is that call's prefill and first step), then
    captures the head and the body and rewrites the body's graph into a
    WHILE conditional node (``kernels.graph_loop.build_loop``), and runs
    the rest of its loop as a replay (``_first``); every later call is one
    replay, whose launches are the head's once, the body's times the steps
    it ran and the condition kernel's once per step and once before the
    loop.  On a CPU device the same closures run in a Python loop under
    the plain condition.  Each call returns the ``READS`` of ``bufs`` on
    the host, read in one transfer."""

    #: the buffers a call brings back to the host
    READS = ("out", "step", "done", "cur")

    def __init__(self, cache: "GraphCache", fn: Callable[[], None],
                 bufs: Dict[str, object], limit: int, key: Hashable,
                 head: Optional[Prefill] = None):
        self._cache, self.fn, self.bufs = cache, fn, bufs
        self.key, self.kind = key, _kind(key)
        self.limit, self.head = limit, head
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        #: kernel launches of one body (the body's capture's tally)
        self.launches: Dict[str, int] = {}

    def _goes_on(self) -> bool:
        return bool(kernel_ops.graph_loop(self.bufs["step"],
                                          self.bufs["done"], self.limit))

    def _run(self) -> None:
        self.bufs["step"].zero_()
        if self.head is not None:
            self.head.fn()
        while self._goes_on():
            self.fn()

    def __call__(self) -> Dict[str, np.ndarray]:
        owner = self._cache
        if not owner.capture:
            self._run()
            return self._read()
        if self.graph is None:
            t0 = time.perf_counter()
            out = self._first()
            owner.captured(self.kind, time.perf_counter() - t0)
            return out
        self.bufs["step"].zero_()
        self.graph.replay()
        out = self._read()
        if self.head is not None:
            kernel_ops.add_launches(self.head.launches)
        self._count(int(out["step"]))
        return out

    def _count(self, n: int) -> None:
        """Add a loop replay's launches: ``n`` bodies and ``n + 1``
        conditions."""
        kernel_ops.add_launches({k: v * n for k, v in self.launches.items()})
        kernel_ops.add_launches({"graph_loop": n + 1})

    def _first(self) -> Dict[str, np.ndarray]:
        """A bucket's first call on the card: the head and one body run
        eagerly on the side stream (the warm-up: this call's prefill and
        first step), then the head (kept) and the body are captured and
        the body's graph becomes the loop's (a failure raises and keeps no
        graph); the rest of this call's loop is one replay of a loop graph
        of the body alone, from the step the warm-up left."""
        owner, b = self._cache, self.bufs
        with _on_side(owner):
            b["step"].zero_()
            if self.head is not None:
                self.head.fn()
            goes_on = self._goes_on()
            if goes_on:
                self.fn()
        head = rest = None
        if self.head is not None:
            head, self.head.launches = _capture(owner, self.head.fn,
                                                keep_graph=True)
        graph, tally = _capture(owner, self.fn, keep_graph=True)
        graph_loop.build_loop(graph, b["step"], b["done"], self.limit,
                              head=head)
        if goes_on:
            if head is None:
                rest = graph
            else:
                rest, _ = _capture(owner, self.fn, keep_graph=True)
                graph_loop.build_loop(rest, b["step"], b["done"],
                                      self.limit)
        #: the head's graph, kept: the loop's graph holds a clone of it
        self.head_graph = head
        self.graph, self.launches = graph, tally
        if rest is not None:
            rest.replay()
        out = self._read()
        if rest is not None:
            self._count(int(out["step"]) - 1)
        return out

    def _read(self) -> Dict[str, np.ndarray]:
        """``READS`` on the host, in one transfer."""
        bufs = [self.bufs[k] for k in self.READS]
        flat = torch.cat([t.reshape(-1).to(torch.int64)
                          for t in bufs]).cpu().numpy()
        out, i = {}, 0
        for name, t in zip(self.READS, bufs):
            dtype = torch.empty((), dtype=t.dtype).numpy().dtype
            out[name] = flat[i:i + t.numel()].astype(dtype).reshape(
                tuple(t.shape))
            i += t.numel()
        return out


class GraphCache:
    """bucket key -> captured work (``Step``, ``Prefill``, ``Loop``), for
    one engine on ``device`` (the JAX engine's ``_compiled``).  ``capture``
    is whether the work is captured: on a CUDA device, not on the CPU."""

    def __init__(self, device: torch.device):
        self.device = device
        self.capture = device.type == "cuda"
        self._entries: Dict[Hashable, object] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        #: buckets captured and the wall seconds spent capturing them,
        #: warm-ups included, in all and by kind (a key's first element:
        #: "dense", "paged", "prefill", "tail", "join", "decode")
        self.n_captures = 0
        self.capture_seconds = 0.0
        self.captures: Dict[str, int] = {}
        self.seconds: Dict[str, float] = {}

    def captured(self, kind: str, seconds: float) -> None:
        self.n_captures += 1
        self.capture_seconds += seconds
        self.captures[kind] = self.captures.get(kind, 0) + 1
        self.seconds[kind] = self.seconds.get(kind, 0.0) + seconds

    def pool(self):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._pool

    def side_stream(self) -> torch.cuda.Stream:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def get(self, key: Hashable):
        return self._entries.get(key)

    def add(self, key: Hashable, fn: Callable[[], None],
            bufs: Dict[str, object]) -> Step:
        """A decode ``Step`` under ``key``."""
        step = self._entries[key] = Step(self, fn, bufs, key)
        return step

    def add_prefill(self, key: Hashable, fn: Callable[[], None],
                    bufs: Dict[str, object]) -> Prefill:
        """A ``Prefill`` under ``key``."""
        pre = self._entries[key] = Prefill(self, fn, bufs, key)
        return pre

    def add_loop(self, key: Hashable, fn: Callable[[], None],
                 bufs: Dict[str, object], limit: int,
                 head: Optional[Callable[[], None]] = None) -> Loop:
        """A ``Loop`` of body ``fn`` under ``key``, after the prefill
        ``head`` where one is given (captured with it as one graph)."""
        pre = Prefill(self, head, bufs, key) if head is not None else None
        loop = self._entries[key] = Loop(self, fn, bufs, limit, key,
                                         head=pre)
        return loop

    def keys(self) -> List[Hashable]:
        return list(self._entries)

    def clear(self, keep: Optional[Hashable] = None) -> None:
        """Drop every entry but ``keep``'s, which must not be captured yet
        (and every dropped graph), and the memory pool: once its last graph
        is gone the allocator frees the pool and takes its id no more, so
        the next capture opens a new one."""
        kept = self._entries.get(keep)
        if getattr(kept, "graph", None) is not None:
            raise ValueError(f"clear: {keep!r} is captured over the pool")
        self._entries = {keep: kept} if kept is not None else {}
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
