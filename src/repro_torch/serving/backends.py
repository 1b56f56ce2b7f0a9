"""Execution backends for :class:`repro_torch.serving.core.SchedulerCore`.

The port's copy of ``repro.serving.backends``.  What varies between the
discrete-event simulator and the real cluster is only how a dispatched
unit of work turns into a duration and token outcomes:

  * :class:`SimBackend` — durations from a calibrated ground-truth latency
    model (optionally noisy), token outcomes derived from each request's
    true generation length; copied verbatim.
  * :class:`RealBackend` — batches run on
    :class:`~repro_torch.engine.static_engine.StaticEngine` workers (every
    FLOP real, on the card), durations are measured wall time, tokens come
    from the model.  ``kv_retain="slice"`` (dense or paged layout) runs
    each slice from a fresh prefill, the paper's SCLS; ``"request"``
    (paged only) keeps each request's prefix pages resident in its engine
    across slices, and anchors a multi-turn session's last completed turn
    past its lifetime so the next turn joins those pages.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.core.estimator import ServingTimeEstimator
from repro_torch.core.memory import MemoryEstimator, PagedMemoryEstimator
from repro_torch.core.request import Batch, Request
from repro_torch.engine.static_engine import EOS_DRIVEN, StaticEngine
from repro_torch.kvcache import PageAllocator

# Per-request outcome dict keys (shared with StaticEngine results):
# tokens, n_valid, invalid, pad, finished.
RequestOutcome = Dict[str, object]


@dataclasses.dataclass
class BatchExecution:
    """What happened to one dispatched slice.

    ``per_request`` is aligned with ``Batch.requests``; ``tokens`` are the
    valid tokens this slice produced for that request (``None`` on the sim
    backend, whose token ids are the generation indices).  ``finished``
    marks EOS/forced completion as observed by the engine.
    ``reprefill_tokens`` counts tokens prefilled beyond each member's
    first prefill (the §3.3 rescheduling overhead).  ``prefill_dur`` is
    the prefill portion of ``duration`` when the backend can attribute it.
    """

    duration: float
    steps: int
    early_return: bool
    per_request: List[RequestOutcome]
    reprefill_tokens: int = 0
    prefill_dur: Optional[float] = None
    #: prompt tokens satisfied by cross-request prefix-page sharing this
    #: slice and the pages those joins took references on
    prefix_hit_tokens: int = 0
    shared_blocks: int = 0


@runtime_checkable
class Backend(Protocol):
    """What a SchedulerCore needs from an execution substrate."""

    #: whether continuous-batching modes (ILS / SCLS-CB) can run here
    supports_continuous: bool

    def run_batch(self, wid: int, batch: Batch,
                  prev_tokens: Sequence[Sequence[int]]) -> BatchExecution:
        """Execute ``batch`` for one slice on worker ``wid``; the returned
        ``duration`` is virtual time."""
        ...

    def finish_batch(self, wid: int, batch: Batch) -> None:
        """The slice-completion event for ``batch`` is being processed."""
        ...

    def finish_request(self, req: Request) -> None:
        """``req`` went terminal: release per-request resources
        (idempotent)."""
        ...

    def release_session(self, session_id: int) -> None:
        """A multi-turn session closed: release any prefix pages anchored
        for it beyond its requests' lifetimes.  Idempotent no-op when the
        backend retains nothing per session."""
        ...

    def prefill_time(self, req: Request) -> float:
        """Continuous modes: virtual cost of one request's join prefill."""
        ...

    def span_time(self, avg_len: float, span: int, n_running: int) -> float:
        """Continuous modes: virtual cost of ``span`` decode iterations."""
        ...


class SimBackend:
    """Latency-model backend: the discrete-event simulator's physics.

    The scheduler consults its own fitted estimator; this backend consumes
    time from the ground-truth profile ``true_lat`` (optionally log-normal
    noisy), so estimation error and its consequences are modelled."""

    supports_continuous = True

    def __init__(self, true_lat: ServingTimeEstimator,
                 noise_sigma: float = 0.0, seed: int = 0):
        self.true_lat = true_lat
        self.noise_sigma = float(noise_sigma)
        self.rng = np.random.default_rng(seed)

    def _noise(self) -> float:
        if self.noise_sigma <= 0:
            return 1.0
        return float(self.rng.lognormal(0.0, self.noise_sigma))

    def run_batch(self, wid: int, batch: Batch,
                  prev_tokens: Sequence[Sequence[int]]) -> BatchExecution:
        steps = min(batch.slice_len,
                    max(r.remaining_gen for r in batch.requests))
        t_nominal = self.true_lat.t_serve(batch.size, batch.input_len, steps)
        dur = t_nominal * self._noise()
        # prefill share of the slice from the nominal model ratio — it
        # MUST NOT cost an extra rng draw (the golden logs pin the stream)
        if t_nominal > 0:
            frac = self.true_lat.t_prefill(batch.size,
                                           batch.input_len) / t_nominal
            prefill_dur = dur * min(max(frac, 0.0), 1.0)
        else:
            prefill_dur = 0.0
        per: List[RequestOutcome] = []
        reprefill = 0
        for r in batch.requests:
            remaining = r.remaining_gen
            gen_now = min(remaining, steps)
            if r.generated > 0:  # §3.3: a reschedule re-prefills everything
                reprefill += r.effective_input_len
            per.append(dict(
                tokens=None,  # sim: synthesized lazily (generation indices)
                n_valid=gen_now,
                invalid=steps - gen_now,
                pad=batch.input_len - r.effective_input_len,
                finished=remaining - gen_now <= 0))
        return BatchExecution(duration=dur, steps=steps,
                              early_return=steps < batch.slice_len,
                              per_request=per,
                              reprefill_tokens=reprefill,
                              prefill_dur=prefill_dur)

    def finish_batch(self, wid: int, batch: Batch) -> None:
        pass  # no per-slice resources in virtual time

    def finish_request(self, req: Request) -> None:
        pass  # no per-request resources in virtual time

    def release_session(self, session_id: int) -> None:
        pass  # no per-session resources in virtual time

    def prefill_time(self, req: Request) -> float:
        return self.true_lat.t_prefill(
            1, req.effective_input_len) * self._noise()

    def span_time(self, avg_len: float, span: int, n_running: int) -> float:
        # Σ_{i=1..span} τ(avg+i, N) ≈ span · τ(avg + span/2, N)
        return span * self.true_lat.tau_decode(
            avg_len + span / 2.0, n_running) * self._noise()


class RealBackend:
    """Real-execution backend over StaticEngine workers.

    One host runs all engines, so each worker's timeline is virtual — the
    core advances it by the measured wall time of that worker's own
    batches.  ``kv_retain`` decides how long a request's KV lives:

      * ``"slice"`` (default): every slice re-prefills prompt + generated
        (§3.3) through ``StaticEngine.serve_batch``.  With
        ``kv_layout="paged"`` each worker keeps a ``PageAllocator`` of the
        scheduler's block budget, every member reserves its batch envelope
        ``L_i + S`` at dispatch and releases it at slice end, so a
        ``MemoryError`` means the DP batcher violated its own bound;
      * ``"request"`` (needs ``kv_layout="paged"`` and persistent paged
        engines): dispatch goes through ``serve_batch_paged``, resumed
        requests re-prefill nothing, and pages are released when the core
        finalizes the request, by evict-on-pressure, or on worker
        migration (the new worker re-prefills; counted in
        ``reprefill_tokens``).

    Continuous modes are not supported.
    """

    supports_continuous = False

    def __init__(self, engines: Sequence[StaticEngine],
                 mem: Optional[MemoryEstimator] = None,
                 kv_layout: str = "dense", sched_bucket: int = 1,
                 kv_retain: str = "slice"):
        if kv_retain not in ("slice", "request"):
            raise ValueError(f"unknown kv_retain {kv_retain!r} "
                             f"(expected 'slice' or 'request')")
        if kv_retain == "request" and kv_layout != "paged":
            raise ValueError("kv_retain='request' needs kv_layout='paged'")
        self.engines = list(engines)
        self.kv_retain = kv_retain
        self.mem = mem if isinstance(mem, PagedMemoryEstimator) else None
        self.allocators: Optional[List[PageAllocator]] = None
        #: kv_retain="request": worker whose engine retains each rid's pages
        self._engine_of: Dict[int, int] = {}
        #: session_id -> (wid, rid) whose pages are anchored past the
        #: request's lifetime so the next turn's prefix join can hit them
        self._session_anchor: Dict[int, tuple] = {}
        if kv_layout != "paged":
            return
        if not isinstance(mem, PagedMemoryEstimator):
            raise TypeError("kv_layout='paged' needs a PagedMemoryEstimator")
        if mem.bucket % sched_bucket:
            # fits() admits with mem.bucket over raw lengths while the
            # reserve charges the estimator-bucketed batch input length
            raise ValueError(
                f"PagedMemoryEstimator.bucket ({mem.bucket}) must be a "
                f"multiple of the estimator bucket ({sched_bucket})")
        if kv_retain == "slice":
            self.allocators = [PageAllocator(mem.total_blocks,
                                             mem.page_tokens)
                               for _ in self.engines]
            return
        for i, e in enumerate(self.engines):
            if getattr(e, "kv_layout", None) != "paged":
                raise TypeError(f"kv_retain='request' needs persistent-paged "
                                f"engines; engine {i} is not")
            if e.allocator.page_tokens != mem.page_tokens:
                raise ValueError(
                    f"engine {i} page_tokens ({e.allocator.page_tokens}) "
                    f"!= estimator's ({mem.page_tokens})")
            if e.allocator.n_pages < mem.total_blocks:
                raise ValueError(
                    f"engine {i} pool ({e.allocator.n_pages} pages) smaller "
                    f"than the scheduler's budget ({mem.total_blocks}): "
                    f"the batcher would over-admit")
        # the engines' own allocators ARE the slice envelopes
        self.allocators = [e.allocator for e in self.engines]

    def run_batch(self, wid: int, batch: Batch,
                  prev_tokens: Sequence[Sequence[int]]) -> BatchExecution:
        eng = self.engines[wid]
        prompts = [r.prompt for r in batch.requests]
        # gen_len=None → EOS-driven: the engine detects the model's own EOS
        forced = [r.remaining_gen if r.gen_len is not None else EOS_DRIVEN
                  for r in batch.requests]
        if self.kv_retain == "request":
            # worker migration: pages retained elsewhere are unreachable
            # from this engine — release them there, re-prefill here
            for r in batch.requests:
                old = self._engine_of.get(r.rid)
                if old is not None and old != wid:
                    self.engines[old].release_request(r.rid)
                self._engine_of[r.rid] = wid
            res = eng.serve_batch_paged(prompts, batch.slice_len,
                                        [r.rid for r in batch.requests],
                                        forced_gen_lens=forced,
                                        already_generated=list(prev_tokens))
            self._sync_retained_gauge()
        else:
            if self.allocators is not None:
                # slice start: every member holds the batch envelope
                # L_i + S (rows are padded to the batch input length, as
                # the engine's per-batch cache is); finish_batch releases
                alloc = self.allocators[wid]
                for r in batch.requests:
                    alloc.reserve(r.rid, batch.input_len + batch.slice_len)
            res = eng.serve_batch(prompts, batch.slice_len,
                                  forced_gen_lens=forced,
                                  already_generated=list(prev_tokens))
        return BatchExecution(duration=res.wall_time, steps=res.steps,
                              early_return=res.early_return,
                              per_request=list(res.results),
                              reprefill_tokens=res.reprefill_tokens,
                              prefill_dur=res.prefill_time,
                              prefix_hit_tokens=res.prefix_hit_tokens,
                              shared_blocks=res.shared_blocks)

    def finish_batch(self, wid: int, batch: Batch) -> None:
        if self.kv_retain == "request":
            return  # retention: the engine trimmed to the resident prefix
        if self.allocators is not None:
            alloc = self.allocators[wid]
            for r in batch.requests:  # slice end: envelope freed
                alloc.release(r.rid)

    def finish_request(self, req: Request) -> None:
        """Terminal (finished/cancelled): free the retained prefix pages.

        A *completed* request belonging to a session is anchored instead:
        its pages (prompt + answer — exactly the next turn's prefix) stay
        resident, replacing the session's previous anchor.  Anchored pages
        remain LRU-evictable under pool pressure and are dropped for good
        by :meth:`release_session` (or an engine eviction); a *cancelled*
        turn releases immediately like any other request.
        """
        if self.kv_retain != "request":
            return
        wid = self._engine_of.pop(req.rid, None)
        if wid is None:
            return
        sid = getattr(req, "session_id", None)
        if sid is not None and req.done and not req.cancelled:
            old = self._session_anchor.get(sid)
            if old is not None and old[1] != req.rid:
                self.engines[old[0]].release_request(old[1])
            self._session_anchor[sid] = (wid, req.rid)
        else:
            self.engines[wid].release_request(req.rid)
        self._sync_retained_gauge()

    def release_session(self, session_id: int) -> None:
        """Drop the session's anchored prefix pages (idempotent)."""
        anchor = self._session_anchor.pop(session_id, None)
        if anchor is not None:
            self.engines[anchor[0]].release_request(anchor[1])
            self._sync_retained_gauge()

    def batch_affinity(self, batch: Batch) -> Optional[int]:
        """Retention-affinity hint for the offloader's ε-tiebreak: the
        worker whose resident prefix pages cover the most tokens of this
        batch's prompts (``None`` when none matches)."""
        if self.kv_retain != "request":
            return None
        streams = []
        for r in batch.requests:
            if r.prompt is None:
                continue
            gen = r.output_tokens or []
            streams.append(np.concatenate([np.asarray(r.prompt, np.int64),
                                           np.asarray(gen, np.int64)])
                           if gen else np.asarray(r.prompt, np.int64))
        if not streams:
            return None
        best_wid, best_hit = None, 0
        for wid, eng in enumerate(self.engines):
            if not eng.prefix_sharing:
                continue
            hit = sum(eng._prefix.lookup(s)[1] for s in streams)
            if hit > best_hit:
                best_wid, best_hit = wid, hit
        return best_wid

    def _sync_retained_gauge(self) -> None:
        if self.mem is not None:
            self.mem.retained_blocks = sum(a.used_blocks
                                           for a in self.allocators)

    def free_blocks(self) -> List[int]:
        """Per-worker free KV-block counts (paged layout; ``[]`` when
        dense)."""
        if self.allocators is None:
            return []
        return [a.free_blocks for a in self.allocators]

    def obs_snapshot(self) -> Dict[str, int]:
        """KV-pool state for the observability gauges / counter tracks
        (``repro_torch.obs``); ``{}`` on the dense layout, where there is
        no page pool to report."""
        if self.allocators is None:
            return {}
        snap = dict(
            free_pages=sum(a.free_blocks for a in self.allocators),
            evictions=sum(getattr(e, "n_evictions", 0)
                          for e in self.engines))
        if self.kv_retain == "request":
            snap["retained_blocks"] = sum(a.used_blocks
                                          for a in self.allocators)
            snap["shared_blocks"] = sum(a.shared_blocks
                                        for a in self.allocators)
        return snap

    def prefill_time(self, req: Request) -> float:
        raise NotImplementedError("RealBackend does not run continuous modes")

    def span_time(self, avg_len: float, span: int, n_running: int) -> float:
        raise NotImplementedError("RealBackend does not run continuous modes")
