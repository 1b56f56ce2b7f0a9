"""The ONE scheduling loop shared by every runtime (sim and real).

The port's copy of ``repro.serving.core.SchedulerCore``: the arrival
intake → ``dp_batch`` → offload → slice dispatch → re-enqueue loop as a
discrete-event engine; a :class:`~repro_torch.serving.backends.Backend`
supplies the only parts that differ between runtimes (durations and
token outcomes).  This copy leaves out the observability hooks
(``repro.obs``) and the prediction-aware mode (``pred``: SCLS-PRED /
ORACLE), which come with a later slice of the port; a core for a
``pred`` strategy raises.

Worker modes mirror the strategy modes (``core.schedulers``):

  * perreq     — SLS/SO: requests round-robined on arrival; each worker
                 runs FCFS static batches of fixed size.
  * central    — PM/AB/LB/SCLS: a central tick drains the pool, batches,
                 and offloads whole batches to worker queues.
  * continuous — ILS: per-iteration join/exit with a conservative
                 parallelism cap (sim backend only).
  * cont_scls  — SCLS-CB: S-token slice leases on continuous batching
                 (sim backend only).

Beyond the offline ``run()``, the core is an *online* machine: requests
can be submitted at any time (``submit``), observed incrementally
(``token_log`` grows per slice), and cancelled mid-flight (``cancel`` —
the request leaves at the next slice/lease boundary and its page
envelope is freed by the backend).
"""
from __future__ import annotations

import heapq
import itertools
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.cluster.metrics import RunMetrics, compute_metrics
from repro_torch.core.batcher import dp_batch
from repro_torch.core.estimator import ServingTimeEstimator
from repro_torch.core.interval import next_interval
from repro_torch.core.memory import MemoryEstimator, PagedMemoryEstimator
from repro_torch.core.offloader import (MaxMinOffloader, Offloader,
                                        RoundRobinOffloader)
from repro_torch.core.request import Batch, Request, bucket_len
from repro_torch.core.schedulers import StrategyConfig
from repro_torch.serving.backends import Backend

#: modes driven by the central scheduling tick
CENTRAL_MODES = ("central", "cont_scls")
#: modes that need Backend.supports_continuous
CONTINUOUS_MODES = ("continuous", "cont_scls")

# batch_log entry tags (the equivalence-test fingerprint format)
_LOG_STATIC = "static"
_LOG_CONT = "cont"


class WorkerState:
    """Per-worker scheduling state (queues live here; execution is the
    backend's business)."""

    __slots__ = ("wid", "queue", "pending", "running", "busy",
                 "completion_time")

    def __init__(self, wid: int):
        self.wid = wid
        self.queue: deque = deque()    # Batch (static modes)
        self.pending: deque = deque()  # Request (perreq/continuous)
        # [req, cached_len, lease_left, block_charge] (continuous modes)
        self.running: list = []
        self.busy = False
        self.completion_time = 0.0


class SchedulerCore:
    """One scheduling loop, two backends — see module docstring."""

    def __init__(self, strategy: StrategyConfig, backend: Backend,
                 n_workers: int, sched_est: ServingTimeEstimator,
                 mem: MemoryEstimator, ils_span: int = 32):
        if strategy.mode == "pred":
            raise NotImplementedError(
                f"strategy {strategy.name} (prediction-aware mode 'pred') "
                f"is not ported yet (see ROADMAP)")
        if (strategy.mode in CONTINUOUS_MODES
                and not backend.supports_continuous):
            raise ValueError(
                f"strategy {strategy.name} (mode {strategy.mode!r}) needs a "
                f"continuous-capable backend; {type(backend).__name__} "
                f"supports central-tick modes only")
        if (strategy.packing == "envelope"
                and not isinstance(mem, PagedMemoryEstimator)):
            # fail at construction, not on the first scheduling tick
            raise ValueError(
                f"strategy {strategy.name} packs per-request envelopes "
                f"(packing='envelope'), which needs a PagedMemoryEstimator; "
                f"got {type(mem).__name__}")
        self.s = strategy
        self.backend = backend
        self.n_workers = n_workers
        self.est = sched_est
        self.mem = mem
        self.ils_span = ils_span
        self.workers = [WorkerState(w) for w in range(n_workers)]
        self.offloader: Offloader = (
            MaxMinOffloader(n_workers) if strategy.offload == "maxmin"
            else RoundRobinOffloader(n_workers))
        # retention-affinity tiebreak (ROADMAP): a backend that can say
        # where a batch's prefix pages are resident feeds the max-min
        # offloader's ε-tiebreak.  SimBackend has no residency (attribute
        # absent -> affinity stays None and placement is bit-identical to
        # the affinity-less offloader, which the goldens pin).
        if strategy.offload == "maxmin" and hasattr(backend,
                                                    "batch_affinity"):
            self.offloader.affinity_fn = backend.batch_affinity
        self.pool: List[Request] = []
        self.now = 0.0
        self._events: list = []
        self._seq = itertools.count()
        self._rr = 0
        # time of the authoritative armed tick (None = no tick armed);
        # superseded tick events are lazily skipped when they pop
        self._armed_tick: Optional[float] = None
        self._lease_est: Dict[int, float] = {}
        # --- request registry / online state ---
        self.requests: List[Request] = []          # every submitted request
        self._by_rid: Dict[int, Request] = {}
        self.token_log: Dict[int, List[int]] = {}  # per-slice token stream
        self._finalized: Set[int] = set()
        self._cancelled: Set[int] = set()
        # progress observers: fn(kind, request) with kind "slice" (the
        # request's token stream advanced at a slice/iteration boundary)
        # or "final" (terminal).  Purely additive — the async front end
        # (repro.serving.aio) hangs its wakeups here; offline runs have
        # no observers and pay nothing.
        self._observers: List = []
        #: requests shed by the admission layer before ever reaching the
        #: scheduler (repro.serving.admission); counted here so metrics()
        #: reports them alongside the work that did run
        self.n_rejected = 0
        #: per-reason-code shed counts (e.g. {"memory": 2, "deadline": 5})
        self.reject_reasons: Dict[str, int] = {}
        # --- accounting (paper figure columns) ---
        self.batch_sizes: List[int] = []
        self.early_returns = 0
        self.total_batches = 0
        #: §3.3 rescheduling overhead: tokens prefilled beyond each
        #: request's first prefill, summed over all dispatched slices
        #: (0 for resumed residents under kv_retain="request")
        self.reprefill_tokens = 0
        #: prompt tokens satisfied by cross-request prefix-page sharing
        #: (their prefill became a page-table remap) and the pages those
        #: joins took references on, summed over all dispatched slices
        self.prefix_hit_tokens = 0
        self.shared_blocks = 0
        self.peak_parallel = 0  # max concurrent requests on one worker
        #: dispatch fingerprint: ["static", wid, rids, input_len, slice] or
        #: ["cont", wid, rids] — pinned by the equivalence golden test
        self.batch_log: List[list] = []

    # ------------------------------------------------------------------
    # event plumbing
    # ------------------------------------------------------------------
    def _push(self, t: float, kind: str, payload: object = None) -> None:
        heapq.heappush(self._events, (t, next(self._seq), kind, payload))

    def _push_tick(self, t: float) -> None:
        """Arm a scheduling tick at ``t``; a tick armed for an earlier (or
        equal) time wins, and the superseded event is skipped when it
        pops — so a submission arriving before a far-future armed tick is
        scheduled at its own arrival time, not starved until that tick."""
        if self._armed_tick is not None and t >= self._armed_tick:
            return
        self._armed_tick = t
        self._push(t, "tick", t)

    def step(self) -> bool:
        """Process one event; returns False when the event queue is empty."""
        if not self._events:
            return False
        self.now, _, kind, payload = heapq.heappop(self._events)
        getattr(self, f"_on_{kind}")(payload)
        return True

    def run_until_idle(self) -> None:
        while self.step():
            pass

    # ------------------------------------------------------------------
    # request lifecycle API
    # ------------------------------------------------------------------
    def submit(self, req: Request, arrival: Optional[float] = None) -> None:
        """Admit ``req``: schedules its arrival event (never in the past)
        and guarantees a scheduling tick will see it."""
        if req.rid in self._by_rid:
            raise ValueError(f"duplicate rid {req.rid}")
        t = req.arrival if arrival is None else float(arrival)
        t = max(t, self.now)
        req.arrival = t
        self.requests.append(req)
        self._by_rid[req.rid] = req
        self._push(t, "arrival", req)
        if self.s.mode in CENTRAL_MODES:
            self._push_tick(t)  # no-op when an earlier tick is armed

    def cancel(self, rid: int) -> bool:
        """Cancel a submitted request.  Queued requests leave immediately;
        a request inside a dispatched slice or continuous lease leaves at
        the next slice/iteration boundary (its page envelope is released
        there).  Returns
        False when the request is unknown or already finished."""
        req = self._by_rid.get(rid)
        if req is None:
            return False
        if rid in self._finalized:
            # idempotent for already-cancelled; False once completed for real
            return rid in self._cancelled
        if rid in self._cancelled:
            return True
        self._cancelled.add(rid)
        for i, r in enumerate(self.pool):
            if r.rid == rid:
                self.pool.pop(i)
                self._finalize(r, completed=False)
                return True
        for w in self.workers:
            for r in list(w.pending):
                if r.rid == rid:
                    w.pending.remove(r)
                    if rid in self._lease_est:
                        # cont_scls: the lease's marginal load was charged
                        # to this worker at placement; a lease that never
                        # starts must decay it like a finished one, or the
                        # phantom load skews max-min placement and the
                        # Eq. 12 interval forever
                        self.offloader.on_batch_complete(
                            w.wid, self._lease_est.pop(rid))
                    self._finalize(r, completed=False)
                    return True
        # in flight (queued batch / dispatched slice / continuous lease)?
        # then the slice/iteration-boundary handlers finalize it
        for w in self.workers:
            if any(r.rid == rid for b in w.queue for r in b.requests):
                return True
            if any(entry[0].rid == rid for entry in w.running):
                return True
        if any(kind == "batch_done"
               and any(r.rid == rid for r in payload[1].requests)
               for _, _, kind, payload in self._events):
            return True
        # nowhere yet — only its arrival event is pending: finalize now
        self._finalize(req, completed=False)
        return True

    def is_finalized(self, rid: int) -> bool:
        return rid in self._finalized

    def add_observer(self, fn: Callable[[str, Request], None]) -> None:
        """Register a progress observer ``fn(kind, request)`` — see
        ``_observers`` in ``__init__``."""
        self._observers.append(fn)

    def _notify(self, kind: str, r: Request) -> None:
        for fn in self._observers:
            fn(kind, r)

    def _finalize(self, r: Request, completed: bool) -> None:
        """Terminal bookkeeping, exactly once per request."""
        r.done = completed
        r.cancelled = not completed
        r.finish_time = self.now
        # real tokens (if any) move to the request; sim runs keep the legacy
        # output_tokens=None (streaming consumers synthesize indices lazily)
        r.output_tokens = self.token_log.pop(r.rid, r.output_tokens)
        # per-request resources retained across slices (persistent paged
        # prefix pages under kv_retain="request") are freed exactly here —
        # the one place every terminal path goes through
        self.backend.finish_request(r)
        self._finalized.add(r.rid)
        self._notify("final", r)

    # ------------------------------------------------------------------
    # offline entry point (legacy ClusterSimulator/RealCluster semantics)
    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request], duration: float) -> RunMetrics:
        for r in requests:
            self.requests.append(r)
            self._by_rid[r.rid] = r
            self._push(r.arrival, "arrival", r)
        if self.s.mode in CENTRAL_MODES:
            self._push_tick(0.0)
        self.run_until_idle()
        return self.metrics(duration)

    def metrics(self, duration: Optional[float] = None) -> RunMetrics:
        wct = [w.completion_time for w in self.workers]
        if duration is None:
            duration = max(wct) if wct else 0.0
        return compute_metrics(self.s.name, list(self.requests), duration,
                               wct, self.batch_sizes, self.early_returns,
                               self.total_batches,
                               n_rejected=self.n_rejected,
                               reprefill_tokens=self.reprefill_tokens,
                               reject_reasons=self.reject_reasons,
                               prefix_hit_tokens=self.prefix_hit_tokens,
                               shared_blocks=self.shared_blocks)

    # ------------------------------------------------------------------
    # event handlers
    # ------------------------------------------------------------------
    def _on_arrival(self, req: Request) -> None:
        if req.rid in self._cancelled:
            if req.rid not in self._finalized:
                self._finalize(req, completed=False)
            return
        if self.s.mode in CENTRAL_MODES:
            self.pool.append(req)
        elif self.s.mode == "perreq":
            w = self.workers[self._rr]
            self._rr = (self._rr + 1) % self.n_workers
            w.pending.append(req)
            if not w.busy:
                self._start_static_fcfs(w)
        else:  # continuous
            w = self.workers[self._rr]
            self._rr = (self._rr + 1) % self.n_workers
            w.pending.append(req)
            if not w.busy:
                self._continuous_step(w)

    def _on_tick(self, t: Optional[float]) -> None:
        if (t is not None and self._armed_tick is not None
                and t != self._armed_tick):
            return  # superseded by a tick re-armed for an earlier time
        self._armed_tick = None
        reqs, self.pool = self.pool, []
        if reqs and self.s.mode == "cont_scls":
            # beyond-paper: max-min placement of S-token *leases*; the
            # worker itself is a continuous-batching engine, so the load a
            # lease adds is its MARGINAL cost (the N-proportional part of
            # Eq. 1-4), not the serial batch-of-one time
            singles = []
            for r in reqs:
                L = r.effective_input_len
                marginal = (self.est.t_serve(1, L, self.s.slice_len)
                            - self.est.t_serve(0, L, self.s.slice_len))
                self._lease_est[r.rid] = marginal
                singles.append(Batch(requests=[r], input_len=L,
                                     slice_len=self.s.slice_len,
                                     est_time=marginal))
            for w, b in self._assign(singles):
                wk = self.workers[w]
                wk.pending.append(b.requests[0])
                if not wk.busy:
                    self._continuous_step(wk)
        elif reqs:
            cap = self.s.dp_cap if self.s.dp_cap else None
            batches = dp_batch(reqs, self.s.slice_len, self.est, self.mem,
                               max_batch_size=cap, packing=self.s.packing)
            for w, b in self._assign(batches):
                wk = self.workers[w]
                wk.queue.append(b)
                if not wk.busy:
                    self._start_batch(wk)
        if self.s.adaptive_interval:
            dt = next_interval(self.offloader.min_load(), self.s.lam,
                               self.s.gamma)
        else:
            dt = self.s.gamma
        if self._more_work_expected():
            self._push_tick(self.now + dt)

    def _assign(self, batches: List[Batch]) -> List[Tuple[int, Batch]]:
        return self.offloader.assign(batches)

    def _more_work_expected(self) -> bool:
        if self.pool:
            return True
        if any(e[2] == "arrival" for e in self._events):
            return True
        # pending/running cover continuous-mode workers whose admission is
        # momentarily blocked (busy alone would miss leased-out work)
        if any(w.queue or w.busy or w.pending or w.running
               for w in self.workers):
            return True
        return False

    # ------------------------------------------------------------------
    # static batch serving (perreq + central)
    # ------------------------------------------------------------------
    def _start_static_fcfs(self, w: WorkerState) -> None:
        if not w.pending:
            return
        n = self.s.fixed_batch_size or len(w.pending)
        group = [w.pending.popleft() for _ in range(min(n, len(w.pending)))]
        L = max(r.effective_input_len for r in group)
        b = Batch(requests=group, input_len=bucket_len(L, self.est.bucket),
                  slice_len=self.s.slice_len)
        b.est_time = self.est.t_serve(b.size, b.input_len, self.s.slice_len)
        w.queue.append(b)
        self._start_batch(w)

    def _start_batch(self, w: WorkerState) -> None:
        if w.busy or not w.queue:
            return
        b = w.queue.popleft()
        self.peak_parallel = max(self.peak_parallel, b.size)
        self.batch_log.append(
            [_LOG_STATIC, w.wid, sorted(r.rid for r in b.requests),
             int(b.input_len), int(b.slice_len)])
        prev = [self.token_log.get(r.rid, []) for r in b.requests]
        ex = self.backend.run_batch(w.wid, b, prev)
        w.busy = True
        self._push(self.now + ex.duration, "batch_done", (w.wid, b, ex))

    def _on_batch_done(self, payload: Tuple[int, Batch, object]) -> None:
        wid, b, ex = payload
        w = self.workers[wid]
        w.busy = False
        w.completion_time = self.now
        self.total_batches += 1
        self.batch_sizes.append(b.size)
        self.reprefill_tokens += ex.reprefill_tokens
        self.prefix_hit_tokens += ex.prefix_hit_tokens
        self.shared_blocks += ex.shared_blocks
        if ex.early_return:
            self.early_returns += 1
        self.backend.finish_batch(wid, b)  # e.g. release page envelopes
        unfinished = []
        for r, rr in zip(b.requests, ex.per_request):
            r.n_schedules += 1
            r.pad_tokens += rr["pad"]
            r.invalid_tokens += rr["invalid"]
            gen_now, toks = rr["n_valid"], rr["tokens"]
            over = gen_now - r.remaining_gen
            if over > 0:
                # EOS-driven row (gen_len=None) overran its max_gen budget
                # within the slice: the overflow is invalid, like any token
                # generated past a request's end
                gen_now -= over
                toks = toks[:gen_now] if toks is not None else None
                r.invalid_tokens += over
            r.generated += gen_now
            if toks is not None:  # sim backend: tokens synthesized lazily
                self.token_log.setdefault(r.rid, []).extend(toks)
            if r.first_token_time is None:
                r.first_token_time = self.now
            if r.rid in self._cancelled:
                self._finalize(r, completed=False)
            elif r.remaining_gen <= 0 or (r.gen_len is None
                                          and rr.get("finished")):
                # forced-length requests run to their emulated EOS position
                # exactly; only EOS-driven ones (gen_len=None) trust the
                # engine's finished flag
                self._finalize(r, completed=True)
            else:
                unfinished.append(r)
                self._notify("slice", r)
        self.offloader.on_batch_complete(wid, b.est_time)
        if unfinished:
            if self.s.mode == "central":
                self.pool.extend(unfinished)
            else:  # SO: re-send round-robin
                for r in unfinished:
                    tgt = self.workers[self._rr]
                    self._rr = (self._rr + 1) % self.n_workers
                    tgt.pending.append(r)
                    if not tgt.busy:
                        self._start_static_fcfs(tgt)
        if self.s.mode == "perreq" and w.pending and not w.busy:
            self._start_static_fcfs(w)
        elif w.queue:
            self._start_batch(w)

    # ------------------------------------------------------------------
    # continuous batching (ILS / SCLS-CB; sim backend only)
    # ------------------------------------------------------------------
    def _block_charge(self, eff_len: int) -> int:
        """kv_layout="paged": blocks the joining request's envelope holds —
        the slice lease S for cont_scls, the length-blind worst case
        (max_gen remaining) for plain ILS.  Fixed for the request's stay,
        exactly like the real engine's join-time ``reserve``."""
        if self.s.kv_layout != "paged":
            return 0
        S = (self.s.slice_len if self.s.mode == "cont_scls"
             else self.s.max_gen)
        return self.mem.blocks_per_request(eff_len, S)

    def _ils_token_budget_ok(self, w: WorkerState, newreq: Request) -> bool:
        if self.s.kv_layout == "paged":
            # block-granular admission (repro.kvcache): each running
            # request occupies exactly its reserved envelope rounded up to
            # pages; the join fits iff the worker's pool has free blocks
            assert isinstance(self.mem, PagedMemoryEstimator), \
                "kv_layout='paged' needs a PagedMemoryEstimator"
            used = sum(blocks for *_, blocks in w.running)
            charge = self._block_charge(newreq.effective_input_len)
            return used + charge <= self.mem.total_blocks
        budget = self.s.max_cached_tokens
        if budget is None and self.s.mode == "cont_scls":
            # slices bound per-request growth to eff_len + S, so the exact
            # memory budget applies (no conservative cap) — Eq. 5/9.
            # NOTE: this is the *idealized* fragmentation-free allocator;
            # kv_layout="paged" is the realizable version (block-rounded)
            if hasattr(self.mem, "m_available") and self.mem.delta_bytes > 0:
                budget = int(self.mem.zeta * self.mem.m_available
                             / self.mem.delta_bytes)
        if budget is None:
            return True
        tokens = sum(c + self.s.slice_len for _, c, _, _ in w.running)
        return tokens + newreq.effective_input_len + self.s.slice_len <= budget

    def _continuous_step(self, w: WorkerState) -> None:
        """Advance worker w: admit joins, then run a span of iterations."""
        dur = 0.0
        # admit (FCFS) under the conservative parallelism cap.  An EMPTY
        # worker always admits its head-of-line request: a request whose
        # envelope alone exceeds the budget (e.g. its effective input grew
        # past it across leases) can never fit, and gating it on the
        # budget would starve it — and everything FCFS behind it — forever
        # (the legacy simulator livelocked here; the real ContinuousEngine
        # rejects such requests up front instead).  Serving it solo is the
        # closest meaningful semantics.
        lease = self.s.mode == "cont_scls"
        while (w.pending and len(w.running) < self.s.max_parallel
               and (not w.running
                    or self._ils_token_budget_ok(w, w.pending[0]))):
            r = w.pending.popleft()
            dur += self.backend.prefill_time(r)
            r.n_schedules += 1
            w.running.append([r, r.effective_input_len,
                              self.s.slice_len if lease else (1 << 30),
                              self._block_charge(r.effective_input_len)])
        if not w.running:
            w.busy = False
            return
        w.busy = True
        span = min(self.ils_span,
                   min(min(r.remaining_gen, lease_left)
                       for r, _, lease_left, _ in w.running))
        span = max(span, 1)
        N = len(w.running)
        self.peak_parallel = max(self.peak_parallel, N)
        avg_len = float(np.mean([c for _, c, _, _ in w.running]))
        dur += self.backend.span_time(avg_len, span, N)
        self.batch_log.append(
            [_LOG_CONT, w.wid, sorted(e[0].rid for e in w.running)])
        self._push(self.now + dur, "cont_done", (w.wid, span, N))

    def _on_cont_done(self, payload: Tuple[int, int, int]) -> None:
        wid, span, n_running = payload
        w = self.workers[wid]
        w.completion_time = self.now
        self.batch_sizes.append(n_running)
        self.total_batches += 1
        still = []
        expired = []
        for r, c, lease_left, blocks in w.running:
            r.generated += span
            lease_left -= span
            if r.first_token_time is None:
                r.first_token_time = self.now
            if r.rid in self._cancelled:
                # mid-lease cancel: leave at this iteration boundary; the
                # block charge vanishes with the running entry
                self._finalize(r, completed=False)
                self.offloader.on_batch_complete(
                    w.wid, self._lease_est.pop(r.rid, 0.0))
            elif r.remaining_gen <= 0:
                self._finalize(r, completed=True)
                self.offloader.on_batch_complete(
                    w.wid, self._lease_est.pop(r.rid, 0.0))
            elif lease_left <= 0:  # slice lease over -> back to the pool
                expired.append(r)
                self.offloader.on_batch_complete(
                    w.wid, self._lease_est.pop(r.rid, 0.0))
                self._notify("slice", r)
            else:
                still.append([r, c + span, lease_left, blocks])
                self._notify("slice", r)
        w.running = still
        if expired:
            self.pool.extend(expired)
        self._continuous_step(w)
