"""Async serving front end: N concurrent clients over one SchedulerCore.

The ``SliceServer`` is a *synchronous reactor*: whichever caller
invokes ``tokens()`` / ``result()`` drives the shared event queue, so only
one client can use it at a time.  ``AsyncSliceServer`` turns the same
:class:`~repro_torch.serving.core.SchedulerCore` into a concurrent service: a
single background task (the *pacer*) steps the core, and any number of
client coroutines submit, stream, cancel, and await results::

    server = ServingConfig(strategy="scls", workers=4).build_sim().aio

    async def client(i):
        h = server.submit(input_len=64, gen_len=100, slo_ms=30_000)
        async for tok in h.tokens():     # wakes at slice boundaries
            ...
        return await h.result()

    await asyncio.gather(*(client(i) for i in range(16)))

Concurrency model — one event loop, **no locks in the core**: ``submit``
and ``cancel`` are plain synchronous methods that mutate the core
in-line, the pacer is the only task that calls ``core.step()``, and
client coroutines never touch the core — they wait on per-handle events
pulsed by the core's progress observers.  Every interleaving is therefore
a sequence of atomic core transitions, exactly as in the offline runs.

Wall-clock pacing: with ``time_scale=k`` (sim backend only) the pacer
sleeps so that virtual second ``t`` occurs at wall second ``t / k`` after
start, and submissions map the wall clock back to virtual arrival times —
``k = 1`` serves the simulated cluster in real time (what the HTTP front
end uses), large ``k`` compresses it.  With ``time_scale=None`` (default)
events are processed as fast as possible; on the real backend the engines
themselves consume wall time inside ``step()``, so no pacing is applied.

SLO-aware admission (``repro_torch.serving.admission``) runs inside ``submit``:
a request whose predicted completion violates its ``slo_ms``/``deadline``
raises :class:`~repro_torch.serving.admission.AdmissionRejected` *before* any
page reservation or prefill work.
"""
from __future__ import annotations

import asyncio
import itertools
from typing import Any, AsyncIterator, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.metrics import RunMetrics
from repro_torch.core.request import Request
from repro_torch.core.schedulers import StrategyConfig
from repro_torch.serving.admission import (AdmissionController, AdmissionDecision,
                                           AdmissionRejected)
from repro_torch.serving.backends import SimBackend
from repro_torch.serving.core import SchedulerCore

#: server-assigned request ids live in their own namespace so interactive
#: ``submit`` calls never collide with trace rids (0..n) fed to ``replay``
_SERVER_RID_BASE = 1 << 32


class RequestView:
    """Read-only view of one submitted request (shared by the sync and
    async handles — all state lives in the core/request, never here)."""

    def __init__(self, server: Any, request: Request):
        self._server = server
        self.request = request

    @property
    def rid(self) -> int:
        return self.request.rid

    @property
    def finished(self) -> bool:
        """Terminal (completed or cancelled)."""
        return self._server.core.is_finalized(self.rid)

    @property
    def done(self) -> bool:
        """Completed successfully."""
        return self.finished and self.request.done

    @property
    def cancelled(self) -> bool:
        return self.request.cancelled

    def _tokens_so_far(self) -> Sequence[int]:
        toks = self._server.core.token_log.get(self.rid)
        if toks is not None:  # real backend, mid-flight
            return toks
        if self.finished and self.request.output_tokens is not None:
            return self.request.output_tokens  # real backend, terminal
        # sim backend: token ids are by definition the generation indices
        return range(self.request.generated)

    @property
    def output_tokens(self) -> List[int]:
        """Tokens produced so far (all of them once terminal)."""
        return list(self._tokens_so_far())


class AsyncRequestHandle(RequestView):
    """Awaitable view of one request on an :class:`AsyncSliceServer`.

    Slice boundaries are recorded as they happen (``_marks``), so
    ``slices()`` reproduces the true per-slice chunking even when the
    consumer polls slower than the pacer produces — the property the SSE
    streaming endpoint relies on.
    """

    def __init__(self, server: "AsyncSliceServer", request: Request):
        super().__init__(server, request)
        self._event = asyncio.Event()
        self._marks: List[int] = []  # cumulative token count per slice

    # -- called by the server's core observer (inside the pacer step) ----
    def _pulse(self, kind: str) -> None:
        if kind in ("slice", "final"):
            n = len(self._tokens_so_far())
            if n > (self._marks[-1] if self._marks else 0):
                self._marks.append(n)
        self._event.set()

    async def _wait(self) -> None:
        # progress check FIRST: a woken waiter must observe a pacer
        # failure before _ensure_running clears it for the restart
        self._server._check_progress(self.request)
        self._server._ensure_running()
        self._event.clear()
        await self._event.wait()

    # -- client API ------------------------------------------------------
    async def result(self) -> Request:
        """Wait until this request is terminal; returns the finalized
        :class:`Request` (cancelled requests return too — check ``done``)."""
        self._server._ensure_running()
        while not self.finished:
            await self._wait()
        return self.request

    async def tokens(self) -> AsyncIterator[int]:
        """Stream this request's tokens; wakes at slice boundaries."""
        self._server._ensure_running()
        cursor = 0
        while True:
            toks = self._tokens_so_far()
            while cursor < len(toks):
                yield toks[cursor]
                cursor += 1
            if self.finished:
                # the pacer may have finalized (and grown the stream)
                # while a consumer awaited between yields above — the
                # snapshot in `toks` is stale, so re-read before ending
                toks = self._tokens_so_far()
                while cursor < len(toks):
                    yield toks[cursor]
                    cursor += 1
                return
            await self._wait()

    async def slices(self) -> AsyncIterator[List[int]]:
        """Stream token chunks, one per completed slice (the scheduling
        atom) — the granularity the SSE endpoint emits."""
        self._server._ensure_running()
        cursor, mi = 0, 0
        while True:
            while mi < len(self._marks):
                mark = self._marks[mi]
                mi += 1
                if mark > cursor:
                    yield list(self._tokens_so_far()[cursor:mark])
                    cursor = mark
            if self.finished:
                toks = self._tokens_so_far()
                if len(toks) > cursor:
                    yield list(toks[cursor:])
                return
            await self._wait()

    def cancel(self) -> bool:
        """Cancel this request — queued: immediate; in flight: at the next
        slice/lease boundary (page envelope freed there)."""
        return self._server.cancel(self.rid)


class AsyncSliceServer:
    """Concurrent submit / stream / cancel front end — module docstring."""

    def __init__(self, core: SchedulerCore,
                 admission: Optional[AdmissionController] = None,
                 default_slo_ms: Optional[float] = None,
                 time_scale: Optional[float] = None):
        if time_scale is not None:
            if time_scale <= 0:
                raise ValueError(f"time_scale must be positive, got {time_scale}")
            if not isinstance(core.backend, SimBackend):
                raise ValueError(
                    "wall-clock pacing maps virtual to wall time, which only "
                    "the sim backend has; the real backend's engines consume "
                    "wall time inside step() already (use time_scale=None)")
        self.core = core
        self.admission = admission if admission is not None \
            else AdmissionController()
        self.default_slo_ms = default_slo_ms
        self._time_scale = time_scale
        self._next_rid = itertools.count(_SERVER_RID_BASE)
        self._next_sid = itertools.count(1)
        self._handles: dict[int, AsyncRequestHandle] = {}
        self._closed = False
        # pacer machinery (bound lazily to the first running loop we see)
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._wall_t0: Optional[float] = None
        self._wake = asyncio.Event()
        self._idle = asyncio.Event()
        self._pacer_exc: Optional[BaseException] = None
        # admission accounting (mirrors core.n_rejected for convenience)
        self.n_submitted = 0
        self.n_degraded = 0
        core.add_observer(self._on_core_event)

    # ------------------------------------------------------------------
    @property
    def strategy(self) -> StrategyConfig:
        return self.core.s

    @property
    def now(self) -> float:
        return self.core.now

    @property
    def n_rejected(self) -> int:
        return self.core.n_rejected

    @property
    def admission_stats(self) -> dict:
        return dict(n_submitted=self.n_submitted,
                    n_rejected=self.core.n_rejected,
                    n_degraded=self.n_degraded,
                    reject_reasons=dict(self.core.reject_reasons))

    # ------------------------------------------------------------------
    # submission (synchronous on purpose: one loop, no interleaving
    # between admission check and core mutation)
    # ------------------------------------------------------------------
    def submit(self, prompt: Optional[np.ndarray] = None, *,
               input_len: Optional[int] = None,
               gen_len: Optional[int] = None,
               max_gen: int = 1024,
               arrival: Optional[float] = None,
               slo_ms: Optional[float] = None,
               deadline: Optional[float] = None,
               allow_degrade: bool = False,
               session_id: Optional[int] = None) -> AsyncRequestHandle:
        """Admit one request; returns a handle immediately.

        ``slo_ms`` sets ``deadline = arrival + slo_ms / 1000`` in core
        time (virtual seconds on the sim backend — wall seconds when paced
        at ``time_scale=1``).  A request whose predicted completion
        violates the deadline raises
        :class:`~repro_torch.serving.admission.AdmissionRejected` *before* any
        page reservation or prefill; with ``allow_degrade=True`` it is
        instead admitted with the longest generation budget that still
        meets the deadline (when one exists).
        """
        if self._closed:
            raise RuntimeError("server is closed")
        if prompt is None and input_len is None:
            raise ValueError("need a prompt or an input_len")
        if prompt is not None:
            prompt = np.asarray(prompt, np.int32)
            if input_len is None:
                input_len = int(prompt.shape[0])
        input_len = int(input_len)
        arrival_t = self._arrival_now() if arrival is None else float(arrival)
        if slo_ms is None:
            slo_ms = self.default_slo_ms
        deadline_t = deadline if deadline is not None else (
            arrival_t + slo_ms / 1e3 if slo_ms is not None else None)
        declared = (min(int(gen_len), int(max_gen))
                    if gen_len is not None else int(max_gen))

        decision = self.admission.decide(
            self.core, input_len=input_len, declared_gen=declared,
            arrival=arrival_t, deadline=deadline_t,
            allow_degrade=allow_degrade)
        if not decision.accept:
            self.core.n_rejected += 1
            code = decision.reason_code or "other"
            self.core.reject_reasons[code] = \
                self.core.reject_reasons.get(code, 0) + 1
            if self.core.obs.enabled:
                # rejects carry rid=None — none was ever assigned
                self.core.obs.on_admission(
                    self.core, decision, input_len=input_len,
                    declared_gen=declared, deadline=deadline_t)
            raise AdmissionRejected(decision)
        if decision.action == "degrade":
            self.n_degraded += 1
            max_gen = decision.max_gen
            if gen_len is not None:
                gen_len = min(int(gen_len), max_gen)

        rid = next(self._next_rid)
        while rid in self.core._by_rid:  # replay() may have taken ids
            rid = next(self._next_rid)
        if self.core.obs.enabled:
            self.core.obs.on_admission(
                self.core, decision, input_len=input_len,
                declared_gen=declared, deadline=deadline_t, rid=rid)
        req = Request(rid=rid, arrival=arrival_t, input_len=input_len,
                      gen_len=None if gen_len is None else int(gen_len),
                      max_gen=int(max_gen), prompt=prompt,
                      deadline=deadline_t, session_id=session_id)
        self.core.submit(req)
        self.n_submitted += 1
        h = AsyncRequestHandle(self, req)
        self._handles[rid] = h
        self._kick()
        return h

    def replay(self, requests: Sequence[Request]) -> List[AsyncRequestHandle]:
        """Submit pre-built trace requests (mutated in place, like the
        legacy ``run()`` path).  Trace replay bypasses admission — it
        reproduces recorded workloads, deadlines and all."""
        if self._closed:
            raise RuntimeError("server is closed")
        handles = []
        for r in requests:
            self.core.submit(r)
            self.n_submitted += 1
            h = AsyncRequestHandle(self, r)
            self._handles[r.rid] = h
            handles.append(h)
        self._kick()
        return handles

    def cancel(self, rid: int) -> bool:
        out = self.core.cancel(rid)
        self._kick()
        return out

    # ------------------------------------------------------------------
    # multi-turn sessions
    # ------------------------------------------------------------------
    def session(self, session_id: Optional[int] = None, *,
                max_gen: int = 1024,
                slo_ms: Optional[float] = None) -> "Session":
        """Open a multi-turn :class:`Session`.  Each turn is one ordinary
        request carrying the whole conversation so far as its prompt; on
        the real retain-mode backend the previous turn's KV pages are
        anchored per session, so the next turn's shared prefix becomes a
        refcounted page-table join instead of a re-prefill."""
        if session_id is None:
            session_id = next(self._next_sid)
        return Session(self, int(session_id), max_gen=max_gen, slo_ms=slo_ms)

    def release_session(self, session_id: int) -> None:
        """Drop the backend's page anchor for ``session_id`` (no-op on
        backends without retention)."""
        self.core.backend.release_session(int(session_id))

    def check_admission(self, *, input_len: int, gen_len: Optional[int] = None,
                        max_gen: int = 1024,
                        slo_ms: Optional[float] = None) -> AdmissionDecision:
        """Dry-run the admission decision for a prospective request
        without submitting (used by load shedders and tests)."""
        arrival_t = self._arrival_now()
        declared = (min(int(gen_len), int(max_gen))
                    if gen_len is not None else int(max_gen))
        deadline_t = arrival_t + slo_ms / 1e3 if slo_ms is not None else None
        return self.admission.decide(self.core, input_len=int(input_len),
                                     declared_gen=declared, arrival=arrival_t,
                                     deadline=deadline_t)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def drain(self, duration: Optional[float] = None) -> RunMetrics:
        """Wait until every event (including paced future arrivals) has
        been processed; returns the run metrics so far."""
        if self._pacer_exc is not None:  # before _ensure_running clears it
            raise self._pacer_exc
        self._ensure_running()
        while self.core._events:
            if self._pacer_exc is not None:
                raise self._pacer_exc
            self._idle.clear()
            await self._idle.wait()
        if self._pacer_exc is not None:
            raise self._pacer_exc
        return self.core.metrics(duration)

    async def close(self, duration: Optional[float] = None) -> RunMetrics:
        """Drain, refuse further submissions, and stop the pacer task."""
        m = await self.drain(duration)
        self._closed = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        return m

    def metrics(self, duration: Optional[float] = None) -> RunMetrics:
        return self.core.metrics(duration)

    async def __aenter__(self) -> "AsyncSliceServer":
        self._ensure_running()
        return self

    async def __aexit__(self, *exc: object) -> None:
        if exc == (None, None, None):
            await self.close()
        elif self._task is not None:  # on error, don't mask it by draining
            self._task.cancel()

    # ------------------------------------------------------------------
    # pacer internals
    # ------------------------------------------------------------------
    def _on_core_event(self, kind: str, req: Request) -> None:
        h = self._handles.get(req.rid)
        if h is not None:
            h._pulse(kind)
            if kind == "final":
                # terminal: the handle works standalone from here (state
                # lives on the request/core), so drop our reference — a
                # serve-forever deployment must not accumulate one entry
                # per request ever served
                del self._handles[req.rid]

    def _arrival_now(self) -> float:
        """Current time for a new submission: the wall clock mapped back
        to virtual time when paced, else the core's clock."""
        if self._time_scale is not None and self._wall_t0 is not None \
                and self._loop is not None:
            mapped = (self._loop.time() - self._wall_t0) * self._time_scale
            return max(self.core.now, mapped)
        return self.core.now

    def _kick(self) -> None:
        """Wake the pacer after a submission/cancellation (no-op when no
        loop is running — the sync adapter drives the core itself)."""
        self._idle.clear()
        self._wake.set()
        self._ensure_running()

    def _ensure_running(self) -> None:
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # sync context: SliceServer steps the core directly
        if self._task is not None and self._task.done():
            if not self._task.cancelled():
                # retrieve the exception (it was already delivered to every
                # waiter via _pacer_exc at crash time) so asyncio doesn't
                # log "exception was never retrieved"
                self._task.exception()
            self._task = None
        if self._task is None and not self._closed:
            self._loop = loop
            if self._wall_t0 is None:
                self._wall_t0 = loop.time()
            # a fresh pacer starts clean: the old failure was surfaced to
            # its contemporaries, and a sticky exception would poison
            # every future (healthy) request forever
            self._pacer_exc = None
            self._task = loop.create_task(self._pace(),
                                          name="AsyncSliceServer.pacer")

    def _check_progress(self, req: Request) -> None:
        if self._pacer_exc is not None:
            raise self._pacer_exc
        if not self.core._events and not self.core.is_finalized(req.rid):
            raise RuntimeError(
                f"request {req.rid} cannot make progress: the event "
                f"queue is empty but it never finalized")

    async def _pace(self) -> None:
        """THE stepping task: the only caller of ``core.step()`` while the
        server is live, so core transitions never interleave."""
        core = self.core
        while True:
            if not core._events:
                self._idle.set()
                # wake any waiter stuck on a request that can no longer
                # progress (its next _wait() raises, same contract as the
                # sync reactor)
                for h in self._handles.values():
                    if not h.finished:
                        h._event.set()
                self._wake.clear()
                await self._wake.wait()
                continue
            if self._time_scale is not None:
                t_next = core._events[0][0]
                delay = (self._wall_t0 + t_next / self._time_scale
                         - self._loop.time())
                if delay > 0:
                    self._wake.clear()
                    try:  # a submit/cancel may preempt with earlier work
                        await asyncio.wait_for(self._wake.wait(), delay)
                    except asyncio.TimeoutError:
                        pass
                    continue  # re-evaluate the earliest event either way
            try:
                core.step()
            except BaseException as e:
                # a failed step would otherwise strand every waiter on an
                # event that never fires: record it, wake everyone (their
                # next _wait()/drain() re-raises), and die loudly
                self._pacer_exc = e
                for h in self._handles.values():
                    h._event.set()
                self._idle.set()
                raise
            await asyncio.sleep(0)  # let clients run between transitions


class Session:
    """One multi-turn conversation over an :class:`AsyncSliceServer`.

    A session is a thin client-side convention plus a server-side page
    anchor: every turn is an ordinary request whose prompt is the whole
    conversation so far (history + new user tokens), tagged with this
    session's id.  Schedulers never see sessions — only the real
    retain-mode backend reads the tag, to keep the finished turn's prefix
    pages resident so the next turn's history prefix becomes a refcounted
    page-table join (``PageAllocator.share``) instead of a re-prefill.
    On the sim backend a session still composes correctly (turn prompts
    grow by the accumulated length); there is just no KV to share.

    ``submit_turn`` may be called while the previous turn is still in
    flight — even mid-slice — in which case it awaits that turn's result
    first, so history is always complete before the next prompt is built.

    Close (or ``async with``) cancels any in-flight turn and drops the
    backend anchor, returning the session's pages to the free pool.
    """

    def __init__(self, server: AsyncSliceServer, session_id: int, *,
                 max_gen: int = 1024, slo_ms: Optional[float] = None):
        self._server = server
        self.session_id = int(session_id)
        self.default_max_gen = int(max_gen)
        self.default_slo_ms = slo_ms
        self._history_tokens: Optional[np.ndarray] = None  # real backend
        self._history_len = 0
        self._last: Optional[AsyncRequestHandle] = None
        self._closed = False
        self.n_turns = 0

    # ------------------------------------------------------------------
    @property
    def history_len(self) -> int:
        """Tokens of conversation context the *next* turn will carry
        (completed turns only — an in-flight turn is not yet absorbed)."""
        return self._history_len

    @property
    def history_tokens(self) -> Optional[List[int]]:
        """Token-level history (real backend; ``None`` in length-only
        sim sessions that never saw a prompt array)."""
        return None if self._history_tokens is None \
            else list(self._history_tokens)

    @property
    def last(self) -> Optional[AsyncRequestHandle]:
        """Handle of the most recently submitted turn, if any."""
        return self._last

    # ------------------------------------------------------------------
    def _absorb_last(self) -> None:
        """Fold the finished previous turn into history.  Cancelled turns
        are dropped (their pages were freed; history stays pre-turn)."""
        h = self._last
        self._last = None
        if h is None or not h.request.done or h.request.cancelled:
            return
        if h.request.prompt is not None:
            self._history_tokens = np.concatenate(
                [np.asarray(h.request.prompt, np.int32),
                 np.asarray(h.output_tokens, np.int32)])
            self._history_len = int(self._history_tokens.shape[0])
        else:
            self._history_len = h.request.input_len + h.request.generated

    async def submit_turn(self, prompt: Optional[np.ndarray] = None, *,
                          input_len: Optional[int] = None,
                          gen_len: Optional[int] = None,
                          max_gen: Optional[int] = None,
                          slo_ms: Optional[float] = None,
                          allow_degrade: bool = False
                          ) -> AsyncRequestHandle:
        """Submit the next turn: ``prompt`` (real) or ``input_len`` (sim)
        is the *new* user message only — the accumulated history is
        prepended here.  Raises
        :class:`~repro_torch.serving.admission.AdmissionRejected` like
        ``submit`` (the session survives; retry or close)."""
        if self._closed:
            raise RuntimeError("session is closed")
        if prompt is None and input_len is None:
            raise ValueError("need a prompt or an input_len")
        if self._last is not None and not self._last.finished:
            await self._last.result()
        self._absorb_last()
        total_len = None
        if prompt is not None:
            prompt = np.asarray(prompt, np.int32)
            if self._history_tokens is not None:
                prompt = np.concatenate([self._history_tokens, prompt])
        else:
            total_len = self._history_len + int(input_len)
        h = self._server.submit(
            prompt, input_len=total_len, gen_len=gen_len,
            max_gen=self.default_max_gen if max_gen is None else int(max_gen),
            slo_ms=self.default_slo_ms if slo_ms is None else slo_ms,
            allow_degrade=allow_degrade, session_id=self.session_id)
        self._last = h
        self.n_turns += 1
        return h

    async def close(self) -> None:
        """Cancel any in-flight turn and release the backend anchor."""
        if self._closed:
            return
        self._closed = True
        h = self._last
        if h is not None and not h.finished:
            h.cancel()
            await h.result()
        self._server.release_session(self.session_id)

    async def __aenter__(self) -> "Session":
        return self

    async def __aexit__(self, *exc: object) -> None:
        await self.close()
