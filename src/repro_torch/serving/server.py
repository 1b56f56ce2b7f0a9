"""Synchronous request-level serving API over one :class:`SchedulerCore`.

``SliceServer`` is the caller-driven flavor of the online API: every
``tokens()`` / ``result()`` / ``drain()`` call advances the shared event
queue, which makes it deterministic and perfect for tests, offline
replays, and single-client scripts::

    server = ServingConfig(strategy="scls", workers=4).build_sim()
    h = server.submit(input_len=64, gen_len=200)
    for tok in h.tokens():          # streams per-slice, driving the core
        ...
    h2 = server.submit(input_len=32, gen_len=500)
    h2.cancel()                     # frees its page envelope mid-flight
    server.drain()                  # completes all in-flight work

It is a thin adapter over
:class:`~repro_torch.serving.aio.AsyncSliceServer` (exposed as ``.aio``): the
submission path — validation, rid allocation, SLO-aware admission
(``slo_ms=`` raises :class:`~repro_torch.serving.admission.AdmissionRejected`
before any prefill/page work), handle bookkeeping — lives exactly once in
the async server, and this class only adds the synchronous drive loop.
For N concurrent clients, wall-clock pacing, or the OpenAI-compatible
HTTP endpoint, use ``server.aio`` (``repro_torch.serving.aio``) directly.

Online arrivals enter the exact same batching/offloading algorithms
(Alg. 1–2) the offline path uses — there is no second scheduler.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np

from repro_torch.cluster.metrics import RunMetrics
from repro_torch.core.request import Request
from repro_torch.core.schedulers import StrategyConfig
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.aio import (_SERVER_RID_BASE, AsyncSliceServer,
                                     RequestView)
from repro_torch.serving.core import SchedulerCore

__all__ = ["RequestHandle", "SliceServer", "_SERVER_RID_BASE"]


class RequestHandle(RequestView):
    """Live view of one submitted request (synchronous drive methods)."""

    def tokens(self) -> Iterator[int]:
        """Stream this request's tokens as slices complete.

        Tokens materialize at slice boundaries (a slice is the atom of
        scheduling); the iterator advances the server's event queue while
        it waits, so consuming it also serves everything else in flight.
        On the sim backend token ids are synthetic generation indices.
        """
        cursor = 0
        while True:
            toks = self._tokens_so_far()
            while cursor < len(toks):
                yield toks[cursor]
                cursor += 1
            if self.finished:
                return
            if not self._server.core.step():  # same contract as result()
                raise RuntimeError(
                    f"request {self.rid} cannot make progress: the event "
                    f"queue is empty but it never finalized")

    def result(self) -> Request:
        """Drive the server until this request is terminal; returns the
        finalized :class:`Request` (tokens in ``output_tokens``)."""
        while not self.finished:
            if not self._server.core.step():
                raise RuntimeError(
                    f"request {self.rid} cannot make progress: the event "
                    f"queue is empty but it never finalized")
        return self.request

    def cancel(self) -> bool:
        """Cancel this request — see :meth:`SchedulerCore.cancel`."""
        return self._server.cancel(self.rid)


class SliceServer:
    """Submit / stream / cancel front end over one shared SchedulerCore.

    Thin synchronous adapter over :class:`AsyncSliceServer` (``.aio``):
    submission/admission/bookkeeping are delegated; only the drive loop
    (``step`` / blocking ``drain``) is this class's own.
    """

    def __init__(self, core: SchedulerCore,
                 admission: Optional[AdmissionController] = None,
                 default_slo_ms: Optional[float] = None,
                 time_scale: Optional[float] = None):
        self.core = core
        #: the concurrent front end this server adapts; share it with
        #: asyncio clients or the HTTP endpoint for the same scheduler
        self.aio = AsyncSliceServer(core, admission=admission,
                                    default_slo_ms=default_slo_ms,
                                    time_scale=time_scale)
        self._handles: dict[int, RequestHandle] = {}

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
        return self.aio.admission_stats

    # ------------------------------------------------------------------
    def submit(self, prompt: Optional[np.ndarray] = None, *,
               input_len: Optional[int] = None,
               gen_len: Optional[int] = None,
               max_gen: int = 1024,
               arrival: Optional[float] = None,
               slo_ms: Optional[float] = None,
               deadline: Optional[float] = None,
               allow_degrade: bool = False) -> RequestHandle:
        """Submit one request; returns a handle immediately.

        ``prompt`` (token ids) is required on the real backend and
        optional on the sim backend (``input_len`` suffices there).
        ``gen_len`` emulates a known EOS position — the repo-wide
        controlled-replay convention; pass None to decode until the
        model's own EOS (real backend) or ``max_gen`` (sim backend).
        ``arrival`` defaults to the server's current virtual time.
        ``slo_ms``/``deadline`` enable SLO-aware admission: a request
        whose predicted completion violates the deadline raises
        :class:`~repro_torch.serving.admission.AdmissionRejected` before any
        prefill or page reservation (see :meth:`AsyncSliceServer.submit`).
        """
        ah = self.aio.submit(prompt, input_len=input_len, gen_len=gen_len,
                             max_gen=max_gen, arrival=arrival, slo_ms=slo_ms,
                             deadline=deadline, allow_degrade=allow_degrade)
        h = RequestHandle(self, ah.request)
        self._handles[h.rid] = h
        return h

    def replay(self, requests: Sequence[Request]) -> List[RequestHandle]:
        """Submit pre-built trace requests (mutated in place, like the
        legacy ``run()`` path — deep-copy the trace to keep it)."""
        handles = []
        for ah in self.aio.replay(requests):
            h = RequestHandle(self, ah.request)
            self._handles[h.rid] = h
            handles.append(h)
        return handles

    # ------------------------------------------------------------------
    def cancel(self, rid: int) -> bool:
        return self.aio.cancel(rid)

    def step(self) -> bool:
        """Advance the shared event queue by one event."""
        return self.core.step()

    def drain(self, duration: Optional[float] = None) -> RunMetrics:
        """Complete all in-flight work; returns the run metrics so far."""
        self.core.run_until_idle()
        return self.core.metrics(duration)

    def metrics(self, duration: Optional[float] = None) -> RunMetrics:
        return self.core.metrics(duration)

    def close(self, duration: Optional[float] = None) -> RunMetrics:
        """Drain and refuse further submissions."""
        m = self.drain(duration)
        self.aio._closed = True
        return m

    # ------------------------------------------------------------------
    def __enter__(self) -> "SliceServer":
        return self

    def __exit__(self, *exc: object) -> None:
        if exc == (None, None, None):
            self.close()
        # on error, don't mask it by draining
