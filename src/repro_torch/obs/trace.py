"""Chrome trace-event tracer for the serving stack (``repro_torch.obs`` pillar 1).

Records *spans* (``ph="X"`` complete events), *instants* (``ph="i"``),
*async request-lifecycle spans* (``ph="b"``/``"e"``, one per rid), and
*counter tracks* (``ph="C"``) in the Chrome trace-event JSON format, so a
``trace.json`` exported here loads directly in Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing``.

Timeline convention: every timestamp is **core time** — the scheduler's
discrete-event clock.  On the sim backend that is virtual time, so the
trace visualizes the discrete-event timeline exactly; on the real backend
core time advances by the *measured wall time* of each worker's own
batches (what N parallel machines would observe), and the prefill/decode
sub-spans inside a slice come from wall-clock timed sections in
``StaticEngine``/``RealBackend``.  Durations are therefore real wall
durations on the real backend and model durations on the sim backend.

Overhead discipline: tracing must never perturb scheduling (the golden
dispatch logs are asserted bit-exact with tracing on) and must cost near
zero when disabled.  The disabled tracer is :data:`NULL_TRACER` — every
method is a no-op ``pass`` and hot paths guard bulk work behind
``tracer.enabled``.  Nothing in this module draws randomness or reads
wall clocks on the sim path, so same seed ⇒ byte-identical trace.

Track layout (Perfetto rows):

  * pid 1 ("scheduler") / tid 0 ("control") — arrivals, admission
    verdicts, scheduling ticks;
  * pid 1 / tid 100+w ("worker w") — per-worker slice spans with nested
    prefill/decode sections;
  * counter tracks (pid 1): ``queue_depth``, ``in_flight_slices``,
    ``free_pages``, ``retained_blocks``;
  * pid 2 ("requests") — async lifecycle spans, one per rid
    (arrival → finalize), carrying the terminal outcome.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Tuple

__all__ = ["Tracer", "NULL_TRACER", "PID_SCHED", "PID_REQUESTS",
           "TID_CONTROL", "worker_tid"]

#: process ids of the two Perfetto "processes" (see module docstring)
PID_SCHED = 1
PID_REQUESTS = 2
#: tid of the scheduler control track (arrivals / ticks / admission)
TID_CONTROL = 0
_TID_WORKER_BASE = 100


def worker_tid(wid: int) -> int:
    """Trace thread id of worker ``wid`` (its Perfetto row)."""
    return _TID_WORKER_BASE + int(wid)


def _us(t: float) -> float:
    """Seconds → trace microseconds, rounded so exports are stable across
    platforms (0.1 ns granularity is far below any modeled duration)."""
    return round(t * 1e6, 4)


class Tracer:
    """Collects trace events against a pluggable clock.

    ``clock`` returns the current time in seconds; the serving stack binds
    it to ``SchedulerCore.now`` (see :meth:`repro_torch.obs.hub.Observability.
    attach`) so all events share the core timeline.  Construct, attach,
    run, then :meth:`export` / :meth:`to_dict`.
    """

    #: hot paths may skip argument marshalling when this is False
    enabled: bool = True

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self._clock: Callable[[], float] = clock or (lambda: 0.0)
        self._events: List[dict] = []
        #: (pid, tid) -> row name; rendered as metadata events on export
        self._tracks: Dict[Tuple[int, int], str] = {
            (PID_SCHED, TID_CONTROL): "control"}
        self._process_names: Dict[int, str] = {PID_SCHED: "scheduler",
                                               PID_REQUESTS: "requests"}

    # ------------------------------------------------------------------
    # clock / track plumbing
    # ------------------------------------------------------------------
    def set_clock(self, clock: Callable[[], float]) -> None:
        self._clock = clock

    @property
    def now(self) -> float:
        """Current trace time in seconds (the bound clock)."""
        return self._clock()

    def declare_worker(self, wid: int) -> int:
        """Name worker ``wid``'s track; returns its tid."""
        tid = worker_tid(wid)
        self._tracks.setdefault((PID_SCHED, tid), f"worker {wid}")
        return tid

    # ------------------------------------------------------------------
    # event emitters (all timestamps in seconds; stored as trace µs)
    # ------------------------------------------------------------------
    def complete(self, name: str, ts: float, dur: float, *,
                 tid: int = TID_CONTROL, cat: str = "sched",
                 args: Optional[dict] = None) -> None:
        """A span ``[ts, ts+dur]`` on one track (``ph="X"``)."""
        ev = dict(name=name, ph="X", ts=_us(ts), dur=_us(max(dur, 0.0)),
                  pid=PID_SCHED, tid=tid, cat=cat)
        if args:
            ev["args"] = args
        self._events.append(ev)

    def instant(self, name: str, ts: Optional[float] = None, *,
                tid: int = TID_CONTROL, cat: str = "sched",
                args: Optional[dict] = None) -> None:
        """A zero-duration marker (``ph="i"``, thread-scoped)."""
        ev = dict(name=name, ph="i", s="t",
                  ts=_us(self._clock() if ts is None else ts),
                  pid=PID_SCHED, tid=tid, cat=cat)
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, name: str, value: float,
                ts: Optional[float] = None) -> None:
        """One sample on counter track ``name`` (``ph="C"``)."""
        self._events.append(dict(
            name=name, ph="C", ts=_us(self._clock() if ts is None else ts),
            pid=PID_SCHED, tid=TID_CONTROL, cat="counter",
            args={name: value}))

    def async_begin(self, name: str, aid: int, ts: Optional[float] = None,
                    *, cat: str = "request",
                    args: Optional[dict] = None) -> None:
        """Open async span ``aid`` (``ph="b"``) on the requests process."""
        ev = dict(name=name, ph="b", id=int(aid), cat=cat,
                  ts=_us(self._clock() if ts is None else ts),
                  pid=PID_REQUESTS, tid=TID_CONTROL)
        if args:
            ev["args"] = args
        self._events.append(ev)

    def async_end(self, name: str, aid: int, ts: Optional[float] = None,
                  *, cat: str = "request",
                  args: Optional[dict] = None) -> None:
        """Close async span ``aid`` (``ph="e"``)."""
        ev = dict(name=name, ph="e", id=int(aid), cat=cat,
                  ts=_us(self._clock() if ts is None else ts),
                  pid=PID_REQUESTS, tid=TID_CONTROL)
        if args:
            ev["args"] = args
        self._events.append(ev)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        self._events.clear()

    def to_dict(self) -> dict:
        """The Chrome trace-event JSON object (``{"traceEvents": [...]}``).

        Metadata events naming processes/threads are prepended so Perfetto
        labels every row; event order within the list is the deterministic
        emission order (the viewer sorts by ``ts`` anyway).
        """
        meta: List[dict] = []
        for pid, pname in sorted(self._process_names.items()):
            meta.append(dict(name="process_name", ph="M", pid=pid, tid=0,
                             args={"name": pname}))
        for (pid, tid), tname in sorted(self._tracks.items()):
            meta.append(dict(name="thread_name", ph="M", pid=pid, tid=tid,
                             args={"name": tname}))
            # thread_sort_index keeps worker rows in wid order
            meta.append(dict(name="thread_sort_index", ph="M", pid=pid,
                             tid=tid, args={"sort_index": tid}))
        return {"traceEvents": meta + self._events,
                "displayTimeUnit": "ms"}

    def to_json(self) -> str:
        """Deterministic serialization (same events ⇒ same bytes)."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())


class _NullTracer(Tracer):
    """The disabled tracer: every emitter is a no-op ``pass`` so traced
    call sites cost one attribute lookup + an empty call when tracing is
    off (plus most sites guard on ``tracer.enabled`` and skip argument
    construction entirely)."""

    enabled = False

    def __init__(self):
        super().__init__()

    def set_clock(self, clock) -> None:  # noqa: D102 — no-op family
        pass

    def declare_worker(self, wid: int) -> int:
        return worker_tid(wid)

    def complete(self, *a, **kw) -> None:
        pass

    def instant(self, *a, **kw) -> None:
        pass

    def counter(self, *a, **kw) -> None:
        pass

    def async_begin(self, *a, **kw) -> None:
        pass

    def async_end(self, *a, **kw) -> None:
        pass


#: the shared disabled tracer (stateless — safe to share everywhere)
NULL_TRACER = _NullTracer()
