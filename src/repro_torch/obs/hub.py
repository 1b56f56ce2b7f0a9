"""Observability hub: wiring the three ``repro_torch.obs`` pillars into the
serving stack.

:class:`Observability` bundles a :class:`~repro_torch.obs.trace.Tracer`, a
:class:`~repro_torch.obs.metrics.MetricsRegistry` (plus the pre-declared
serving instruments), and a :class:`~repro_torch.obs.audit.DecisionLog`, and
implements every scheduler hook as a method — ``SchedulerCore`` only ever
does ``if self.obs.enabled: self.obs.on_dispatch(...)``, so the hot path
costs one attribute read and a bool test when observability is off, and
all emission logic lives here, not in the scheduler.

The cardinal rule is **zero scheduling perturbation**: every hook reads
scheduler state, none mutates it, and nothing here draws randomness —
the golden dispatch logs are asserted bit-exact with full observability
enabled (``tests/test_torch_obs.py``).

Construction:

  * ``Observability.off()`` — the shared disabled instance (the default
    for a bare ``SchedulerCore``; offline paper replays pay nothing);
  * ``Observability.standard(trace=...)`` — metrics + decision audit
    always, Chrome tracing when ``trace=True`` (what ``ServingConfig``
    builds for servers).

Metric catalog (all ``scls_`` namespaced; catalog with units in
``docs/observability.md``):

  histograms  ``scls_ttft_seconds``, ``scls_response_seconds``,
              ``scls_slice_seconds``
  counters    ``scls_slices_dispatched_total``,
              ``scls_requests_total{outcome}``,
              ``scls_admission_total{action,reason}``,
              ``scls_reprefill_tokens_total``,
              ``scls_prefix_hit_tokens_total``
  gauges      ``scls_queue_depth``, ``scls_in_flight_slices``,
              ``scls_kv_free_pages``, ``scls_kv_retained_blocks``,
              ``scls_kv_evictions``, ``scls_kv_shared_blocks``
"""
from __future__ import annotations

import json
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.audit import DecisionLog
from repro_torch.obs.metrics import (DEFAULT_TIME_BUCKETS, DEFAULT_TOKEN_BUCKETS,
                                     MetricsRegistry)
from repro_torch.obs.trace import NULL_TRACER, Tracer

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.request import Batch, Request
    from repro_torch.serving.admission import AdmissionDecision
    from repro_torch.serving.core import SchedulerCore

__all__ = ["Observability", "ServingInstruments", "OBS_OFF",
           "decisions_path_for"]


def decisions_path_for(trace_path: str) -> str:
    """Sibling path of the decision-audit dump for ``--trace-out PATH``
    (``trace.json`` → ``trace.decisions.json``)."""
    if trace_path.endswith(".json"):
        return trace_path[:-len(".json")] + ".decisions.json"
    return trace_path + ".decisions.json"


class ServingInstruments:
    """The serving stack's pre-declared metrics (see module docstring)."""

    def __init__(self, registry: MetricsRegistry):
        self.registry = registry
        self.ttft = registry.histogram(
            "scls_ttft_seconds",
            "Time to first token in core seconds (slice-granular)",
            buckets=DEFAULT_TIME_BUCKETS)
        self.response = registry.histogram(
            "scls_response_seconds",
            "End-to-end response latency in core seconds",
            buckets=DEFAULT_TIME_BUCKETS)
        self.slice_time = registry.histogram(
            "scls_slice_seconds",
            "Execution time of one dispatched slice in core seconds",
            buckets=DEFAULT_TIME_BUCKETS)
        self.reprefill_hist = registry.histogram(
            "scls_slice_reprefill_tokens",
            "Re-prefilled tokens per dispatched slice (paper section 3.3)",
            buckets=DEFAULT_TOKEN_BUCKETS)
        self.slices = registry.counter(
            "scls_slices_dispatched_total",
            "Dispatched slices (static batches and continuous spans)")
        self.requests = registry.counter(
            "scls_requests_total",
            "Finalized requests by terminal outcome",
            labelnames=("outcome",))
        self.admission = registry.counter(
            "scls_admission_total",
            "Admission verdicts by action and reason code",
            labelnames=("action", "reason"))
        self.reprefill = registry.counter(
            "scls_reprefill_tokens_total",
            "Tokens re-prefilled beyond each request's first prefill")
        self.prefix_hit = registry.counter(
            "scls_prefix_hit_tokens_total",
            "Prompt tokens satisfied by a shared-prefix page join "
            "instead of prefill (COW paged KV)")
        self.queue_depth = registry.gauge(
            "scls_queue_depth",
            "Requests waiting to be dispatched (pool + worker queues)")
        self.in_flight = registry.gauge(
            "scls_in_flight_slices",
            "Slices currently executing across workers")
        self.free_pages = registry.gauge(
            "scls_kv_free_pages",
            "Free KV pages across workers (paged layout)")
        self.retained = registry.gauge(
            "scls_kv_retained_blocks",
            "Prefix KV blocks retained across slices (kv_retain=request)")
        self.evictions = registry.gauge(
            "scls_kv_evictions",
            "Cumulative resident-prefix evictions under pool pressure")
        self.shared_blocks = registry.gauge(
            "scls_kv_shared_blocks",
            "KV pages currently referenced by more than one request "
            "(refcounted prefix sharing)")


class Observability:
    """One bundle of tracer + metrics + decision audit — module docstring."""

    def __init__(self, tracer: Optional[Tracer] = None,
                 registry: Optional[MetricsRegistry] = None,
                 audit: Optional[DecisionLog] = None):
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.registry = registry
        self.ins: Optional[ServingInstruments] = (
            ServingInstruments(registry) if registry is not None else None)
        self.audit = audit
        #: the single guard scheduler hot paths test
        self.enabled = (self.tracer.enabled or registry is not None
                        or audit is not None)

    # ------------------------------------------------------------------
    @classmethod
    def off(cls) -> "Observability":
        """The shared disabled bundle (stateless; see :data:`OBS_OFF`)."""
        return OBS_OFF

    @classmethod
    def standard(cls, trace: bool = False,
                 audit_capacity: int = 4096) -> "Observability":
        """Metrics + decision audit (cheap, always useful online);
        Chrome tracing opt-in via ``trace=True``."""
        return cls(tracer=Tracer() if trace else None,
                   registry=MetricsRegistry(),
                   audit=DecisionLog(audit_capacity)
                   if audit_capacity > 0 else None)

    def attach(self, core: "SchedulerCore") -> None:
        """Bind this bundle to one scheduler: the trace clock becomes the
        core's discrete-event clock (virtual on sim; advanced by measured
        wall time on real) and the worker tracks are declared."""
        self.tracer.set_clock(lambda: core.now)
        for w in range(core.n_workers):
            self.tracer.declare_worker(w)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------
    def export(self, trace_path: str) -> List[str]:
        """Write the Chrome trace to ``trace_path`` and (when auditing)
        the decision ring next to it; returns the paths written."""
        self.tracer.export(trace_path)
        written = [trace_path]
        if self.audit is not None:
            dpath = decisions_path_for(trace_path)
            with open(dpath, "w") as f:
                json.dump(self.audit.to_list(), f, sort_keys=True)
            written.append(dpath)
        return written

    # ------------------------------------------------------------------
    # scheduler hooks (call sites guard on ``obs.enabled``)
    # ------------------------------------------------------------------
    def _sample(self, core: "SchedulerCore") -> None:
        """Refresh the load gauges + counter tracks from live state."""
        depth = len(core.pool) + sum(
            len(w.pending) + sum(b.size for b in w.queue)
            for w in core.workers)
        in_flight = sum(1 for w in core.workers if w.busy)
        tr = self.tracer
        if tr.enabled:
            tr.counter("queue_depth", depth)
            tr.counter("in_flight_slices", in_flight)
        ins = self.ins
        if ins is not None:
            ins.queue_depth.set(depth)
            ins.in_flight.set(in_flight)
        snap = getattr(core.backend, "obs_snapshot", None)
        if snap is not None:
            s = snap()
            if s:
                if tr.enabled:
                    for key in ("free_pages", "retained_blocks"):
                        if key in s:
                            tr.counter(key, s[key])
                if ins is not None:
                    if "free_pages" in s:
                        ins.free_pages.set(s["free_pages"])
                    if "retained_blocks" in s:
                        ins.retained.set(s["retained_blocks"])
                    if "evictions" in s:
                        ins.evictions.set(s["evictions"])
                    if "shared_blocks" in s:
                        ins.shared_blocks.set(s["shared_blocks"])

    def on_arrival(self, core: "SchedulerCore", req: "Request") -> None:
        tr = self.tracer
        if tr.enabled:
            tr.instant("arrival", core.now, args=dict(
                rid=req.rid, input_len=req.effective_input_len))
            tr.async_begin("request", req.rid, req.arrival, args=dict(
                rid=req.rid, input_len=req.input_len,
                max_gen=req.max_gen, deadline=req.deadline))
        self._sample(core)

    def on_admission(self, core: "SchedulerCore",
                     decision: "AdmissionDecision", *, input_len: int,
                     declared_gen: int, deadline: Optional[float],
                     rid: Optional[int] = None) -> None:
        """One admission verdict (rejects have no rid — none was ever
        assigned)."""
        reason = decision.reason_code or ""
        if self.ins is not None:
            self.ins.admission.inc(action=decision.action, reason=reason)
        if self.tracer.enabled:
            self.tracer.instant(
                f"admission:{decision.action}", core.now,
                cat="admission",
                args=dict(rid=rid, reason=reason,
                          predicted_completion=decision.predicted_completion))
        if self.audit is not None:
            self.audit.record(
                "admission", core.now, rid=rid, action=decision.action,
                reason=reason, input_len=int(input_len),
                declared_gen=int(declared_gen), deadline=deadline,
                queue_delay=decision.queue_delay,
                service_est=decision.service_est,
                gen_cap=decision.gen_cap,
                predicted_completion=decision.predicted_completion,
                max_gen=decision.max_gen)

    def on_schedule(self, core: "SchedulerCore",
                    assignments: Sequence[Tuple[int, "Batch"]],
                    loads_before: Dict[int, float]) -> None:
        """One central-tick scheduling round: audit every batch
        composition (Alg. 1) and every placement (Eq. 10–11).

        ``loads_before`` is the offloader's per-worker load snapshot taken
        *before* ``assign``; both offloaders charge ``est_time`` in
        assignment order, so replaying that bookkeeping reconstructs the
        exact loads each placement decision saw.
        """
        if self.audit is None and not self.tracer.enabled:
            return
        from repro_torch.core.batcher import batch_audit_fields
        loads = dict(loads_before)
        for w, b in assignments:
            rids = sorted(r.rid for r in b.requests)
            if self.audit is not None:
                self.audit.record("batch", core.now,
                                  **batch_audit_fields(b, core.mem))
                self.audit.record(
                    "offload", core.now, rids=rids, worker=w,
                    est_time=float(b.est_time),
                    loads={str(k): round(v, 9)
                           for k, v in sorted(loads.items())})
            if self.tracer.enabled:
                self.tracer.instant("offload", core.now, cat="offload",
                                    args=dict(worker=w, rids=rids))
            loads[w] = loads.get(w, 0.0) + float(b.est_time)
        self._sample(core)

    def on_dispatch(self, core: "SchedulerCore", wid: int, b: "Batch",
                    duration: float,
                    prefill_dur: Optional[float]) -> None:
        """One static slice dispatched: the span on the worker track plus
        prefill/decode sub-spans when the backend measured them."""
        ins = self.ins
        if ins is not None:
            ins.slices.inc()
            ins.slice_time.observe(duration)
        tr = self.tracer
        if not tr.enabled:
            return
        rids = sorted(r.rid for r in b.requests)
        tid = tr.declare_worker(wid)
        # slice index per member = completed slices so far (n_schedules
        # increments when the slice completes)
        tr.complete("slice", core.now, duration, tid=tid, cat="slice",
                    args=dict(rids=rids,
                              input_len=int(b.input_len),
                              slice_len=int(b.slice_len),
                              slice_idx={str(r.rid): r.n_schedules
                                         for r in b.requests}))
        if prefill_dur is not None:
            p = min(max(prefill_dur, 0.0), duration)
            tr.complete("prefill", core.now, p, tid=tid, cat="phase")
            tr.complete("decode", core.now + p, duration - p, tid=tid,
                        cat="phase")

    def on_slice_done(self, core: "SchedulerCore", wid: int, b: "Batch",
                      reprefill_tokens: int, prefix_hit_tokens: int = 0,
                      shared_blocks: int = 0) -> None:
        ins = self.ins
        if ins is not None:
            ins.reprefill.inc(reprefill_tokens)
            ins.reprefill_hist.observe(reprefill_tokens)
            if prefix_hit_tokens:
                ins.prefix_hit.inc(prefix_hit_tokens)
        # audit only slices where a prefix join actually happened, so
        # sharing-free runs produce byte-identical decision logs (the
        # golden-equivalence guard relies on this)
        if self.audit is not None and prefix_hit_tokens:
            self.audit.record(
                "prefix_share", core.now, worker=wid,
                rids=sorted(r.rid for r in b.requests),
                prefix_hit_tokens=int(prefix_hit_tokens),
                shared_blocks=int(shared_blocks))
        self._sample(core)

    def on_cont_dispatch(self, core: "SchedulerCore", wid: int,
                         rids: Sequence[int], duration: float) -> None:
        """One continuous-mode span (ILS iteration run / SCLS-CB lease
        span) dispatched on worker ``wid``."""
        ins = self.ins
        if ins is not None:
            ins.slices.inc()
            ins.slice_time.observe(duration)
        tr = self.tracer
        if tr.enabled:
            tid = tr.declare_worker(wid)
            tr.complete("cont", core.now, duration, tid=tid, cat="slice",
                        args=dict(rids=sorted(rids)))

    def on_cont_done(self, core: "SchedulerCore", wid: int) -> None:
        self._sample(core)

    def on_finalize(self, core: "SchedulerCore", req: "Request",
                    completed: bool) -> None:
        outcome = "completed" if completed else "cancelled"
        ins = self.ins
        if ins is not None:
            ins.requests.inc(outcome=outcome)
            if completed:
                ins.response.observe(core.now - req.arrival)
                if req.first_token_time is not None:
                    ins.ttft.observe(req.first_token_time - req.arrival)
        tr = self.tracer
        if tr.enabled:
            tr.instant("finalize", core.now, args=dict(rid=req.rid,
                                                       outcome=outcome))
            tr.async_end("request", req.rid, core.now,
                         args=dict(outcome=outcome,
                                   generated=req.generated,
                                   n_schedules=req.n_schedules))


#: the one shared disabled bundle — every hook call site guards on
#: ``obs.enabled`` so bare cores (offline paper replays, goldens) pay one
#: attribute read per hook point
OBS_OFF = Observability()
