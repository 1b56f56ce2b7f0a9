"""``repro_torch.obs`` — observability for the slice-level serving stack.

Three pillars (see ``docs/observability.md``):

  1. **Tracing** (:mod:`repro_torch.obs.trace`) — Chrome trace-event spans /
     instants / counter tracks, exported as Perfetto-loadable JSON;
  2. **Metrics** (:mod:`repro_torch.obs.metrics`) — dependency-free
     Prometheus-style registry (the HTTP front end,
     :mod:`repro_torch.serving.http`, serves it at ``GET /metrics``);
  3. **Decision audit** (:mod:`repro_torch.obs.audit`) — ring-buffered
     structured records of every admission / batching / offload decision,
     queryable through ``DecisionLog.query`` and dumped by ``--trace-out``.

:class:`repro_torch.obs.Observability` bundles all three and implements the
scheduler hooks; ``Observability.off()`` is the shared disabled bundle.
"""
from repro_torch.obs.audit import DecisionLog
from repro_torch.obs.hub import (OBS_OFF, Observability, ServingInstruments,
                                 decisions_path_for)
from repro_torch.obs.metrics import (DEFAULT_TIME_BUCKETS,
                                     DEFAULT_TOKEN_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry)
from repro_torch.obs.trace import (NULL_TRACER, PID_REQUESTS, PID_SCHED,
                                   TID_CONTROL, Tracer, worker_tid)

__all__ = [
    "DecisionLog",
    "Observability",
    "ServingInstruments",
    "OBS_OFF",
    "decisions_path_for",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "DEFAULT_TIME_BUCKETS",
    "DEFAULT_TOKEN_BUCKETS",
    "Tracer",
    "NULL_TRACER",
    "PID_SCHED",
    "PID_REQUESTS",
    "TID_CONTROL",
    "worker_tid",
]
