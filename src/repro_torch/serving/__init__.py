"""repro_torch.serving — request-level online serving over one shared
scheduling loop.

One :class:`SchedulerCore` runs the scheduling loop (arrival intake →
predict → DP batch → max-min offload → slice dispatch → re-enqueue); a
backend supplies the physics (:class:`SimBackend`: calibrated latency
models in virtual time; :class:`RealBackend`: the port's engines on the
card, measured wall time).  :class:`SliceServer` (synchronous) and
:class:`AsyncSliceServer` (N concurrent clients, multi-turn
:class:`Session` s) put submit / stream / cancel and SLO-aware admission
in front of it, :class:`HTTPFrontend` (``repro_torch.serving.http``) puts
a stdlib-only OpenAI-compatible endpoint in front of the async server, and
:class:`ServingConfig` builds the whole stack.  The legacy offline entry
points (``repro_torch.cluster.simulator.ClusterSimulator``,
``repro_torch.cluster.realtime.RealCluster``) remain as thin shims over
this package.
"""
from repro_torch.serving.admission import (NO_ADMISSION, AdmissionController,
                                           AdmissionDecision,
                                           AdmissionRejected,
                                           predicted_queue_delay,
                                           predicted_service_time)
from repro_torch.serving.aio import (AsyncRequestHandle, AsyncSliceServer,
                                     Session)
from repro_torch.serving.backends import (Backend, BatchExecution,
                                          RealBackend, SimBackend)
from repro_torch.serving.config import (SERVABLE_REAL, ServingConfig,
                                        default_sim_environment,
                                        fitted_estimator)
from repro_torch.serving.core import SchedulerCore, WorkerState
from repro_torch.serving.http import HTTPFrontend
from repro_torch.serving.server import RequestHandle, SliceServer

__all__ = [
    "AdmissionController", "AdmissionDecision", "AdmissionRejected",
    "AsyncRequestHandle", "AsyncSliceServer", "Backend", "BatchExecution",
    "HTTPFrontend", "NO_ADMISSION", "RealBackend", "RequestHandle", "SERVABLE_REAL",
    "SchedulerCore", "ServingConfig", "Session", "SimBackend", "SliceServer",
    "WorkerState", "default_sim_environment", "fitted_estimator",
    "predicted_queue_delay", "predicted_service_time",
]
