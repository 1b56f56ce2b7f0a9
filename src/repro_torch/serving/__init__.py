"""repro_torch.serving — the scheduling core and its execution backends.

One :class:`SchedulerCore` runs the scheduling loop (arrival intake →
DP batch → max-min offload → slice dispatch → re-enqueue); a backend
supplies the physics (:class:`SimBackend`: calibrated latency models in
virtual time; :class:`RealBackend`: the port's engines on the card,
measured wall time).
"""
from repro_torch.serving.backends import (Backend, BatchExecution,
                                          RealBackend, SimBackend)
from repro_torch.serving.config import fitted_estimator
from repro_torch.serving.core import SchedulerCore, WorkerState

__all__ = [
    "Backend", "BatchExecution", "RealBackend", "SchedulerCore",
    "SimBackend", "WorkerState", "fitted_estimator",
]
