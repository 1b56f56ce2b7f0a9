"""Discrete-event multi-worker serving simulator (legacy shim).

The scheduling loop that used to live here moved verbatim into
``repro_torch.serving.core.SchedulerCore``; this module keeps the historical
constructor working as a thin wrapper over ``SchedulerCore`` +
``repro_torch.serving.backends.SimBackend`` (ground-truth latency model,
optionally noisy, in virtual time).  Scheduling decisions are therefore
*bit-identical* to the real cluster's — there is one code path with two
backends, pinned by ``tests/test_serving.py``'s golden equivalence test.

Prefer ``repro_torch.serving.ServingConfig(...).build_sim()`` for new code;
it returns the online :class:`~repro_torch.serving.server.SliceServer` API
(submit / stream / cancel) over the same core.

The port's copy of ``repro.cluster.simulator``, the same code with its
imports moved to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.cluster.metrics import RunMetrics
from repro_torch.core.estimator import ServingTimeEstimator
from repro_torch.core.memory import MemoryEstimator
from repro_torch.core.request import Request
from repro_torch.core.schedulers import StrategyConfig
from repro_torch.predict import LengthPredictor
from repro_torch.serving.backends import SimBackend
from repro_torch.serving.core import SchedulerCore


@dataclasses.dataclass
class SimResult:
    metrics: RunMetrics
    requests: List[Request]
    worker_completion: List[float]
    batch_sizes: List[int]


class ClusterSimulator:
    """Deprecated shim: offline ``run()`` over the shared SchedulerCore."""

    def __init__(self, strategy: StrategyConfig, n_workers: int,
                 true_lat: ServingTimeEstimator, sched_est: ServingTimeEstimator,
                 mem: MemoryEstimator, noise_sigma: float = 0.0, seed: int = 0,
                 ils_span: int = 32, predictor: Optional[LengthPredictor] = None):
        backend = SimBackend(true_lat, noise_sigma=noise_sigma, seed=seed)
        self.core = SchedulerCore(strategy, backend, n_workers, sched_est,
                                  mem, predictor=predictor, ils_span=ils_span)

    # --- legacy attribute surface (tests/benchmarks read these) ---
    @property
    def s(self) -> StrategyConfig:
        return self.core.s

    @property
    def workers(self):
        return self.core.workers

    @property
    def pool(self) -> List[Request]:
        return self.core.pool

    @property
    def pred(self):
        return self.core.pred

    @property
    def predictor(self):
        return self.core.predictor

    @property
    def calibrator(self):
        return self.core.calibrator

    @property
    def batch_sizes(self) -> List[int]:
        return self.core.batch_sizes

    @property
    def batch_log(self) -> List[list]:
        return self.core.batch_log

    @property
    def peak_parallel(self) -> int:
        return self.core.peak_parallel

    @property
    def now(self) -> float:
        return self.core.now

    def _more_work_expected(self) -> bool:
        return self.core._more_work_expected()

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request], duration: float) -> SimResult:
        metrics = self.core.run(requests, duration)
        return SimResult(metrics, list(requests),
                         [w.completion_time for w in self.core.workers],
                         self.core.batch_sizes)
