"""Real-execution cluster (legacy shim): the same scheduler code as the
simulator, but workers run batches on the port's engines (StaticEngine,
each on the device it was built for), every FLOP real.

The scheduling loop that used to live here moved into
``repro_torch.serving.core.SchedulerCore``; this module keeps the historical
constructor working as a thin wrapper over ``SchedulerCore`` +
``repro_torch.serving.backends.RealBackend``.  One physical CPU hosts all
workers, so each worker keeps a *virtual clock* advanced by the measured
wall time of its own batches — worker i's timeline is exactly what i
parallel machines would see.  Token outcomes (EOS, invalid, pads) come
from the engine, not from a latency model.

Prefer ``repro_torch.serving.ServingConfig(...).build_real(engines, est, mem)``
for new code; it returns the online SliceServer API over the same core.

The port's copy of ``repro.cluster.realtime``, the same code with its
imports moved to ``repro_torch``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.cluster.metrics import RunMetrics
from repro_torch.core.estimator import ServingTimeEstimator
from repro_torch.core.memory import MemoryEstimator
from repro_torch.core.request import Request
from repro_torch.core.schedulers import StrategyConfig
from repro_torch.engine.static_engine import StaticEngine
from repro_torch.predict import LengthPredictor
from repro_torch.serving.backends import RealBackend
from repro_torch.serving.core import SchedulerCore


class RealCluster:
    """Deprecated shim: central-mode strategies (PM/AB/LB/SCLS and the
    prediction-aware SCLS-PRED/ORACLE) against real engines."""

    def __init__(self, strategy: StrategyConfig, engines: Sequence[StaticEngine],
                 sched_est: ServingTimeEstimator, mem: MemoryEstimator,
                 predictor: Optional[LengthPredictor] = None):
        assert strategy.mode in ("central", "pred")
        backend = RealBackend(engines, mem=mem, kv_layout=strategy.kv_layout,
                              sched_bucket=sched_est.bucket)
        self.engines = list(engines)
        self.core = SchedulerCore(strategy, backend, len(engines), sched_est,
                                  mem, predictor=predictor)

    # --- legacy attribute surface ---
    @property
    def s(self) -> StrategyConfig:
        return self.core.s

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
    def allocators(self):
        return self.core.backend.allocators

    @property
    def batch_sizes(self) -> List[int]:
        return self.core.batch_sizes

    # ------------------------------------------------------------------
    def run(self, requests: Sequence[Request], duration: float) -> RunMetrics:
        return self.core.run(requests, duration)
