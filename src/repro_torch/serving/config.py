"""Scheduler-estimator wiring shared by the launcher and the tests.

The part of ``repro.serving.config`` this slice needs: ``fitted_estimator``
"profiles" a ground-truth latency model with 2% noise and fits Eq. 3/4,
as the paper's one-time profiling step does.  ``ServingConfig`` and its
``build_sim``/``build_real`` are left for a later slice (the launcher
wires the core itself).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.estimator import ServingTimeEstimator


def fitted_estimator(true_lat: ServingTimeEstimator,
                     seed: int = 0) -> ServingTimeEstimator:
    """'Profile' the ground-truth latency model with 2% measurement noise
    and fit Eq. 3/4 — mirrors the paper's one-time profiling step."""
    rng = np.random.default_rng(seed)
    pre = [(N, L, true_lat.t_prefill(N, L) * rng.lognormal(0, 0.02))
           for N in (1, 2, 4, 8, 16, 32) for L in (16, 128, 512, 1024)]
    dec = [(N, L, true_lat.tau_decode(L, N) * rng.lognormal(0, 0.02))
           for N in (1, 2, 4, 8, 16, 32) for L in (16, 128, 512, 1024)]
    est, _, _ = ServingTimeEstimator.fit(pre, dec)
    return est
