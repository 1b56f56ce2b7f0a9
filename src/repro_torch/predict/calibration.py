"""Quantile calibration: raw length predictions -> conservative caps.

A raw point prediction is useless to a scheduler without an error model: an
under-predicted request blows through its slice and must be rescheduled
(wasting a prefill), an over-predicted one wastes reserved memory and
invalid tokens.  The calibrator learns a multiplicative correction from the
observed ratio actual/predicted (split-conformal style, over a sliding
window so it tracks both workload and predictor drift):

    cap(r) = clip( raw(r) * Q_coverage(actual/raw history), 1, budget )

so that, when the ratios are exchangeable, P[actual <= cap] ~= coverage.
A perfect predictor yields all-ones ratios and the calibration passes its
predictions through exactly — which is what makes ``scls-pred`` with
:class:`~repro_torch.predict.perfect.PerfectPredictor` reproduce ORACLE.

Mispredictions stay safe: the scheduler serves at most a slice per round
regardless, and an uncompleted request simply goes back to the pool.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Tuple

import numpy as np


class QuantileCalibrator:
    """Turns raw predicted remaining lengths into per-request caps."""

    def __init__(self, coverage: float = 0.7, window: int = 512,
                 min_samples: int = 16, max_scale: float = 32.0):
        assert 0.0 < coverage < 1.0
        self.coverage = float(coverage)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.max_scale = float(max_scale)
        self.ratios: Deque[float] = deque(maxlen=window)
        # rid -> [(raw prediction, generated at prediction time), ...]: every
        # prediction point is kept and scored — scoring only the final one
        # would systematically flatter the predictor (the last slice of a
        # many-times-rescheduled request is trivially well predicted) and
        # the scale would never correct the early under-predictions
        self._pending: Dict[int, List[Tuple[float, int]]] = {}

    # ------------------------------------------------------------------
    @property
    def scale(self) -> float:
        if len(self.ratios) < self.min_samples:
            return 1.0
        return float(np.clip(np.quantile(np.asarray(self.ratios),
                                         self.coverage),
                             1.0 / self.max_scale, self.max_scale))

    def cap(self, req, raw_remaining: float) -> int:
        """Conservative remaining-length cap for ``req`` (>= 1 token)."""
        self._pending.setdefault(req.rid, []).append(
            (max(float(raw_remaining), 1.0), int(req.generated)))
        budget = max(int(req.max_gen) - int(req.generated), 1)
        return int(np.clip(round(raw_remaining * self.scale), 1, budget))

    def observe(self, req) -> None:
        """Completion feedback: score every prediction made for ``req``."""
        for raw, g_at_pred in self._pending.pop(req.rid, ()):
            actual = max(int(req.generated) - g_at_pred, 1)
            self.ratios.append(actual / raw)

    # ------------------------------------------------------------------
    def empirical_coverage(self) -> float:
        """Fraction of scored predictions with actual <= calibrated cap
        under the *current* scale (diagnostic, used by the benchmark)."""
        if not self.ratios:
            return float("nan")
        r = np.asarray(self.ratios)
        return float(np.mean(r <= self.scale))
