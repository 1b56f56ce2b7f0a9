"""Shared pred-mode glue for the scheduling core.

The sim and the real backend run *the same scheduler code*; this module
is what keeps that true for the prediction path: predictor/calibrator
construction, the schedule-time observe→predict→calibrate→batch sequence,
and the completion feedback live here exactly once.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.batcher import bucketed_pred_batch
from repro_torch.predict.base import LengthPredictor
from repro_torch.predict.calibration import QuantileCalibrator


class PredictionPipeline:
    """Owns the predictor + calibrator for one pred-mode run (a proxy
    built here goes to the default device, the card; ``ServingConfig``
    passes one placed on its ``device``)."""

    def __init__(self, strategy, predictor: Optional[LengthPredictor] = None):
        from repro_torch.predict import make_predictor
        self.s = strategy
        self.predictor = predictor or make_predictor(
            strategy.predictor or "histogram", max_gen=strategy.max_gen,
            coverage=strategy.coverage)
        self.calibrator = QuantileCalibrator(coverage=strategy.coverage)

    def batches(self, reqs: Sequence, est, mem) -> List:
        """One scheduling round: censored survival evidence, calibrated
        remaining-length caps, then slice-aware bucketed batching."""
        for r in reqs:
            self.predictor.observe_alive(r)
        caps = {r.rid: self.calibrator.cap(
            r, self.predictor.predict_remaining(r)) for r in reqs}
        return bucketed_pred_batch(reqs, caps, self.s.slice_len, est, mem,
                                   phi=self.s.bucket_phi,
                                   min_slice=self.s.min_pred_slice,
                                   packing=self.s.packing)

    def on_complete(self, req) -> None:
        """Online-learning feedback: every completed request trains the
        predictor and scores its calibrated predictions."""
        self.predictor.observe(req)
        self.calibrator.observe(req)
