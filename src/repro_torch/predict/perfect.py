"""Ground-truth predictor: the analysis upper bound (old ORACLE path).

Reads ``Request.gen_len`` — the one component allowed to do so (the
``Request`` docstring bans schedulers from it).  With this predictor,
``scls-pred`` reproduces the ORACLE strategy: requests are grouped by
exact remaining length, short requests finish in a single exact-length
slice, and the gap to the histogram/proxy predictors is the price of
prediction error.
"""
from __future__ import annotations

from repro_torch.predict.base import LengthPredictor


class PerfectPredictor(LengthPredictor):
    name = "perfect"

    def predict_remaining(self, req) -> float:
        return float(max(req.remaining_gen, 1))
