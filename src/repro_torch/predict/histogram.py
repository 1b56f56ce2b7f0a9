"""Online per-workload histogram/EWMA generation-length predictor.

A discrete hazard (Kaplan–Meier) estimator over generation-length bins,
updated from the live request stream:

  * every *completed* request contributes an event in its final bin
    (``observe``, called by the cluster runtimes' feedback hooks);
  * every *in-flight* request contributes survival evidence for the bins it
    has already outlived (``observe_alive``, called at schedule time).

The censored (in-flight) evidence matters: a predictor trained only on
completions is length-biased — short requests finish first, so for the
whole life of a serving run the completed set under-represents long
requests and conditional quantiles come out systematically low (we
measured calibration having to inflate such a predictor's caps 5–17x to
reach target coverage).  Counting at-risk mass the KM way removes that
bias at the source.

Predictions are conditional quantiles of G | G > g for a request that has
already generated ``g`` valid tokens — the same hazard-style estimate S³
builds from its offline length classifier, but learned online.  All counts
are exponentially decayed per completion (an EWMA over the request
stream), so the predictor tracks workload drift at a rate set by
``decay``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.predict.base import LengthPredictor


class HistogramPredictor(LengthPredictor):
    name = "histogram"

    def __init__(self, max_gen: int = 1024, n_bins: int = 128,
                 decay: float = 0.999, quantile: float = 0.5,
                 min_observed: int = 8):
        assert 0.0 < decay <= 1.0 and 0.0 < quantile < 1.0
        self.max_gen = int(max_gen)
        self.n_bins = int(n_bins)
        self.decay = float(decay)
        self.quantile = float(quantile)
        self.min_observed = int(min_observed)
        # bin j covers lengths (edges[j], edges[j+1]]
        self.edges = np.linspace(0.0, float(max_gen), n_bins + 1)
        self.at_risk = np.zeros(n_bins)   # requests that entered bin j
        self.events = np.zeros(n_bins)    # requests that finished in bin j
        self._credited: Dict[int, int] = {}  # rid -> bins already credited
        self.n_observed = 0

    # ------------------------------------------------------------------
    def _bin(self, length: float) -> int:
        i = int(np.searchsorted(self.edges, min(length, self.max_gen),
                                side="left")) - 1
        return int(np.clip(i, 0, self.n_bins - 1))

    def _survived_bins(self, generated: int) -> int:
        """Number of leading bins fully outlived by ``generated`` tokens."""
        k = int(np.searchsorted(self.edges, generated, side="right")) - 1
        return int(np.clip(k, 0, self.n_bins))

    def _credit(self, rid: int, upto: int) -> None:
        c = self._credited.get(rid, 0)
        if upto > c:
            self.at_risk[c:upto] += 1.0
            self._credited[rid] = upto

    # ------------------------------------------------------------------
    def observe_alive(self, req) -> None:
        """Censored observation: ``req`` is still generating at
        ``req.generated`` tokens, so it has survived every bin below."""
        self._credit(req.rid, self._survived_bins(req.generated))

    def observe(self, req) -> None:
        total = max(req.generated, 1)
        b = self._bin(total)
        self._credit(req.rid, b)
        self._credited.pop(req.rid, None)
        self.at_risk[b] += 1.0
        self.events[b] += 1.0
        self.at_risk *= self.decay
        self.events *= self.decay
        self.n_observed += 1

    # ------------------------------------------------------------------
    def _survival(self) -> np.ndarray:
        """S[j] = P(G > edges[j+1]) from the discrete hazard."""
        with np.errstate(divide="ignore", invalid="ignore"):
            h = np.where(self.at_risk > 0, self.events / self.at_risk, 0.0)
        return np.cumprod(1.0 - np.clip(h, 0.0, 1.0))

    def predict_total(self, generated: int) -> float:
        """``quantile`` of G | G > generated (total length, not remaining)."""
        if self.n_observed < self.min_observed:
            return float(self.max_gen)  # cold start: fall back to slicing
        S = self._survival()
        k0 = self._survived_bins(generated)
        base = S[k0 - 1] if k0 > 0 else 1.0
        if base <= 0.0:
            return float(self.max_gen)
        target = base * (1.0 - self.quantile)
        for j in range(k0, self.n_bins):
            if S[j] <= target:
                return float(self.edges[j + 1])  # conservative: upper edge
        return float(self.max_gen)

    def predict_remaining(self, req) -> float:
        total = self.predict_total(req.generated)
        return float(max(total - req.generated, 1.0))
