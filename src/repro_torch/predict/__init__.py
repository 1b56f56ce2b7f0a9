"""Generation-length prediction subsystem (see ``repro_torch.predict.base``)."""
from __future__ import annotations

from repro_torch.predict.base import LengthPredictor
from repro_torch.predict.calibration import QuantileCalibrator
from repro_torch.predict.histogram import HistogramPredictor
from repro_torch.predict.perfect import PerfectPredictor
from repro_torch.predict.pipeline import PredictionPipeline

__all__ = [
    "LengthPredictor", "QuantileCalibrator", "HistogramPredictor",
    "PerfectPredictor", "PredictionPipeline", "ProxyPredictor",
    "make_predictor", "PREDICTORS",
]

PREDICTORS = ("histogram", "proxy", "perfect")


def make_predictor(name: str, max_gen: int = 1024,
                   coverage: float | None = None, device=None,
                   **kw) -> LengthPredictor:
    """Factory used by the scheduling core and the serve launcher.

    ``coverage`` is the scheduler's target quantile: a distribution-aware
    predictor (histogram) aims its raw predictions directly at it, so the
    downstream :class:`QuantileCalibrator` only has to correct residual
    bias; point predictors (proxy) ignore it and rely on the calibrator
    entirely.  ``device`` places the proxy's MLP (``None``: the CUDA card,
    an error without one); the other predictors run on the host and
    ignore it.
    """
    name = name.lower()
    if name == "histogram":
        if coverage is not None:
            kw.setdefault("quantile", coverage)
        return HistogramPredictor(max_gen=max_gen, **kw)
    if name == "proxy":
        # imported lazily: pulls in torch, which the pure-simulator path
        # (histogram/perfect) does not need
        from repro_torch.predict.proxy import ProxyPredictor
        return ProxyPredictor(max_gen=max_gen, device=device, **kw)
    if name == "perfect":
        return PerfectPredictor()
    raise ValueError(f"unknown predictor {name!r} (have {PREDICTORS})")


def __getattr__(name: str):
    if name == "ProxyPredictor":
        from repro_torch.predict.proxy import ProxyPredictor
        return ProxyPredictor
    raise AttributeError(name)
