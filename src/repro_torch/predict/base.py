"""Generation-length prediction interface (beyond-paper subsystem).

The paper (§6 Related Work) names length prediction (S³, PiA, proxy-model
predictors) as the main rival line to slice-level scheduling: if the
scheduler knew each request's generation length it could batch requests of
similar remaining length together, pick exact slice lengths, and waste no
invalid tokens.  ``repro_torch.predict`` supplies that knowledge as a pluggable
component:

  * :class:`LengthPredictor` — the interface: ``predict_remaining`` gives a
    raw point estimate of the remaining decode length of a request,
    ``observe`` feeds back every completed request (online learning).
  * ``HistogramPredictor`` — per-workload decayed histogram (EWMA counts)
    of completed generation lengths; predicts conditional quantiles of
    G | G > generated.
  * ``ProxyPredictor`` — a small PyTorch MLP head over cheap prompt features,
    trained online by SGD (cf. arXiv 2404.08509).
  * ``PerfectPredictor`` — ground truth; subsumes the old ORACLE
    special-case in the simulator and serves as the analysis upper bound.

Predictions are never trusted raw: :mod:`repro_torch.predict.calibration` turns
them into conservative per-request caps at a target coverage, and the
scheduler treats a blown cap as an ordinary unfinished slice (the request
is simply rescheduled), so correctness never depends on the predictor.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.core.request import Request


class LengthPredictor:
    """Interface: point predictions of remaining generation length."""

    name = "base"

    def predict_remaining(self, req: "Request") -> float:
        """Raw estimate of the remaining decode iterations of ``req``.

        Called at schedule time; may use anything observable by a scheduler
        (input length, tokens generated so far, prompt tokens) but NOT the
        ground-truth ``gen_len`` — only :class:`PerfectPredictor` reads
        that, as an explicitly-labeled analysis bound.
        """
        raise NotImplementedError

    def observe(self, req: "Request") -> None:
        """Feedback hook: ``req`` has completed (``req.generated`` is its
        realized total generation length).  Called by the cluster runtimes
        for every finished request; default is a no-op (stateless
        predictors)."""

    def observe_alive(self, req: "Request") -> None:
        """Censored feedback: ``req`` is being scheduled while still
        generating — evidence that its total length exceeds
        ``req.generated``.  Survival-aware predictors (histogram) use this
        to avoid the length bias of completion-only training; default is a
        no-op."""

    def __repr__(self) -> str:  # pragma: no cover
        return f"{type(self).__name__}()"
