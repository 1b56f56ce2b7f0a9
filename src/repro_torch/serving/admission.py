"""SLO-aware admission control for the online serving API.

The paper's core claim (§3.2, Eq. 1–4) is that slice-level scheduling
gives a *precise range of serving time and memory usage* for a batch.
This module is where that precision becomes operational: before a request
costs any prefill work or page reservation, the controller predicts when
it would complete — queue delay from the Eq. 10–11 worker loads plus the
Eq. 1–4 slice time estimates over a calibrated generation-length cap
(``repro_torch.predict``) — and compares the prediction against the request's
deadline.  A request whose predicted completion violates its SLO is
rejected (HTTP 429 upstream) or, when the caller opts in, *degraded* to
the longest ``max_gen`` that still meets the deadline.

Three decision shapes (the ``AdmissionDecision`` constructors):

  * ``AdmissionDecision.accepted(...)``   — proceed, prediction attached;
  * ``AdmissionDecision.rejected(reason)``— shed now, nothing reserved;
  * ``AdmissionDecision.degraded(max_gen)``— admit with a shorter budget.

Requests without a deadline are always admitted (best-effort traffic is
never shed), so attaching a controller to a server changes nothing for
existing SLO-less callers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Any, Optional

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from repro_torch.serving.core import SchedulerCore


class AdmissionRejected(RuntimeError):
    """Raised by ``submit`` when the admission controller sheds a request
    (what an HTTP front end answers with 429 + ``Retry-After``)."""

    def __init__(self, decision: "AdmissionDecision"):
        super().__init__(decision.reason or "request rejected by admission")
        self.decision = decision


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of one admission check.

    ``action`` is one of ``"accept"`` / ``"reject"`` / ``"degrade"``;
    ``predicted_completion`` is the controller's estimate of the absolute
    (core-time) completion instant, ``retry_after`` a suggested backoff in
    core seconds for rejected requests, ``max_gen`` the degraded
    generation budget for ``"degrade"`` decisions.

    The decision *inputs* ride along for the observability layer
    (``repro_torch.obs`` decision audit / per-reason reject metrics):
    ``reason_code`` is a stable machine key (``"memory"`` — the Eq. 5–9
    bound admits no batch of one; ``"deadline"`` — the prediction misses
    the SLO), ``queue_delay`` the Eq. 10–11 predicted queueing delay,
    ``service_est`` the Eq. 1–4 service-time estimate at ``gen_cap``
    generated tokens.  All 0/None for accept-all and best-effort paths
    where they were never computed.
    """

    action: str
    reason: Optional[str] = None
    predicted_completion: float = 0.0
    retry_after: Optional[float] = None
    max_gen: Optional[int] = None
    reason_code: Optional[str] = None
    queue_delay: float = 0.0
    service_est: float = 0.0
    gen_cap: Optional[int] = None

    @property
    def accept(self) -> bool:
        """True when the request may enter the scheduler (possibly with a
        degraded budget)."""
        return self.action in ("accept", "degrade")

    # -- constructors ---------------------------------------------------
    @classmethod
    def accepted(cls, predicted_completion: float = 0.0,
                 **inputs: Any) -> "AdmissionDecision":
        return cls("accept", predicted_completion=predicted_completion,
                   **inputs)

    @classmethod
    def rejected(cls, reason: str, predicted_completion: float = 0.0,
                 retry_after: Optional[float] = None,
                 **inputs: Any) -> "AdmissionDecision":
        return cls("reject", reason=reason,
                   predicted_completion=predicted_completion,
                   retry_after=retry_after, **inputs)

    @classmethod
    def degraded(cls, max_gen: int, predicted_completion: float = 0.0,
                 **inputs: Any) -> "AdmissionDecision":
        return cls("degrade", max_gen=int(max_gen),
                   predicted_completion=predicted_completion, **inputs)


# ---------------------------------------------------------------------------
# the Eq. 1–4 / Eq. 10–11 completion-time prediction
# ---------------------------------------------------------------------------
def memory_admits_one(core: "SchedulerCore", input_len: int,
                      first_slice: int) -> bool:
    """Eq. 5–9 batch-of-one feasibility, under the strategy's packing mode.

    With ``packing='envelope'`` the check routes through the same
    envelope-exact bound the batcher packs against — the request is
    charged exactly its own ``blocks_for(L + S)`` — so admission and
    Algorithm 1 read ONE bound (for N = 1 the two bounds coincide
    numerically; what matters is that they can never drift apart).
    """
    mem = core.mem
    if core.s.packing == "envelope":
        # validated at SchedulerCore construction: envelope => paged
        return mem.fits_envelope(
            mem.blocks_per_request(int(input_len), int(first_slice)))
    return mem.max_batch_size(int(input_len), int(first_slice)) >= 1


def predicted_queue_delay(core: "SchedulerCore") -> float:
    """Estimated core-time delay until a *new* arrival is first scheduled.

    Two observable components, both already maintained by the scheduler:

      * the least-loaded worker's outstanding estimated work — the Eq.
        10–11 load the max-min offloader adds at placement and decays at
        completion, so it is exactly the Eq. 1–4 serving-time mass ahead
        of a newcomer on the best worker;
      * the un-batched pool backlog, priced per request at one
        batch-of-one slice (Eq. 1: ``t_serve(1, L_i, S)``) and spread
        over the workers.
    """
    delay = core.offloader.min_load()
    if core.pool:
        S = core.s.slice_len
        backlog = sum(
            core.est.t_serve(1, r.effective_input_len,
                             min(S, max(r.remaining_gen, 1)))
            for r in core.pool)
        delay += backlog / core.n_workers
    return delay


def predicted_service_time(core: "SchedulerCore", input_len: int,
                           gen_cap: int) -> float:
    """Estimated core-time to serve ``gen_cap`` tokens for a fresh request
    of length ``input_len``, batch-of-one.

    ``t_serve(1, L_i, gen_cap)`` (Eq. 1–2 closed form) prices the prefill
    and every decode iteration over the growing cache; on top of that,
    each of the ``ceil(gen_cap / S) - 1`` reschedules pays its re-prefill
    of prompt + generated tokens (the paper's §3.3 slicing overhead,
    Eq. 3) and up to one Γ scheduling-interval wait.
    """
    s = core.s
    S = max(int(s.slice_len), 1)
    gen_cap = max(int(gen_cap), 1)
    t = core.est.t_serve(1, input_len, gen_cap)
    n_slices = math.ceil(gen_cap / S)
    for j in range(1, n_slices):
        t += core.est.t_prefill(1, input_len + j * S)
    t += (n_slices - 1) * s.gamma
    return t


class AdmissionController:
    """Deadline-aware admission over the scheduler's own estimators.

    Stateless apart from configuration: every ``decide`` reads the live
    core (loads, pool, predictor) so the prediction tracks the system.

    ``headroom`` scales the predicted completion before the deadline
    comparison (> 1 is more conservative); ``enabled=False`` turns the
    controller into an accept-all pass-through (used by benchmarks to
    measure the no-admission baseline).
    """

    def __init__(self, headroom: float = 1.0, enabled: bool = True):
        if headroom <= 0:
            raise ValueError(f"headroom must be positive, got {headroom}")
        self.headroom = float(headroom)
        self.enabled = bool(enabled)

    # ------------------------------------------------------------------
    def predicted_gen_cap(self, core: "SchedulerCore", input_len: int,
                          declared: int) -> int:
        """Generation-length cap used for the time prediction.

        With a prediction pipeline (``scls-pred``/``oracle``) the cap is
        the calibrated predicted remaining length — the same quantity the
        batcher uses — clipped to the declared budget.  Without one, the
        client-declared budget (``max_tokens``/``gen_len``) is all the
        scheduler may legally observe, so it is used as-is.
        """
        declared = max(int(declared), 1)
        if core.pred is None:
            return declared
        from repro_torch.core.request import Request
        probe = Request(rid=-1, arrival=core.now, input_len=int(input_len),
                        gen_len=None, max_gen=declared)
        raw = max(float(core.pred.predictor.predict_remaining(probe)), 1.0)
        # the calibrator's multiplicative correction, without registering
        # a pending prediction for a request that may never be admitted
        cap = int(np.clip(round(raw * core.pred.calibrator.scale), 1,
                          declared))
        return cap

    def decide(self, core: "SchedulerCore", *, input_len: int,
               declared_gen: int, arrival: float,
               deadline: Optional[float] = None,
               allow_degrade: bool = False) -> AdmissionDecision:
        """Admission check for one prospective request.

        ``declared_gen`` is the client's generation budget (``max_tokens``
        / ``gen_len``), ``deadline`` an absolute core-time instant (None =
        best-effort: always admitted).  Nothing here touches the
        scheduler state — a rejected request leaves no trace beyond the
        ``n_rejected`` counter its caller increments.
        """
        if not self.enabled:
            return AdmissionDecision.accepted()
        first_slice = min(int(core.s.slice_len), max(int(declared_gen), 1))
        if not memory_admits_one(core, int(input_len), first_slice):
            return AdmissionDecision.rejected(
                f"prompt of {input_len} tokens does not fit worker memory "
                f"even as a batch of one", reason_code="memory")
        if deadline is None:
            return AdmissionDecision.accepted()

        queue_delay = predicted_queue_delay(core)
        cap = self.predicted_gen_cap(core, input_len, declared_gen)
        service = predicted_service_time(core, int(input_len), cap)
        inputs = dict(queue_delay=queue_delay, service_est=service,
                      gen_cap=cap)
        start = max(float(arrival), core.now)
        completion = start + self.headroom * (queue_delay + service)
        if completion <= deadline:
            return AdmissionDecision.accepted(predicted_completion=completion,
                                              **inputs)

        if allow_degrade:
            # longest budget that still meets the deadline (monotone in
            # gen, so bisect); degrade only when at least one slice fits
            budget = deadline - start - self.headroom * queue_delay
            lo, hi = 0, cap
            while lo < hi:
                mid = (lo + hi + 1) // 2
                if self.headroom * predicted_service_time(
                        core, int(input_len), mid) <= budget:
                    lo = mid
                else:
                    hi = mid - 1
            if lo >= 1:
                degraded_completion = start + self.headroom * (
                    queue_delay + predicted_service_time(core, int(input_len), lo))
                return AdmissionDecision.degraded(
                    lo, predicted_completion=degraded_completion, **inputs)

        return AdmissionDecision.rejected(
            f"predicted completion {completion:.3f}s exceeds deadline "
            f"{deadline:.3f}s (queue delay {queue_delay:.3f}s, "
            f"predicted {cap} tokens)",
            predicted_completion=completion,
            retry_after=max(queue_delay, completion - deadline),
            reason_code="deadline", **inputs)


#: accept-all controller for the no-admission baseline arms
NO_ADMISSION = AdmissionController(enabled=False)
