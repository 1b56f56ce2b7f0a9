"""Placement policies for the fleet router — Eq. 10–11, one level up.

Inside one instance the paper's Alg. 2 assigns batches to workers by
Eq. 11 loads (``repro_torch.core.offloader``): charge the serving-time
estimate on assignment, subtract it on completion, always pick the
min-load worker.  The fleet router plays the *same* game one level up,
with instances in place of workers and whole requests in place of
batches:

  * ``round_robin`` — the count-based baseline (``RoundRobinOffloader``
    one level up): blind to request size and instance load;
  * ``least_load`` — Eq. 11 one level up: instance load = the
    instance's own polled Eq. 10–11 ``queue_delay_est`` plus the cost of
    everything this router placed there that has not come back yet (the
    charge decays exactly like ``Offloader``: added on placement,
    subtracted on completion — never reset by polls, because a paced
    instance drains whole slices between polls and its point-in-time
    estimate misses work the router knows is outstanding); near-ties
    break toward the least *cumulative* work placed, so an idle fleet
    degrades to size-weighted rotation rather than piling onto the
    sorted-first instance;
  * ``retention_affinity`` — ``least_load`` with the
    ``MaxMinOffloader`` epsilon tiebreak one level up: a session turn
    *prefers* the instance whose pages hold its history (the pin) and
    only migrates when that instance's load exceeds the fleet minimum by
    more than ``epsilon × (request cost + migration cost)``, where the
    migration cost is the §3.3 re-prefill of the resident history the
    move would throw away.

The router has no per-request Eq. 1–4 estimator of its own, so request
cost is the coarse linearization ``(prompt + max_tokens) × token_time``
— one price constant converting token counts into the same seconds
currency as the instances' queue-delay estimates.  Any constant
balances; matching the profile's decode latency just keeps the polled
and charged terms commensurate.

The port's copy of ``repro.fleet.placement``, the same code with its
imports moved to ``repro_torch``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol, Sequence, Tuple

from repro_torch.fleet.registry import InstanceSnapshot

__all__ = ["PlacementRequest", "Placement", "Placer", "RoundRobinPlacer",
           "LeastLoadPlacer", "RetentionAffinityPlacer", "PLACERS",
           "make_placer", "imbalance", "DEFAULT_TOKEN_TIME"]

#: coarse per-token price (seconds) converting request sizes into the
#: queue-delay currency — ballpark decode latency of the A100/13B profile
DEFAULT_TOKEN_TIME = 0.03


@dataclasses.dataclass(frozen=True)
class PlacementRequest:
    """What the router knows about a request at placement time."""

    rid: int                          # router-side request counter
    input_tokens: int                 # estimated prompt length
    max_tokens: int                   # requested generation budget
    session_id: Optional[int] = None
    pinned: Optional[str] = None      # instance holding the session's pages
    history_tokens: int = 0           # resident prefix a migration re-prefills


@dataclasses.dataclass(frozen=True)
class Placement:
    """One placement decision (feeds the router's audit record)."""

    instance: str
    policy: str
    loads: Tuple[Tuple[str, float], ...] = ()  # decision-time loads, sorted


class Placer(Protocol):
    """Pluggable placement policy (the router's offloader)."""

    name: str

    def place(self, candidates: Sequence[InstanceSnapshot],
              req: PlacementRequest) -> Placement:
        """Pick an instance for ``req``; ``candidates`` is non-empty and
        sorted by url (healthy, non-draining instances only)."""
        ...

    def observe(self, candidates: Sequence[InstanceSnapshot]) -> None:
        """Fresh registry poll: ``candidates`` is the current placeable
        set (lets a placer prune state for departed instances)."""
        ...

    def on_complete(self, instance: str, req: PlacementRequest) -> None:
        """The proxied request finished on ``instance``."""
        ...


class RoundRobinPlacer:
    """Count-based baseline: cycle the sorted candidate list."""

    name = "round_robin"

    def __init__(self) -> None:
        self._i = 0

    def place(self, candidates: Sequence[InstanceSnapshot],
              req: PlacementRequest) -> Placement:
        chosen = candidates[self._i % len(candidates)]
        self._i += 1
        return Placement(instance=chosen.instance, policy=self.name)

    def observe(self, candidates: Sequence[InstanceSnapshot]) -> None:
        pass

    def on_complete(self, instance: str, req: PlacementRequest) -> None:
        pass


class LeastLoadPlacer:
    """Eq. 11 one level up with Offloader-style charge decay."""

    name = "least_load"

    def __init__(self, token_time: float = DEFAULT_TOKEN_TIME):
        if token_time <= 0:
            raise ValueError(f"token_time must be positive, "
                             f"got {token_time}")
        self.token_time = float(token_time)
        self._charges: Dict[str, float] = {}
        # cumulative placed work (never decremented): the tie-breaker
        # when instantaneous loads agree — typically a drained fleet
        # where every charge has been released and every polled delay is
        # ~0.  Without it min() would park every idle-time arrival on
        # the sorted-first instance.
        self._totals: Dict[str, float] = {}

    # -- the load model -------------------------------------------------
    def estimate(self, req: PlacementRequest) -> float:
        """Coarse request cost in seconds (Eq. 1 linearized)."""
        return (req.input_tokens + req.max_tokens) * self.token_time

    def load(self, snap: InstanceSnapshot) -> float:
        """Polled Eq. 10–11 delay + this router's outstanding charges.

        The two terms may briefly overlap (a poll lands while charged
        work is running), which only makes a busy instance look busier —
        the conservative direction for balancing."""
        return snap.queue_delay_est + self._charges.get(snap.instance, 0.0)

    def loads(self, candidates: Sequence[InstanceSnapshot]
              ) -> Tuple[Tuple[str, float], ...]:
        return tuple((s.instance, round(self.load(s), 6))
                     for s in candidates)

    # -- Placer protocol ------------------------------------------------
    def _pick(self, candidates: Sequence[InstanceSnapshot]
              ) -> InstanceSnapshot:
        # near-ties (within ~1 ms of load) break on least cumulative
        # placed work, then sorted url — deterministic for a fixed
        # sequence, and an idle fleet degrades to size-weighted rotation
        # instead of collapsing onto the sorted-first instance
        return min(candidates,
                   key=lambda s: (round(self.load(s), 3),
                                  self._totals.get(s.instance, 0.0),
                                  s.instance))

    def place(self, candidates: Sequence[InstanceSnapshot],
              req: PlacementRequest) -> Placement:
        loads = self.loads(candidates)
        chosen = self._pick(candidates)
        self._charge(chosen.instance, self.estimate(req))
        return Placement(instance=chosen.instance, policy=self.name,
                         loads=loads)

    def observe(self, candidates: Sequence[InstanceSnapshot]) -> None:
        # charges persist across polls (released by on_complete, like
        # Offloader.on_batch_complete); a poll only prunes ledger rows
        # for instances that left the placeable set — their in-flight
        # work died or drained with them
        live = {snap.instance for snap in candidates}
        for url in list(self._charges):
            if url not in live:
                del self._charges[url]

    def on_complete(self, instance: str, req: PlacementRequest) -> None:
        # mirror Offloader.on_batch_complete one level up; clamp at zero
        # because an eviction may already have pruned the charge
        c = self._charges.get(instance, 0.0)
        if c > 0.0:
            self._charges[instance] = max(0.0, c - self.estimate(req))

    def _charge(self, instance: str, cost: float) -> None:
        self._charges[instance] = self._charges.get(instance, 0.0) + cost
        self._totals[instance] = self._totals.get(instance, 0.0) + cost


class RetentionAffinityPlacer(LeastLoadPlacer):
    """Least-load with the MaxMin epsilon tiebreak toward the instance
    retaining the session's pages (migration = §3.3 re-prefill)."""

    name = "retention_affinity"

    def __init__(self, token_time: float = DEFAULT_TOKEN_TIME,
                 epsilon: float = 0.25):
        super().__init__(token_time)
        if epsilon < 0:
            raise ValueError(f"epsilon must be >= 0, got {epsilon}")
        self.epsilon = float(epsilon)

    def place(self, candidates: Sequence[InstanceSnapshot],
              req: PlacementRequest) -> Placement:
        loads = self.loads(candidates)
        chosen = self._pick(candidates)
        if req.pinned is not None and req.pinned != chosen.instance:
            pinned = next((s for s in candidates
                           if s.instance == req.pinned), None)
            if pinned is not None:
                # stay home unless the pinned instance is loaded more
                # than epsilon × (request cost + the re-prefill a move
                # would force) above the fleet minimum — the
                # MaxMinOffloader tiebreak with a migration-cost term
                slack = self.epsilon * (
                    self.estimate(req)
                    + req.history_tokens * self.token_time)
                if self.load(pinned) <= self.load(chosen) + slack:
                    chosen = pinned
        self._charge(chosen.instance, self.estimate(req))
        return Placement(instance=chosen.instance, policy=self.name,
                         loads=loads)


PLACERS: Tuple[str, ...] = ("round_robin", "least_load",
                            "retention_affinity")


def make_placer(name: str, *, token_time: float = DEFAULT_TOKEN_TIME,
                epsilon: float = 0.25) -> Placer:
    """Placer factory for CLI/router construction."""
    if name == "round_robin":
        return RoundRobinPlacer()
    if name == "least_load":
        return LeastLoadPlacer(token_time)
    if name == "retention_affinity":
        return RetentionAffinityPlacer(token_time, epsilon)
    raise ValueError(f"unknown placer {name!r}; choose from {PLACERS}")


def imbalance(served: Dict[str, int]) -> float:
    """max/min served-token imbalance across instances (the bench/fleet
    balance metric; 1.0 = perfectly even, inf when an instance idles)."""
    if not served:
        return 1.0
    lo, hi = min(served.values()), max(served.values())
    if lo <= 0:
        return float("inf") if hi > 0 else 1.0
    return hi / lo
