"""Balanced load-oriented offloading (paper §4.5) + round-robin baseline."""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from repro_torch.core.request import Batch


class Offloader:
    def __init__(self, n_workers: int):
        self.n_workers = n_workers
        self.loads: Dict[int, float] = {w: 0.0 for w in range(n_workers)}
        #: retention-affinity hook (ROADMAP; wired by SchedulerCore when
        #: the backend exposes ``batch_affinity``): ``fn(batch) ->
        #: Optional[wid]`` naming the worker where the batch's prefix
        #: pages are resident.  ``None`` (default, and for every batch
        #: without resident pages) leaves placement untouched.
        self.affinity_fn = None

    def assign(self, batches: Sequence[Batch]) -> List[Tuple[int, Batch]]:
        raise NotImplementedError

    def on_batch_complete(self, worker: int, est_time: float) -> None:
        """Eq. 11 follow-up: subtract the estimate on completion so the
        estimation error never accumulates in the load."""
        self.loads[worker] = max(0.0, self.loads[worker] - est_time)

    def snapshot(self) -> Dict[int, float]:
        """Copy of the per-worker Eq. 11 loads at this instant.  Both
        policies charge ``est_time`` per batch in assignment order, so a
        pre-``assign`` snapshot plus that bookkeeping replays the exact
        loads each placement decision saw — the decision-audit input
        (``repro.obs``)."""
        return dict(self.loads)

    def min_load(self) -> float:
        return min(self.loads.values())


class MaxMinOffloader(Offloader):
    """Longest-estimated batch -> least-loaded worker (max-min policy).

    Retention-affinity tiebreak: when ``affinity_fn`` names a worker whose
    resident prefix pages cover this batch and that worker's Eq. 11 load
    is within ``epsilon · est_time`` of the minimum, it wins the placement
    — the batch's prefill becomes a page-table remap there, while a
    cross-worker move would release those pages and re-prefill from
    scratch.  With no affinity source (or ``None`` per batch) placement
    is bit-identical to the plain policy, which the golden dispatch logs
    pin.
    """

    def __init__(self, n_workers: int, epsilon: float = 0.25):
        super().__init__(n_workers)
        if epsilon < 0:
            raise ValueError(f"epsilon must be >= 0, got {epsilon}")
        self.epsilon = float(epsilon)

    def assign(self, batches: Sequence[Batch]) -> List[Tuple[int, Batch]]:
        out = []
        for b in sorted(batches, key=lambda b: -b.est_time):
            w = min(self.loads, key=self.loads.get)
            if self.affinity_fn is not None:
                pref = self.affinity_fn(b)
                if (pref is not None and pref != w and pref in self.loads
                        and self.loads[pref] <= self.loads[w]
                        + self.epsilon * b.est_time):
                    w = pref
            self.loads[w] += b.est_time  # Eq. 11
            out.append((w, b))
        return out


class RoundRobinOffloader(Offloader):
    """SLS/ILS baseline policy.  Loads are still tracked (for Eq. 12 and
    metrics) but do not influence placement."""

    def __init__(self, n_workers: int):
        super().__init__(n_workers)
        self._next = 0

    def assign(self, batches: Sequence[Batch]) -> List[Tuple[int, Batch]]:
        out = []
        for b in batches:
            w = self._next
            self._next = (self._next + 1) % self.n_workers
            self.loads[w] += b.est_time
            out.append((w, b))
        return out
