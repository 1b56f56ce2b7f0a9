"""Adaptive schedule-interval update (paper §4.6, Eq. 12)."""
from __future__ import annotations


def next_interval(min_worker_load: float, lam: float, gamma: float) -> float:
    """T <- max(λ · min_w load(w), Γ)."""
    return max(lam * min_worker_load, gamma)
