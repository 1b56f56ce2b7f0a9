"""Scheduler decision audit (``repro_torch.obs`` pillar 3).

The scheduler computes the paper's Eq. 1–2 service estimates and
Eq. 10–11 queue/load signals at every decision point — and, before this
module, threw them away the moment the decision was made.  The
:class:`DecisionLog` is a bounded ring buffer of structured decision
events so an operator (or a test) can answer "*why* was request 17
rejected / batched with those peers / placed on worker 3":

  * ``kind="admission"`` — one event per admission verdict: action
    (accept/reject/degrade), reason code, the Eq. 1–2 service estimate,
    the Eq. 10–11 predicted queue delay, the calibrated generation cap,
    and the deadline it was compared against;
  * ``kind="batch"`` — one event per ``dp_batch`` /
    ``bucketed_pred_batch`` composition: member rids, the chosen slice
    length S, the batch input length, the Eq. 1–4 estimated serving
    time, and the memory bound (Eq. 5–9 ``max_batch_size``) the no-OOM
    constraint enforced;
  * ``kind="offload"`` — one event per placement: the chosen worker and
    every worker's Eq. 11 load *at decision time* (reconstructed from
    the offloader's greedy bookkeeping order).

Events are plain dicts (JSON-ready) with a monotone ``seq`` and the core
timestamp ``ts``; the ring drops the oldest events at capacity so a
serve-forever deployment holds bounded memory.  Query via
:meth:`DecisionLog.query` (``GET /debug/decisions`` upstream) or dump the
whole ring alongside a trace (``serve --trace-out``).
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import Deque, List, Optional

__all__ = ["DecisionLog"]


class DecisionLog:
    """Ring buffer of structured scheduler decisions — module docstring."""

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._ring: Deque[dict] = deque(maxlen=self.capacity)
        self._seq = itertools.count()
        #: total events ever recorded (>= len(ring) once it wraps)
        self.n_recorded = 0

    # ------------------------------------------------------------------
    def record(self, kind: str, ts: float, **fields) -> dict:
        """Append one decision event; returns the stored dict."""
        ev = dict(seq=next(self._seq), ts=float(ts), kind=kind, **fields)
        self._ring.append(ev)
        self.n_recorded += 1
        return ev

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._ring)

    def _touches(self, ev: dict, rid: int) -> bool:
        if ev.get("rid") == rid:
            return True
        rids = ev.get("rids")
        return bool(rids) and rid in rids

    def query(self, rid: Optional[int] = None, kind: Optional[str] = None,
              limit: Optional[int] = None) -> List[dict]:
        """Events matching the filters, oldest first.

        ``rid`` matches events whose ``rid`` equals it or whose ``rids``
        list contains it; ``limit`` keeps the *newest* N of the matches
        (the interesting end of a ring buffer).
        """
        out = [ev for ev in self._ring
               if (kind is None or ev["kind"] == kind)
               and (rid is None or self._touches(ev, rid))]
        if limit is not None and limit >= 0:
            out = out[len(out) - min(limit, len(out)):]
        return out

    def to_list(self) -> List[dict]:
        """Every retained event, oldest first (the ``--trace-out`` dump)."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
