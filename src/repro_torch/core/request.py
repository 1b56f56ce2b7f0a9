"""Request / Batch types shared by schedulers, engines, and the simulator."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    """One user request.

    ``gen_len`` is the request's *true* generation length (number of decode
    iterations until EOS).  It is ground truth for the workload generator /
    engine and is NEVER read by any scheduler — schedulers only observe
    ``input_len``, ``generated`` and completion events, exactly as in the
    paper.  ``gen_len=None`` (online submissions through
    ``repro.serving``) means the length is unknown in advance: the real
    backend decodes until the model's own EOS, the sim backend until
    ``max_gen``.
    """

    rid: int
    arrival: float
    input_len: int
    gen_len: Optional[int]
    max_gen: int = 1024
    prompt: Optional[np.ndarray] = None  # actual tokens (real-execution mode)
    #: absolute completion deadline in core time (``arrival + slo``), set
    #: by the online serving API's SLO-aware admission; None = best-effort.
    #: Schedulers never read it — it exists for admission decisions (made
    #: before submission) and the SLO-attainment metric.
    deadline: Optional[float] = None
    #: multi-turn session this request is a turn of (``repro.serving``
    #: ``Session`` / HTTP chat): on completion the real retain-mode
    #: backend anchors its prefix pages for the next turn's prefix join
    #: instead of freeing them.  Schedulers never read it.
    session_id: Optional[int] = None

    # --- scheduling state ---
    generated: int = 0
    done: bool = False
    cancelled: bool = False  # terminal via SliceServer.cancel(), not EOS
    n_schedules: int = 0
    finish_time: Optional[float] = None
    first_token_time: Optional[float] = None
    # accounting (paper Figs. 13/16/19)
    pad_tokens: int = 0
    invalid_tokens: int = 0
    output_tokens: Optional[list] = None  # generated token ids (real mode)

    @property
    def effective_input_len(self) -> int:
        """Input length at (re)schedule time: prompt + already-generated."""
        return self.input_len + self.generated

    @property
    def remaining_gen(self) -> int:
        cap = (self.max_gen if self.gen_len is None
               else min(self.gen_len, self.max_gen))
        return cap - self.generated

    def response_time(self) -> float:
        assert self.finish_time is not None
        return self.finish_time - self.arrival


@dataclasses.dataclass
class Batch:
    """A scheduled unit of work: requests padded to ``input_len`` and served
    for at most ``slice_len`` iterations (SCLS) or ``max_gen`` (SLS)."""

    requests: List[Request]
    input_len: int  # batch input length (max effective input len, bucketed)
    slice_len: int  # iteration limit for this serving round
    est_time: float = 0.0

    @property
    def size(self) -> int:
        return len(self.requests)


def bucket_len(L: int, bucket: int) -> int:
    """TPU adaptation: round L up to a multiple of ``bucket`` (DESIGN.md §8)."""
    if bucket <= 1:
        return L
    return ((L + bucket - 1) // bucket) * bucket
