"""Run metrics matching the paper's evaluation (§5.1 Metrics + dive figures)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.request import Request


@dataclasses.dataclass
class RunMetrics:
    name: str
    duration: float
    n_requests: int
    n_completed: int
    throughput: float           # completed requests / s (paper Fig. 12 top)
    mean_response: float        # paper Fig. 12 middle
    p50_response: float         # end-to-end latency percentiles (beyond
    p95_response: float         # paper Fig. 12 bottom: p95 only)
    p99_response: float
    ttft_mean: float            # time to first token (slice-granular:
    ttft_p95: float             # tokens materialize at slice boundaries)
    ct_std: float               # STD of worker completion times (Fig. 17)
    avg_batch_size: float       # Fig. 13b
    avg_invalid_tokens: float   # Fig. 13a
    avg_pad_tokens: float       # Fig. 13c
    avg_schedules: float        # Fig. 14a (slice count)
    early_return_ratio: float   # Fig. 14b
    makespan: float
    # --- online-serving columns (SLO-aware admission) ---
    # defaulted so offline runs and pre-existing benchmark CSV schemas
    # stay valid: no admission layer -> 0 rejected, and with no deadlines
    # submitted every completion trivially attains its (absent) SLO
    n_rejected: int = 0         # shed by admission before any prefill
    slo_attainment: float = 1.0  # completed-with-deadline meeting it
    # per-reason shed counts (repro.serving.admission reason codes), so
    # benchmark CSVs report WHY goodput was protected: "memory" = the
    # prompt cannot fit worker memory even as a batch of one (Eq. 5–9
    # bound < 1), "deadline" = predicted completion (Eq. 1–4 service +
    # Eq. 10–11 queue delay) exceeds the request's SLO deadline
    n_rejected_memory: int = 0
    n_rejected_deadline: int = 0
    # --- §3.3 rescheduling overhead (persistent paged KV) ---
    # tokens prefilled beyond each request's FIRST prefill, summed over the
    # run: the cost slice-level scheduling pays to reschedule.  The
    # kv_retain="request" real backend drives this to 0 for uninterrupted
    # requests (prefix pages survive, re-prefill becomes a page-table
    # remap); the sim backend reports the analytic dense cost.
    reprefill_tokens: int = 0
    # --- cross-request prefix sharing (COW paged KV) ---
    # prompt tokens satisfied by a refcounted prefix-page join instead of
    # prefill (multi-turn sessions, shared system prompts), and the pages
    # those joins took references on.  0 everywhere except the real
    # kv_retain="request" backend with prefix sharing enabled.
    prefix_hit_tokens: int = 0
    shared_blocks: int = 0

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


def compute_metrics(name: str, requests: Sequence[Request], duration: float,
                    worker_completion_times: Sequence[float],
                    batch_sizes: Sequence[int],
                    early_returns: int, total_batches: int,
                    n_rejected: int = 0,
                    reprefill_tokens: int = 0,
                    reject_reasons: Optional[Dict[str, int]] = None,
                    prefix_hit_tokens: int = 0,
                    shared_blocks: int = 0,
                    ) -> RunMetrics:
    done = [r for r in requests if r.done and r.finish_time is not None]
    # SLO attainment: of the completed requests that carried a deadline
    # (online submissions with slo_ms), the fraction that met it.  Shed
    # work is reported separately as n_rejected; deadline-less (offline /
    # best-effort) runs default to 1.0 so the column is always finite.
    with_slo = [r for r in done if r.deadline is not None]
    slo_attainment = (float(np.mean([r.finish_time <= r.deadline
                                     for r in with_slo]))
                      if with_slo else 1.0)
    # requests can be empty (an online server drained before any submit)
    per_req = (np.array([[r.invalid_tokens, r.pad_tokens, r.n_schedules]
                         for r in requests], float)
               if requests else np.zeros((1, 3)))
    resp = np.array([r.response_time() for r in done]) if done else np.array([0.0])
    ttft = np.array([r.first_token_time - r.arrival for r in done
                     if r.first_token_time is not None])
    if ttft.size == 0:
        ttft = np.array([0.0])
    ct = np.array(list(worker_completion_times)) if worker_completion_times else np.array([0.0])
    bs = np.array(list(batch_sizes)) if batch_sizes else np.array([0.0])
    return RunMetrics(
        name=name,
        duration=duration,
        n_requests=len(requests),
        n_completed=len(done),
        throughput=len(done) / max(ct.max(), duration, 1e-9),
        mean_response=float(resp.mean()),
        p50_response=float(np.percentile(resp, 50)),
        p95_response=float(np.percentile(resp, 95)),
        p99_response=float(np.percentile(resp, 99)),
        ttft_mean=float(ttft.mean()),
        ttft_p95=float(np.percentile(ttft, 95)),
        ct_std=float(ct.std()),
        avg_batch_size=float(bs.mean()),
        avg_invalid_tokens=float(per_req[:, 0].mean()),
        avg_pad_tokens=float(per_req[:, 1].mean()),
        avg_schedules=float(per_req[:, 2].mean()),
        early_return_ratio=early_returns / max(total_batches, 1),
        makespan=float(ct.max()),
        n_rejected=int(n_rejected),
        slo_attainment=slo_attainment,
        reprefill_tokens=int(reprefill_tokens),
        n_rejected_memory=int((reject_reasons or {}).get("memory", 0)),
        n_rejected_deadline=int((reject_reasons or {}).get("deadline", 0)),
        prefix_hit_tokens=int(prefix_hit_tokens),
        shared_blocks=int(shared_blocks),
    )
