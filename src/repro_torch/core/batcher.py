"""Serving time-oriented batching (paper §4.4, Algorithm 1).

Sort requests ascending by effective input length; a dynamic program over
the sorted order partitions them into contiguous batches minimizing total
estimated serving time, subject to the no-OOM constraint.  Because requests
are sorted, request i's input length is the batch input length for any
batch ending at i, so each DP transition is O(1) via the estimator's closed
form.

``bucketed_pred_batch`` extends Algorithm 1 with generation-length
predictions (the ``scls-pred``/ORACLE path): requests predicted to outlive
a slice are DP-batched exactly like SCLS, while requests predicted to
finish within one are grouped into geometric remaining-length buckets and
served with exact per-batch slice lengths.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from repro_torch.core.estimator import ServingTimeEstimator
from repro_torch.core.memory import (MAX_BATCH_SIZE_CAP, MemoryEstimator,
                               PagedMemoryEstimator)
from repro_torch.core.request import Batch, Request, bucket_len

#: no-OOM bounds the DP may pack against: "batch-max" is the paper's
#: Eq. 5–9 check ``fits(N, L_max, S)`` (every member charged the longest
#: member's envelope); "envelope" charges each member its own
#: ``blocks_for(L_j + S)`` via ``PagedMemoryEstimator.fits_envelope`` —
#: at least as permissive, exact on the paged engines which reserve
#: per-request envelopes anyway (``StaticEngine.serve_batch_paged``)
PACKING_MODES = ("batch-max", "envelope")


def _check_packing(packing: str, mem: MemoryEstimator) -> None:
    if packing not in PACKING_MODES:
        raise ValueError(f"unknown packing {packing!r} "
                         f"(expected one of {PACKING_MODES})")
    if packing == "envelope" and not isinstance(mem, PagedMemoryEstimator):
        raise ValueError(
            f"packing='envelope' charges per-request block envelopes, "
            f"which needs a PagedMemoryEstimator (kv_layout='paged'); "
            f"got {type(mem).__name__}")


def batch_fits(b: Batch, mem: MemoryEstimator,
               packing: str = "batch-max") -> bool:
    """Eq. 5–9 feasibility of an already-composed batch under either
    packing bound — the recheck used after ``bucketed_pred_batch``
    rewrites slice lengths, and by tests/audit."""
    S = int(b.slice_len)
    if packing == "envelope":
        total = sum(mem.blocks_per_request(r.effective_input_len, S)
                    for r in b.requests)
        return mem.fits_envelope(total)
    return mem.fits(b.size, int(b.input_len), S)


def dp_batch(requests: Sequence[Request], slice_len: int,
             est: ServingTimeEstimator, mem: MemoryEstimator,
             max_batch_size: Optional[int] = None,
             packing: str = "batch-max") -> List[Batch]:
    """Algorithm 1.  ``max_batch_size`` caps N (None = unbounded, the full
    adaptive batcher; the PM ablation passes the engine's fixed size).

    ``packing`` picks the no-OOM bound (``PACKING_MODES``): the default
    "batch-max" transition is the paper's O(1) closed form; "envelope"
    keeps O(1) transitions by prefix-summing the sorted requests'
    per-request block envelopes, so a batch over ``reqs[j-1:i]`` is
    charged exactly ``pre[i] - pre[j-1]`` blocks.
    """
    _check_packing(packing, mem)
    if not requests:
        return []
    reqs = sorted(requests, key=lambda r: r.effective_input_len)
    n = len(reqs)
    INF = float("inf")
    T = [0.0] + [INF] * n  # T[i]: min total time for first i requests
    P = [0] * (n + 1)      # split positions

    lens = [r.effective_input_len for r in reqs]
    pre = [0] * (n + 1)  # envelope mode: prefix sums of per-request blocks
    if packing == "envelope":
        for idx, L in enumerate(lens):
            pre[idx + 1] = pre[idx] + mem.blocks_per_request(L, slice_len)
    for i in range(1, n + 1):
        L_i = lens[i - 1]
        # request i as its own batch
        T[i] = T[i - 1] + est.t_serve(1, L_i, slice_len)
        P[i] = i - 1
        # widen the batch over preceding requests j..i
        j = i - 1
        while j > 0:
            N = i - j + 1
            if max_batch_size is not None and N > max_batch_size:
                break
            if packing == "envelope":
                # Σ blocks over reqs[j-1:i] grows as j widens left and
                # fits_envelope is monotone in it, so breaking on the
                # first failure is exact; fits_envelope cannot bound N
                # when the pool is unbounded (Δ = 0), so cap N here
                if N > MAX_BATCH_SIZE_CAP:
                    break
                if not mem.fits_envelope(pre[i] - pre[j - 1]):
                    break
            elif not mem.fits(N, L_i, slice_len):
                break
            t = T[j - 1] + est.t_serve(N, L_i, slice_len)
            if t < T[i]:
                T[i] = t
                P[i] = j - 1
            j -= 1

    batches: List[Batch] = []
    i = n
    while i > 0:
        p = P[i]
        group = reqs[p:i]
        L = group[-1].effective_input_len  # sorted: last has the max
        b = Batch(requests=list(group), input_len=bucket_len(L, est.bucket),
                  slice_len=slice_len)
        b.est_time = est.t_serve(b.size, L, slice_len)
        batches.append(b)
        i = p
    batches.reverse()
    return batches


def bucketed_pred_batch(requests: Sequence[Request], caps: Dict[int, int],
                        slice_len: int, est: ServingTimeEstimator,
                        mem: MemoryEstimator, phi: float = 2.0,
                        min_slice: int = 16,
                        packing: str = "batch-max") -> List[Batch]:
    """Length-prediction-aware batching (``scls-pred`` / refactored ORACLE).

    ``caps[rid]`` is the calibrated remaining-length cap for each request.
    Requests with cap >= ``slice_len`` form one "long" group scheduled
    exactly like SCLS (slice = ``slice_len``): under-predictions therefore
    degrade to plain slice-level scheduling, never to incorrectness.
    Requests predicted to finish within a slice are bucketed by cap with
    geometric ratio ``phi`` (bounding the within-batch length spread, hence
    the invalid tokens, by a factor of ``phi``), DP-batched within each
    bucket, and served with slice length = the batch's largest cap — so a
    correctly-predicted request completes in this round with no overshoot
    beyond the ``min_slice`` floor (perfect predictions use floor 1).

    ``min_slice`` floors the short-bucket slice lengths: an under-predicted
    request costs a full reschedule (another prefill and another wait for a
    tick), so serving micro-slices on the word of an imperfect predictor is
    a bad trade — a few invalid tokens are far cheaper.
    """
    if phi <= 1.0:
        raise ValueError(f"bucket ratio phi must be > 1, got {phi}")
    if not requests:
        return []
    min_slice = max(1, min(min_slice, slice_len))
    log_phi = math.log(phi)
    groups: Dict[int, List[Request]] = {}
    eff: Dict[int, int] = {}
    for r in requests:
        c = max(int(caps[r.rid]), min_slice)
        eff[r.rid] = c
        if c >= slice_len:
            key = -1
        else:
            key = int(math.ceil(math.log(c) / log_phi))
        groups.setdefault(key, []).append(r)
    batches: List[Batch] = []
    for key, group in sorted(groups.items()):
        if key == -1:
            batches.extend(dp_batch(group, slice_len, est, mem,
                                    packing=packing))
            continue
        bucket_cap = min(slice_len, max(eff[r.rid] for r in group))
        for b in dp_batch(group, bucket_cap, est, mem, packing=packing):
            b.slice_len = min(slice_len, max(eff[r.rid] for r in b.requests))
            b.est_time = est.t_serve(b.size, b.input_len, b.slice_len)
            # the DP admitted this batch under Eq. 5–9 at slice =
            # bucket_cap ≥ b.slice_len; every shipped estimator's bound is
            # monotone in S, so the shrunk batch still fits — but that was
            # previously assumed, not checked.  Recompute the bound against
            # the FINAL slice length so a non-monotone estimator (a future
            # rule table, say) fails loudly here instead of OOMing a worker.
            if not batch_fits(b, mem, packing):
                raise RuntimeError(
                    f"bucketed_pred_batch: batch of {b.size} no longer "
                    f"satisfies the Eq. 5–9 bound after shrinking slice "
                    f"{bucket_cap} -> {b.slice_len} (non-monotone memory "
                    f"estimator {type(mem).__name__}?)")
            batches.append(b)
    return batches


def batch_audit_fields(b: Batch, mem: MemoryEstimator) -> Dict[str, object]:
    """Decision-audit record for one Algorithm-1 batch (``repro.obs``).

    Reconstructs the inputs the DP transition saw when it closed this
    batch: the member rids, the bucketed batch input length, the chosen
    slice length, the Eq. 1–2 estimated serving time already priced on
    the batch, and the Eq. 5–9 memory bound ``max_batch_size(L_i, S)``
    the no-OOM constraint compared ``N`` against.  Pure read — safe to
    call from observability hooks on a live scheduler.

    On a block-pool estimator the record additionally carries the
    envelope-exact view of the same bound: ``envelope_blocks`` (the sum
    of the members' per-request ``blocks_for(L_j + S)`` charges — what
    the paged engine actually reserves) and ``envelope_fits`` (its
    ``fits_envelope`` verdict), regardless of which packing mode composed
    the batch — so audits of batch-max runs show the blocks the tighter
    bound would have freed.
    """
    fields: Dict[str, object] = dict(
        rids=sorted(r.rid for r in b.requests),
        slice_len=int(b.slice_len),
        input_len=int(b.input_len),
        est_time=float(b.est_time),
        mem_bound=int(mem.max_batch_size(int(b.input_len),
                                         int(b.slice_len))))
    if isinstance(mem, PagedMemoryEstimator):
        env = sum(mem.blocks_per_request(r.effective_input_len,
                                         int(b.slice_len))
                  for r in b.requests)
        fields["envelope_blocks"] = int(env)
        fields["envelope_fits"] = bool(mem.fits_envelope(env))
    return fields


def fcfs_batch(requests: Sequence[Request], batch_size: int, slice_len: int,
               est: Optional[ServingTimeEstimator] = None) -> List[Batch]:
    """SLS / SO baseline batching: FCFS order, fixed batch size."""
    reqs = sorted(requests, key=lambda r: r.arrival)
    batches = []
    for i in range(0, len(reqs), batch_size):
        group = reqs[i:i + batch_size]
        L = max(r.effective_input_len for r in group)
        b = Batch(requests=group, input_len=L, slice_len=slice_len)
        if est is not None:
            b.est_time = est.t_serve(b.size, L, slice_len)
        batches.append(b)
    return batches


def total_time(batches: Sequence[Batch]) -> float:
    return sum(b.est_time for b in batches)
