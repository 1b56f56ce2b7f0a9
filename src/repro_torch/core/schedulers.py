"""Scheduling strategies: the paper's SCLS and every baseline/ablation.

Strategies are declarative configs consumed by the cluster runtime
(``repro.cluster.simulator`` drives the same logic in virtual time that
``repro.launch.serve`` drives against real JAX engines):

  SLS  — per-request round-robin offload; workers run FCFS static batches of
         fixed size with iteration limit = max_gen (paper baseline).
  ILS  — per-request round-robin; continuous batching with a conservative
         parallelism cap (DeepSpeed-FastGen-like baseline).
  SO   — SLS + generation slicing (iteration limit = S, reschedule).
  PM   — SO + sorted contiguous batching capped at the fixed batch size,
         fetched centrally every Γ, round-robin offload.
  AB   — PM with the cap lifted: full DP adaptive batching (Algorithm 1).
  LB   — AB + max-min offloading (§4.5).
  SCLS — LB + adaptive schedule interval (§4.6, Eq. 12).

Beyond-paper strategies:

  SCLS-CB   — slice leases on top of continuous batching (§7 Discussion).
  SCLS-PRED — SCLS + the ``repro.predict`` generation-length subsystem
         (cf. §6 Related Work: S³/PiA and proxy-model predictors).  At each
         central tick, every pooled request gets a calibrated remaining-
         length cap from an online predictor (histogram/EWMA, JAX proxy
         MLP, or ground truth).  Requests with cap ≥ S are scheduled
         exactly like SCLS; requests predicted to finish within a slice
         are bucketed by cap and served with exact per-batch slice lengths
         (``core.batcher.bucketed_pred_batch``), eliminating most invalid
         tokens and letting memory-bound workers pack tighter batches.
         Calibrated caps interact with the slice length S as a *ceiling*:
         a cap never stretches a serving round beyond S, and a request
         that outlives its cap is rescheduled like any unfinished slice —
         so a bad predictor degrades SCLS-PRED to SCLS, never breaks it.
  ORACLE — SCLS-PRED with a perfect predictor: the analysis upper bound
         (the price of length-blindness is SCLS's gap to it).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class StrategyConfig:
    name: str
    mode: str  # "perreq" | "central" | "continuous"
    slice_len: int
    max_gen: int = 1024
    fixed_batch_size: Optional[int] = None  # worker-local FCFS batch size
    use_dp: bool = False
    dp_cap: Optional[int] = None  # PM: DP with batch-size cap
    offload: str = "rr"  # "rr" | "maxmin"
    adaptive_interval: bool = False
    gamma: float = 3.0  # Γ: minimal schedule interval (s)
    lam: float = 0.5  # λ in Eq. 12
    # ILS conservative memory management
    max_parallel: int = 12
    max_cached_tokens: Optional[int] = None
    # KV-cache layout on the workers (repro.kvcache): "dense" reserves a
    # contiguous worst-case region per engine slot; "paged" allocates
    # fixed-size token blocks against the (L_i + S) slice envelope, so
    # parallelism is bounded by real free memory instead of a slot count.
    # Continuous-mode runtimes require a PagedMemoryEstimator when "paged".
    kv_layout: str = "dense"
    # Algorithm-1 no-OOM bound (core.batcher.PACKING_MODES): "batch-max"
    # charges every member the longest member's (L_i + S) envelope (the
    # paper's O(1) closed form — the default, pinned by the goldens);
    # "envelope" charges each member its own blocks_for(L_j + S) via
    # prefix sums — at least as permissive, requires kv_layout="paged"
    # (the bound is exact only against a block pool).
    packing: str = "batch-max"
    # SCLS-PRED / ORACLE (mode "pred"): generation-length prediction
    predictor: Optional[str] = None   # "histogram" | "proxy" | "perfect"
    coverage: float = 0.7             # calibration target quantile
    bucket_phi: float = 2.0           # geometric short-bucket ratio
    min_pred_slice: int = 16          # floor for predicted slice lengths

    @property
    def slices(self) -> bool:
        return self.slice_len < self.max_gen


def make_strategy(name: str, slice_len: int = 128, max_gen: int = 1024,
                  fixed_batch_size: int = 12, gamma: float = 3.0,
                  lam: float = 0.5, max_parallel: int = 12,
                  predictor: str = "histogram", coverage: float = 0.7,
                  bucket_phi: float = 2.0,
                  kv_layout: str = "dense",
                  packing: str = "batch-max") -> StrategyConfig:
    name = name.lower()
    if kv_layout not in ("dense", "paged"):
        raise ValueError(f"unknown kv_layout {kv_layout!r}")
    if packing not in ("batch-max", "envelope"):
        raise ValueError(f"unknown packing {packing!r} "
                         f"(expected 'batch-max' or 'envelope')")
    if packing == "envelope" and kv_layout != "paged":
        raise ValueError(
            "packing='envelope' charges per-request block envelopes, "
            "which only a paged block pool can account exactly; set "
            "kv_layout='paged' (or keep the default 'batch-max' bound)")
    base = dict(slice_len=slice_len, max_gen=max_gen, gamma=gamma, lam=lam,
                kv_layout=kv_layout, packing=packing)
    if name == "sls":
        return StrategyConfig("SLS", "perreq", slice_len=max_gen, max_gen=max_gen,
                              fixed_batch_size=fixed_batch_size, gamma=gamma,
                              lam=lam, kv_layout=kv_layout, packing=packing)
    if name == "ils":
        return StrategyConfig("ILS", "continuous", slice_len=max_gen, max_gen=max_gen,
                              max_parallel=max_parallel, gamma=gamma, lam=lam,
                              kv_layout=kv_layout, packing=packing)
    if name == "so":
        return StrategyConfig("SO", "perreq", fixed_batch_size=fixed_batch_size, **base)
    if name == "pm":
        return StrategyConfig("PM", "central", use_dp=True, dp_cap=fixed_batch_size,
                              offload="rr", **base)
    if name == "ab":
        return StrategyConfig("AB", "central", use_dp=True, offload="rr", **base)
    if name == "lb":
        return StrategyConfig("LB", "central", use_dp=True, offload="maxmin", **base)
    if name == "scls":
        return StrategyConfig("SCLS", "central", use_dp=True, offload="maxmin",
                              adaptive_interval=True, **base)
    # predicted-slice floor: scales with S so small-slice setups (e.g. the
    # reduced serve demo at S=8) still exercise the short buckets instead
    # of flooring every cap into the long group.  The floor exists to
    # amortize the reschedule cost of *under*-predictions, so perfect
    # predictions get none — ORACLE serves exact slices (zero overshoot)
    min_pred_slice = 1 if predictor == "perfect" else max(
        1, min(16, slice_len // 8))
    if name == "scls-pred":
        # SCLS + online length prediction (repro.predict): bucket by
        # calibrated predicted remaining length, exact slice lengths for
        # requests predicted to finish within a slice
        return StrategyConfig("SCLS-PRED", "pred", use_dp=True,
                              offload="maxmin", adaptive_interval=True,
                              predictor=predictor, coverage=coverage,
                              bucket_phi=bucket_phi,
                              min_pred_slice=min_pred_slice, **base)
    if name == "oracle":
        # analysis upper bound (cf. PiA / S^3, paper §6 Related Work):
        # SCLS-PRED with a perfect generation-length predictor — requests
        # are bucketed by exactly-known remaining length, short requests
        # finish in one exact slice with zero overshoot.  SCLS's gap to
        # this bound is the price of length-blindness.
        return StrategyConfig("ORACLE", "pred", use_dp=True,
                              offload="maxmin", adaptive_interval=True,
                              predictor="perfect", coverage=coverage,
                              bucket_phi=bucket_phi, min_pred_slice=1, **base)
    if name == "scls-cb":
        # beyond-paper (§7 Discussion): slice-level scheduling ON TOP OF
        # continuous batching — requests get S-token *leases* on a worker,
        # join/exit at iteration boundaries under an exact token budget
        # (slices make memory predictable, so no conservative cap), and
        # leases are placed max-min by estimated slice time.
        return StrategyConfig("SCLS-CB", "cont_scls", use_dp=False,
                              offload="maxmin", adaptive_interval=True,
                              max_parallel=1 << 30, **base)
    raise ValueError(f"unknown strategy {name!r}")


ALL_STRATEGIES = ("sls", "ils", "so", "pm", "ab", "lb", "scls", "scls-cb",
                  "scls-pred", "oracle")
