"""Memory-usage estimator (paper §4.3, Eq. 5–9 + Algorithm 2).

Three implementations:
  * AnalyticMemoryEstimator — Eq. 5/9: KV bytes = (L_i + S)·N·Δ ≤ ζ·M_ava,
    for engines with predictable allocators (HF in the paper; our JAX engine
    is exactly predictable, so ζ defaults to 1.0 there).  Mesh-aware: Δ is
    per model-shard (DESIGN.md §8.3).
  * RuleBasedMemoryEstimator — Algorithm 2's profiled rule table for engines
    with opaque allocators (DS in the paper).
  * PagedMemoryEstimator — beyond-paper: the block-pool view of the same
    budget for ``kv_layout="paged"`` engines (``repro.kvcache``), counting
    *free blocks* instead of the ζ·M_ava closed form, so in-flight
    reservations shrink what the batcher may admit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

from repro_torch.core.request import bucket_len

# Documented ceiling for ``max_batch_size`` when the memory model does not
# bind (e.g. Δ = 0, or a rule table whose last rule always fits): no real
# engine schedules batches beyond this, and callers must never see an
# internal search sentinel leak out as if it were a schedulable size.
MAX_BATCH_SIZE_CAP = 4096


def blocks_for(n_tokens: int, page_tokens: int) -> int:
    """Blocks needed for ``n_tokens`` cache slots (ceil division).

    THE block-rounding rule of the paged KV subsystem: the estimator's
    admission check, the ``repro.kvcache.PageAllocator`` free list, and
    the simulator's admission all share this one definition.
    """
    return -(-max(n_tokens, 0) // page_tokens)


class MemoryEstimator:
    def fits(self, N: int, L_i: int, S: int) -> bool:
        raise NotImplementedError

    def max_batch_size(self, L_i: int, S: int) -> int:
        """Largest N with fits(N, L_i, S) — Eq. 8 for the analytic case.

        Capped at ``MAX_BATCH_SIZE_CAP`` when the constraint never binds.
        """
        if self.fits(MAX_BATCH_SIZE_CAP, L_i, S):
            return MAX_BATCH_SIZE_CAP
        lo, hi = 0, MAX_BATCH_SIZE_CAP
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if self.fits(mid, L_i, S):
                lo = mid
            else:
                hi = mid
        return lo


@dataclasses.dataclass
class AnalyticMemoryEstimator(MemoryEstimator):
    delta_bytes: float          # Δ: KV bytes per token (per model shard)
    m_available: float          # M_ava = M_cap - M_model - M_engine (bytes)
    zeta: float = 1.0           # engine fragmentation factor (Eq. 9)
    bucket: int = 1

    def kv_bytes(self, N: int, L_i: int, S: int) -> float:
        return (bucket_len(L_i, self.bucket) + S) * N * self.delta_bytes  # Eq. 5

    def fits(self, N: int, L_i: int, S: int) -> bool:
        if N <= 0:
            return True
        return self.kv_bytes(N, L_i, S) <= self.zeta * self.m_available  # Eq. 9

    def max_batch_size(self, L_i: int, S: int) -> int:  # Eq. 8 closed form
        denom = self.delta_bytes * (bucket_len(L_i, self.bucket) + S)
        if denom <= 0:
            return MAX_BATCH_SIZE_CAP
        return min(int(self.zeta * self.m_available // denom),
                   MAX_BATCH_SIZE_CAP)


@dataclasses.dataclass
class RuleBasedMemoryEstimator(MemoryEstimator):
    """Paper Algorithm 2: total-token thresholds -> max batch size.

    ``rules`` is a list of (min_total_len_exclusive, max_batch) sorted
    descending; the default is the paper's DS table.
    """

    rules: Sequence[Tuple[int, int]] = ((1024, 12), (512, 22), (0, 28))

    def fits(self, N: int, L_i: int, S: int) -> bool:
        L = L_i + S
        for threshold, max_n in self.rules:
            if L > threshold:
                return N <= max_n
        return N <= self.rules[-1][1]


@dataclasses.dataclass
class PagedMemoryEstimator(MemoryEstimator):
    """Block-pool memory model for ``kv_layout="paged"`` (``repro.kvcache``).

    The same ζ·M_ava byte budget as the analytic model, viewed as a pool of
    fixed-size token blocks: a request scheduled with batch input length
    L_i and slice S occupies ⌈(L_i + S)/pg⌉ blocks (Eq. 5 rounded up to
    block granularity).  Unlike the closed form, ``max_batch_size`` counts
    *currently free* blocks.

    ``reserve_batch`` / ``release_blocks`` track in-flight slices for
    runtimes that overlap batch execution on one machine.  The current
    cluster runtimes serve one batch per worker at a time (RealCluster
    additionally enforces the envelope with a real per-worker
    ``repro.kvcache.PageAllocator``), so they admit via ``fits`` alone and
    ``reserved_blocks`` stays 0 there — any future overlapped-execution
    runtime must reserve around each in-flight slice or it will
    over-admit.

    Retention (``kv_retain``, the persistent-paged StaticEngine path):
    with ``kv_retain="request"`` the real backend keeps each in-flight
    request's prefix pages resident across slices, and ``retained_blocks``
    gauges them.  The Eq. 5–9 feasibility math deliberately still counts
    retained pages as *free*: retained prefixes are reclaimable on demand
    (the engine's evict-on-pressure path falls back to classic §3.3
    re-prefill), so a scheduled batch can always claim its envelope — the
    no-OOM guarantee is exactly the slice-scoped one, while the gauge
    makes the retention state observable (``/healthz``, benchmarks).
    """

    delta_bytes: float          # Δ: KV bytes per token (per model shard)
    m_available: float          # M_ava = M_cap - M_model - M_engine (bytes)
    page_tokens: int = 16       # block size in cache slots
    zeta: float = 1.0           # engine fragmentation factor (Eq. 9)
    bucket: int = 1
    kv_retain: str = "slice"    # "slice" | "request" (see RealBackend)

    def __post_init__(self):
        if self.kv_retain not in ("slice", "request"):
            raise ValueError(f"unknown kv_retain {self.kv_retain!r} "
                             f"(expected 'slice' or 'request')")
        bytes_per_block = self.page_tokens * self.delta_bytes
        self.total_blocks = (int(self.zeta * self.m_available
                                 // bytes_per_block)
                             if bytes_per_block > 0 else 0)
        self.reserved_blocks = 0
        #: observability gauge (never admission): blocks currently held by
        #: retained/in-flight requests on the real engines
        self.retained_blocks = 0

    # ------------------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return self.total_blocks - self.reserved_blocks

    def blocks_per_request(self, L_i: int, S: int) -> int:
        return blocks_for(bucket_len(L_i, self.bucket) + S, self.page_tokens)

    def fits(self, N: int, L_i: int, S: int) -> bool:
        if N <= 0:
            return True
        if self.total_blocks == 0:  # Δ = 0: memory model cannot bind
            return N <= MAX_BATCH_SIZE_CAP
        return N * self.blocks_per_request(L_i, S) <= self.free_blocks

    def max_batch_size(self, L_i: int, S: int) -> int:
        """Counts free blocks — NOT the ζ·M_ava closed form."""
        if self.total_blocks == 0:
            return MAX_BATCH_SIZE_CAP
        return min(self.free_blocks // self.blocks_per_request(L_i, S),
                   MAX_BATCH_SIZE_CAP)

    def fits_envelope(self, prefix_blocks: int) -> bool:
        """Envelope-exact Eq. 5–9: admit a batch charged the SUM of its
        members' per-request envelopes Σ_j ⌈(L_j + S)/pg⌉, not the
        batch-max ``N · ⌈(L_max + S)/pg⌉`` that ``fits`` rounds up to.
        Since Σ_j blocks_j ≤ N · blocks_max always, this bound is at
        least as permissive as ``fits`` for the same batch — mixed-length
        batches stop paying for the longest member's envelope N times.

        ``prefix_blocks`` is that sum (the envelope DP supplies it as a
        prefix-sum difference, keeping each transition O(1)).  Monotone:
        widening a sorted batch only grows the sum, so a DP may break on
        the first failure.  When Δ = 0 the pool is unbounded and nothing
        binds — callers must cap N at ``MAX_BATCH_SIZE_CAP`` themselves
        (``fits`` bounds N directly; a block sum cannot).
        """
        if prefix_blocks <= 0:
            return True
        if self.total_blocks == 0:  # Δ = 0: memory model cannot bind
            return True
        return prefix_blocks <= self.free_blocks

    # ------------------------------------------------------------------
    # in-flight accounting (cluster runtimes)
    # ------------------------------------------------------------------
    def reserve_batch(self, N: int, L_i: int, S: int) -> int:
        """Reserve a scheduled batch's blocks; returns the count to release."""
        blocks = N * self.blocks_per_request(L_i, S)
        self.reserved_blocks += blocks
        return blocks

    def release_blocks(self, blocks: int) -> None:
        self.reserved_blocks = max(0, self.reserved_blocks - blocks)


def model_kv_delta(n_layers: int, n_kv_heads: int, head_dim: int,
                   bytes_per_el: int = 2, n_model_shards: int = 1) -> float:
    """Δ for a dense GQA transformer (2 = K and V)."""
    return 2.0 * n_layers * n_kv_heads * head_dim * bytes_per_el / max(
        min(n_model_shards, n_kv_heads), 1)


# LLaMA2-13B: 40 layers, 40 heads, 128 head_dim, fp16
LLAMA2_13B_DELTA = model_kv_delta(40, 40, 128, 2)
# A100-80GB serving LLaMA2-13B (26GB weights fp16, ~4GB engine overhead)
A100_80GB_AVAILABLE = 80e9 - 26e9 - 4e9
