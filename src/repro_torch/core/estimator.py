"""Serving-time estimator (paper §4.2, Eq. 1–4).

  T_prefill(N, L) = p1·N·L + p2·N + p3·L + p4               (Eq. 3)
  τ_decode(l, N)  = d1·N·l + d2·N + d3·l + d4               (Eq. 4)
  T_serve(N, L_i, L_o) = T_prefill + Σ_{l=1..L_o} τ(L_i+l, N)   (Eq. 1–2)

The decode sum has the closed form used below (τ is affine in l), so the
O(n²) DP batcher evaluates T_serve in O(1).  Coefficients are fit by linear
least squares on one-time per-iteration profiles — no re-profiling when the
slice length changes (the paper's key practicality argument).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence, Tuple

import numpy as np

from repro_torch.core.request import bucket_len


@dataclasses.dataclass
class LatencyCoeffs:
    """(c1·N·L + c2·N + c3·L + c4) coefficient quadruple."""

    c1: float
    c2: float
    c3: float
    c4: float

    def __call__(self, N, L):
        return self.c1 * N * L + self.c2 * N + self.c3 * L + self.c4

    def as_array(self) -> np.ndarray:
        return np.array([self.c1, self.c2, self.c3, self.c4])


def fit_bilinear(samples: Iterable[Tuple[float, float, float]]) -> Tuple[LatencyCoeffs, float]:
    """samples: (N, L, seconds) -> (coeffs, rmse)."""
    pts = np.asarray(list(samples), dtype=np.float64)
    N, L, t = pts[:, 0], pts[:, 1], pts[:, 2]
    X = np.stack([N * L, N, L, np.ones_like(N)], axis=1)
    beta, *_ = np.linalg.lstsq(X, t, rcond=None)
    resid = X @ beta - t
    rmse = float(np.sqrt(np.mean(resid ** 2)))
    return LatencyCoeffs(*beta), rmse


@dataclasses.dataclass
class ServingTimeEstimator:
    prefill: LatencyCoeffs
    decode: LatencyCoeffs
    bucket: int = 1  # TPU shape-bucketing (DESIGN.md §8); 1 = paper-exact

    # -- paper Eq. 3 --
    def t_prefill(self, N: int, L_i: int) -> float:
        return max(self.prefill(N, bucket_len(L_i, self.bucket)), 0.0)

    # -- paper Eq. 4 --
    def tau_decode(self, l: int, N: int) -> float:
        return max(self.decode(N, l), 0.0)

    # -- paper Eq. 2 closed form:
    #   Σ_{l=1..S} τ(L+l, N) = S·(d2·N + d4) + (d1·N + d3)·(S·L + S(S+1)/2)
    def t_decode_sum(self, N: int, L_i: int, L_o: int) -> float:
        L = bucket_len(L_i, self.bucket)
        d = self.decode
        s = L_o * (d.c2 * N + d.c4) + (d.c1 * N + d.c3) * (L_o * L + L_o * (L_o + 1) / 2.0)
        return max(s, 0.0)

    # -- paper Eq. 1 --
    def t_serve(self, N: int, L_i: int, L_o: int) -> float:
        return self.t_prefill(N, L_i) + self.t_decode_sum(N, L_i, L_o)

    @classmethod
    def fit(cls, prefill_samples, decode_samples, bucket: int = 1
            ) -> Tuple["ServingTimeEstimator", float, float]:
        """prefill_samples: (N, L_i, t); decode_samples: (N, l_cached, t)."""
        pc, prmse = fit_bilinear(prefill_samples)
        dc, drmse = fit_bilinear(decode_samples)
        return cls(pc, dc, bucket=bucket), prmse, drmse


# ---------------------------------------------------------------------------
# calibrated latency profiles
# ---------------------------------------------------------------------------
def a100_llama13b_profile() -> "ServingTimeEstimator":
    """Synthetic calibration matching the paper's Fig. 8/9 scales for
    LLaMA2-13B on A100-80GB under deepspeed-inference (DESIGN.md §2):
    prefill grows ~linearly in N and L (Fig. 8); per-iteration decode is
    dominated by the N·l and l terms (Fig. 9), with a small fixed base —
    which is what makes separate batching win in the paper's Fig. 11.
    Used by the cluster simulator as the *ground-truth* latency model."""
    # prefill: compute-bound, ~0.87s at N=12, L=1024 (Fig. 8)
    prefill = LatencyCoeffs(c1=6.0e-5, c2=1.0e-3, c3=1.0e-4, c4=2.0e-2)
    # decode: c4 = weight-streaming base (N-independent -> batching pays;
    # Fig. 9a shows ~30ms at N=1), c2 = per-request kernel overhead
    # (Fig. 9b slope ~1.7ms/request at l=1024 => c2 + c1·1024), c1 =
    # KV-cache stream; ~45ms at N=12, l=1024
    decode = LatencyCoeffs(c1=8.0e-7, c2=9.0e-4, c3=3.0e-6, c4=2.6e-2)
    return ServingTimeEstimator(prefill, decode)


def a100_llama13b_hf_profile() -> "ServingTimeEstimator":
    """HF-transformers profile: ~2.5-3x slower bases (paper Fig. 10: HF
    latency bases are much larger than DS).  Calibrated so the paper's
    Fig. 11 example reproduces: batching 15 short with 1 long request is
    ~2x slower than serving them separately."""
    # Fig. 11 calibration: 15x10 + 1x1024 together = ~2.5x the cost of
    # serving them as two batches (the big c1 = N·l term is what padding
    # inflates)
    prefill = LatencyCoeffs(c1=2.0e-4, c2=2.0e-3, c3=3.0e-4, c4=5.0e-2)
    decode = LatencyCoeffs(c1=4.0e-6, c2=1.0e-3, c3=6.0e-6, c4=8.0e-3)
    return ServingTimeEstimator(prefill, decode)
