"""One-time engine profiling → serving-time estimator fitting (paper §4.2).

Profiles T_prefill(N, L) and τ_decode(l, N) on the real model through
its dense ``prefill``/``decode_step`` at a grid of batch sizes and
lengths, then fits Eq. 3/4 by least squares.  On a CUDA device every
timed region ends in ``torch.cuda.synchronize``.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.estimator import ServingTimeEstimator
from repro_torch.models.registry import Model


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def profile_engine(model: Model, params, batch_sizes: Sequence[int],
                   input_lens: Sequence[int], n_decode_iters: int = 4,
                   repeats: int = 2, seed: int = 0
                   ) -> Tuple[List[tuple], List[tuple]]:
    """Returns (prefill_samples, decode_samples) of (N, L, seconds)."""
    rng = np.random.default_rng(seed)
    cfg = model.cfg
    dev = params.embed.table.device
    prefill_samples, decode_samples = [], []

    for N in batch_sizes:
        for L in input_lens:
            toks = rng.integers(2, cfg.vocab_size, size=(N, L)).astype(np.int32)
            batch = {"tokens": torch.from_numpy(toks).to(dev),
                     "lengths": torch.full((N,), L, dtype=torch.int32,
                                           device=dev)}
            cache_window = L + n_decode_iters + 1
            last, cache = model.prefill(params, batch, cache_window)  # warmup
            _sync(dev)
            best_p = np.inf
            for _ in range(repeats):
                t0 = time.perf_counter()
                model.prefill(params, batch, cache_window)
                _sync(dev)
                best_p = min(best_p, time.perf_counter() - t0)
            prefill_samples.append((N, L, best_p))

            cur = torch.argmax(last, -1).to(torch.int32)
            model.decode_step(params, cache, cur, 0)  # warmup
            _sync(dev)
            best_d = np.inf
            for _ in range(repeats):
                t0 = time.perf_counter()
                for s in range(n_decode_iters):
                    lg, cache = model.decode_step(params, cache, cur, s)
                _sync(dev)
                best_d = min(best_d, (time.perf_counter() - t0) / n_decode_iters)
            decode_samples.append((N, L, best_d))
    return prefill_samples, decode_samples


def fit_estimator(model: Model, params, batch_sizes=(1, 2, 4),
                  input_lens=(16, 32, 64), bucket: int = 1,
                  **kw) -> Tuple[ServingTimeEstimator, float, float]:
    pre, dec = profile_engine(model, params, batch_sizes, input_lens, **kw)
    return ServingTimeEstimator.fit(pre, dec, bucket=bucket)
