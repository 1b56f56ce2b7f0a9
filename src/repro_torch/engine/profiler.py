"""One-time engine profiling → serving-time estimator fitting (paper §4.2).

Profiles T_prefill(N, L) and τ_decode(l, N) on the real model through
its dense ``prefill``/``decode_step`` at a grid of batch sizes and
lengths, then fits Eq. 3/4 by least squares.  On a CUDA device every
timed region ends in ``torch.cuda.synchronize``.  The prefills and the
decode steps are timed as the engines run them: a prefill
(``graphs.Prefill``) and a decode step (``graphs.Step``) captured over
static buffers and replayed, each capture paid before the clock starts,
as the JAX profiler pays its compile of the jitted prefill and
``decode_step``; eagerly where ``graphs.eager_reason`` says.
"""
from __future__ import annotations

import time
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.estimator import ServingTimeEstimator
from repro_torch.engine import graphs
from repro_torch.models.registry import Model


def _decoder(model: Model, params, cache, cur: torch.Tensor):
    """A callable that runs one decode step of ``cur`` over ``cache``,
    advancing the cache and the step counter: a ``graphs.Step`` over an
    arena copy of the cache (captured at its first call on the card), or
    the model's eager step."""
    dev = cur.device
    if graphs.eager_reason(params, model.cfg.family) is not None:
        state = {"cache": cache, "step": 0}

        def eager() -> None:
            _, state["cache"] = model.decode_step(params, state["cache"], cur,
                                                  state["step"])
            state["step"] += 1
        return eager
    static = graphs.Arena(dev).views(cache)
    graphs.fill(static, cache)
    step = torch.zeros((), dtype=torch.int64, device=dev)

    def fn() -> None:
        _, new = model.decode_step(params, static, cur, step)
        graphs.copy_back(static, new)
        step.add_(1)

    return graphs.GraphCache(dev).add("decode", fn, dict(cache=static))


def _prefiller(model: Model, params, batch, cache_window: int):
    """(a callable that runs ``model.prefill(params, batch,
    cache_window)``, the dict whose "last" and "cache" it leaves the last
    logits and the cache in): a ``graphs.Prefill`` over ``batch``'s
    tensors that copies them into buffers made at its first call (captured
    at its first call on the card), or the eager prefill."""
    dev = batch["tokens"].device
    bufs: dict = {}
    if graphs.eager_reason(params, model.cfg.family) is not None:
        def eager() -> None:
            bufs["last"], bufs["cache"] = model.prefill(params, batch,
                                                        cache_window)
        return eager, bufs

    def fn() -> None:
        last, cache = model.prefill(params, batch, cache_window)
        if "cache" not in bufs:
            bufs["last"] = torch.empty_like(last)
            bufs["cache"] = graphs.Arena(dev).views(cache)
        bufs["last"].copy_(last)
        graphs.fill(bufs["cache"], cache)

    return graphs.GraphCache(dev).add_prefill("prefill", fn, bufs), bufs


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
            prefill, out = _prefiller(model, params, batch, cache_window)
            prefill()  # warmup (and the capture)
            _sync(dev)
            best_p = np.inf
            for _ in range(repeats):
                t0 = time.perf_counter()
                prefill()
                _sync(dev)
                best_p = min(best_p, time.perf_counter() - t0)
            prefill_samples.append((N, L, best_p))
            last, cache = out["last"], out["cache"]

            cur = torch.argmax(last, -1).to(torch.int32)
            decode = _decoder(model, params, cache, cur)
            decode()  # warmup (and the capture)
            _sync(dev)
            best_d = np.inf
            for _ in range(repeats):
                t0 = time.perf_counter()
                for _ in range(n_decode_iters):
                    decode()
                _sync(dev)
                best_d = min(best_d, (time.perf_counter() - t0) / n_decode_iters)
            decode_samples.append((N, L, best_d))
    return prefill_samples, decode_samples


def fit_estimator(model: Model, params, batch_sizes=(1, 2, 4),
                  input_lens=(16, 32, 64), bucket: int = 1,
                  **kw) -> Tuple[ServingTimeEstimator, float, float]:
    pre, dec = profile_engine(model, params, batch_sizes, input_lens, **kw)
    return ServingTimeEstimator.fit(pre, dec, bucket=bucket)
