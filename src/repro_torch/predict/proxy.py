"""Proxy-model length predictor: a small PyTorch MLP head trained online.

Follows the proxy-predictor line (arXiv 2404.08509): a model orders of
magnitude cheaper than the served LLM predicts generation length from
request features available at schedule time.  Here the head is a 2-layer
MLP over cheap scalar features (log input length, tokens generated so far,
and a prompt summary statistic), regressing ``log1p(remaining)``; it is
fitted online by mini-batch SGD on completed requests, so it needs no
offline training set and adapts to the live workload.

The port of ``repro.predict.proxy``: the features, the sample buffer, the
recency-biased minibatch padded to 32 rows and the weighted-MSE SGD step
are the reference's; the MLP is an ``nn.Module`` on an explicit device
(the CUDA card unless told otherwise), initialised from a seeded
``torch.Generator``, and the step takes its gradient from autograd.
``jax.random`` draws cannot be reproduced here, so parity with the
reference starts from its parameters carried across
(``repro_torch.weights.load_proxy_params``).  Every ``predict_remaining``
ends in one host sync (``.item()``).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import DeviceLike, resolve_device
from repro_torch.predict.base import LengthPredictor

_N_FEATURES = 4
_HIDDEN = 16
_BATCH = 32


class ProxyMLP(nn.Module):
    """``tanh(x @ w1 + b1) @ w2 + b2`` (4 → 16 → 1), parameters named and
    shaped as the reference's ``params`` dict."""

    def __init__(self, hidden: int = _HIDDEN, seed: int = 0,
                 device: DeviceLike = "cpu"):
        super().__init__()
        g = torch.Generator().manual_seed(int(seed))
        self.w1 = nn.Parameter(torch.randn(_N_FEATURES, hidden, generator=g)
                               * 0.3)
        self.b1 = nn.Parameter(torch.zeros(hidden))
        self.w2 = nn.Parameter(torch.randn(hidden, 1, generator=g) * 0.3)
        self.b2 = nn.Parameter(torch.zeros(1))
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(x @ self.w1 + self.b1)
        return (h @ self.w2 + self.b2)[..., 0]


def _loss(mlp: ProxyMLP, x: torch.Tensor, y: torch.Tensor,
          w: torch.Tensor) -> torch.Tensor:
    pred = mlp(x)
    return torch.sum(w * (pred - y) ** 2) / torch.clamp(torch.sum(w), min=1.0)


def _sgd_step(mlp: ProxyMLP, x: torch.Tensor, y: torch.Tensor,
              w: torch.Tensor, lr: float = 0.05) -> None:
    params = list(mlp.parameters())
    grads = torch.autograd.grad(_loss(mlp, x, y, w), params)
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)


class ProxyPredictor(LengthPredictor):
    name = "proxy"

    def __init__(self, max_gen: int = 1024, max_input: int = 1024,
                 lr: float = 0.05, window: int = 512, seed: int = 0,
                 steps_per_observe: int = 1, device: DeviceLike = None):
        self.max_gen = int(max_gen)
        self.max_input = int(max_input)
        self.lr = float(lr)
        self.steps_per_observe = int(steps_per_observe)
        self.device = resolve_device(device)
        self.mlp = ProxyMLP(seed=seed, device=self.device)
        self._buf: List[Tuple[np.ndarray, float]] = []
        self._window = int(window)
        self._cursor = 0
        self.n_observed = 0

    # ------------------------------------------------------------------
    def _features(self, input_len: int, generated: int, prompt) -> np.ndarray:
        prompt_stat = 0.0
        if prompt is not None and len(prompt):
            # cheap content signal: token-id dispersion, scaled to O(1)
            prompt_stat = float(np.std(prompt)) / (1.0 + float(np.mean(prompt)))
        return np.array([
            np.log1p(input_len) / np.log1p(self.max_input),
            np.log1p(generated) / np.log1p(self.max_gen),
            float(generated > 0),
            prompt_stat,
        ], dtype=np.float32)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    def predict_remaining(self, req) -> float:
        x = self._features(req.input_len, req.generated, req.prompt)
        with torch.no_grad():
            z = float(self.mlp(self._tensor(x[None, :]))[0].item())
        rem = float(np.expm1(np.clip(z, 0.0, np.log1p(self.max_gen))))
        return max(rem, 1.0)

    def observe(self, req) -> None:
        # two supervision points per completion: remaining at arrival and a
        # mid-generation conditional, so the `generated` feature is learned
        total = max(req.generated, 1)
        pairs = [(self._features(req.input_len, 0, req.prompt), total)]
        if total > 1:
            g = total // 2
            pairs.append((self._features(req.input_len, g, req.prompt),
                          total - g))
        for x, rem in pairs:
            item = (x, float(np.log1p(rem)))
            if len(self._buf) < self._window:
                self._buf.append(item)
            else:
                self._buf[self._cursor] = item
                self._cursor = (self._cursor + 1) % self._window
        self.n_observed += 1
        for _ in range(self.steps_per_observe):
            self._train_minibatch()

    def _train_minibatch(self) -> None:
        n = len(self._buf)
        if n == 0:
            return
        # deterministic recency-biased minibatch, padded to a fixed shape
        # as the reference pads it for its one compiled step
        take = min(_BATCH, n)
        idx = [(len(self._buf) + self._cursor - 1 - i) % n for i in range(take)]
        x = np.zeros((_BATCH, _N_FEATURES), dtype=np.float32)
        y = np.zeros((_BATCH,), dtype=np.float32)
        w = np.zeros((_BATCH,), dtype=np.float32)
        for row, j in enumerate(idx):
            x[row], y[row] = self._buf[j]
            w[row] = 1.0
        _sgd_step(self.mlp, self._tensor(x), self._tensor(y),
                  self._tensor(w), lr=self.lr)
