"""Token data pipeline for the training driver.

Deterministic synthetic corpus (Zipfian token stream with local structure)
chunked into fixed-length sequences, plus an iterator with host-side
prefetch semantics.  Real deployments would swap ``SyntheticCorpus`` for a
file-backed source; the interface is the same.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    vocab_size: int
    seed: int = 0
    zipf_a: float = 1.3

    def stream(self, n_tokens: int, offset: int = 0) -> np.ndarray:
        rng = np.random.default_rng(self.seed + offset)
        toks = rng.zipf(self.zipf_a, size=n_tokens) % (self.vocab_size - 2) + 2
        # weave in local bigram structure so the LM has something to learn
        rep = rng.random(n_tokens) < 0.15
        toks[1:][rep[1:]] = toks[:-1][rep[1:]]
        return toks.astype(np.int32)


class TokenBatcher:
    """Yields {tokens, loss_mask} batches of (B, T)."""

    def __init__(self, corpus: SyntheticCorpus, batch_size: int, seq_len: int,
                 start_step: int = 0):
        self.corpus = corpus
        self.B = batch_size
        self.T = seq_len
        self.step = start_step

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        n = self.B * self.T
        toks = self.corpus.stream(n, offset=self.step).reshape(self.B, self.T)
        self.step += 1
        return {"tokens": toks,
                "loss_mask": np.ones((self.B, self.T - 1), np.float32)}

    def state(self) -> dict:
        return {"step": self.step}

    def restore(self, state: dict) -> None:
        self.step = int(state["step"])
