"""Workload generation: Poisson arrivals + generation-length distributions
matching the paper's Fig. 6 (CodeFuse / ShareGPT: the vast majority of
requests generate < 512 tokens, with a thin tail to the 1024 limit)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.core.request import Request


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    # log-normal parameters for input and generation lengths
    input_mu: float
    input_sigma: float
    gen_mu: float
    gen_sigma: float
    max_input: int = 1024
    max_gen: int = 1024


# CodeFuse-like (Fig. 6a): code prompts are long-ish, generations mostly short
CODEFUSE = WorkloadSpec("codefuse", input_mu=5.3, input_sigma=0.9,
                        gen_mu=4.6, gen_sigma=1.0)
# ShareGPT-like (Fig. 6b): chattier, slightly longer generations
SHAREGPT = WorkloadSpec("sharegpt", input_mu=4.8, input_sigma=1.0,
                        gen_mu=5.0, gen_sigma=1.0)

WORKLOADS = {"codefuse": CODEFUSE, "sharegpt": SHAREGPT}


def _trunc_lognormal(rng, mu, sigma, lo, hi, size):
    x = rng.lognormal(mu, sigma, size=size)
    return np.clip(np.round(x), lo, hi).astype(int)


def generate_trace(rate: float, duration: float, spec: WorkloadSpec = CODEFUSE,
                   seed: int = 0, vocab_size: Optional[int] = None
                   ) -> List[Request]:
    """Poisson arrivals at ``rate`` req/s for ``duration`` seconds."""
    rng = np.random.default_rng(seed)
    n = rng.poisson(rate * duration)
    arrivals = np.sort(rng.uniform(0.0, duration, size=n))
    in_lens = _trunc_lognormal(rng, spec.input_mu, spec.input_sigma, 1, spec.max_input, n)
    gen_lens = _trunc_lognormal(rng, spec.gen_mu, spec.gen_sigma, 1, spec.max_gen, n)
    reqs = []
    for i in range(n):
        prompt = None
        if vocab_size is not None:
            prompt = rng.integers(0, vocab_size, size=int(in_lens[i])).astype(np.int32)
        reqs.append(Request(rid=i, arrival=float(arrivals[i]),
                            input_len=int(in_lens[i]), gen_len=int(gen_lens[i]),
                            max_gen=spec.max_gen, prompt=prompt))
    return reqs


def length_distribution_summary(reqs: List[Request]) -> dict:
    g = np.array([r.gen_len for r in reqs])
    return {
        "n": len(reqs),
        "gen_p50": float(np.percentile(g, 50)),
        "gen_p90": float(np.percentile(g, 90)),
        "gen_p99": float(np.percentile(g, 99)),
        "frac_lt_512": float(np.mean(g < 512)),
    }
