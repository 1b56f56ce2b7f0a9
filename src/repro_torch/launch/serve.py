"""Serving launcher: the SCLS scheduler over the port's engines.

  # persistent paged engines on the card (every token really computed):
  # prefix pages survive across slices, so a resumed slice re-prefills
  # nothing, and prompts that share pages with a resident request
  # prefill only their tail
  PYTHONPATH=src python -m repro_torch.launch.serve --backend real \\
      --arch llama3.2-1b --reduced --workers 1 --rate 2 --duration 8

  # the same on the CPU (plain versions of the kernels)
  PYTHONPATH=src python -m repro_torch.launch.serve --backend real \\
      --device cpu --reduced --max-input 64 --max-gen 16 --slice-len 8

  # discrete-event sim backend (no model): the same scheduler code
  PYTHONPATH=src python -m repro_torch.launch.serve --backend sim

The real backend profiles the engine, fits the Eq. 3/4 estimator, builds
a ``PagedMemoryEstimator`` over ``--m-available`` bytes and one
persistent paged ``StaticEngine`` per worker whose page pool is exactly
that budget (``kv_retain="request"``, COW prefix sharing on unless
``--no-prefix-sharing``), then replays a CodeFuse-shaped Poisson trace
through ``SchedulerCore.run`` and prints the metrics as JSON.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.metrics import RunMetrics
from repro_torch.cluster.trace import CODEFUSE, generate_trace
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.estimator import a100_llama13b_profile
from repro_torch.core.memory import PagedMemoryEstimator, RuleBasedMemoryEstimator
from repro_torch.core.request import Request
from repro_torch.core.schedulers import ALL_STRATEGIES, make_strategy
from repro_torch.serving import (RealBackend, SchedulerCore, SimBackend,
                                 fitted_estimator)

#: minimal schedule interval Γ (s), as the JAX launcher sets it
GAMMA = 0.25


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backend", default="real", choices=["real", "sim"])
    ap.add_argument("--device", default=None,
                    help="torch device of the real backend (default: the "
                         "CUDA card; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--arch", default="llama3.2-1b", choices=list(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced float32 config")
    ap.add_argument("--strategy", default="scls", choices=ALL_STRATEGIES)
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--rate", type=float, default=2.0,
                    help="Poisson arrivals per second")
    ap.add_argument("--duration", type=float, default=8.0,
                    help="trace length in seconds")
    ap.add_argument("--slice-len", type=int, default=64)
    ap.add_argument("--max-gen", type=int, default=256)
    ap.add_argument("--max-input", type=int, default=CODEFUSE.max_input,
                    help="prompt-length cap of the CodeFuse trace")
    ap.add_argument("--page-tokens", type=int, default=16)
    ap.add_argument("--m-available", type=float, default=256e6,
                    help="KV bytes per worker (the page pool, Eq. 5-9)")
    ap.add_argument("--no-prefix-sharing", dest="prefix_sharing",
                    action="store_false",
                    help="disable COW prefix-page sharing")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="add this many pairs of requests in which the "
                         "second prompt repeats >= 2 pages of the first")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def make_trace(args: argparse.Namespace, vocab: Optional[int]
               ) -> List[Request]:
    """The CodeFuse-shaped trace, plus ``--shared-prefix`` pairs.

    In each pair the first request arrives at t=0 and generates
    ``max_gen`` tokens, so it stays resident for several slices; the
    second arrives just after the first scheduling tick with a prompt
    that repeats the first's leading pages (half its prompt, at least two
    pages) followed by a novel tail, so it joins those pages and prefills
    only the tail."""
    spec = dataclasses.replace(CODEFUSE, max_gen=args.max_gen,
                               max_input=args.max_input)
    trace = generate_trace(args.rate, args.duration, spec, seed=args.seed,
                           vocab_size=vocab)
    if not args.shared_prefix:
        return trace
    if vocab is None:
        raise ValueError("--shared-prefix needs real prompts")
    pg = args.page_tokens
    rng = np.random.default_rng(args.seed + 1)
    rid = len(trace)
    for _ in range(args.shared_prefix):
        n_src = int(rng.integers(3 * pg, max(3 * pg, args.max_input) + 1))
        src = rng.integers(0, vocab, size=n_src).astype(np.int32)
        shared = max(2 * pg, (n_src // 2) // pg * pg)
        tail = rng.integers(0, vocab, size=pg + 1).astype(np.int32)
        joiner = np.concatenate([src[:shared], tail])
        gen = int(rng.integers(1, args.max_gen + 1))
        trace.append(Request(rid=rid, arrival=0.0, input_len=n_src,
                             gen_len=args.max_gen, max_gen=args.max_gen,
                             prompt=src))
        trace.append(Request(rid=rid + 1, arrival=1e-3,
                             input_len=len(joiner), gen_len=gen,
                             max_gen=args.max_gen, prompt=joiner))
        rid += 2
    return trace


def build_core(args: argparse.Namespace) -> Tuple[SchedulerCore, list,
                                                   Optional[int]]:
    """(core, engines, vocab size) for the configured backend; the sim
    backend has no engines and no vocabulary."""
    strategy = make_strategy(args.strategy, slice_len=args.slice_len,
                             max_gen=args.max_gen, gamma=GAMMA,
                             kv_layout="paged" if args.backend == "real"
                             else "dense")
    if args.backend == "sim":
        # the paper's A100 / LLaMA2-13B testbed with DeepSpeed's memory rules
        true_lat = a100_llama13b_profile()
        backend = SimBackend(true_lat, seed=args.seed)
        core = SchedulerCore(strategy, backend, args.workers,
                             fitted_estimator(true_lat),
                             RuleBasedMemoryEstimator())
        return core, [], None

    from repro_torch import resolve_device
    from repro_torch.engine.profiler import fit_estimator
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.models.registry import get_model

    device = resolve_device(args.device)
    arch = get_config(args.arch, reduced=args.reduced)
    model = get_model(arch)
    params = model.init(args.seed, device=device)
    est, prmse, drmse = fit_estimator(model, params, batch_sizes=(1, 2, 4),
                                      input_lens=(16, 32, 64))
    print(f"[serve] estimator fitted: prefill rmse {prmse * 1e3:.2f} ms, "
          f"decode rmse {drmse * 1e3:.2f} ms")
    mem = PagedMemoryEstimator(delta_bytes=model.kv_bytes_per_token(),
                               m_available=args.m_available, zeta=0.9,
                               page_tokens=args.page_tokens, bucket=8,
                               kv_retain="request")
    if mem.total_blocks < 1:
        raise SystemExit(f"--m-available {args.m_available:g} holds no "
                         f"page of {args.page_tokens} tokens")
    engines = [StaticEngine(model, params, eos_id=1, len_bucket=8,
                            kv_layout="paged", page_tokens=args.page_tokens,
                            kv_pool_tokens=mem.total_blocks
                            * args.page_tokens,
                            prefix_sharing=args.prefix_sharing,
                            device=device)
               for _ in range(args.workers)]
    print(f"[serve] {arch.name} on {device}: {mem.total_blocks} pages of "
          f"{args.page_tokens} tokens per worker, kv_retain=request, "
          f"prefix sharing {'on' if args.prefix_sharing else 'off'}")
    backend = RealBackend(engines, mem=mem, kv_layout="paged",
                          sched_bucket=est.bucket, kv_retain="request")
    core = SchedulerCore(strategy, backend, args.workers, est, mem)
    return core, engines, arch.vocab_size


def main(argv: Optional[Sequence[str]] = None) -> RunMetrics:
    args = parse_args(argv)
    core, _, vocab = build_core(args)
    trace = make_trace(args, vocab)
    metrics = core.run(trace, args.duration)
    print(json.dumps(dataclasses.asdict(metrics)))
    if metrics.n_completed != metrics.n_requests:
        raise SystemExit(f"[serve] FAILED: {metrics.n_completed} of "
                         f"{metrics.n_requests} requests completed")
    return metrics


if __name__ == "__main__":
    main()
