"""Serving launcher: run the full SCLS stack of the port through the
online ``repro_torch.serving`` API (SliceServer over one SchedulerCore).

  # the paper's SCLS on the card: dense per-slice KV caches, every
  # reschedule re-prefills prompt + generated tokens (§3.3)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
      --reduced --workers 1 --rate 2 --duration 8

  # persistent paged engines: prefix pages survive across slices, so a
  # resumed slice re-prefills nothing, and prompts that share pages with a
  # resident request prefill only their tail
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --kv-layout paged --kv-retain request --reduced

  # the same on the CPU (plain versions of the kernels)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --reduced --max-input 64 --max-gen 16 --slice-len 8

  # prediction-aware scheduling (repro_torch.predict) with a Chrome trace
  # of the run (+ the scheduler decision audit next to it)
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --reduced --max-input 64 --max-gen 16 --slice-len 8 \\
      --strategy scls-pred --predictor histogram --trace-out trace.json

  # Mamba-2 through dense SCLS (its prefill on the ssd_scan kernel); the
  # SSM's decode state has a constant size, so Δ = 0 and the dense memory
  # model admits MAX_BATCH_SIZE_CAP rows, as in JAX
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \\
      --device cpu --reduced --max-input 64 --max-gen 16 --slice-len 8

  # the MoE and hybrid families through dense SCLS (mixtral-8x22b's and
  # recurrentgemma-9b's attention on the kernels, deepseek-v2-lite-16b's
  # MLA and every MoE dispatch and RG-LRU scan in plain torch)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \\
      --device cpu --reduced --max-input 64 --max-gen 16 --slice-len 8

  # discrete-event sim backend (no model): the same scheduler code
  PYTHONPATH=src python -m repro_torch.launch.serve --backend sim

  # an OpenAI-compatible HTTP endpoint instead of the trace replay
  # (repro_torch.serving.http; 0 = an ephemeral port, --duration <= 0
  # serves until interrupted); several such instances behind
  # ``python -m repro_torch.launch.route`` make a fleet
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
      --reduced --kv-layout paged --kv-retain request --http-port 8001 \
      --duration 0

Every flag of ``ServingConfig.add_cli_args`` is accepted, plus the
launcher's own ``--max-input`` (the CodeFuse trace's prompt cap) and
``--shared-prefix`` (pairs of requests whose prompts share pages).  The
model is served at full width unless ``--reduced`` is given.

The real backend profiles the engine and fits the Eq. 3/4 estimator.
Its memory model follows ``--kv-layout``: ``AnalyticMemoryEstimator``
(Eq. 5-9) over ``--m-available`` bytes for ``dense``, a
``PagedMemoryEstimator`` of the same bytes for ``paged``.  With
``--kv-retain request`` each worker is a persistent paged
``StaticEngine`` whose page pool is exactly that budget (COW prefix
sharing on unless ``--no-prefix-sharing``); with ``slice`` (the default)
each worker is a dense engine that prefills every slice afresh, and a
paged layout keeps per-worker page envelopes in the backend.  A
CodeFuse-shaped Poisson trace is replayed through ``SliceServer`` — plus
one *interactive* request submitted mid-run and streamed per slice — then
the server drains, the metrics are printed as JSON, and ``--trace-out``
writes the trace and the decision audit.  With ``--http-port`` the server
is fronted by :class:`~repro_torch.serving.http.HTTPFrontend` for
``--duration`` seconds instead, then drains.
"""
from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.cluster.metrics import RunMetrics
from repro_torch.cluster.trace import CODEFUSE, generate_trace
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.request import Request
from repro_torch.serving import (HTTPFrontend, RequestHandle, ServingConfig,
                                 SliceServer, default_sim_environment)

#: the launcher's defaults for ``ServingConfig.from_cli`` (a flag the user
#: passes wins): the real backend at full width, one worker, Γ = 0.25 s as
#: the JAX launcher sets it, slices of 64 up to 256 tokens
DEFAULTS = dict(backend="real", reduced=False, workers=1, slice_len=64,
                max_gen=256, gamma=0.25, rate=2.0, duration=8.0,
                mem_bucket=8)


def _launcher_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--max-input", type=int, default=CODEFUSE.max_input,
                    help="prompt-length cap of the CodeFuse trace")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="add this many pairs of requests in which the "
                         "second prompt repeats >= 2 pages of the first")
    return ap


def parse_args(argv: Optional[Sequence[str]] = None
               ) -> Tuple[ServingConfig, argparse.Namespace]:
    """(the validated ``ServingConfig``, the launcher's own flags)."""
    opts, rest = _launcher_parser().parse_known_args(argv)
    cfg = ServingConfig.from_cli(
        rest, description=__doc__.splitlines()[0]
        + " (launcher flags: --max-input N, --shared-prefix N)", **DEFAULTS)
    return cfg, opts


def make_trace(cfg: ServingConfig, opts: argparse.Namespace,
               vocab: Optional[int]) -> List[Request]:
    """The CodeFuse-shaped trace, plus ``--shared-prefix`` pairs.

    In each pair the first request arrives at t=0 and generates
    ``max_gen`` tokens, so it stays resident for several slices; the
    second arrives just after the first scheduling tick with a prompt
    that repeats the first's leading pages (half its prompt, at least two
    pages) followed by a novel tail, so it joins those pages and prefills
    only the tail."""
    spec = dataclasses.replace(CODEFUSE, max_gen=cfg.max_gen,
                               max_input=opts.max_input)
    trace = generate_trace(cfg.rate, cfg.duration, spec, seed=cfg.seed,
                           vocab_size=vocab or None)
    if not opts.shared_prefix:
        return trace
    if not vocab:
        raise ValueError("--shared-prefix needs real prompts")
    pg = cfg.page_tokens
    rng = np.random.default_rng(cfg.seed + 1)
    rid = len(trace)
    for _ in range(opts.shared_prefix):
        n_src = int(rng.integers(3 * pg, max(3 * pg, opts.max_input) + 1))
        src = rng.integers(0, vocab, size=n_src).astype(np.int32)
        shared = max(2 * pg, (n_src // 2) // pg * pg)
        tail = rng.integers(0, vocab, size=pg + 1).astype(np.int32)
        joiner = np.concatenate([src[:shared], tail])
        gen = int(rng.integers(1, cfg.max_gen + 1))
        trace.append(Request(rid=rid, arrival=0.0, input_len=n_src,
                             gen_len=cfg.max_gen, max_gen=cfg.max_gen,
                             prompt=src))
        trace.append(Request(rid=rid + 1, arrival=1e-3,
                             input_len=len(joiner), gen_len=gen,
                             max_gen=cfg.max_gen, prompt=joiner))
        rid += 2
    return trace


def build_server(cfg: ServingConfig) -> Tuple[SliceServer, int]:
    """(server, vocab_size) for the configured backend; the sim backend
    has no vocabulary (0)."""
    if cfg.backend == "sim":
        # the paper's A100 / LLaMA2-13B testbed with DeepSpeed's memory
        # rules, or its block pool for a paged layout
        true_lat, est, mem = default_sim_environment(
            paged=cfg.kv_layout == "paged", page_tokens=cfg.page_tokens)
        return cfg.build_sim(true_lat, est, mem), 0

    from repro_torch import resolve_device
    from repro_torch.engine.profiler import fit_estimator
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.models.registry import get_model

    if cfg.arch not in ARCHS:
        raise SystemExit(f"unknown --arch {cfg.arch!r}; choose from "
                         f"{sorted(ARCHS)}")
    device = resolve_device(cfg.device)
    arch = get_config(cfg.arch, reduced=cfg.reduced)
    if arch.family not in ("dense", "moe", "ssm", "hybrid"):
        raise SystemExit(f"serve launcher drives token-only archs; "
                         f"{cfg.arch} needs frontend embeddings (use examples/)")
    if cfg.kv_retain == "request" and arch.family != "dense":
        raise SystemExit(f"--kv-retain request drives the persistent paged "
                         f"StaticEngine (dense family only); {cfg.arch} is "
                         f"{arch.family}")
    model = get_model(arch)
    params = model.init(cfg.seed, device=device)
    est, prmse, drmse = fit_estimator(model, params, batch_sizes=(1, 2, 4),
                                      input_lens=(16, 32, 64))
    print(f"[serve] estimator fitted: prefill rmse {prmse * 1e3:.2f} ms, "
          f"decode rmse {drmse * 1e3:.2f} ms")
    try:
        mem = cfg.memory_estimator(model.kv_bytes_per_token())
    except ValueError as e:
        raise SystemExit(f"--m-available {cfg.m_available:g} holds no page "
                         f"of {cfg.page_tokens} tokens: {e}") from e
    if cfg.kv_retain == "request":
        # persistent paged storage: each engine owns the page pool the
        # scheduler budgets, and prefix pages survive across slices
        engines = [StaticEngine(model, params, eos_id=1, len_bucket=8,
                                kv_layout="paged",
                                page_tokens=cfg.page_tokens,
                                kv_pool_tokens=mem.total_blocks
                                * cfg.page_tokens,
                                prefix_sharing=cfg.prefix_sharing,
                                device=device)
                   for _ in range(cfg.workers)]
        kv = (f"{mem.total_blocks} pages of {cfg.page_tokens} tokens per "
              f"worker, kv_retain=request, prefix sharing "
              f"{'on' if cfg.prefix_sharing else 'off'}")
    else:
        engines = [StaticEngine(model, params, eos_id=1, len_bucket=8,
                                device=device)
                   for _ in range(cfg.workers)]
        kv = (f"dense engines, kv_layout={cfg.kv_layout}, "
              f"kv_retain=slice")
    print(f"[serve] {arch.name} on {device}: {kv}")
    return cfg.build_real(engines, est, mem), arch.vocab_size


def submit_interactive(server: SliceServer, cfg: ServingConfig, vocab: int,
                       gen_len: int = 10) -> RequestHandle:
    """One interactive request through the online path: a 12-token
    prompt (on the real backend) submitted mid-run, at
    ``min(duration / 2, 1)`` s, generating ``min(gen_len, max_gen)``
    tokens."""
    rng = np.random.default_rng(cfg.seed + 1)
    prompt = (rng.integers(0, vocab, size=12).astype(np.int32)
              if vocab else None)
    return server.submit(prompt, input_len=12,
                         gen_len=min(gen_len, cfg.max_gen),
                         max_gen=cfg.max_gen,
                         arrival=min(cfg.duration / 2, 1.0))


def export_trace(cfg: ServingConfig, server: SliceServer) -> List[str]:
    """--trace-out: write the Chrome trace (+ the decision-audit dump
    alongside it) after the run; returns the paths written."""
    if cfg.trace_out is None:
        return []
    paths = server.core.obs.export(cfg.trace_out)
    for path in paths:
        print(f"[serve] wrote {path}")
    return paths


def start_http(cfg: ServingConfig, server: SliceServer,
               vocab: int) -> HTTPFrontend:
    """Front ``server`` with the OpenAI-compatible HTTP endpoint on
    ``--http-host``:``--http-port`` (0 = ephemeral) and start it; the
    model name is ``--arch`` on the real backend, ``scls-sim`` on the
    sim one."""
    model_name = cfg.arch if cfg.backend == "real" else "scls-sim"
    front = HTTPFrontend(server.aio, host=cfg.http_host,
                         port=cfg.http_port, model_name=model_name,
                         vocab_size=vocab)
    front.start()
    print(f"[serve] http listening on {front.url} "
          f"(model={model_name}, slo_ms={cfg.slo_ms}, "
          f"time_scale={cfg.time_scale})", flush=True)
    return front


def serve_http(cfg: ServingConfig, server: SliceServer, vocab: int) -> None:
    """--http-port mode: expose the server over the OpenAI-compatible
    HTTP front end until --duration elapses (<= 0 = forever), then drain
    it and write --trace-out."""
    front = start_http(cfg, server, vocab)
    try:
        if cfg.duration > 0:
            time.sleep(cfg.duration)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    front.shutdown(drain=True)
    m = server.metrics()
    stats = server.admission_stats
    print(f"[serve] http served {m.n_completed} completions "
          f"({stats['n_submitted']} submitted, {stats['n_rejected']} "
          f"rejected, {stats['n_degraded']} degraded); "
          f"SLO attainment {m.slo_attainment:.2f}", flush=True)
    export_trace(cfg, server)


def main(argv: Optional[Sequence[str]] = None) -> RunMetrics:
    cfg, opts = parse_args(argv)
    print(f"[serve] backend={cfg.backend} strategy={cfg.strategy} "
          f"workers={cfg.workers}"
          + (f" arch={cfg.arch} (reduced={cfg.reduced})"
             if cfg.backend == "real" else ""))
    server, vocab = build_server(cfg)
    if cfg.http_port is not None:
        serve_http(cfg, server, vocab)
        return server.metrics()
    trace = make_trace(cfg, opts, vocab)
    handles = server.replay(trace)

    # one interactive request through the online path: submit mid-run,
    # stream its tokens per slice, then read the finalized result
    live = submit_interactive(server, cfg, vocab)
    streamed = list(itertools.islice(live.tokens(), 6))
    print(f"[serve] interactive rid={live.rid} streamed "
          f"{len(streamed)} tokens: {streamed}")
    live.result()

    metrics = server.drain(cfg.duration)
    export_trace(cfg, server)
    print(json.dumps(dataclasses.asdict(metrics)))
    if server.core.predictor is not None:
        print(f"[serve] predictor={server.core.predictor.name} "
              f"calibration scale={server.core.calibrator.scale:.2f} "
              f"coverage={server.core.calibrator.empirical_coverage():.2f}")
    done = [h for h in handles if h.done]
    print(f"[serve] completed {len(done)}/{len(trace)}; "
          f"TTFT mean {metrics.ttft_mean:.3f}s, "
          f"p99 latency {metrics.p99_response:.3f}s, "
          f"reprefill {metrics.reprefill_tokens} tokens")
    if done:
        print(f"[serve] sample output ({done[0].rid}): "
              f"{done[0].output_tokens[:12]}")
    if not live.done or metrics.n_completed != metrics.n_requests:
        raise SystemExit(f"[serve] FAILED: {metrics.n_completed} of "
                         f"{metrics.n_requests} requests completed")
    return metrics


if __name__ == "__main__":
    main()
