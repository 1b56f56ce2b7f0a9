"""Paper-scale cluster comparison on the PyTorch/CUDA port: SLS vs ILS vs
SCLS (+ ablations) on 8 simulated A100/LLaMA2-13B workers, the shape of
Fig. 12/15/17, driven through the online ``repro_torch.serving`` API;
the counterpart of examples/serving_cluster.py, with its three sections:

  * ``sim``: every strategy runs a ``SliceServer`` (submit -> slice
    scheduling -> drain) over the shared ``SchedulerCore`` with the sim
    backend (host only);
  * ``aio``: the *concurrent* front end (``AsyncSliceServer``), a gather of
    asyncio clients with mixed per-request SLOs, one of which cancels
    mid-stream (host only);
  * ``real``: the REAL backend (reduced llama, every FLOP real, on the card
    unless ``--device cpu``) with ``--kv-retain request``: prefix KV pages
    persist in the engine across slices, so resumed slices re-prefill
    nothing -- asserted via ``reprefill_tokens == 0`` for uninterrupted
    requests (the paper's §3.3 overhead, eliminated).  On the card the
    paged path runs ``paged_prefill_write`` (B2) and
    ``paged_decode_attention`` (B1); their launches are printed.

  PYTHONPATH=src python examples/torch_serving_cluster.py [--rate 20] \\
      [--duration 300] [--section all|sim|aio|real] [--device cpu]

A failed check raises (exit code 1); the real section's last line is a
JSON summary.
"""
import argparse
import asyncio
import copy
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.memory import RuleBasedMemoryEstimator  # noqa: E402
from repro_torch.core.schedulers import ALL_STRATEGIES  # noqa: E402
from repro_torch.serving import (AdmissionRejected,  # noqa: E402
                                 ServingConfig, default_sim_environment)


async def concurrent_clients_demo() -> None:
    """N asyncio clients over one AsyncSliceServer, mixed SLOs, one
    mid-stream cancel."""
    server = ServingConfig(strategy="scls", workers=2, slice_len=64,
                           gamma=1.0).build_sim().aio
    # mixed traffic: generous SLOs, one unmeetable (shed at submit),
    # one best-effort (no SLO), one cancelled after its first slice
    jobs = [dict(input_len=96, gen_len=200, slo_ms=60_000),
            dict(input_len=64, gen_len=150, slo_ms=60_000),
            dict(input_len=48, gen_len=120, slo_ms=None),
            dict(input_len=900, gen_len=1000, slo_ms=200),   # doomed
            dict(input_len=80, gen_len=400, slo_ms=90_000)]  # cancels

    async def client(i: int, job: dict) -> str:
        try:
            h = server.submit(input_len=job["input_len"],
                              gen_len=job["gen_len"], slo_ms=job["slo_ms"])
        except AdmissionRejected as e:
            return f"client {i}: REJECTED at submit ({e.decision.reason})"
        n_stream = 0
        async for _tok in h.tokens():
            n_stream += 1
            if i == 4 and n_stream >= 64:  # one slice in: hang up
                h.cancel()
                break
        await h.result()
        state = "cancelled" if h.cancelled else "done"
        return (f"client {i}: {state} after {h.request.generated} tokens "
                f"({h.request.n_schedules} slices, streamed {n_stream})")

    results = await asyncio.gather(*(client(i, j)
                                     for i, j in enumerate(jobs)))
    for line in results:
        print(f"  {line}")
    m = await server.close()
    stats = server.admission_stats
    print(f"  -> {m.n_completed} completed, {stats['n_rejected']} rejected, "
          f"SLO attainment {m.slo_attainment:.2f}")
    assert m.n_completed == 3 and stats["n_rejected"] == 1
    assert any("cancelled" in line for line in results)


def real_retain_demo(device=None) -> dict:
    """Real engines, kv_retain="request": zero re-prefill on resume."""
    import numpy as np

    from repro_torch import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.engine.profiler import fit_estimator
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.kernels import ops
    from repro_torch.models.registry import get_model

    t_start = time.perf_counter()
    dev = resolve_device(device)
    arch = get_config("llama3.2-1b", reduced=True)
    model = get_model(arch)
    params = model.init(0, device=dev)
    est, _, _ = fit_estimator(model, params, batch_sizes=(1, 2),
                              input_lens=(16, 32), n_decode_iters=2,
                              repeats=1)
    page_tokens = 16
    cfg = ServingConfig(strategy="scls", backend="real", kv_layout="paged",
                        kv_retain="request", page_tokens=page_tokens,
                        slice_len=4, max_gen=16, gamma=0.25,
                        m_available=64e6, mem_bucket=8, workers=1)
    mem = cfg.memory_estimator(model.kv_bytes_per_token())
    engines = [StaticEngine(model, params, eos_id=1, len_bucket=8,
                            kv_layout="paged", page_tokens=page_tokens,
                            kv_pool_tokens=mem.total_blocks * page_tokens,
                            device=dev)]
    server = cfg.build_real(engines, est, mem)
    rng = np.random.default_rng(7)
    ops.reset_counts()
    handles = [server.submit(
        rng.integers(0, arch.vocab_size, size=8 + 3 * i).astype(np.int32),
        gen_len=10 + i, max_gen=16, arrival=0.1 * i) for i in range(3)]
    m = server.drain()
    launches, plain = ops.launches(), dict(ops.plain_calls)
    slices = [h.request.n_schedules for h in handles]
    print(f"  {m.n_completed} requests in {slices} slices each, "
          f"reprefill_tokens={m.reprefill_tokens} "
          f"(retained prefix pages made every resume a page-table remap)")
    for name in ("paged_prefill_write", "paged_decode_attention"):
        print(f"  {name}: {launches[name]} kernel launches, "
              f"{plain[name]} plain calls")
    assert m.n_completed == 3 and all(h.done for h in handles)
    assert max(slices) >= 3, "multi-slice regime expected"
    # THE §3.3 claim: uninterrupted requests never re-prefill
    assert m.reprefill_tokens == 0
    # and every retained page went back to the pool on completion
    alloc = engines[0].allocator
    assert alloc.free_blocks == alloc.n_pages
    out = dict(example="torch_serving_cluster", section="real",
               device=str(dev), n_completed=m.n_completed, slices=slices,
               reprefill_tokens=m.reprefill_tokens, launches=launches,
               plain_calls=plain, wall_s=time.perf_counter() - t_start)
    print(json.dumps(out))
    return out


def sim_comparison(rate: float, duration: float, workers: int,
                   slice_len: int) -> dict:
    from repro_torch.cluster.trace import CODEFUSE, generate_trace

    # paper testbed wiring, centralized in repro_torch.serving (DS
    # profile: Algorithm 2 rule table for memory)
    true_lat, est, _ = default_sim_environment("ds")
    trace = generate_trace(rate, duration, CODEFUSE, seed=1)
    print(f"{len(trace)} requests @ {rate}/s over {duration:.0f}s, "
          f"{workers} workers (DS profile)\n")
    hdr = (f"{'strategy':8s} {'thr(req/s)':>10s} {'resp(s)':>9s} "
           f"{'p95(s)':>8s} {'p99(s)':>8s} {'ttft(s)':>8s} "
           f"{'CTstd(s)':>9s} {'batch':>6s} {'invalid':>8s} {'pads':>7s}")
    print(hdr)
    print("-" * len(hdr))
    out = {}
    for name in ALL_STRATEGIES:
        cfg = ServingConfig(strategy=name, backend="sim", workers=workers,
                            slice_len=slice_len, fixed_batch_size=12,
                            gamma=3.0, max_parallel=12, noise_sigma=0.02,
                            seed=2)
        server = cfg.build_sim(true_lat, est, RuleBasedMemoryEstimator())
        server.replay(copy.deepcopy(trace))
        m = server.drain(duration)
        assert m.n_completed > 0, f"{name}: no requests completed"
        print(f"{m.name:8s} {m.throughput:10.2f} {m.mean_response:9.1f} "
              f"{m.p95_response:8.1f} {m.p99_response:8.1f} "
              f"{m.ttft_mean:8.1f} {m.ct_std:9.1f} {m.avg_batch_size:6.1f} "
              f"{m.avg_invalid_tokens:8.1f} {m.avg_pad_tokens:7.1f}")
        out[name] = dict(throughput=m.throughput, n_completed=m.n_completed)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=float, default=20.0)
    ap.add_argument("--duration", type=float, default=300.0)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--slice-len", type=int, default=128)
    ap.add_argument("--section", default="all",
                    choices=("all", "sim", "aio", "real"))
    ap.add_argument("--device", default=None,
                    help="torch device of the real section (default: the "
                         "CUDA card)")
    args = ap.parse_args(argv)
    out: dict = {}
    if args.section in ("all", "sim"):
        out["sim"] = sim_comparison(args.rate, args.duration, args.workers,
                                    args.slice_len)
    if args.section in ("all", "aio"):
        print("\nconcurrent asyncio clients (AsyncSliceServer, mixed SLOs, "
              "one mid-stream cancel):")
        asyncio.run(concurrent_clients_demo())
        out["aio"] = True
    if args.section in ("all", "real"):
        print("\nreal backend with persistent paged KV (--kv-retain "
              "request):")
        out["real"] = real_retain_demo(args.device)
    return out


if __name__ == "__main__":
    main()
