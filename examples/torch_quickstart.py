"""Quickstart on the PyTorch/CUDA port: serve a small LLaMA with
slice-level scheduling (SCLS), the counterpart of examples/quickstart.py.

  PYTHONPATH=src python examples/torch_quickstart.py               # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

What happens (every FLOP real, on the card unless ``--device cpu``):
  1. build a reduced llama3.2 and profile its prefill/decode latency;
  2. fit the paper's serving-time estimator (Eq. 3/4);
  3. a burst of requests (seed 7) is DP-batched (Algorithm 1), offloaded
     max-min to two workers, and served slice by slice (S = 8) with
     rescheduling over two dense ``StaticEngine``s: on the card every
     prefill runs the ``flash_prefill`` kernel (B5) and every decode step
     ``decode_attention`` (B6); on the CPU their plain versions;
  4. every request's tokens are checked against one-shot generation, and
     each kernel's launches (plain calls on the CPU) while serving are
     printed.

The last line is a JSON summary; the exit code is 1 unless all 8
checked requests match.
"""
import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import resolve_device  # noqa: E402
from repro_torch.cluster.trace import WorkloadSpec, generate_trace  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.engine.profiler import fit_estimator  # noqa: E402
from repro_torch.engine.static_engine import StaticEngine  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.registry import get_model  # noqa: E402
from repro_torch.serving import ServingConfig  # noqa: E402

N_CHECKED = 8


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    dev = resolve_device(args.device)
    cfg = get_config("llama3.2-1b", reduced=True)
    model = get_model(cfg)
    params = model.init(0, device=dev)
    print(f"model: {cfg.name} (reduced) — {cfg.n_layers}L d{cfg.d_model} "
          f"on {dev}")

    est, prmse, drmse = fit_estimator(model, params, batch_sizes=(1, 2, 4),
                                      input_lens=(16, 32))
    print(f"estimator fit: prefill rmse {prmse*1e3:.2f}ms, "
          f"decode rmse {drmse*1e3:.2f}ms")

    serve_cfg = ServingConfig(strategy="scls", backend="real", workers=2,
                              slice_len=8, max_gen=24, gamma=0.25,
                              m_available=64e6, mem_bucket=8)
    mem = serve_cfg.memory_estimator(model.kv_bytes_per_token())
    spec = WorkloadSpec("demo", input_mu=3.0, input_sigma=0.6,
                        gen_mu=2.2, gen_sigma=0.6, max_input=48, max_gen=24)
    trace = generate_trace(rate=2.0, duration=10.0, spec=spec, seed=7,
                           vocab_size=cfg.vocab_size)
    print(f"workload: {len(trace)} Poisson requests over 10s")

    engines = [StaticEngine(model, params, eos_id=1, len_bucket=8,
                            device=dev) for _ in range(2)]
    server = serve_cfg.build_real(engines, est, mem)
    ops.reset_counts()
    t_serve = time.perf_counter()
    server.replay(trace)
    metrics = server.drain(10.0)
    serve_s = time.perf_counter() - t_serve
    launches, plain = ops.launches(), dict(ops.plain_calls)

    print(f"\nthroughput      : {metrics.throughput:.2f} req/s (virtual time)")
    print(f"mean response   : {metrics.mean_response:.2f} s")
    print(f"TTFT mean       : {metrics.ttft_mean:.2f} s")
    print(f"avg batch size  : {metrics.avg_batch_size:.1f}")
    print(f"avg slices/req  : {metrics.avg_schedules:.2f}")
    print(f"worker CT std   : {metrics.ct_std:.2f} s")
    for name in ("flash_prefill", "decode_attention"):
        print(f"{name:16s}: {launches[name]} kernel launches, "
              f"{plain[name]} plain calls")

    # verify slice-level serving produced exactly the one-shot tokens
    eng = StaticEngine(model, params, eos_id=1, len_bucket=8, device=dev)
    ok = 0
    for r in trace[:N_CHECKED]:
        want = eng.serve_batch([r.prompt], slice_len=32,
                               forced_gen_lens=[min(r.gen_len, r.max_gen)]
                               ).results[0]["tokens"]
        ok += (r.output_tokens == want)
    print(f"token parity with one-shot generation: {ok}/{N_CHECKED} OK")
    out = dict(example="torch_quickstart", device=str(dev),
               n_requests=len(trace), n_completed=metrics.n_completed,
               parity=ok, checked=N_CHECKED, launches=launches,
               plain_calls=plain, serve_s=serve_s,
               wall_s=time.perf_counter() - t_start)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    res = main()
    raise SystemExit(0 if res["parity"] == res["checked"] else 1)
