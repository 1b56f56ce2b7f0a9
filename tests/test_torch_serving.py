"""The port's scheduling core and the slice as a whole: the golden
dispatch logs bit-exact through ``repro_torch.serving.SchedulerCore`` +
``SimBackend`` (built from the port's own copies), the launcher serving
a CodeFuse trace end to end on the CPU, and the port's ``RealBackend``
giving every request of a fixed trace the JAX ``RealBackend``'s tokens."""
import copy
import json
import os

import numpy as np
import pytest

from torch_port import assert_same_stream, prompts, shared_models

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_batch_compositions.json")


def _golden_runs():
    with open(GOLDEN) as f:
        g = json.load(f)
    return [pytest.param(g["scenario_args"], r,
                         id=f"{r['strategy']}-sigma{r['noise_sigma']}")
            for r in g["runs"]]


@pytest.mark.parametrize("args, want", _golden_runs())
def test_port_core_matches_golden_batch_compositions(args, want):
    """The port's SchedulerCore reproduces the recorded dispatch logs (which
    requests ran together, on which worker, with what slice) bit for bit,
    wired as ``repro.cluster.simulator.ClusterSimulator`` wires it."""
    from repro_torch.cluster.trace import CODEFUSE, generate_trace
    from repro_torch.core.estimator import a100_llama13b_profile
    from repro_torch.core.memory import (A100_80GB_AVAILABLE,
                                         LLAMA2_13B_DELTA,
                                         AnalyticMemoryEstimator)
    from repro_torch.core.schedulers import make_strategy
    from repro_torch.serving import (SchedulerCore, SimBackend,
                                     fitted_estimator)
    true_lat = a100_llama13b_profile()
    est = fitted_estimator(true_lat, seed=0)
    mem = AnalyticMemoryEstimator(delta_bytes=LLAMA2_13B_DELTA,
                                  m_available=A100_80GB_AVAILABLE, zeta=0.9)
    trace = generate_trace(args["rate"], args["duration"], CODEFUSE,
                           seed=args["trace_seed"])
    s = make_strategy(want["strategy"], slice_len=args["slice_len"],
                      fixed_batch_size=args["fixed_batch_size"],
                      gamma=args["gamma"], max_parallel=args["max_parallel"])
    backend = SimBackend(true_lat, noise_sigma=want["noise_sigma"],
                         seed=args["sim_seed"])
    core = SchedulerCore(s, backend, args["workers"], est, mem, ils_span=32)
    metrics = core.run(copy.deepcopy(trace), args["duration"])
    assert metrics.n_completed == want["n_completed"]
    assert core.batch_log == want["batch_log"]


def test_pred_mode_is_not_ported_yet():
    from repro_torch.core.estimator import a100_llama13b_profile
    from repro_torch.core.memory import RuleBasedMemoryEstimator
    from repro_torch.core.schedulers import make_strategy
    from repro_torch.serving import SchedulerCore, SimBackend
    lat = a100_llama13b_profile()
    with pytest.raises(NotImplementedError, match="pred"):
        SchedulerCore(make_strategy("scls-pred"), SimBackend(lat), 1, lat,
                      RuleBasedMemoryEstimator())


def test_launcher_serves_a_codefuse_trace_on_cpu():
    """``repro_torch.launch.serve --backend real --device cpu --reduced``:
    every request completes, a shared-prefix request joins resident pages,
    and both kernel wrappers took their plain (CPU) versions."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_counts()
    m = serve.main(["--backend", "real", "--device", "cpu", "--reduced",
                    "--rate", "2", "--duration", "3", "--max-input", "48",
                    "--max-gen", "12", "--slice-len", "6",
                    "--shared-prefix", "1", "--m-available", "16e6"])
    assert m.n_requests >= 4 and m.n_completed == m.n_requests
    assert m.prefix_hit_tokens > 0 and m.reprefill_tokens == 0
    assert ops.plain_calls["paged_prefill_write"] > 0
    assert ops.plain_calls["paged_decode_attention"] > 0
    assert ops.launches() == {"paged_prefill_write": 0,
                              "paged_decode_attention": 0}


def test_launcher_sim_backend_runs_the_same_core():
    from repro_torch.launch import serve
    m = serve.main(["--backend", "sim", "--rate", "2", "--duration", "5"])
    assert m.n_requests > 0 and m.n_completed == m.n_requests


def _fixed_trace(request_cls, vocab):
    """Five requests, two of which repeat an earlier prompt's first two
    pages; arrivals staggered across the first scheduling ticks."""
    ps = prompts(vocab, [21, 9, 14, 5], seed=11)
    ps.append(np.concatenate([ps[0][:16], ps[3]]))
    ps.append(np.concatenate([ps[0][:16], ps[1]]))
    gens = [20, 7, 13, 4, 11, 9]
    return [request_cls(rid=i, arrival=0.3 * i, input_len=len(p), gen_len=g,
                        max_gen=24, prompt=p)
            for i, (p, g) in enumerate(zip(ps, gens))]


def test_real_backend_tokens_match_jax_real_backend():
    """The same fixed trace through the JAX and the port's ``RealBackend``
    (persistent paged engines, ``kv_retain="request"``, SCLS): every
    request gets the same output tokens (near-tie rule), and both pools
    return to their baselines."""
    from repro.core.estimator import a100_llama13b_profile as jax_profile
    from repro.core.memory import PagedMemoryEstimator as JaxPagedMem
    from repro.core.request import Request as JaxRequest
    from repro.core.schedulers import make_strategy as jax_strategy
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro.serving import RealBackend as JaxRealBackend
    from repro.serving import SchedulerCore as JaxCore
    from repro.serving import fitted_estimator as jax_fitted
    from repro_torch.core.estimator import a100_llama13b_profile
    from repro_torch.core.memory import PagedMemoryEstimator
    from repro_torch.core.request import Request
    from repro_torch.core.schedulers import make_strategy
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.serving import RealBackend, SchedulerCore, \
        fitted_estimator
    jm, jp, tm, tp = shared_models()
    mem_kw = dict(delta_bytes=tm.kv_bytes_per_token(), m_available=4e6,
                  zeta=0.9, page_tokens=8, bucket=8, kv_retain="request")
    eng_kw = dict(eos_id=1, len_bucket=8, kv_layout="paged", page_tokens=8)
    strat_kw = dict(slice_len=8, max_gen=24, gamma=0.25, kv_layout="paged")

    jmem = JaxPagedMem(**mem_kw)
    jest = jax_fitted(jax_profile())
    jeng = JaxEngine(jm, jp, kv_pool_tokens=jmem.total_blocks * 8, **eng_kw)
    jcore = JaxCore(jax_strategy("scls", **strat_kw),
                    JaxRealBackend([jeng], mem=jmem, kv_layout="paged",
                                   sched_bucket=jest.bucket,
                                   kv_retain="request"), 1, jest, jmem)
    jtrace = _fixed_trace(JaxRequest, tm.cfg.vocab_size)
    jm_ = jcore.run(jtrace, 2.0)

    mem = PagedMemoryEstimator(**mem_kw)
    est = fitted_estimator(a100_llama13b_profile())
    eng = StaticEngine(tm, tp, kv_pool_tokens=mem.total_blocks * 8,
                       device="cpu", **eng_kw)
    core = SchedulerCore(make_strategy("scls", **strat_kw),
                         RealBackend([eng], mem=mem, sched_bucket=est.bucket),
                         1, est, mem)
    trace = _fixed_trace(Request, tm.cfg.vocab_size)
    m = core.run(trace, 2.0)

    assert m.n_completed == jm_.n_completed == len(trace)
    assert m.prefix_hit_tokens > 0 and jm_.prefix_hit_tokens > 0
    for a, b in zip(jtrace, trace):
        assert len(b.output_tokens) == b.gen_len
        assert_same_stream(b.prompt, a.output_tokens, b.output_tokens)
    assert eng.allocator.free_blocks == eng.allocator.n_pages
    assert jeng.allocator.free_blocks == jeng.allocator.n_pages
    assert mem.retained_blocks == 0
