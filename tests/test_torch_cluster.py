"""The port's legacy cluster shims against the JAX package's:
``repro_torch.cluster.simulator.ClusterSimulator`` reproduces the golden
dispatch logs of ``tests/data/golden_batch_compositions.json`` bit for bit
with JAX's results beside them, keeps the legacy attribute surface, and
``repro_torch.cluster.realtime.RealCluster`` over two reduced float32
port engines on the CPU gives JAX's ``RealCluster`` dispatch log and token
streams on the same weights."""
import copy
import dataclasses
import importlib
import json
import os

import numpy as np
import pytest

from torch_port import assert_same_stream, shared_models

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_batch_compositions.json")
PKGS = ("repro", "repro_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _golden_runs():
    with open(GOLDEN) as f:
        g = json.load(f)
    return [pytest.param(g["scenario_args"], r,
                         id=f"{r['strategy']}-sigma{r['noise_sigma']}")
            for r in g["runs"]]


def _sim_env(pkg):
    estimator = _mod(pkg, "core.estimator")
    memory = _mod(pkg, "core.memory")
    true_lat = estimator.a100_llama13b_profile()
    est = _mod(pkg, "serving").fitted_estimator(true_lat, seed=0)
    mem = memory.AnalyticMemoryEstimator(
        delta_bytes=memory.LLAMA2_13B_DELTA,
        m_available=memory.A100_80GB_AVAILABLE, zeta=0.9)
    return true_lat, est, mem


def _golden_sim(pkg, args, run):
    """``pkg``'s ClusterSimulator on the golden scenario, as
    ``scripts/gen_equivalence_golden.py`` wires it."""
    trace_mod = _mod(pkg, "cluster.trace")
    true_lat, est, mem = _sim_env(pkg)
    trace = trace_mod.generate_trace(args["rate"], args["duration"],
                                     trace_mod.CODEFUSE,
                                     seed=args["trace_seed"])
    s = _mod(pkg, "core.schedulers").make_strategy(
        run["strategy"], slice_len=args["slice_len"],
        fixed_batch_size=args["fixed_batch_size"], gamma=args["gamma"],
        max_parallel=args["max_parallel"])
    sim = _mod(pkg, "cluster.simulator").ClusterSimulator(
        s, args["workers"], true_lat, est, mem,
        noise_sigma=run["noise_sigma"], seed=args["sim_seed"])
    res = sim.run(copy.deepcopy(trace), args["duration"])
    return sim, res


@pytest.mark.parametrize("args, want", _golden_runs())
def test_cluster_simulator_reproduces_the_golden_logs(args, want):
    """The shim's dispatch log is the golden's bit for bit, and its
    ``SimResult`` (metrics, per-worker completion times, batch sizes,
    every request's outcome) is JAX's ClusterSimulator's."""
    sim, res = _golden_sim("repro_torch", args, want)
    assert res.metrics.n_completed == want["n_completed"]
    assert sim.batch_log == want["batch_log"]
    jsim, jres = _golden_sim("repro", args, want)
    assert jsim.batch_log == sim.batch_log
    assert dataclasses.asdict(res.metrics) == \
        dataclasses.asdict(jres.metrics)
    assert res.worker_completion == jres.worker_completion
    assert res.batch_sizes == jres.batch_sizes
    assert [(r.rid, r.generated, r.n_schedules, r.finish_time)
            for r in res.requests] == \
        [(r.rid, r.generated, r.n_schedules, r.finish_time)
         for r in jres.requests]


def test_shims_keep_the_legacy_surface():
    """Both shims drive the port's one SchedulerCore, expose the legacy
    attributes, and the simulator's continuation check sees leased-out
    requests (tests/test_cluster.py's regression)."""
    from repro_torch.cluster.realtime import RealCluster
    from repro_torch.cluster.simulator import ClusterSimulator
    from repro_torch.core.request import Request
    from repro_torch.core.schedulers import make_strategy
    from repro_torch.serving.core import SchedulerCore
    true_lat, est, mem = _sim_env("repro_torch")
    sim = ClusterSimulator(make_strategy("scls-cb", slice_len=64), 2,
                           true_lat, est, mem, seed=0)
    assert type(sim.core) is SchedulerCore
    assert sim.s is sim.core.s and sim.workers is sim.core.workers
    assert sim.pool is sim.core.pool and sim.now == 0.0
    assert sim.pred is None and sim.predictor is None
    assert sim.batch_sizes == [] and sim.batch_log == []
    assert sim.peak_parallel == 0
    r = Request(rid=0, arrival=0.0, input_len=8, gen_len=32)
    assert not sim._more_work_expected()
    sim.workers[0].pending.append(r)
    assert sim._more_work_expected()
    sim.workers[0].pending.clear()
    sim.workers[0].running.append([r, 8, 64])
    assert sim._more_work_expected()
    with pytest.raises(AssertionError):
        RealCluster(make_strategy("ils"), [], est, mem)


@pytest.mark.parametrize("name", ["sls", "ils", "so", "pm", "ab", "lb",
                                  "scls", "scls-cb"])
def test_every_strategy_completes_as_jax(name):
    """tests/test_cluster.py's every-strategy run (2 workers, a minute of
    CodeFuse at 2 requests/s) through both shims: every request
    completes, with JAX's metrics and dispatch log."""
    out = {}
    for pkg in PKGS:
        trace_mod = _mod(pkg, "cluster.trace")
        true_lat, est, mem = _sim_env(pkg)
        trace = trace_mod.generate_trace(2.0, 60.0, trace_mod.CODEFUSE,
                                         seed=1)
        s = _mod(pkg, "core.schedulers").make_strategy(
            name, slice_len=128, fixed_batch_size=12, gamma=3.0)
        sim = _mod(pkg, "cluster.simulator").ClusterSimulator(
            s, 2, true_lat, est, mem, seed=2)
        res = sim.run(trace, 60.0)
        out[pkg] = (dataclasses.asdict(res.metrics), sim.batch_log)
    m, log = out["repro_torch"]
    assert m["n_completed"] == m["n_requests"] > 0
    assert out["repro_torch"] == out["repro"]


# ---------------------------------------------------------------------------
# RealCluster over real engines
# ---------------------------------------------------------------------------
def _fixed_clock(engine):
    """Replace the engine's measured wall time by a function of the batch
    alone (rows, padded prompt length, decode steps), so that both
    packages' clusters see one virtual timeline and their dispatch logs
    can be compared; the tokens are the engine's own."""
    serve = engine.serve_batch

    def timed(*args, **kw):
        res = serve(*args, **kw)
        res.wall_time = 1e-3 * (res.batch_size * res.batch_input_len / 64
                                + res.steps)
        res.prefill_time = 0.25 * res.wall_time
        return res

    engine.serve_batch = timed
    return engine


def _real_cluster_run(pkg, model, params, vocab):
    trace_mod = _mod(pkg, "cluster.trace")
    spec = trace_mod.WorkloadSpec("tiny", input_mu=3.0, input_sigma=0.6,
                                  gen_mu=2.2, gen_sigma=0.6, max_input=48,
                                  max_gen=24)
    trace = trace_mod.generate_trace(2.0, 6.0, spec, seed=5,
                                     vocab_size=vocab)
    dev = {"device": "cpu"} if pkg == "repro_torch" else {}
    engines = [_fixed_clock(_mod(pkg, "engine.static_engine").StaticEngine(
        model, params, eos_id=1, len_bucket=8, **dev)) for _ in range(2)]
    mem = _mod(pkg, "core.memory").AnalyticMemoryEstimator(
        delta_bytes=model.kv_bytes_per_token(), m_available=64e6, zeta=0.9,
        bucket=8)
    est = _mod(pkg, "serving").fitted_estimator(
        _mod(pkg, "core.estimator").a100_llama13b_profile())
    strategy = _mod(pkg, "core.schedulers").make_strategy(
        "scls", slice_len=8, max_gen=24, gamma=0.25)
    cluster = _mod(pkg, "cluster.realtime").RealCluster(strategy, engines,
                                                        est, mem)
    metrics = cluster.run(trace, 6.0)
    return cluster, metrics, trace


def test_real_cluster_matches_jax():
    """Two reduced float32 llama3.2-1b engines behind each package's
    RealCluster (SCLS, slices of 8), on one clock: the port's dispatch log
    is JAX's, every request completes with JAX's tokens (near-tie rule),
    and the metrics agree."""
    jm, jp, tm, tp = shared_models()
    vocab = tm.cfg.vocab_size
    jc, jmet, jtrace = _real_cluster_run("repro", jm, jp, vocab)
    tc, tmet, ttrace = _real_cluster_run("repro_torch", tm, tp, vocab)
    assert tmet.n_completed == tmet.n_requests == len(ttrace) > 5
    assert tc.core.batch_log == jc.core.batch_log
    assert max(len(b[2]) for b in tc.core.batch_log) > 1
    assert any(r.n_schedules > 1 for r in ttrace)
    assert len(tc.engines) == 2 and tc.allocators is None
    for a, b in zip(jtrace, ttrace):
        assert np.array_equal(a.prompt, b.prompt)
        assert len(b.output_tokens) == min(b.gen_len, b.max_gen)
        assert_same_stream(b.prompt, a.output_tokens, b.output_tokens)
    assert dataclasses.asdict(tmet) == dataclasses.asdict(jmet)
