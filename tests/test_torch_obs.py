"""The port's observability (``repro_torch.obs``) against the JAX
package's: the 8 golden dispatch logs stay bit-exact through the port's
core with tracing, metrics and the decision audit all on; on the sim
backend the port's Chrome trace, Prometheus text and decision audit equal
JAX's for the same config and seed; the three pillars answer the same
scripted calls alike; and every hook call site of the port is guarded."""
import copy
import importlib.util
import json
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "data" / "golden_batch_compositions.json"

_spec = importlib.util.spec_from_file_location(
    "validate_obs", REPO / "scripts" / "validate_obs.py")
validate_obs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(validate_obs)


def _golden_runs():
    g = json.loads(GOLDEN.read_text())
    return [pytest.param(g["scenario_args"], r,
                         id=f"{r['strategy']}-sigma{r['noise_sigma']}")
            for r in g["runs"]]


@pytest.mark.parametrize("args, want", _golden_runs())
def test_golden_dispatch_log_bit_exact_with_full_observability(args, want):
    """Every golden dispatch log, through the port's SchedulerCore with
    ``Observability.standard(trace=True)`` attached: the log is the
    recorded one, the trace is valid and its slice spans rebuild the log,
    the slice counter saw every dispatch, and the audit holds a batch and
    an offload entry (with every worker's Eq. 11 load) per central
    dispatch."""
    from repro_torch.cluster.trace import CODEFUSE, generate_trace
    from repro_torch.core.estimator import a100_llama13b_profile
    from repro_torch.core.memory import (A100_80GB_AVAILABLE,
                                         LLAMA2_13B_DELTA,
                                         AnalyticMemoryEstimator)
    from repro_torch.core.schedulers import make_strategy
    from repro_torch.obs import Observability
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
    obs = Observability.standard(trace=True)
    core = SchedulerCore(s, SimBackend(true_lat,
                                       noise_sigma=want["noise_sigma"],
                                       seed=args["sim_seed"]),
                         args["workers"], est, mem, obs=obs)
    metrics = core.run(copy.deepcopy(trace), args["duration"])
    assert metrics.n_completed == want["n_completed"]
    assert core.batch_log == want["batch_log"]

    tdict = obs.tracer.to_dict()
    assert validate_obs.validate_trace(tdict) == []
    assert validate_obs.trace_slice_log(tdict) == want["batch_log"]
    assert obs.ins.slices.value() == len(want["batch_log"])
    assert obs.ins.slice_time.count() == len(want["batch_log"])
    n_static = sum(1 for e in want["batch_log"] if e[0] == "static")
    if s.mode == "central":
        assert len(obs.audit.query(kind="batch")) == n_static
        assert len(obs.audit.query(kind="offload")) == n_static
    for e in obs.audit.query(kind="offload"):
        assert set(e["loads"]) == {str(w) for w in range(args["workers"])}
    assert all(e["mem_bound"] >= len(e["rids"])
               for e in obs.audit.query(kind="batch"))


#: (strategy, predictor, noise_sigma, kv_layout) of the sim parity runs:
#: central, continuous, lease and prediction-aware modes, dense and paged
SIM_CASES = [
    ("scls", None, 0.0, "dense"),
    ("scls", None, 0.05, "paged"),
    ("lb", None, 0.05, "dense"),
    ("so", None, 0.0, "dense"),
    ("ils", None, 0.05, "dense"),
    ("scls-cb", None, 0.05, "paged"),
    ("scls-pred", "histogram", 0.05, "dense"),
    ("oracle", None, 0.0, "paged"),
]


def _sim_artifacts(pkg, strategy, predictor, sigma, kv_layout):
    """Build the sim server of ``pkg`` (``repro`` or ``repro_torch``) from
    one ServingConfig, replay one CodeFuse trace plus a submission with an
    SLO, drain, and return (trace dict, Prometheus text, audit list,
    batch log)."""
    import importlib
    serving = importlib.import_module(f"{pkg}.serving")
    ctrace = importlib.import_module(f"{pkg}.cluster.trace")
    true_lat, est, mem = serving.default_sim_environment(
        "hf", paged=kv_layout == "paged")
    cfg = serving.ServingConfig(strategy=strategy, predictor=predictor,
                                workers=2, seed=4, noise_sigma=sigma,
                                kv_layout=kv_layout, trace_out="unused.json")
    server = cfg.build_sim(true_lat, est, mem)
    server.replay(ctrace.generate_trace(3.0, 15.0, ctrace.CODEFUSE, seed=8))
    server.submit(input_len=40, gen_len=30, slo_ms=120_000, arrival=2.0)
    server.drain()
    obs = server.core.obs
    return (obs.tracer.to_dict(), obs.registry.render(), obs.audit.to_list(),
            server.core.batch_log)


@pytest.mark.parametrize("strategy, predictor, sigma, kv_layout", SIM_CASES)
def test_sim_trace_metrics_and_audit_equal_jax(strategy, predictor, sigma,
                                               kv_layout):
    """Same config, same seed, same trace on the sim backend: the port's
    Chrome trace (parsed JSON), Prometheus exposition and decision audit
    are JAX's, and the trace is valid."""
    want = _sim_artifacts("repro", strategy, predictor, sigma, kv_layout)
    got = _sim_artifacts("repro_torch", strategy, predictor, sigma,
                         kv_layout)
    assert len(got[0]["traceEvents"]) > 10 and got[3]
    assert got[3] == want[3]
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert validate_obs.validate_trace(got[0]) == []
    assert validate_obs.validate_prometheus(got[1]) == []


def _scripted_registry(pkg):
    import importlib
    m = importlib.import_module(f"{pkg}.obs.metrics")
    reg = m.MetricsRegistry()
    c = reg.counter("demo_requests", "Requests", labelnames=("outcome",))
    g = reg.gauge("demo_depth", "Queue depth")
    h = reg.histogram("demo_seconds", "Latency", buckets=(0.1, 1.0, 10.0))
    t = reg.histogram("demo_tokens", "Tokens",
                      buckets=m.DEFAULT_TOKEN_BUCKETS)
    for i, v in enumerate((0.05, 0.5, 5.0, 50.0, 1.0, 0.1)):
        c.inc(outcome="ok" if i % 2 else "cancelled")
        g.set(i * 3 - 2)
        h.observe(v)
        t.observe(int(v * 100))
    g.dec(1.5)
    errors = []
    for bad in (lambda: c.inc(-1, outcome="ok"), lambda: c.inc(shape="x"),
                lambda: reg.gauge("demo_depth", "again")):
        try:
            bad()
        except Exception as e:  # noqa: BLE001 — the error's type and text
            errors.append((type(e).__name__, str(e)))
    return reg.render(), c.value(outcome="ok"), h.count(), errors


def _scripted_tracer(pkg):
    import importlib
    tr_mod = importlib.import_module(f"{pkg}.obs.trace")
    clock = [0.0]
    tr = tr_mod.Tracer(clock=lambda: clock[0])
    tr.declare_worker(0)
    tr.declare_worker(3)
    tr.complete("slice", 0.5, 1.25, tid=tr.declare_worker(0), cat="slice",
                args=dict(rids=[1, 2], input_len=64, slice_len=32))
    tr.instant("arrival", 0.1, args=dict(rid=1))
    tr.async_begin("request", 1, 0.1, args=dict(rid=1))
    clock[0] = 2.0
    tr.counter("queue_depth", 3)
    tr.async_end("request", 1, 2.0, args=dict(outcome="completed"))
    return tr.to_json(), tr_mod.worker_tid(3)


def _scripted_audit(pkg):
    import importlib
    audit = importlib.import_module(f"{pkg}.obs.audit")
    hub = importlib.import_module(f"{pkg}.obs.hub")
    log = audit.DecisionLog(4)
    for i in range(7):
        log.record("batch" if i % 2 else "offload", float(i), rids=[i],
                   worker=i % 3)
    return (log.to_list(), log.query(kind="batch"),
            log.query(rid=5, limit=1), log.query(kind="offload", limit=2),
            len(log),
            hub.decisions_path_for("x/trace.json"),
            hub.decisions_path_for("trace"))


@pytest.mark.parametrize("script", [_scripted_registry, _scripted_tracer,
                                    _scripted_audit],
                         ids=["metrics", "trace", "audit"])
def test_obs_pillars_answer_scripted_calls_as_jax(script):
    """Each pillar (metrics registry, tracer, decision ring) given the
    same calls renders, serialises and answers the same, errors
    included."""
    assert script("repro_torch") == script("repro")


def test_every_port_hook_site_is_guarded():
    """Every ``*.obs.on_*`` call site in the port's serving stack sits
    behind an ``obs.enabled`` guard (the reference's obs-guard pass, run
    over the port's files), and the port has as many hook sites as the
    reference's core and async server."""
    import re

    from repro.analysis.framework import SourceFile
    from repro.analysis.passes.obs_guard import ObsGuardPass
    files = [REPO / "src" / "repro_torch" / "serving" / f"{n}.py"
             for n in ("core", "aio", "server", "backends", "admission")]
    sfs = [SourceFile(REPO, p) for p in files]
    assert list(ObsGuardPass().run(REPO, sfs)) == []

    def sites(pkg):
        text = "".join((REPO / "src" / pkg / "serving" / f"{n}.py")
                       .read_text() for n in ("core", "aio"))
        return len(re.findall(r"\.obs\.on_\w+\(", text))

    assert sites("repro_torch") == sites("repro") >= 9
