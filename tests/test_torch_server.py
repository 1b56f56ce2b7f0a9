"""The port's online serving layer against the JAX package's:
``ServingConfig`` (fields, validation messages, the CLI), ``SliceServer``
and ``AsyncSliceServer`` on the sim backend (per-request results,
streamed chunks, admission), ``RealBackend`` behind ``SliceServer`` on the
CPU (tokens, a two-turn session's prefix hits and page release), and the
launcher rebuilt on ``ServingConfig.from_cli`` + ``build_server``."""
import argparse
import asyncio
import dataclasses
import importlib
import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest

from torch_port import assert_same_stream, prompts, shared_models

REPO = pathlib.Path(__file__).resolve().parent.parent


def _serving(pkg):
    return importlib.import_module(f"{pkg}.serving")


# ---------------------------------------------------------------------------
# ServingConfig
# ---------------------------------------------------------------------------
CONFIGS = [
    {},
    dict(strategy="scls-pred", predictor="proxy", coverage=0.8),
    dict(strategy="oracle", predictor="perfect", kv_layout="paged"),
    dict(strategy="scls", backend="real", kv_layout="paged",
         kv_retain="request", packing="envelope", page_tokens=8,
         prefix_sharing=False, trace_out="t.json", audit_capacity=0),
    dict(strategy="scls-cb", kv_layout="paged", slo_ms=3e4, time_scale=2.0,
         http_host="0.0.0.0", reduced=False, arch="codeqwen1.5-7b"),
]


@pytest.mark.parametrize("kw", CONFIGS)
def test_serving_config_fields_equal_jax_plus_device(kw):
    """``to_dict()`` is JAX's plus ``device`` (None: the card), and
    round-trips through ``from_dict``."""
    cfg = _serving("repro_torch").ServingConfig(**kw)
    d = cfg.to_dict()
    assert d.pop("device") is None
    assert d == _serving("repro").ServingConfig(**kw).to_dict()
    assert _serving("repro_torch").ServingConfig.from_dict(
        cfg.to_dict()) == cfg


#: every rejected combination of the reference's ServingConfig tests
BAD = [
    dict(strategy="nope"),
    dict(strategy="scls", predictor="histogram"),
    dict(strategy="oracle", predictor="histogram"),
    dict(strategy="ils", backend="real"),
    dict(kv_layout="sparse"),
    dict(coverage=1.5),
    dict(workers=0),
    dict(packing="exact"),
    dict(packing="envelope"),
    dict(backend="gpu"),
    dict(predictor="oracle-ish", strategy="scls-pred"),
    dict(slice_len=0),
    dict(page_tokens=0),
    dict(page_tokens=2.5),
    dict(kv_retain="forever"),
    dict(kv_retain="request"),
    dict(kv_retain="request", kv_layout="paged"),
    dict(bucket_phi=1.0),
    dict(http_port=70000),
    dict(http_host=" "),
    dict(slo_ms=0),
    dict(time_scale=-1.0),
    dict(time_scale=1.0, backend="real"),
    dict(audit_capacity=-1),
    dict(trace_out=" "),
]


@pytest.mark.parametrize("kw", BAD)
def test_bad_combinations_raise_as_jax(kw):
    """The same combinations are refused with the same error and message."""
    errors = []
    for pkg in ("repro", "repro_torch"):
        with pytest.raises(Exception) as ei:
            _serving(pkg).ServingConfig(**kw)
        errors.append((type(ei.value).__name__, str(ei.value)))
    assert errors[1] == errors[0]
    assert errors[0][0] == "ValueError"


CLI = [
    ["--strategy", "scls-pred", "--predictor", "histogram",
     "--kv-layout", "paged", "--workers", "5"],
    ["--packing", "envelope", "--kv-layout", "paged"],
    ["--strategy", "oracle", "--gamma", "0.5", "--slice-len", "16",
     "--max-gen", "48", "--no-prefix-sharing", "--trace-out", "x.json",
     "--audit-capacity", "16", "--slo-ms", "2000", "--noise-sigma", "0.1",
     "--seed", "3", "--rate", "4", "--duration", "2", "--coverage", "0.6"],
    ["--backend", "real", "--kv-layout", "paged", "--kv-retain", "request",
     "--page-tokens", "8", "--arch", "gemma-2b", "--reduced",
     "--fixed-batch-size", "4", "--max-parallel", "6",
     "--http-host", "127.0.0.2", "--http-port", "0"],
]


@pytest.mark.parametrize("argv", CLI)
def test_from_cli_matches_jax_and_round_trips(argv):
    """The reference's flags parse into the same config (plus ``device``),
    with launcher defaults applied, and ``from_dict(to_dict())`` is the
    identity."""
    got = _serving("repro_torch").ServingConfig.from_cli(argv, gamma=0.25)
    want = _serving("repro").ServingConfig.from_cli(argv, gamma=0.25)
    d = got.to_dict()
    assert d.pop("device") is None and d == want.to_dict()
    assert type(got).from_dict(got.to_dict()) == got
    dev = type(got).from_cli(argv + ["--device", "cpu",
                                     "--m-available", "1e6"])
    assert (dev.device, dev.m_available) == ("cpu", 1e6)


@pytest.mark.parametrize("argv", [["--strategy", "scls", "--predictor",
                                   "proxy"], ["--packing", "envelope"]])
def test_from_cli_refuses_bad_combinations(argv):
    for pkg in ("repro", "repro_torch"):
        with pytest.raises(SystemExit):
            _serving(pkg).ServingConfig.from_cli(argv)


def test_launcher_accepts_every_reference_flag():
    """Every flag of JAX's ``ServingConfig.add_cli_args`` is the port's,
    with the same destination, default, choices and type."""
    parsers = {}
    for pkg in ("repro", "repro_torch"):
        ap = argparse.ArgumentParser()
        _serving(pkg).ServingConfig.add_cli_args(ap)
        parsers[pkg] = {a.option_strings[0]: a for a in ap._actions
                        if a.option_strings}
    want, got = parsers["repro"], parsers["repro_torch"]
    assert set(want) <= set(got) and len(want) > 25
    for flag, a in want.items():
        b = got[flag]
        assert (b.dest, b.default, b.choices, b.type, type(b)) == \
            (a.dest, a.default, a.choices, a.type, type(a)), flag
    from repro_torch.launch import serve
    for argv in CLI[:3]:
        cfg, _ = serve.parse_args(argv + ["--max-input", "64"])
        want_cfg = _serving("repro").ServingConfig.from_cli(argv)
        assert cfg.strategy == want_cfg.strategy
        assert cfg.kv_layout == want_cfg.kv_layout


def test_http_port_serves_healthz_and_drains():
    """``serve.main`` with ``--http-port 0`` fronts the sim server with the
    HTTP front end (``start_http``) for ``--duration`` seconds, answers
    ``/healthz`` meanwhile, then drains and stops listening."""
    import threading
    import urllib.error
    import urllib.request
    from repro_torch.launch import serve
    fronts, out = [], {}
    start = serve.start_http

    def recorded(*a, **kw):
        front = start(*a, **kw)
        fronts.append(front)
        return front

    def run():
        out["metrics"] = serve.main(["--backend", "sim", "--http-port", "0",
                                     "--duration", "1"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(serve, "start_http", recorded)
        t = threading.Thread(target=run, daemon=True)
        t.start()
        for _ in range(500):
            if fronts or not t.is_alive():
                break
            time.sleep(0.01)
        assert fronts, "the launcher never started its front end"
        url = fronts[0].url
        with urllib.request.urlopen(url + "/healthz", timeout=30) as resp:
            snap = json.loads(resp.read())
        assert snap["status"] == "ok" and snap["model"] == "scls-sim"
        assert snap["backend"] == "SimBackend"
        t.join(timeout=60)
    assert not t.is_alive()
    assert out["metrics"].n_requests == 0
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/healthz", timeout=5)


# ---------------------------------------------------------------------------
# SliceServer / AsyncSliceServer on the sim backend
# ---------------------------------------------------------------------------
def _request_view(r):
    return (r.rid, r.arrival, r.input_len, r.gen_len, r.max_gen,
            r.generated, r.done, r.cancelled, r.n_schedules, r.finish_time,
            r.first_token_time, r.deadline, r.pad_tokens, r.invalid_tokens)


def _sync_run(pkg, strategy, predictor, sigma):
    """Replay a trace, submit under SLOs (accepted, degraded and
    rejected), stream an interactive request, cancel one, drain."""
    serving = _serving(pkg)
    ctrace = importlib.import_module(f"{pkg}.cluster.trace")
    true_lat, est, mem = serving.default_sim_environment("hf")
    server = serving.ServingConfig(
        strategy=strategy, predictor=predictor, workers=2, slice_len=64,
        gamma=1.0, noise_sigma=sigma, seed=1).build_sim(true_lat, est, mem)
    trace = ctrace.generate_trace(4.0, 20.0, ctrace.CODEFUSE, seed=2)
    handles = server.replay(trace)
    decisions = []
    for kw in (dict(input_len=64, gen_len=600, slo_ms=8_000),
               dict(input_len=64, gen_len=600, slo_ms=8_000,
                    allow_degrade=True),
               dict(input_len=32, gen_len=40, slo_ms=600_000),
               dict(input_len=512, gen_len=900, slo_ms=1.0)):
        try:
            h = server.submit(**kw)
            handles.append(h)
            decisions.append(("accept", h.request.max_gen))
        except serving.AdmissionRejected as e:
            decisions.append(("reject", e.decision.reason_code))
    live = server.submit(input_len=100, gen_len=200, arrival=1.0)
    chunks, at = [], None
    for tok in live.tokens():
        if server.now != at:
            chunks.append([])
            at = server.now
        chunks[-1].append(tok)
    victim = server.submit(input_len=300, gen_len=500)
    server.step()
    victim.cancel()
    m = server.drain(20.0)
    return dict(chunks=chunks, decisions=decisions,
                stats=server.admission_stats,
                requests=[_request_view(h.request)
                          for h in handles + [live, victim]],
                metrics=dataclasses.asdict(m), log=server.core.batch_log)


@pytest.mark.parametrize("strategy, predictor, sigma", [
    ("scls", None, 0.0), ("scls", None, 0.05),
    ("scls-pred", "histogram", 0.05), ("scls-cb", None, 0.0)])
def test_slice_server_sim_matches_jax(strategy, predictor, sigma):
    """``SliceServer`` on the sim backend: the same per-request results,
    the same stream chunking of an interactive request, the same admission
    verdicts (rejected and degraded counts under ``slo_ms``) and the same
    dispatch log and metrics as JAX's."""
    want = _sync_run("repro", strategy, predictor, sigma)
    got = _sync_run("repro_torch", strategy, predictor, sigma)
    assert got == want
    assert got["stats"]["n_rejected"] >= 1
    assert got["stats"]["n_degraded"] == 1
    assert len(got["chunks"]) >= 2


def _async_run(pkg):
    """Eight concurrent clients (slices streamed, one cancelled, one
    rejected under its SLO) and a two-turn sim session, then close."""
    serving = _serving(pkg)
    true_lat, est, mem = serving.default_sim_environment("hf")
    server = serving.ServingConfig(strategy="scls", workers=2, slice_len=64,
                                   gamma=1.0).build_sim(true_lat, est,
                                                        mem).aio
    out = {}

    async def client(i):
        try:
            h = server.submit(input_len=32 + 8 * i, gen_len=50 + 30 * i,
                              arrival=0.5 * i,
                              slo_ms=1.0 if i == 6 else None)
        except serving.AdmissionRejected as e:
            return ("rejected", e.decision.reason_code)
        if i == 3:
            h.cancel()
        chunks = [c async for c in h.slices()]
        r = await h.result()
        return ([len(c) for c in chunks], _request_view(r))

    async def main():
        res = await asyncio.gather(*(client(i) for i in range(8)))
        s = server.session(max_gen=64)
        h1 = await s.submit_turn(input_len=20, gen_len=10)
        await h1.result()
        h2 = await s.submit_turn(input_len=5, gen_len=10)
        await h2.result()
        await s.close()
        m = await server.close()
        return res, h2.request.input_len, m

    res, turn2_len, m = asyncio.run(main())
    out.update(clients=res, turn2_len=turn2_len,
               metrics=dataclasses.asdict(m), log=server.core.batch_log,
               stats=server.admission_stats)
    return out


def test_async_slice_server_sim_matches_jax():
    """``AsyncSliceServer``: concurrent clients get JAX's per-slice chunks
    and results, the rejected one JAX's reason, the session's second turn
    carries the first's history; same dispatch log and metrics."""
    want, got = _async_run("repro"), _async_run("repro_torch")
    assert got == want
    assert got["turn2_len"] == 20 + 10 + 5
    assert got["clients"][6][0] == "rejected"


# ---------------------------------------------------------------------------
# RealBackend behind SliceServer on the CPU
# ---------------------------------------------------------------------------
PG = 8


def _real_server(pkg, model, params, strategy="scls", predictor=None):
    """``pkg``'s SliceServer over one persistent paged engine of ``model``
    (retain mode, prefix sharing) with the paper testbed's fitted
    estimator, built by ``ServingConfig.build_real``."""
    serving = _serving(pkg)
    engine = importlib.import_module(f"{pkg}.engine.static_engine")
    estimator = importlib.import_module(f"{pkg}.core.estimator")
    cfg = serving.ServingConfig(
        strategy=strategy, predictor=predictor, backend="real",
        kv_layout="paged", kv_retain="request", page_tokens=PG, slice_len=8,
        max_gen=24, gamma=0.25, mem_bucket=8, m_available=4e6,
        **({"device": "cpu"} if pkg == "repro_torch" else {}))
    mem = cfg.memory_estimator(model.kv_bytes_per_token())
    dev = {"device": "cpu"} if pkg == "repro_torch" else {}
    eng = engine.StaticEngine(model, params, eos_id=1, len_bucket=8,
                              kv_layout="paged", page_tokens=PG,
                              kv_pool_tokens=mem.total_blocks * PG, **dev)
    est = serving.fitted_estimator(estimator.a100_llama13b_profile())
    return cfg.build_real([eng], est, mem)


def _real_run(pkg, model, params, vocab):
    """A fixed trace through ``SliceServer.replay`` plus one streamed
    interactive request, then a two-turn session; returns what the test
    compares."""
    request = importlib.import_module(f"{pkg}.core.request")
    server = _real_server(pkg, model, params, strategy="scls-pred",
                          predictor="histogram")
    ps = prompts(vocab, [21, 9, 14, 5], seed=11)
    ps.append(np.concatenate([ps[0][:16], ps[3]]))
    gens = [20, 7, 13, 4, 11]
    trace = [request.Request(rid=i, arrival=0.3 * i, input_len=len(p),
                             gen_len=g, max_gen=24, prompt=p)
             for i, (p, g) in enumerate(zip(ps, gens))]
    handles = server.replay(trace)
    live = server.submit(prompts(vocab, [12], seed=3)[0], gen_len=17,
                         max_gen=24, arrival=0.5)
    streamed = list(live.tokens())
    m = server.drain()
    core = server.core
    free0 = core.backend.free_blocks()
    turn1, tail = prompts(vocab, [19, 6], seed=4)
    seen = {}

    async def session():
        s = server.aio.session(max_gen=24)
        h1 = await s.submit_turn(turn1, gen_len=9)
        await h1.result()
        hits = core.prefix_hit_tokens
        h2 = await s.submit_turn(tail, gen_len=9)
        await h2.result()
        seen["hit"] = core.prefix_hit_tokens - hits
        seen["held"] = core.backend.free_blocks()
        await s.close()
        return h1, h2

    h1, h2 = asyncio.run(session())
    return dict(outputs=[h.output_tokens for h in handles + [live]],
                prompts=ps + [live.request.prompt], streamed=streamed,
                live=live.output_tokens, n_completed=m.n_completed,
                free=[free0, seen["held"], core.backend.free_blocks()],
                hit=seen["hit"], turns=[h1.output_tokens, h2.output_tokens],
                turn_prompts=[h1.request.prompt, h2.request.prompt],
                reprefill=m.reprefill_tokens)


def test_real_backend_slice_server_and_session_match_jax():
    """The reduced float32 llama3.2-1b behind ``SliceServer`` with
    ``scls-pred`` on both packages: every request of a fixed trace and the
    streamed interactive request get JAX's tokens (near-tie rule), the
    streamed tokens are the handle's, a two-turn session's second turn
    joins JAX's number of prefix tokens (at least turn 1's whole pages),
    and ``release_session`` frees the same pages back to the baseline."""
    jm, jp, tm, tp = shared_models()
    vocab = tm.cfg.vocab_size
    want = _real_run("repro", jm, jp, vocab)
    got = _real_run("repro_torch", tm, tp, vocab)
    assert got["n_completed"] == want["n_completed"] == 6
    assert got["streamed"] == got["live"]
    for p, a, b in zip(got["prompts"], want["outputs"], got["outputs"]):
        assert_same_stream(p, a, b)
    for p, a, b in zip(got["turn_prompts"], want["turns"], got["turns"]):
        assert_same_stream(p, a, b)
    whole = (len(got["turn_prompts"][0]) + len(got["turns"][0]) - 1) \
        // PG * PG
    assert got["hit"] == want["hit"] >= whole > 0
    assert got["free"] == want["free"]
    assert got["free"][2] == got["free"][0] > got["free"][1]
    assert got["reprefill"] == want["reprefill"] == 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------
def test_launcher_serves_scls_pred_with_a_trace_on_cpu(tmp_path):
    """``repro_torch.launch.serve --strategy scls-pred --predictor
    histogram --trace-out`` on the CPU (reduced llama, persistent paged
    engines): every request completes, the Chrome trace and the decision
    audit pass ``scripts/validate_obs.py``, and the trace's slice spans
    rebuild the dispatch log of the printed run."""
    from repro_torch.launch import serve
    spec = importlib.util.spec_from_file_location(
        "validate_obs", REPO / "scripts" / "validate_obs.py")
    validate_obs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(validate_obs)
    out = tmp_path / "trace.json"
    m = serve.main(["--device", "cpu", "--reduced", "--rate", "2",
                    "--duration", "3", "--max-input", "48", "--max-gen",
                    "12", "--slice-len", "6", "--shared-prefix", "1",
                    "--m-available", "16e6", "--kv-layout", "paged",
                    "--kv-retain", "request", "--strategy", "scls-pred",
                    "--predictor", "histogram", "--trace-out", str(out)])
    assert m.n_requests >= 5 and m.n_completed == m.n_requests
    assert m.prefix_hit_tokens > 0
    decisions = tmp_path / "trace.decisions.json"
    assert validate_obs.main([str(out), "--decisions", str(decisions)]) == 0
    trace = json.loads(out.read_text())
    n_slices = len(validate_obs.trace_slice_log(trace))
    audit = json.loads(decisions.read_text())
    assert n_slices == sum(1 for e in audit if e["kind"] == "batch")
    assert sum(1 for e in audit if e["kind"] == "admission") == 1


def test_launcher_serves_full_width_unless_reduced():
    """``--reduced`` is a store_true flag whose reference default is True;
    the launcher's own default keeps the full-width model."""
    from repro_torch.launch import serve
    cfg, opts = serve.parse_args([])
    assert cfg.reduced is False and cfg.backend == "real"
    assert (cfg.workers, cfg.slice_len, cfg.max_gen, cfg.gamma) == \
        (1, 64, 256, 0.25)
    cfg, opts = serve.parse_args(["--reduced", "--max-input", "64",
                                  "--shared-prefix", "2"])
    assert cfg.reduced is True
    assert (opts.max_input, opts.shared_prefix) == (64, 2)
