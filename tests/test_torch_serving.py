"""The port's scheduling core and the slice as a whole: the golden
dispatch logs bit-exact through ``repro_torch.serving.SchedulerCore`` +
``SimBackend`` (built from the port's own copies), the launcher serving
a CodeFuse trace end to end on the CPU on each KV path, the port's
``RealBackend`` giving every request of a fixed trace the JAX
``RealBackend``'s tokens, and fused engines behind ``SchedulerCore``
streaming the unfused engines' tokens."""
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


LAUNCH_CPU = ["--backend", "real", "--device", "cpu", "--reduced",
              "--rate", "2", "--duration", "3", "--max-input", "48",
              "--max-gen", "12", "--slice-len", "6", "--shared-prefix", "1",
              "--m-available", "16e6"]


def test_launcher_serves_a_codefuse_trace_on_cpu():
    """``repro_torch.launch.serve --backend real --device cpu --reduced
    --kv-layout paged --kv-retain request``: every request completes, a
    shared-prefix request joins resident pages, and both unfused kernel
    wrappers took their plain (CPU) versions."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_counts()
    m = serve.main(LAUNCH_CPU + ["--kv-layout", "paged",
                                 "--kv-retain", "request"])
    assert m.n_requests >= 4 and m.n_completed == m.n_requests
    assert m.prefix_hit_tokens > 0 and m.reprefill_tokens == 0
    assert ops.plain_calls["paged_prefill_write"] > 0
    assert ops.plain_calls["paged_decode_attention"] > 0
    assert ops.launches() == dict.fromkeys(ops.plain_calls, 0)


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_launcher_slice_retain_on_cpu(kv_layout):
    """The launcher's default ``--kv-retain slice`` (the JAX launcher's
    default serving path) with either memory model: every request
    completes, requests that outlive a slice re-prefill (``max_gen`` 12 >
    ``slice_len`` 6), and the dense attention runs through the plain
    versions of flash_prefill and decode_attention only (and the decode
    loop's condition through graph_loop's), nothing launched."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    ops.reset_counts()
    m = serve.main(LAUNCH_CPU + ["--kv-layout", kv_layout])
    assert m.n_requests >= 4 and m.n_completed == m.n_requests
    assert m.reprefill_tokens > 0 and m.prefix_hit_tokens == 0
    dense = ("flash_prefill", "decode_attention", "graph_loop")
    assert all(ops.plain_calls[k] > 0 for k in dense)
    assert not any(n for k, n in ops.plain_calls.items() if k not in dense)
    assert not any(ops.launches().values())


def test_launcher_rejects_request_retain_without_paged_layout():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.parse_args(["--kv-retain", "request"])


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
                         RealBackend([eng], mem=mem, kv_layout="paged",
                                     sched_bucket=est.bucket,
                                     kv_retain="request"),
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


def test_fused_engines_behind_the_core_stream_unfused_tokens():
    """``tests/test_retain.py``'s server-level fused sweep below
    ``SliceServer`` (``tests/test_torch_server.py`` drives that layer):
    ``SchedulerCore`` + ``RealBackend``
    over fused persistent paged engines gives every request the tokens of
    the same run over unfused engines, and only the fused plain versions
    run."""
    from repro_torch.core.estimator import a100_llama13b_profile
    from repro_torch.core.memory import PagedMemoryEstimator
    from repro_torch.core.request import Request
    from repro_torch.core.schedulers import make_strategy
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.kernels import ops
    from repro_torch.serving import RealBackend, SchedulerCore, \
        fitted_estimator
    jm, jp, tm, tp = shared_models()
    ps = prompts(tm.cfg.vocab_size, [12, 9, 5], seed=4)
    gens = (14, 6, 10)
    streams, calls = {}, {}
    for impl in ("unfused", "fused"):
        mem = PagedMemoryEstimator(delta_bytes=tm.kv_bytes_per_token(),
                                   m_available=64e6, zeta=0.9, page_tokens=8,
                                   bucket=8, kv_retain="request")
        est = fitted_estimator(a100_llama13b_profile())
        eng = StaticEngine(tm, tp, eos_id=1, len_bucket=8, kv_layout="paged",
                           page_tokens=8, kv_pool_tokens=mem.total_blocks * 8,
                           attn_impl=impl, device="cpu")
        core = SchedulerCore(
            make_strategy("scls", slice_len=8, max_gen=24, gamma=0.25,
                          kv_layout="paged"),
            RealBackend([eng], mem=mem, kv_layout="paged",
                        sched_bucket=est.bucket, kv_retain="request"),
            1, est, mem)
        trace = [Request(rid=i, arrival=0.1 * i, input_len=len(p),
                         gen_len=g, max_gen=24, prompt=p)
                 for i, (p, g) in enumerate(zip(ps, gens))]
        ops.reset_counts()
        m = core.run(trace, 2.0)
        assert m.n_completed == len(trace)
        streams[impl] = [r.output_tokens for r in trace]
        calls[impl] = dict(ops.plain_calls)
    for p, want, got in zip(ps, streams["unfused"], streams["fused"]):
        assert_same_stream(p, want, got)
    assert calls["fused"]["paged_prefill_write"] == 0
    assert calls["fused"]["paged_decode_attention"] == 0
    assert calls["fused"]["fused_rope_prefill_write"] > 0
    assert calls["fused"]["fused_rope_decode_append"] > 0


# ---------------------------------------------------------------------------
# sessions and persistent retention (tests/test_sessions.py,
# tests/test_retain.py): the cases the port had no counterpart of
# ---------------------------------------------------------------------------
SESSION_POOL_TOKENS = 512
SESSION_PG = 8


def _fixed_estimator(pkg):
    """The paper testbed's fitted estimator: fixed, where the reference's
    session tests fit one from wall-clock timings (ROADMAP C5)."""
    import importlib
    serving = importlib.import_module(f"{pkg}.serving")
    estimator = importlib.import_module(f"{pkg}.core.estimator")
    return serving.fitted_estimator(estimator.a100_llama13b_profile())


def _session_server(pkg, model, params, prefix_sharing=True, workers=1):
    """``pkg``'s SliceServer over ``workers`` persistent paged engines of
    512 tokens in pages of 8 (retain mode), as ``tests/test_sessions.py``
    builds it, with the fixed estimator."""
    import importlib
    serving = importlib.import_module(f"{pkg}.serving")
    engine = importlib.import_module(f"{pkg}.engine.static_engine")
    dev = {"device": "cpu"} if pkg == "repro_torch" else {}
    cfg = serving.ServingConfig(
        strategy="scls", backend="real", workers=workers, kv_layout="paged",
        kv_retain="request", page_tokens=SESSION_PG, slice_len=8, max_gen=8,
        gamma=0.25, mem_bucket=8, prefix_sharing=prefix_sharing, **dev)
    delta = model.kv_bytes_per_token()
    pool_pages = SESSION_POOL_TOKENS // SESSION_PG
    mem = cfg.memory_estimator(
        delta, m_available=pool_pages * SESSION_PG * delta / cfg.zeta + 1)
    assert mem.total_blocks == pool_pages
    engines = [engine.StaticEngine(model, params, eos_id=1, len_bucket=8,
                                   kv_layout="paged", page_tokens=SESSION_PG,
                                   kv_pool_tokens=SESSION_POOL_TOKENS,
                                   prefix_sharing=prefix_sharing, **dev)
               for _ in range(workers)]
    return cfg.build_real(engines, _fixed_estimator(pkg), mem)


def _turn_prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=n).astype(np.int32)
            for n in (24, 12, 9)]


def _mid_slice_turn(pkg, model, params, turns):
    import asyncio

    async def main():
        server = _session_server(pkg, model, params).aio
        async with server:
            s = server.session(max_gen=6)
            h1 = await s.submit_turn(turns[0], gen_len=4)
            # h1 not awaited: turn 2 goes in while turn 1 is in flight
            h2 = await s.submit_turn(turns[1], gen_len=4)
            await h2.result()
            assert h1.done
            expected = np.concatenate(
                [turns[0], np.asarray(h1.output_tokens, np.int32), turns[1]])
            np.testing.assert_array_equal(np.asarray(h2.request.prompt),
                                          expected)
            out = (list(h1.output_tokens), list(h2.output_tokens),
                   np.asarray(h2.request.prompt))
            await s.close()
            m = await server.close()
        return out, m

    return asyncio.run(main())


def test_session_turn_submitted_mid_slice_matches_jax():
    """``tests/test_sessions.py:231`` on the port: a turn submitted while
    the previous one is mid-slice awaits it, joins its prefix and serves
    JAX's tokens (near-tie rule), history intact."""
    jm, jp, tm, tp = shared_models()
    turns = _turn_prompts(tm.cfg.vocab_size, seed=1)
    (w1, w2, _), wm = _mid_slice_turn("repro", jm, jp, turns)
    (g1, g2, prompt2), gm = _mid_slice_turn("repro_torch", tm, tp, turns)
    assert len(g2) == 4
    assert_same_stream(turns[0], w1, g1)
    if g1 == w1:
        assert_same_stream(prompt2, w2, g2)
    assert gm.prefix_hit_tokens == wm.prefix_hit_tokens > 0


def test_session_cancel_mid_conversation_restores_baseline():
    """``tests/test_sessions.py:261`` on the port: a turn cancelled
    mid-conversation leaves history; the anchor holds turn 1's pages
    while the session lives, and on close every page returns."""
    import asyncio
    _, _, tm, tp = shared_models()
    turns = _turn_prompts(tm.cfg.vocab_size, seed=2)

    async def main():
        server = _session_server("repro_torch", tm, tp).aio
        alloc = server.core.backend.allocators[0]
        baseline = alloc.free_blocks
        async with server:
            s = server.session(max_gen=8)
            h1 = await s.submit_turn(turns[0], gen_len=6)
            await h1.result()
            h2 = await s.submit_turn(turns[1], gen_len=8)
            h2.cancel()
            await h2.result()
            assert h2.cancelled
            assert alloc.used_blocks > 0    # the anchor holds turn 1
            h3 = await s.submit_turn(turns[2], gen_len=2)
            await h3.result()
            assert h3.request.input_len == len(turns[0]) + 6 + len(turns[2])
            await s.close()
            assert alloc.free_blocks == baseline
            assert not alloc.owners()
            await server.close()

    asyncio.run(main())


def test_real_affinity_keeps_turns_on_anchor_worker():
    """``tests/test_sessions.py:294`` on the port, with a fixed estimator
    (ROADMAP C5): two workers, the Eq. 11 minimum nudged away from the
    anchor worker; ``RealBackend.batch_affinity`` keeps turn 2 where its
    pages live (a prefix hit), the plain policy moves it (a full
    prefill), and the tokens are the same either way."""
    import asyncio
    _, _, tm, tp = shared_models()
    turns = _turn_prompts(tm.cfg.vocab_size, seed=3)

    async def run(affinity):
        server = _session_server("repro_torch", tm, tp, workers=2).aio
        async with server:
            off = server.core.offloader
            assert off.affinity_fn is not None
            if not affinity:
                off.affinity_fn = None
            s = server.session(max_gen=6)
            h1 = await s.submit_turn(turns[0], gen_len=4)
            await h1.result()
            anchor, _ = server.core.backend._session_anchor[s.session_id]
            off.loads = {w: (0.005 if w == anchor else 0.0)
                         for w in off.loads}
            h2 = await s.submit_turn(turns[1], gen_len=4)
            await h2.result()
            outs = (list(h1.output_tokens), list(h2.output_tokens))
            await s.close()
            m = await server.close()
        return outs, m

    outs_on, m_on = asyncio.run(run(True))
    outs_off, m_off = asyncio.run(run(False))
    assert outs_on == outs_off
    assert m_on.prefix_hit_tokens > 0
    assert m_off.prefix_hit_tokens == 0


def _retain_server(model, params, slice_len=8, max_gen=32, pg=16,
                   m_available=64e6):
    """``tests/test_retain.py``'s retain-mode server on the port (one
    persistent paged engine, the fixed estimator)."""
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.serving import ServingConfig
    cfg = ServingConfig(strategy="scls", backend="real", kv_layout="paged",
                        page_tokens=pg, kv_retain="request",
                        slice_len=slice_len, max_gen=max_gen, gamma=0.25,
                        m_available=m_available, mem_bucket=8, device="cpu")
    mem = cfg.memory_estimator(model.kv_bytes_per_token())
    eng = StaticEngine(model, params, eos_id=1, len_bucket=8,
                       kv_layout="paged", page_tokens=pg,
                       kv_pool_tokens=mem.total_blocks * pg, device="cpu")
    return cfg.build_real([eng], _fixed_estimator("repro_torch"), mem)


def test_retain_request_cancel_mid_flight_returns_pool_to_baseline():
    """``tests/test_retain.py:192`` on the port: cancelling a request whose
    prefix pages are retained mid-flight releases them at the slice
    boundary; the other requests complete and the pool is back at its
    baseline."""
    _, _, tm, tp = shared_models()
    server = _retain_server(tm, tp)
    allocators = server.core.backend.allocators
    baseline = [a.free_blocks for a in allocators]
    victim = server.submit(prompts(tm.cfg.vocab_size, [16], seed=3)[0],
                           gen_len=24, max_gen=32, arrival=0.0)
    others = [server.submit(p, gen_len=6 + i, max_gen=32, arrival=0.1 * i)
              for i, p in enumerate(prompts(tm.cfg.vocab_size, [8, 9],
                                            seed=4))]
    while not victim.finished and victim.request.generated == 0:
        server.step()
    assert not victim.finished
    assert any(a.used_blocks > 0 for a in allocators)
    assert victim.cancel()
    m = server.drain()
    assert victim.cancelled and not victim.done
    assert all(h.done for h in others)
    assert m.n_completed == 2
    assert [a.free_blocks for a in allocators] == baseline
    assert all(not a.owners() for a in allocators)
    assert server.core.mem.retained_blocks == 0


def test_retain_request_streaming_matches_one_shot():
    """``tests/test_retain.py:235`` on the port: tokens streamed slice by
    slice through a retained request's handle equal one-shot generation
    by a dense engine, and JAX's one-shot stream (near-tie rule)."""
    import itertools

    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = shared_models()
    server = _retain_server(tm, tp)
    p = prompts(tm.cfg.vocab_size, [14], seed=6)[0]
    h = server.submit(p, gen_len=18, max_gen=32)
    got = list(itertools.islice(h.tokens(), 18))
    server.drain()
    assert h.request.n_schedules >= 3
    one_shot = StaticEngine(tm, tp, eos_id=1, len_bucket=8, device="cpu")
    want = one_shot.serve_batch([p], slice_len=32,
                                forced_gen_lens=[18]).results[0]["tokens"]
    assert got == want
    jax_want = JaxEngine(jm, jp, eos_id=1, len_bucket=8).serve_batch(
        [p], slice_len=32, forced_gen_lens=[18]).results[0]["tokens"]
    assert_same_stream(p, jax_want, got)


def test_unsatisfiable_batch_unwinds_partial_reservations():
    """``tests/test_retain.py:251`` on the port: a batch that cannot fit
    after evicting every parked resident unwinds the rows it had granted,
    so the pool is not wedged and each rid serves alone afterwards."""
    from repro_torch.engine.static_engine import StaticEngine
    _, _, tm, tp = shared_models()
    p1, p2 = prompts(tm.cfg.vocab_size, [10, 10], seed=8)
    eng = StaticEngine(tm, tp, eos_id=1, len_bucket=8, kv_layout="paged",
                       page_tokens=8, kv_pool_tokens=32, device="cpu")
    with pytest.raises(MemoryError):
        eng.serve_batch_paged([p1, p2], 8, [1, 2], forced_gen_lens=[4, 4])
    assert eng.allocator.free_blocks == eng.allocator.n_pages
    assert not eng.allocator.owners()
    res = eng.serve_batch_paged([p1], 8, [1], forced_gen_lens=[4])
    assert res.results[0]["n_valid"] == 4
    eng.release_request(1)
    assert eng.allocator.free_blocks == eng.allocator.n_pages
