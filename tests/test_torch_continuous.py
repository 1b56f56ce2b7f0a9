"""The port's ILS engine (``repro_torch.engine.continuous_engine``) against
the JAX ``ContinuousEngine`` on shared weights (reduced float32
llama3.2-1b, CPU), in the scenarios of ``tests/test_engine.py``: tokens
equal to the static engine's, the slot cap, paged == dense, paged with
EOS, parallelism bounded by free pages, bad geometry, a never-fitting
request, and pages released when ``serve`` stops mid-flight.  Outputs,
join order, iterations and peak parallelism must equal the JAX engine's,
and the port's allocator must end with every page free."""
import numpy as np
import pytest
import torch

from torch_port import prompts, shared_models


@pytest.fixture(scope="module")
def models():
    return shared_models()


def _pair(models, **kw):
    """(JAX engine, port engine) built with the same arguments."""
    from repro.engine.continuous_engine import ContinuousEngine as JaxEngine
    from repro_torch.engine.continuous_engine import ContinuousEngine
    jm, jp, tm, tp = models
    kw = dict(dict(max_slots=2, max_context=64, eos_id=1, len_bucket=8), **kw)
    return JaxEngine(jm, jp, **kw), ContinuousEngine(tm, tp, device="cpu",
                                                     **kw)


def _serve_both(jeng, teng, ps, **kw):
    want = jeng.serve(ps, **kw)
    got = teng.serve(ps, **kw)
    assert got.outputs == want.outputs
    assert got.join_order == want.join_order
    assert got.iterations == want.iterations
    assert got.peak_parallel == want.peak_parallel
    assert got.concurrency == want.concurrency
    if teng.alloc is not None:
        assert teng.alloc.free_blocks == teng.alloc.n_pages
    return want, got


def _paged(page_tokens=8, **kw):
    return dict(kv_layout="paged", page_tokens=page_tokens, **kw)


#: (prompt sizes, seed, serve arguments) of tests/test_engine.py's
#: static-tokens, slot-cap and EOS scenarios
SCENARIOS = {
    "static_tokens": ([5, 9, 4], 3, dict(forced_gen_lens=[4, 6, 3])),
    "slot_cap": ([4] * 5, 4, dict(forced_gen_lens=[3] * 5)),
    "eos": ([6, 11, 4], 7, dict(max_gen=12)),
}


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_continuous_engine_matches_jax(models, scenario, layout):
    sizes, seed, kw = SCENARIOS[scenario]
    jeng, teng = _pair(models, **(_paged() if layout == "paged" else {}))
    ps = prompts(models[2].cfg.vocab_size, sizes, seed=seed)
    want, got = _serve_both(jeng, teng, ps, **kw)
    if scenario == "slot_cap":
        # 2 slots, 5 requests of 3 tokens: FCFS join waves
        assert got.join_order == [0, 1, 2, 3, 4]
        assert all(len(o) == 3 for o in got.outputs)
        assert got.peak_parallel == 2
    if scenario == "eos":
        assert all(1 <= len(o) <= 12 for o in got.outputs)
    assert teng.n_prefill_stages == len(ps)
    assert teng.n_decode_steps == got.iterations - 1


def test_continuous_engine_matches_static_tokens(models):
    """Each request's ILS stream equals a one-shot static serve of it."""
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = models
    _, teng = _pair(models)
    se = StaticEngine(tm, tp, eos_id=1, len_bucket=8, device="cpu")
    ps = prompts(tm.cfg.vocab_size, [5, 9, 4], seed=3)
    forced = [4, 6, 3]
    res = teng.serve(ps, forced_gen_lens=forced)
    for i, p in enumerate(ps):
        want = se.serve_batch([p], slice_len=16,
                              forced_gen_lens=[forced[i]]).results[0]
        assert res.outputs[i] == want["tokens"]


def test_paged_engine_token_exact_vs_dense(models):
    """kv_layout="paged" is layout only: the port's paged engine gives the
    dense engine's tokens, join order and iterations, and both the JAX
    engines'."""
    ps = prompts(models[2].cfg.vocab_size, [5, 9, 4, 12, 3], seed=3)
    kw = dict(forced_gen_lens=[4, 6, 3, 5, 7])
    jd, td = _pair(models)
    jp_, tp_ = _pair(models, **_paged())
    _, rd = _serve_both(jd, td, ps, **kw)
    _, rp = _serve_both(jp_, tp_, ps, **kw)
    assert rp.outputs == rd.outputs
    assert rp.join_order == rd.join_order
    assert rp.iterations == rd.iterations


def test_paged_engine_parallelism_bounded_by_free_pages(models):
    """Under one KV-token budget the paged engine packs short requests
    into more parallel rows than the dense worst-case slots, and frees
    every page by the end, as the JAX engine does."""
    ps = prompts(models[2].cfg.vocab_size, [4] * 6, seed=4)
    kw = dict(forced_gen_lens=[3] * 6)
    W, budget = 64, 2 * 64
    jd, td = _pair(models, max_slots=budget // W, max_context=W)
    jp_, tp_ = _pair(models, max_slots=6, max_context=W,
                     **_paged(total_kv_tokens=budget))
    _, rd = _serve_both(jd, td, ps, **kw)
    _, rp = _serve_both(jp_, tp_, ps, **kw)
    assert rp.outputs == rd.outputs
    assert rd.peak_parallel == 2
    assert rp.peak_parallel > rd.peak_parallel
    assert rp.iterations < rd.iterations
    assert tp_.alloc.free_blocks == tp_.alloc.n_pages


@pytest.mark.parametrize("kw", [
    dict(max_context=60, page_tokens=16),          # 60 % 16 != 0
    dict(max_context=64, page_tokens=16, total_kv_tokens=40),
])
def test_paged_engine_rejects_bad_geometry(models, kw):
    from repro.engine.continuous_engine import ContinuousEngine as JaxEngine
    from repro_torch.engine.continuous_engine import ContinuousEngine
    jm, jp, tm, tp = models
    with pytest.raises(ValueError):
        JaxEngine(jm, jp, kv_layout="paged", **kw)
    with pytest.raises(ValueError, match="multiple of page_tokens"):
        ContinuousEngine(tm, tp, kv_layout="paged", device="cpu", **kw)


def test_paged_engine_raises_on_never_fitting_request(models):
    """A request whose envelope exceeds the whole pool raises before any
    reservation: nothing leaks and the engine still serves."""
    jeng, teng = _pair(models, **_paged(total_kv_tokens=32))
    vocab = models[2].cfg.vocab_size
    small = prompts(vocab, [4], seed=5)[0]
    huge = prompts(vocab, [28], seed=5)[0]
    for eng in (jeng, teng):
        with pytest.raises(ValueError, match="exceeds the page pool"):
            eng.serve([small, huge], forced_gen_lens=[3, 20])
        assert eng.alloc.free_blocks == eng.alloc.n_pages
    _, got = _serve_both(jeng, teng, [small], forced_gen_lens=[3])
    assert len(got.outputs[0]) == 3


def test_paged_engine_releases_pages_when_serve_stops_mid_flight(models):
    """``serve`` stopped by ``max_iters`` with rows in flight returns every
    envelope to the pool and clears the rows; a later serve still works."""
    jeng, teng = _pair(models, **_paged())
    ps = prompts(models[2].cfg.vocab_size, [5, 9], seed=11)
    _, got = _serve_both(jeng, teng, ps, forced_gen_lens=[30, 30],
                         max_iters=3)
    assert got.iterations == 3 and all(len(o) < 30 for o in got.outputs)
    assert bool((teng.cache.block_table == 0).all())
    assert bool((teng.cache.slot_pos == -1).all())
    _, got = _serve_both(jeng, teng, ps, forced_gen_lens=[3, 3])
    assert all(len(o) == 3 for o in got.outputs)


def test_continuous_engine_defaults_to_cuda_and_raises_without_it(
        models, monkeypatch):
    from repro_torch.engine.continuous_engine import ContinuousEngine
    jm, jp, tm, tp = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for layout in ("dense", "paged"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ContinuousEngine(tm, tp, kv_layout=layout, max_context=64,
                             page_tokens=8)


def test_paged_rows_write_and_clear_like_jax(models):
    """``write_prefill_pages`` and ``clear_row`` leave the port's per-row
    cache as the JAX functions leave theirs (pages, block table, slot_pos,
    lengths)."""
    import jax.numpy as jnp
    from repro.kvcache import paged as jpaged
    from repro_torch.kvcache import paged as tpaged
    L, P, pg, nb, Hkv, D, T = 2, 6, 4, 3, 2, 8, 10
    rng = np.random.default_rng(12)
    k = rng.standard_normal((L, T, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((L, T, Hkv, D)).astype(np.float32)
    sp = np.concatenate([np.full(3, -1), np.arange(7)]).astype(np.int32)
    jc = jpaged.init_paged_kv_cache(L, 2, P, pg, nb, Hkv, D, jnp.float32)
    tc = tpaged.init_paged_kv_cache(L, 2, P, pg, nb, Hkv, D, torch.float32,
                                    torch.device("cpu"))
    jc = jpaged.write_prefill_pages(jc, 1, [4, 2, 6], jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(sp), 7)
    tc = tpaged.write_prefill_pages(tc, 1, [4, 2, 6], torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(sp),
                                    7)
    for name in ("k_pages", "v_pages", "block_table", "slot_pos", "lengths"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)))
    jc, tc = jpaged.clear_row(jc, 1), tpaged.clear_row(tc, 1)
    np.testing.assert_array_equal(tc.block_table.numpy(),
                                  np.asarray(jc.block_table))
    np.testing.assert_array_equal(tc.slot_pos.numpy(),
                                  np.asarray(jc.slot_pos))
    with pytest.raises(ValueError, match="exceed"):
        tpaged.write_prefill_pages(tc, 0, [1], torch.from_numpy(k),
                                   torch.from_numpy(v), torch.from_numpy(sp),
                                   7)
