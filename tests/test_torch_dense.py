"""The port's dense serving path against the JAX package on shared
weights: ``StaticEngine.serve_batch`` (left padding, the power-of-two
batch bucket, a cache of ``L + S`` slots, forced lengths, EOS, invalid-
token accounting and the §3.3 re-prefill count) in the scenarios of
``tests/test_engine.py``, and ``RealBackend(kv_retain="slice")`` over
dense engines with a dense and a paged memory model, streaming the JAX
``RealBackend``'s tokens with the same re-prefill count."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import assert_same_stream, prompts, shared_models

#: float32 logits of the reduced model, port vs JAX (as test_torch_models)
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def engines():
    """(JAX dense engine, the port's dense engine), both with EOS id 1."""
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = shared_models()
    return (JaxEngine(jm, jp, eos_id=1, len_bucket=8),
            StaticEngine(tm, tp, eos_id=1, len_bucket=8, device="cpu"))


def _vocab():
    return shared_models()[2].cfg.vocab_size


def _serve_both(engines, batch, slice_len, **kw):
    """One ``serve_batch`` on each engine; the port's result must be the
    JAX one's (streams by the near-tie rule, every count exactly)."""
    jeng, teng = engines
    want = jeng.serve_batch(batch, slice_len, **kw)
    got = teng.serve_batch(batch, slice_len, **kw)
    assert got.steps == want.steps
    assert got.batch_input_len == want.batch_input_len
    assert got.batch_size == want.batch_size
    assert got.early_return == want.early_return
    assert got.reprefill_tokens == want.reprefill_tokens
    for p, a, b in zip(batch, want.results, got.results):
        assert_same_stream(p, a["tokens"], b["tokens"])
        for key in ("n_valid", "finished", "invalid", "pad"):
            assert b[key] == a[key], key
    return got


def test_dense_invalid_and_pad_tokens_match_jax(engines):
    """Finished rows keep generating invalid tokens until the batch ends
    (paper §2.4); short prompts are left-padded."""
    got = _serve_both(engines, prompts(_vocab(), [5, 11, 3]), 8,
                      forced_gen_lens=[3, 8, 20])
    r0, r1, r2 = got.results
    assert got.steps == 8
    assert r0["n_valid"] == 3 and r0["invalid"] == 5 and r0["finished"]
    assert r1["n_valid"] == 8 and r1["finished"]
    assert r2["n_valid"] == 8 and not r2["finished"]
    assert r2["pad"] == got.batch_input_len - 3


def test_dense_early_return_matches_jax(engines):
    got = _serve_both(engines, prompts(_vocab(), [4, 6]), 32,
                      forced_gen_lens=[2, 3])
    assert got.early_return and got.steps == 3


def test_dense_slice_invariance_matches_jax(engines):
    """A request served in slices of 8, re-prefilling prompt + generated
    each time, gets the one-shot stream; every slice agrees with JAX,
    re-prefill counts included."""
    p = prompts(_vocab(), [7])
    total = 20
    one_shot = _serve_both(engines, p, 32, forced_gen_lens=[total])
    got, reprefill = [], 0
    while len(got) < total:
        res = _serve_both(engines, p, 8,
                          forced_gen_lens=[total - len(got)],
                          already_generated=[got])
        reprefill += res.reprefill_tokens
        got.extend(res.results[0]["tokens"])
    assert got == one_shot.results[0]["tokens"]
    assert reprefill == (7 + 8) + (7 + 16)


def test_dense_slice_invariance_with_companions_matches_jax(engines):
    ps = prompts(_vocab(), [9, 4, 13], seed=2)
    solo = _serve_both(engines, ps[:1], 8, forced_gen_lens=[8])
    together = _serve_both(engines, ps, 8, forced_gen_lens=[8, 5, 6])
    assert together.results[0]["tokens"] == solo.results[0]["tokens"]


def test_dense_eos_without_forced_lens_matches_jax(engines):
    got = _serve_both(engines, prompts(_vocab(), [5]), 8)
    r = got.results[0]
    assert 1 <= r["n_valid"] <= 8
    if r["n_valid"] < 8:
        assert r["tokens"][-1] == 1


def test_windowed_ring_cache_matches_jax():
    """A sliding window of 5 over a ring cache narrower than the prompt (8
    slots, 12-token prompts, one left-padded): the ring keeps the last 8
    entries and decode overwrites the oldest, so slot_pos leaves index
    order after the first step.  The port's dense prefill and decode
    (flash_prefill and decode_attention's plain versions) give the JAX
    model's logits at every step."""
    from repro_torch.kernels import ops
    jm, jp, tm, tp = shared_models()
    T, W, window = 12, 8, 5
    ops.reset_counts()
    toks = np.zeros((2, T), np.int32)
    for b, p in enumerate(prompts(tm.cfg.vocab_size, [12, 9], seed=5)):
        toks[b, T - len(p):] = p
    lens = np.array([12, 9], np.int32)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, W,
                        window=window)
    with torch.no_grad():
        tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                                 "lengths": torch.from_numpy(lens)}, W,
                            window=window)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(10):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur),
                                jnp.asarray(step, jnp.int32), window=window)
        with torch.no_grad():
            tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur), step,
                                    window=window)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   atol=LOGIT_TOL)
        np.testing.assert_array_equal(tc.slot_pos.numpy(),
                                      np.asarray(jc.slot_pos))
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    sp = tc.slot_pos.numpy()
    assert (np.diff(sp, axis=1) < 0).any()  # ring order, not index order
    n_layers = tm.cfg.n_layers
    assert ops.plain_calls["flash_prefill"] == n_layers
    assert ops.plain_calls["decode_attention"] == 10 * n_layers
    ops.reset_counts()


def _fixed_trace(request_cls, vocab):
    """Five requests over several slices of 8 (two repeat an earlier
    prompt's first pages, which a dense engine re-prefills in full)."""
    ps = prompts(vocab, [21, 9, 14, 5], seed=11)
    ps.append(np.concatenate([ps[0][:16], ps[3]]))
    gens = [20, 7, 13, 4, 11]
    return [request_cls(rid=i, arrival=0.3 * i, input_len=len(p), gen_len=g,
                        max_gen=24, prompt=p)
            for i, (p, g) in enumerate(zip(ps, gens))]


@pytest.mark.parametrize("kv_layout", ["dense", "paged"])
def test_slice_retain_real_backend_matches_jax(kv_layout):
    """``RealBackend(kv_retain="slice")`` over dense engines, SCLS: every
    request gets the JAX backend's tokens, the §3.3 re-prefill count is
    the JAX one's (and > 0: requests outlive one slice), and a paged
    memory model's per-worker envelopes are all released."""
    from repro.core.estimator import a100_llama13b_profile as jax_profile
    from repro.core import memory as jmemory
    from repro.core.request import Request as JaxRequest
    from repro.core.schedulers import make_strategy as jax_strategy
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro.serving import RealBackend as JaxRealBackend
    from repro.serving import SchedulerCore as JaxCore
    from repro.serving import fitted_estimator as jax_fitted
    from repro_torch.core import memory
    from repro_torch.core.estimator import a100_llama13b_profile
    from repro_torch.core.request import Request
    from repro_torch.core.schedulers import make_strategy
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.serving import (RealBackend, SchedulerCore,
                                     fitted_estimator)
    jm, jp, tm, tp = shared_models()
    mem_kw = dict(delta_bytes=tm.kv_bytes_per_token(), m_available=4e6,
                  zeta=0.9, bucket=8)
    if kv_layout == "paged":
        mem_kw.update(page_tokens=8, kv_retain="slice")
    mem_cls = ("PagedMemoryEstimator" if kv_layout == "paged"
               else "AnalyticMemoryEstimator")
    strat_kw = dict(slice_len=8, max_gen=24, gamma=0.25, kv_layout=kv_layout)
    runs = {}
    for side in ("jax", "port"):
        if side == "jax":
            mem = getattr(jmemory, mem_cls)(**mem_kw)
            est = jax_fitted(jax_profile())
            eng = JaxEngine(jm, jp, eos_id=1, len_bucket=8)
            backend = JaxRealBackend([eng], mem=mem, kv_layout=kv_layout,
                                     sched_bucket=est.bucket)
            core = JaxCore(jax_strategy("scls", **strat_kw), backend, 1,
                           est, mem)
            trace = _fixed_trace(JaxRequest, tm.cfg.vocab_size)
        else:
            mem = getattr(memory, mem_cls)(**mem_kw)
            est = fitted_estimator(a100_llama13b_profile())
            eng = StaticEngine(tm, tp, eos_id=1, len_bucket=8, device="cpu")
            backend = RealBackend([eng], mem=mem, kv_layout=kv_layout,
                                  sched_bucket=est.bucket)
            core = SchedulerCore(make_strategy("scls", **strat_kw), backend,
                                 1, est, mem)
            trace = _fixed_trace(Request, tm.cfg.vocab_size)
        runs[side] = (core.run(trace, 2.0), trace, backend)
    (jmet, jtrace, _), (met, trace, backend) = runs["jax"], runs["port"]
    assert met.n_completed == jmet.n_completed == len(trace)
    assert met.reprefill_tokens == jmet.reprefill_tokens > 0
    for a, b in zip(jtrace, trace):
        assert len(b.output_tokens) == b.gen_len
        assert_same_stream(b.prompt, a.output_tokens, b.output_tokens)
    if kv_layout == "paged":
        alloc = backend.allocators[0]
        assert alloc.free_blocks == alloc.n_pages
    else:
        assert backend.allocators is None
