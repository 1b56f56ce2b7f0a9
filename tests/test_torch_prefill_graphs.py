"""The engines' captured prefills and device loops
(``repro_torch.engine.graphs.Prefill`` and ``Loop``) on the CPU.

On the CPU a ``Loop`` runs the same body closure that the card captures,
in a Python loop under the plain condition (``kernels.ref.
graph_loop_ref``), and a ``Prefill`` runs the prefill closure that the
card captures; these tests hold them to the JAX engines on shared weights
(reduced float32 configs) and to the eager paths (``graphs.disabled()``)
at the three points where a loop must stop exactly: a batch whose rows
all finish before the slice's end, one that runs to the slice's end, and
rows whose forced lengths end them at different steps; the loop's
condition is tested before the first body too.  Then the plain condition
over a grid, the counts of condition tests, the keys of the prefill
buckets (a dense key covers prefill and loop), the joins' single-row
cache, and the profiler's prefill through its ``Prefill``.
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.engine import graphs


def _prompts(vocab, sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=s).astype(np.int32) for s in sizes]


@pytest.mark.parametrize("B", [1, 3, 8])
def test_graph_loop_ref_is_the_while_loops_cond(B):
    """``graph_loop_ref`` (and the ``ops`` wrapper on CPU tensors) is
    ``step < S and not all(done)`` over steps below, at and past S and
    every pattern of done flags of a small batch."""
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(B)
    patterns = [np.zeros(B, bool), np.ones(B, bool)] + [
        rng.random(B) < 0.5 for _ in range(6)]
    for S in (1, 4, 7):
        for s in range(0, S + 2):
            for done in patterns:
                want = s < S and not done.all()
                step = torch.tensor(s, dtype=torch.int64)
                flags = torch.from_numpy(done.copy())
                got = ref.graph_loop_ref(step, flags, S)
                assert got.dtype == torch.bool and got.dim() == 0
                assert bool(got) == want
                assert bool(ops.graph_loop(step, flags, S)) == want


@pytest.mark.parametrize("stop,limit,want", [
    (3, 8, 3),      # every row done before the limit
    (20, 8, 8),     # the limit reached
    (0, 8, 0),      # every row done before the first body
])
def test_loop_runs_while_the_condition_holds(stop, limit, want):
    """A ``Loop`` on the CPU: its body runs while ``step < limit and not
    all(done)``, the condition tested before the first body too; the step
    counter starts at 0 at each call, the head runs once first, and the
    reads come back on the host; the condition is tested once per body
    and once more (``graph_loop``'s plain calls)."""
    from repro_torch.kernels import ops
    dev = torch.device("cpu")
    bufs = dict(step=torch.full((), 5, dtype=torch.int64),
                done=torch.zeros(3, dtype=torch.bool),
                out=torch.zeros(3, dtype=torch.int32),
                cur=torch.zeros(3, dtype=torch.int32))
    heads = []

    def head():
        heads.append(1)
        bufs["done"].fill_(stop == 0)

    def body():
        bufs["out"].add_(1)
        bufs["step"].add_(1)
        bufs["done"].copy_(bufs["step"].expand(3) >= stop)

    cache = graphs.GraphCache(dev)
    loop = cache.add_loop(("dense", 3, 8, limit), body, bufs, limit,
                          head=head)
    ops.reset_counts()
    for call in range(2):
        bufs["out"].zero_()
        got = loop()
        assert int(got["step"]) == want
        assert got["out"].tolist() == [want] * 3
        assert got["out"].dtype == np.int32 and got["done"].dtype == np.bool_
        assert len(heads) == call + 1
    assert ops.plain_calls["graph_loop"] == 2 * (want + 1)
    assert cache.keys() == [("dense", 3, 8, limit)]
    assert cache.n_captures == 0
    ops.reset_counts()


def _jax_torch(arch="llama3.2-1b"):
    from torch_port import shared_models
    return shared_models(arch)


def _same(want, got, ps, arch):
    from torch_port import assert_same_stream
    assert got.steps == want.steps
    assert got.early_return == want.early_return
    for p, a, b in zip(ps, want.results, got.results):
        assert_same_stream(p, a["tokens"], b["tokens"], arch)
        for key in ("n_valid", "finished", "invalid", "pad"):
            assert b[key] == a[key], key


#: the three stopping points of one slice of 6 over three rows: every row
#: forced to end before the slice does, the slice's end reached, and
#: forced lengths that end the rows at three different steps
STOPS = {"before S": [3, 2, 4], "at S": [9, 6, 12], "forced": [1, 6, 3]}


@pytest.mark.parametrize("attn_impl", ["unfused", "fused"])
def test_paged_loop_stops_where_jax_and_eager_do(attn_impl):
    """The paged engine's ``Loop`` and ``Prefill`` closures at the three
    stopping points, each slice resuming the rows of the one before (or
    re-prefilling those whose valid tokens ended early) and adding a row
    that shares a parked resident's first page (a tail prefill past it):
    the JAX engine's results, steps, retained tokens and next tokens, and
    the eager paths' bit for bit."""
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = _jax_torch()
    kw = dict(eos_id=1, len_bucket=8, kv_layout="paged", page_tokens=8,
              kv_pool_tokens=1024, attn_impl=attn_impl)
    jeng = JaxEngine(jm, jp, **kw)
    run, eager = (StaticEngine(tm, tp, device="cpu", **kw)
                  for _ in range(2))
    ps = _prompts(tm.cfg.vocab_size, (11, 17, 6), 21)
    engines = (jeng, run, eager)
    for eng in engines:  # a parked resident whose first page joiners share
        with graphs.disabled() if eng is eager else contextlib.nullcontext():
            eng.serve_batch_paged([ps[1]], 6, [9], forced_gen_lens=[6])
    outs = {0: [], 1: [], 2: []}
    rid = 3
    for stop, forced in STOPS.items():
        joiner = np.concatenate([ps[1][:8], _prompts(tm.cfg.vocab_size,
                                                     (5,), rid)[0]])
        rows = [0, 1, 2, rid]
        batch = ps + [joiner]
        prev = [outs[r] for r in (0, 1, 2)] + [[]]
        args = (batch, 6, rows)
        skw = dict(forced_gen_lens=forced + [2], already_generated=prev)
        want = jeng.serve_batch_paged(*args, **skw)
        got = run.serve_batch_paged(*args, **skw)
        with graphs.disabled():
            ref = eager.serve_batch_paged(*args, **skw)
        _same(want, got, batch, "llama3.2-1b")
        assert [r["tokens"] for r in got.results] == \
            [r["tokens"] for r in ref.results]
        assert got.steps == ref.steps == {"before S": 4, "at S": 6,
                                          "forced": 6}[stop]
        assert got.prefix_hit_tokens == want.prefix_hit_tokens >= 8
        res = {r: (x.n_tokens, x.next_token)
               for r, x in run._resident.items()}
        assert res == {r: (x.n_tokens, x.next_token)
                       for r, x in eager._resident.items()}
        assert res == {r: (x.n_tokens, x.next_token)
                       for r, x in jeng._resident.items()}
        for r, out in zip(rows[:3], got.results):
            outs[r] = outs[r] + out["tokens"]
        for eng in engines:
            eng.release_request(rid)
        rid += 1
    kinds = {k[0] for k in run.step_graphs.keys()}
    assert kinds == {"prefill", "tail", "paged"}
    assert run.n_tail_prefill_stages == eager.n_tail_prefill_stages == 3
    assert eager.step_graphs.keys() == []


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m",
                                  "mixtral-8x22b"])
def test_dense_loop_stops_where_jax_and_eager_do(arch):
    """The dense engine's ``Loop`` (its prefill ahead of it in one bucket)
    at the three stopping points, each slice re-prefilling prompt +
    generated: the JAX engine's results and steps, and the eager path's
    tokens bit for bit; one bucket a distinct (B, L, S)."""
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.core.request import bucket_len
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = _jax_torch(arch)
    jeng = JaxEngine(jm, jp, eos_id=1, len_bucket=8)
    run, eager = (StaticEngine(tm, tp, eos_id=1, len_bucket=8, device="cpu")
                  for _ in range(2))
    ps = _prompts(tm.cfg.vocab_size, (7, 12, 4), 22)
    gen = [[], [], []]
    for stop, forced in STOPS.items():
        kw = dict(forced_gen_lens=forced,
                  already_generated=gen if any(gen) else None)
        want = jeng.serve_batch(ps, 6, **kw)
        got = run.serve_batch(ps, 6, **kw)
        with graphs.disabled():
            ref = eager.serve_batch(ps, 6, **kw)
        _same(want, got, ps, arch)
        assert [r["tokens"] for r in got.results] == \
            [r["tokens"] for r in ref.results]
        assert got.steps == ref.steps == {"before S": 4, "at S": 6,
                                          "forced": 6}[stop]
        gen = [g + r["tokens"] for g, r in zip(gen, got.results)]
    keys = run.step_graphs.keys()
    # L grows each slice, and with it the arena: older buckets are dropped
    assert all(k[0] == "dense" for k in keys)
    assert keys[-1][:4] == ("dense", 4, bucket_len(
        max(len(p) + len(g) for p, g in zip(ps, gen)) - 6, 8), 6)
    assert run.n_prefill_stages == eager.n_prefill_stages == 3
    assert run.n_decode_steps == eager.n_decode_steps == 16
    assert eager.step_graphs.keys() == []


def test_dense_key_covers_prefill_and_loop():
    """A dense bucket is one ``Loop`` whose ``Prefill`` runs at each call
    (no prefill key of its own); two slices in one (B, L, S) reuse it, and
    its static inputs hold the last slice's tokens and lengths."""
    from repro_torch.configs import get_config
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.models.registry import get_model
    model = get_model(get_config("llama3.2-1b", reduced=True))
    params = model.init(0, device="cpu")
    eng = StaticEngine(model, params, eos_id=1, len_bucket=8, device="cpu")
    ps = _prompts(model.cfg.vocab_size, (5, 7, 3, 6), 23)
    eng.serve_batch(ps[:2], 4)
    loop = eng.step_graphs.get(("dense", 2, 8, 4))
    assert isinstance(loop, graphs.Loop)
    assert isinstance(loop.head, graphs.Prefill)
    eng.serve_batch(ps[2:], 4)
    assert eng.step_graphs.keys() == [("dense", 2, 8, 4)]
    assert eng.step_graphs.get(("dense", 2, 8, 4)) is loop
    assert loop.bufs["lengths"].tolist() == [3, 6]
    assert eng.n_prefill_stages == 2 and eng.n_loops == 2


def test_join_prefill_fills_one_static_single_row_cache():
    """``ContinuousEngine``'s joins through their ``("join", L)``
    ``Prefill``s write one static single-row cache of width W, whatever
    L, equal to the eager prefill's."""
    from repro_torch.configs import get_config
    from repro_torch.engine.continuous_engine import ContinuousEngine
    from repro_torch.models import transformer as tfm
    from repro_torch.models.registry import get_model
    model = get_model(get_config("llama3.2-1b", reduced=True))
    params = model.init(0, device="cpu")
    eng = ContinuousEngine(model, params, max_slots=2, max_context=64,
                           eos_id=1, len_bucket=8, device="cpu")
    with torch.no_grad():
        for n in (5, 13, 6):
            prompt = _prompts(model.cfg.vocab_size, (n,), n)[0]
            first, L, single = eng._run_prefill(prompt)
            assert single is eng._single
            toks = np.zeros((1, L), np.int32)
            toks[0, L - n:] = prompt
            logits, want = tfm.prefill(params, model.cfg,
                                       torch.from_numpy(toks),
                                       torch.tensor([n], dtype=torch.int32),
                                       64)
            assert first == int(torch.argmax(logits[0]))
            for a, b in zip(graphs._leaves(single), graphs._leaves(want)):
                if isinstance(b, torch.Tensor):
                    assert torch.equal(a, b)
                else:
                    assert int(a) == b
    assert eng.step_graphs.keys() == [("join", 8), ("join", 16)]


def test_profiler_times_the_prefill_through_its_prefill_graph(monkeypatch):
    """``profile_engine`` builds a ``Prefill`` per (N, L) and times its
    calls (the capture's call on the card is the warm-up), and its decode
    starts from that prefill's outputs, which equal the eager prefill's:
    the samples' grid and the fitted estimator come out as the eager
    profile's, whose prefill stays eager under ``graphs.disabled()``."""
    from repro_torch.configs import get_config
    from repro_torch.engine import profiler
    from repro_torch.models.registry import get_model
    model = get_model(get_config("llama3.2-1b", reduced=True))
    params = model.init(0, device="cpu")
    made, calls = [], []
    orig = graphs.GraphCache.add_prefill

    def add_prefill(cache, key, fn, bufs):
        def counted():
            calls.append(key)
            fn()
        made.append(key)
        return orig(cache, key, counted, bufs)

    monkeypatch.setattr(graphs.GraphCache, "add_prefill", add_prefill)
    pre, dec = profiler.profile_engine(model, params, (1, 2), (8, 16),
                                       n_decode_iters=2, repeats=2)
    assert [(n, L) for n, L, _ in pre] == [(1, 8), (1, 16), (2, 8), (2, 16)]
    assert len(made) == 4 and len(calls) == 4 * 3
    assert all(t > 0 for _, _, t in pre + dec)
    made.clear()
    with graphs.disabled():
        pre_e, dec_e = profiler.profile_engine(model, params, (1,), (8,),
                                               n_decode_iters=2, repeats=1)
    assert made == [] and len(pre_e) == len(dec_e) == 1
    batch = {"tokens": torch.arange(2, 10, dtype=torch.int32)[None],
             "lengths": torch.tensor([8], dtype=torch.int32)}
    run, out = profiler._prefiller(model, params, batch, 11)
    run()
    last, cache = model.prefill(params, batch, 11)
    assert torch.equal(out["last"], last)
    assert torch.equal(out["cache"].k, cache.k)
    assert int(out["cache"].write_idx) == cache.write_idx
