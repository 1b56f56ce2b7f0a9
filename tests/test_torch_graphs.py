"""The engines' decode step per bucket (``repro_torch.engine.graphs``).

On the CPU the engines run each bucket's ``Step`` (the closure over static
buffers that the card captures, run uncaptured), and these tests hold it
to the JAX engines on shared weights (reduced float32 configs) and to the
port's eager loops (``graphs.disabled()``): the token streams, and per
slice the steps, the finished rows, and the paged engine's retained
tokens and next tokens, over two slices of different batch and block
table buckets; StaticEngine dense (llama3.2-1b, mamba2-130m,
deepseek-v2-lite-16b), paged unfused and fused (a resumed request and a
prefix-sharing tail prefill), ContinuousEngine dense and paged.  Then the
bucket keys (a bucket reused, a new one added, an arena that grows drops
the dense steps), the launch tally of a capture (per thread, under
threads that launch meanwhile), ``disabled()`` per thread, and the rule
that keeps an engine eager.

The tests marked ``cuda`` run on the card and skip here: a replay gives
the eager paths' tokens, decode steps and page pools bit for bit on each
captured path, and launch counts that add up to the eager ones; each
bucket is captured once (a dense bucket's prefill and loop as one graph);
and a step or loop that cannot be captured, or a graph that cannot be
rewritten into a loop, raises.
JAX is imported inside the CPU tests only, so on the card

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_graphs.py
"""
import numpy as np
import pytest
import torch

from repro_torch.engine import graphs

#: the scenario's prompts: 3 rows (batch bucket 4), then 5 (bucket 8)
#: whose longest row needs twice the block table
SIZES_A, SIZES_B = (7, 12, 4), (30, 9)


def _prompts(vocab, sizes, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=s).astype(np.int32) for s in sizes]


def _same_results(want, got, ps, arch, check_stream=True):
    from torch_port import assert_same_stream
    assert got.steps == want.steps
    assert got.early_return == want.early_return
    assert got.reprefill_tokens == want.reprefill_tokens
    for p, a, b in zip(ps, want.results, got.results):
        if check_stream:
            assert_same_stream(p, a["tokens"], b["tokens"], arch)
        else:
            assert b["tokens"] == a["tokens"]
        for key in ("n_valid", "finished", "invalid", "pad"):
            assert b[key] == a[key], key


def _residents(eng):
    return {rid: (r.n_tokens, r.next_token)
            for rid, r in eng._resident.items()}


@pytest.mark.parametrize("attn_impl", ["unfused", "fused"])
def test_paged_static_engine_steps_match_jax_and_eager(attn_impl):
    """Two slices: three fresh rows (batch bucket 4, block table 4), then
    two of them resumed, a row joining the first one's pages (a tail
    prefill) and two fresh rows, one of 30 tokens (bucket 8, block table
    8).  The runner's results equal the JAX engine's and the eager loop's,
    and its retained tokens and next tokens the eager loop's."""
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    from torch_port import shared_models
    jm, jp, tm, tp = shared_models()
    kw = dict(eos_id=1, len_bucket=8, kv_layout="paged", page_tokens=8,
              kv_pool_tokens=1024, attn_impl=attn_impl)
    jeng = JaxEngine(jm, jp, **kw)
    run, eager = (StaticEngine(tm, tp, device="cpu", **kw)
                  for _ in range(2))
    vocab = tm.cfg.vocab_size
    pa = _prompts(vocab, SIZES_A, 0)
    pb = [pa[1][:16].copy()] + _prompts(vocab, SIZES_B, 1)
    pb[0][-1] = 3  # its first page joins row 1's, its tail is its own
    slices = [(pa, [0, 1, 2], [20, 9, 6], None),
              ([pa[0], pa[1]] + pb, [0, 1, 3, 4, 5], [14, 3, 8, 8, 5],
               "resume")]
    outs = {}
    for ps, rids, forced, mode in slices:
        prev = ([outs[r] for r in rids[:2]] + [[]] * (len(rids) - 2)
                if mode else None)
        args = (ps, 6, rids)
        want = jeng.serve_batch_paged(*args, forced_gen_lens=forced,
                                      already_generated=prev)
        got = run.serve_batch_paged(*args, forced_gen_lens=forced,
                                    already_generated=prev)
        with graphs.disabled():
            ref = eager.serve_batch_paged(*args, forced_gen_lens=forced,
                                          already_generated=prev)
        _same_results(want, got, ps, "llama3.2-1b")
        _same_results(ref, got, ps, "llama3.2-1b", check_stream=False)
        assert got.prefix_hit_tokens == want.prefix_hit_tokens
        assert _residents(run) == _residents(eager)
        for r, res in zip(rids, got.results):
            outs[r] = outs.get(r, []) + res["tokens"]
    assert got.prefix_hit_tokens > 0
    assert run.step_graphs.keys() == [
        ("prefill", attn_impl, 4, 16, 2), ("paged", attn_impl, 4, 4, 6),
        ("prefill", attn_impl, 2, 32, 4), ("tail", attn_impl, 1, 8, 4),
        ("paged", attn_impl, 8, 8, 6)]
    assert eager.step_graphs.keys() == []


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m",
                                  "deepseek-v2-lite-16b"])
def test_dense_static_engine_steps_match_jax_and_eager(arch):
    """Two slices of the paper's SCLS on the dense layout: three rows
    (bucket 4), then two of them re-prefilled with what they generated
    (bucket 2, a longer batch length): the runner's results equal the JAX
    engine's and the eager loop's."""
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    from torch_port import shared_models
    jm, jp, tm, tp = shared_models(arch)
    jeng = JaxEngine(jm, jp, eos_id=1, len_bucket=8)
    run, eager = (StaticEngine(tm, tp, eos_id=1, len_bucket=8, device="cpu")
                  for _ in range(2))
    ps = _prompts(tm.cfg.vocab_size, SIZES_A, 2)
    first = dict(forced_gen_lens=[10, 4, 10])
    results = []
    for batch, kw in ((ps, first), ([ps[0], ps[2]], None)):
        if kw is None:
            kw = dict(forced_gen_lens=[4, 4], already_generated=[
                results[0].results[0]["tokens"],
                results[0].results[2]["tokens"]])
        want = jeng.serve_batch(batch, 6, **kw)
        got = run.serve_batch(batch, 6, **kw)
        with graphs.disabled():
            ref = eager.serve_batch(batch, 6, **kw)
        _same_results(want, got, batch, arch)
        _same_results(ref, got, batch, arch, check_stream=False)
        results.append(got)
    assert run.step_graphs.keys() == [("dense", 4, 16, 6),
                                      ("dense", 2, 16, 6)]
    assert eager.step_graphs.keys() == []


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_continuous_engine_step_matches_jax_and_eager(layout):
    """Five requests through two slots (joins, exits, per-row write
    slots): the runner's outputs, join order and iterations equal the JAX
    engine's and the eager loop's, all through the engine's one step."""
    from repro.engine.continuous_engine import ContinuousEngine as JaxEngine
    from repro_torch.engine.continuous_engine import ContinuousEngine
    from torch_port import shared_models
    jm, jp, tm, tp = shared_models()
    kw = dict(max_slots=2, max_context=64, eos_id=1, len_bucket=8)
    if layout == "paged":
        kw.update(kv_layout="paged", page_tokens=8)
    jeng = JaxEngine(jm, jp, **kw)
    run, eager = (ContinuousEngine(tm, tp, device="cpu", **kw)
                  for _ in range(2))
    ps = _prompts(tm.cfg.vocab_size, (5, 9, 4, 11, 6), 3)
    forced = [4, 6, 3, 5, 2]
    want = jeng.serve(ps, forced_gen_lens=forced)
    got = run.serve(ps, forced_gen_lens=forced)
    with graphs.disabled():
        ref = eager.serve(ps, forced_gen_lens=forced)
    for other in (want, ref):
        assert got.outputs == other.outputs
        assert got.join_order == other.join_order
        assert got.iterations == other.iterations
    assert run.step_graphs.keys() == [("join", 8), ("join", 16), "decode"]
    assert eager.step_graphs.keys() == []


@pytest.fixture(scope="module")
def llama():
    """The reduced float32 llama3.2-1b on the CPU, random weights (no JAX:
    the bucket tests look at keys, not at values)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    model = get_model(get_config("llama3.2-1b", reduced=True))
    return model, model.init(0, device="cpu")


def test_dense_buckets_reuse_add_and_drop_on_arena_growth(llama):
    """Two slices of one (B, L, S) share a step; a new B or slice length
    adds one; a bucket whose cache outgrows the arena drops every dense
    step (they were captured over the old buffer), and a bucket that
    fits again is added beside it."""
    from repro_torch.engine.static_engine import StaticEngine
    model, params = llama
    eng = StaticEngine(model, params, eos_id=1, len_bucket=8, device="cpu")
    ps = _prompts(model.cfg.vocab_size, (5, 7, 3, 6), 4)
    eng.serve_batch(ps[:2], 4)
    step = eng.step_graphs.get(("dense", 2, 8, 4))
    eng.serve_batch(ps[2:], 4)
    assert eng.step_graphs.keys() == [("dense", 2, 8, 4)]
    assert eng.step_graphs.get(("dense", 2, 8, 4)) is step
    eng.serve_batch(ps[:1], 4)  # B 1: a smaller cache, the arena fits
    eng.serve_batch(ps[:2], 3)
    assert eng.step_graphs.keys() == [("dense", 2, 8, 4), ("dense", 1, 8, 4),
                                      ("dense", 2, 8, 3)]
    size = eng._arena.nbytes
    eng.serve_batch(ps, 8)  # B 4, S 8: the arena grows
    assert eng._arena.nbytes > size
    assert eng.step_graphs.keys() == [("dense", 4, 8, 8)]
    eng.serve_batch(ps[:1], 4)
    assert eng.step_graphs.keys() == [("dense", 4, 8, 8), ("dense", 1, 8, 4)]


def test_paged_buckets_reuse_and_add(llama):
    """A slice in a bucket seen before reuses its loop, and a prefill in a
    (B, L, nb) bucket seen before its prefill; a new batch bucket,
    block-table bucket or slice length adds a loop, a new B, L or nb a
    prefill."""
    from repro_torch.engine.static_engine import StaticEngine
    model, params = llama
    eng = StaticEngine(model, params, eos_id=1, len_bucket=8,
                       kv_layout="paged", page_tokens=8, kv_pool_tokens=512,
                       device="cpu")
    ps = _prompts(model.cfg.vocab_size, (5, 7, 40), 5)
    eng.serve_batch_paged(ps[:2], 4, [0, 1])
    pre = eng.step_graphs.get(("prefill", "unfused", 2, 8, 1))
    eng.serve_batch_paged(ps[:2], 4, [0, 1])  # resumed, same buckets
    assert eng.step_graphs.keys() == [("prefill", "unfused", 2, 8, 1),
                                      ("paged", "unfused", 2, 4, 4)]
    eng.serve_batch_paged(ps[:2], 4, [3, 4])  # fresh rows, same buckets
    assert eng.step_graphs.get(("prefill", "unfused", 2, 8, 1)) is pre
    assert len(eng.step_graphs.keys()) == 2
    eng.serve_batch_paged(ps[:2], 2, [0, 1])
    eng.serve_batch_paged(ps[2:], 4, [2])
    eng.serve_batch_paged(ps, 4, [0, 1, 2])  # stale residents: prefilled
    eng.serve_batch_paged(ps[:1], 4, [5])  # B 1: a new prefill bucket
    assert eng.step_graphs.keys() == [
        ("prefill", "unfused", 2, 8, 1), ("paged", "unfused", 2, 4, 4),
        ("paged", "unfused", 2, 4, 2), ("prefill", "unfused", 1, 40, 5),
        ("paged", "unfused", 1, 8, 4), ("prefill", "unfused", 4, 40, 5),
        ("paged", "unfused", 4, 8, 4), ("prefill", "unfused", 1, 8, 1),
        ("paged", "unfused", 1, 4, 4)]


def test_capture_tally_moves_launches_to_replays():
    """A launch made while this thread captures is tallied, not counted;
    ``add_launches`` adds a replay's tally to the counts."""
    from repro_torch.kernels import build, ops
    ops.reset_counts()
    assert build.counted("decode_attention")
    with build.capturing() as tally:
        assert not build.counted("decode_attention")
        assert not build.counted("decode_attention")
    assert tally == {"decode_attention": 2}
    assert build.counted("decode_attention")
    ops.add_launches(tally)
    ops.add_launches(tally)
    assert ops.launches()["decode_attention"] == 4
    ops.reset_counts()


def test_capture_tallies_are_per_thread():
    """Threads that launch while another captures keep their counts: a
    tally takes only its own thread's launches."""
    import sys
    import threading
    from repro_torch.kernels import build, ops
    ops.reset_counts()
    tallies = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def capturer():
        with build.capturing() as tally:
            for _ in range(500):
                build.counted("paged_decode_attention")
        tallies.append(tally)

    def launcher():
        for _ in range(500):
            if build.counted("paged_decode_attention"):
                ops.add_launches({"paged_decode_attention": 1})

    try:
        threads = [threading.Thread(target=f) for f in
                   (capturer, launcher) * 4]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert tallies == [{"paged_decode_attention": 500}] * 4
    assert ops.launches()["paged_decode_attention"] == 4 * 500
    ops.reset_counts()


def test_disabled_holds_for_its_own_thread(llama):
    """``graphs.disabled()`` sends this thread's engines to their eager
    loops, not another thread's."""
    import threading
    model, params = llama
    seen = []
    with graphs.disabled():
        assert graphs.eager_reason(params, "dense") == "graphs.disabled()"
        t = threading.Thread(
            target=lambda: seen.append(graphs.eager_reason(params, "dense")))
        t.start()
        t.join(timeout=30)
    assert seen == [None]
    assert graphs.eager_reason(params, "dense") is None


def test_eager_rule_keeps_a_family_eager(llama, monkeypatch):
    """A family named in ``EAGER_FAMILIES`` decodes through the eager
    loop (no step is built), with the same tokens."""
    from repro_torch.engine.static_engine import StaticEngine
    model, params = llama
    ps = _prompts(model.cfg.vocab_size, (5, 7), 6)
    run = StaticEngine(model, params, eos_id=1, len_bucket=8, device="cpu")
    got = run.serve_batch(ps, 4)
    monkeypatch.setattr(graphs, "EAGER_FAMILIES", frozenset({"dense"}))
    assert graphs.eager_reason(params, "dense") is not None
    eager = StaticEngine(model, params, eos_id=1, len_bucket=8, device="cpu")
    ref = eager.serve_batch(ps, 4)
    assert eager.step_graphs.keys() == []
    assert [r["tokens"] for r in got.results] == \
        [r["tokens"] for r in ref.results]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def card_models():
    """{arch: (model, params)} of reduced llama3.2-1b and mamba2-130m in
    bf16 on the card, random weights from a seed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (captures CUDA graphs)")
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    out = {}
    for arch in ("llama3.2-1b", "mamba2-130m"):
        cfg = get_config(arch, reduced=True).replace(dtype=torch.bfloat16)
        model = get_model(cfg)
        out[arch] = (model, model.init(0, device="cuda"))
    return out


#: the captured paths of the card tests: (arch, engine, keyword arguments)
CARD_PATHS = {
    "dense": ("llama3.2-1b", "static", {}),
    "unfused": ("llama3.2-1b", "static",
                dict(kv_layout="paged", page_tokens=16, kv_pool_tokens=2048)),
    "fused": ("llama3.2-1b", "static",
              dict(kv_layout="paged", page_tokens=16, kv_pool_tokens=2048,
                   attn_impl="fused")),
    "ils_dense": ("llama3.2-1b", "continuous", dict(max_context=128)),
    "ils_paged": ("llama3.2-1b", "continuous",
                  dict(max_context=128, kv_layout="paged", page_tokens=16)),
    "mamba2": ("mamba2-130m", "static", {}),
}


def _card_serve(card_models, path):
    """(tokens, engine) of ``path`` serving two slices (one for ILS): the
    first slice's rows end at different forced lengths, the second's run
    to the slice's end."""
    from repro_torch.engine.continuous_engine import ContinuousEngine
    from repro_torch.engine.static_engine import StaticEngine
    arch, kind, kw = CARD_PATHS[path]
    model, params = card_models[arch]
    ps = _prompts(model.cfg.vocab_size, (17, 40, 9), 7)
    with torch.no_grad():
        if kind == "continuous":
            eng = ContinuousEngine(model, params, max_slots=2, eos_id=1,
                                   len_bucket=8, device="cuda", **kw)
            return eng.serve(ps, forced_gen_lens=[12, 7, 20]).outputs, eng
        eng = StaticEngine(model, params, eos_id=1, len_bucket=8,
                           device="cuda", **kw)
        toks = []
        for forced in ([3, 8, 5], None):  # the second resumes / re-prefills
            if eng.kv_layout == "paged":
                res = eng.serve_batch_paged(ps, 8, [0, 1, 2],
                                            forced_gen_lens=forced,
                                            already_generated=toks or None)
            else:
                res = eng.serve_batch(ps, 8, forced_gen_lens=forced,
                                      already_generated=toks or None)
            toks = [t + r["tokens"] for t, r in
                    zip(toks or [[]] * len(ps), res.results)]
        return toks, eng


@pytest.mark.cuda
@pytest.mark.parametrize("path", list(CARD_PATHS))
def test_replay_equals_eager_bit_for_bit(card_models, path):
    """Graph replays (a static engine's prefills and device loops, an ILS
    engine's joins and steps) give the eager paths' tokens and decode
    steps, and on the paged paths their page pools, bit for bit."""
    from repro_torch.kernels import ops
    ops.reset_counts()
    got, eng = _card_serve(card_models, path)
    torch.cuda.synchronize()
    graph_launches = ops.launches()
    ops.reset_counts()
    with graphs.disabled():
        want, ref = _card_serve(card_models, path)
    torch.cuda.synchronize()
    eager_launches = ops.launches()
    assert got == want
    assert eng.n_decode_steps == ref.n_decode_steps
    assert eng.n_prefill_stages == ref.n_prefill_stages
    assert eng.step_graphs.n_captures >= 1
    assert ref.step_graphs.n_captures == 0
    # the replays' tallies add up to the eager launches, the loop's
    # condition once a step and once a slice
    loops = getattr(eng, "n_loops", 0)
    assert graph_launches.pop("graph_loop") == \
        (eng.n_decode_steps + loops if loops else 0)
    assert eager_launches.pop("graph_loop") == 0
    assert graph_launches == eager_launches
    if eng.kv_layout == "paged":
        pools = ((e.cache.k_pages, e.cache.v_pages) if hasattr(e, "cache")
                 else (e._k_pages, e._v_pages) for e in (eng, ref))
        for a, b in zip(*pools):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_one_capture_per_bucket(card_models):
    """Slices in one bucket replay one prefill graph and one loop graph; a
    new bucket captures one more of each; the launches counted are the
    replays' too: a layer's kernel once a prefill stage or decode step,
    the loop's condition once a step and once a slice."""
    from repro_torch.engine.static_engine import StaticEngine
    from repro_torch.kernels import ops
    model, params = card_models["llama3.2-1b"]
    eng = StaticEngine(model, params, eos_id=1, len_bucket=8, device="cuda",
                       kv_layout="paged", page_tokens=16,
                       kv_pool_tokens=2048)
    ps = _prompts(model.cfg.vocab_size, (17, 40), 8)
    ops.reset_counts()
    with torch.no_grad():
        for rids in ([0, 1], [2, 3], [4, 5]):
            eng.serve_batch_paged(ps, 8, rids, forced_gen_lens=[8, 8])
            for rid in rids:
                eng.release_request(rid)
        assert eng.step_graphs.captures == {"prefill": 1, "paged": 1}
        eng.serve_batch_paged(ps[:1], 8, [6], forced_gen_lens=[8])
    torch.cuda.synchronize()
    assert eng.step_graphs.captures == {"prefill": 2, "paged": 2}
    assert eng.step_graphs.n_captures == 4
    L = model.cfg.n_layers
    launches = ops.launches()
    assert launches["paged_decode_attention"] == L * eng.n_decode_steps
    assert launches["paged_prefill_write"] == L * eng.n_prefill_stages
    assert launches["graph_loop"] == eng.n_decode_steps + eng.n_loops == \
        4 * 8 + 4


@pytest.mark.cuda
def test_dense_bucket_is_one_capture_of_prefill_and_loop(card_models):
    """A dense bucket captures its prefill and its loop once, as one
    graph: a second slice in the bucket replays it (one loop call, whose
    host read is the slice's only one) and gives the eager path's
    tokens."""
    from repro_torch.engine.static_engine import StaticEngine
    model, params = card_models["llama3.2-1b"]
    ps = _prompts(model.cfg.vocab_size, (17, 40, 9), 9)
    with torch.no_grad():
        eng = StaticEngine(model, params, eos_id=1, len_bucket=8,
                           device="cuda")
        runs = [eng.serve_batch(ps, 8, forced_gen_lens=[8, 3, 6])
                for _ in range(2)]
        with graphs.disabled():
            ref = StaticEngine(model, params, eos_id=1, len_bucket=8,
                               device="cuda").serve_batch(
                ps, 8, forced_gen_lens=[8, 3, 6])
    assert eng.step_graphs.captures == {"dense": 1}
    assert eng.step_graphs.keys() == [("dense", 4, 40, 8)]
    assert eng.n_loops == 2
    for res in runs:
        assert [r["tokens"] for r in res.results] == \
            [r["tokens"] for r in ref.results]
        assert res.steps == ref.steps == 8


@pytest.mark.cuda
def test_failed_capture_raises(card_models):
    """A step that reads a device value on the host runs as the warm-up,
    then its capture raises; no graph is kept, and the device stays
    usable."""
    dev = torch.device("cuda")
    cache = graphs.GraphCache(dev)
    x = torch.ones(4, device=dev)

    def fn():
        x.add_(float(x.sum()))  # a host read: not capturable

    step = cache.add("bad", fn, {"x": x})
    with pytest.raises(RuntimeError):
        step()
    assert step.graph is None and cache.n_captures == 0
    torch.cuda.synchronize()
    assert float(torch.ones(2, device=dev).sum()) == 2.0


@pytest.mark.cuda
def test_failed_loop_capture_or_edit_raises(card_models):
    """A loop body that reads a device value on the host runs its warm-up
    loop, then its capture raises and no graph is kept; a graph captured
    without ``keep_graph`` cannot be rewritten into a loop and raises; the
    device stays usable."""
    from repro_torch.kernels import graph_loop
    dev = torch.device("cuda")
    cache = graphs.GraphCache(dev)
    bufs = dict(step=torch.zeros((), dtype=torch.int64, device=dev),
                done=torch.zeros(2, dtype=torch.bool, device=dev),
                out=torch.zeros(2, dtype=torch.int32, device=dev),
                cur=torch.zeros(2, dtype=torch.int32, device=dev))

    def body():
        bufs["out"].add_(int(bufs["out"].sum()) + 1)  # a host read
        bufs["step"].add_(1)

    loop = cache.add_loop("bad", body, bufs, 3)
    with pytest.raises(RuntimeError):
        loop()
    assert loop.graph is None and cache.n_captures == 0
    plain = torch.cuda.CUDAGraph()
    with torch.cuda.graph(plain):
        bufs["cur"].add_(1)
    with pytest.raises(RuntimeError):
        graph_loop.build_loop(plain, bufs["step"], bufs["done"], 3)
    torch.cuda.synchronize()
    assert float(torch.ones(2, device=dev).sum()) == 2.0
