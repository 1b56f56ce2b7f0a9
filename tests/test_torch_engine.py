"""The port's persistent paged engine (``repro_torch.engine.static_engine``)
against the JAX ``StaticEngine(kv_layout="paged")`` on shared weights, in
the scenarios of ``tests/test_retain.py``: multi-slice retention with zero
re-prefill, EOS-driven rows, evict-on-pressure falling back to re-prefill,
and a prefix-sharing tail join, with ``attn_impl="unfused"`` and (for the
retention and tail-join scenarios) ``"fused"``, whose streams must also
equal the port's unfused engine's.  Tokens, ``n_valid``, ``finished``,
``steps``, re-prefill and prefix-hit counts must agree, and the allocator
must return to its baseline.  The scenarios run at pages of 8 slots, and
the retention and tail-join scenarios of both engines again at pages of
4 and 32 (``PAGE_SIZES``): on the card, the paged decode kernels look a
page of 32 up once per 8 slots and a page of 4 once per slot."""
import numpy as np
import pytest

from torch_port import assert_same_stream, prompts, shared_models


#: the page sizes the retention and tail-join scenarios run at besides 8
PAGE_SIZES = (4, 32)


@pytest.fixture(scope="module")
def models():
    return shared_models()


def _engines(models, pool_tokens=512, page_tokens=8, eos_id=1,
             attn_impl="unfused"):
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = models
    kw = dict(eos_id=eos_id, len_bucket=8, kv_layout="paged",
              page_tokens=page_tokens, kv_pool_tokens=pool_tokens,
              attn_impl=attn_impl)
    return JaxEngine(jm, jp, **kw), StaticEngine(tm, tp, device="cpu", **kw)


def _assert_same_result(want, got, prompts_in, arch="llama3.2-1b"):
    assert got.steps == want.steps
    assert got.reprefill_tokens == want.reprefill_tokens
    assert got.prefix_hit_tokens == want.prefix_hit_tokens
    assert got.shared_blocks == want.shared_blocks
    assert got.batch_input_len == want.batch_input_len
    assert got.early_return == want.early_return
    for p, a, b in zip(prompts_in, want.results, got.results):
        assert_same_stream(p, a["tokens"], b["tokens"], arch)
        for key in ("n_valid", "finished", "invalid", "pad"):
            assert b[key] == a[key], key


def _serve_both(jeng, teng, batch, slice_len, rids, arch="llama3.2-1b",
                **kw):
    want = jeng.serve_batch_paged(batch, slice_len, rids, **kw)
    got = teng.serve_batch_paged(batch, slice_len, rids, **kw)
    _assert_same_result(want, got, batch, arch)
    return want, got


def _release_all(jeng, teng, rids):
    for rid in rids:
        assert teng.release_request(rid) == jeng.release_request(rid)
    assert teng.allocator.free_blocks == teng.allocator.n_pages
    assert jeng.allocator.free_blocks == jeng.allocator.n_pages


def test_multi_slice_retention_zero_reprefill(models):
    """>= 3 slices with retained pages: every resumed slice remaps its
    pages (no re-prefill) and the streams match the JAX engine's."""
    check_multi_slice_retention(models)


def check_multi_slice_retention(models, arch="llama3.2-1b", page_tokens=8):
    """The retention scenario on ``models`` (the reduced ``arch``)."""
    jm, jp, tm, tp = models
    jeng, teng = _engines(models, page_tokens=page_tokens)
    ps = prompts(tm.cfg.vocab_size, [7, 12, 4], seed=0)
    totals = [20, 9, 16]
    outs = [[] for _ in ps]
    n_slices = reprefill = 0
    while any(len(o) < t for o, t in zip(outs, totals)):
        idx = [i for i in range(len(ps)) if len(outs[i]) < totals[i]]
        want, got = _serve_both(
            jeng, teng, [ps[i] for i in idx], 8, [100 + i for i in idx],
            arch=arch,
            forced_gen_lens=[totals[i] - len(outs[i]) for i in idx],
            already_generated=[outs[i] for i in idx])
        reprefill += got.reprefill_tokens
        n_slices += 1
        for s, i in enumerate(idx):
            outs[i].extend(want.results[s]["tokens"])
    assert n_slices >= 3 and reprefill == 0
    assert [len(o) for o in outs] == totals
    _release_all(jeng, teng, [100, 101, 102])


def test_eos_driven_rows_finish_early_alike(models):
    """EOS-driven rows (forced length at the sentinel) end at the model's
    own EOS token; the EOS id is taken from the stream so that it occurs."""
    from repro_torch.engine.static_engine import EOS_DRIVEN
    jm, jp, tm, tp = models
    ps = prompts(tm.cfg.vocab_size, [9, 13], seed=7)
    probe, _ = _engines(models)
    stream = probe.serve_batch_paged(ps, 6, [1, 2], forced_gen_lens=[6, 6])
    eos = stream.results[1]["tokens"][2]
    jeng, teng = _engines(models, eos_id=eos)
    want, got = _serve_both(jeng, teng, ps, 6, [1, 2],
                            forced_gen_lens=[3, EOS_DRIVEN])
    assert got.results[1]["finished"] and got.results[1]["n_valid"] <= 3
    assert got.results[0]["n_valid"] == 3
    _release_all(jeng, teng, [1, 2])


def test_evict_on_pressure_falls_back_to_reprefill(models):
    """5 pages of 8 tokens: the second request's dispatch evicts the
    parked first, whose next slice re-prefills classically (counted)."""
    jm, jp, tm, tp = models
    jeng, teng = _engines(models, pool_tokens=40)
    p1, p2 = prompts(tm.cfg.vocab_size, [10, 9], seed=1)
    w1, _ = _serve_both(jeng, teng, [p1], 8, [1], forced_gen_lens=[16])
    w2, _ = _serve_both(jeng, teng, [p2], 8, [2], forced_gen_lens=[16])
    assert teng.n_evictions == jeng.n_evictions == 1
    o1, o2 = list(w1.results[0]["tokens"]), list(w2.results[0]["tokens"])
    w, g = _serve_both(jeng, teng, [p1], 8, [1], forced_gen_lens=[8],
                       already_generated=[o1])
    assert g.reprefill_tokens == len(p1) + len(o1)
    _serve_both(jeng, teng, [p2], 8, [2], forced_gen_lens=[8],
                already_generated=[o2])
    _release_all(jeng, teng, [1, 2])


def test_prefix_sharing_tail_join(models):
    """A prompt repeating a resident request's first two pages joins them
    and prefills only its tail (stage A'), in the same call as a fresh
    stage-A prefill and a resumed resident.  The engine counts the two
    stages apart: stage A attends through ``ops.flash_prefill`` (once per
    layer), the tail over its gathered pages."""
    check_tail_join(models)


def check_tail_join(models, pg=8):
    """The tail-join scenario at pages of ``pg`` slots: the resident
    prompt holds two whole pages and 5 tokens more."""
    from repro_torch.kernels import ops
    jm, jp, tm, tp = models
    jeng, teng = _engines(models, page_tokens=pg, pool_tokens=64 * pg)
    src, tail, fresh = prompts(tm.cfg.vocab_size, [2 * pg + 5, 7, 11],
                               seed=9)
    first, _ = _serve_both(jeng, teng, [src], 8, [1], forced_gen_lens=[24])
    joiner = np.concatenate([src[:2 * pg], tail])
    teng.n_prefill_stages = teng.n_tail_prefill_stages = 0
    ops.reset_counts()
    want, got = _serve_both(jeng, teng, [src, joiner, fresh], 8, [1, 2, 3],
                            forced_gen_lens=[16, 12, 12],
                            already_generated=[first.results[0]["tokens"],
                                               [], []])
    assert (teng.n_prefill_stages, teng.n_tail_prefill_stages) == (2, 1)
    L = tm.cfg.n_layers
    assert ops.plain_calls["flash_prefill"] == L
    assert ops.plain_calls["paged_prefill_write"] == 2 * L
    assert got.reprefill_tokens == 0
    assert got.prefix_hit_tokens == 2 * pg and got.shared_blocks == 2
    assert teng.allocator.shared_blocks == jeng.allocator.shared_blocks > 0
    _release_all(jeng, teng, [1, 2, 3])


@pytest.mark.parametrize("pg", PAGE_SIZES)
def test_multi_slice_retention_at_page_size(models, pg):
    """The retention scenario at pages of ``pg`` slots."""
    check_multi_slice_retention(models, page_tokens=pg)


@pytest.mark.parametrize("pg", PAGE_SIZES)
def test_prefix_sharing_tail_join_at_page_size(models, pg):
    """The tail-join scenario at pages of ``pg`` slots."""
    check_tail_join(models, pg)


# ---------------------------------------------------------------------------
# attn_impl="fused": the fused kernels' plain versions on the CPU
# ---------------------------------------------------------------------------
def test_fused_engine_multi_slice_matches_jax_fused_and_port_unfused(models):
    """The scenario of ``tests/test_retain.py``'s fused test (prompts of
    7/12/4 tokens, totals 20/9/16, slices of 8, pages of 8): the port's
    fused engine streams the JAX fused engine's tokens and the port's
    unfused engine's, slice by slice."""
    check_fused_multi_slice(models)


def check_fused_multi_slice(models, arch="llama3.2-1b", page_tokens=8):
    """The fused retention scenario on ``models`` (the reduced ``arch``)."""
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = models
    jeng, teng = _engines(models, attn_impl="fused", page_tokens=page_tokens)
    ueng = StaticEngine(tm, tp, eos_id=1, len_bucket=8, kv_layout="paged",
                        page_tokens=page_tokens, kv_pool_tokens=512,
                        device="cpu")
    ps = prompts(tm.cfg.vocab_size, [7, 12, 4], seed=0)
    totals = [20, 9, 16]
    outs = [[] for _ in ps]
    n_slices = 0
    while any(len(o) < t for o, t in zip(outs, totals)):
        idx = [i for i in range(len(ps)) if len(outs[i]) < totals[i]]
        batch = [ps[i] for i in idx]
        kw = dict(forced_gen_lens=[totals[i] - len(outs[i]) for i in idx],
                  already_generated=[outs[i] for i in idx])
        rids = [100 + i for i in idx]
        want, got = _serve_both(jeng, teng, batch, 8, rids, arch=arch, **kw)
        unfused = ueng.serve_batch_paged(batch, 8, rids, **kw)
        _assert_same_result(unfused, got, batch, arch)
        n_slices += 1
        for s, i in enumerate(idx):
            outs[i].extend(want.results[s]["tokens"])
    assert n_slices >= 3 and [len(o) for o in outs] == totals
    _release_all(jeng, teng, [100, 101, 102])


def test_fused_engine_prefix_sharing_tail_join(models):
    """The tail join through the fused prefill write: stage A (fresh),
    stage A' (tail past two shared pages) and a resumed resident in one
    call, against the JAX fused engine and the port's unfused engine."""
    check_fused_tail_join(models)


def check_fused_tail_join(models, pg=8):
    """The fused tail-join scenario at pages of ``pg`` slots."""
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = models
    jeng, teng = _engines(models, attn_impl="fused", page_tokens=pg,
                          pool_tokens=64 * pg)
    ueng = StaticEngine(tm, tp, eos_id=1, len_bucket=8, kv_layout="paged",
                        page_tokens=pg, kv_pool_tokens=64 * pg,
                        device="cpu")
    src, tail, fresh = prompts(tm.cfg.vocab_size, [2 * pg + 5, 7, 11],
                               seed=9)
    first, _ = _serve_both(jeng, teng, [src], 8, [1], forced_gen_lens=[24])
    ueng.serve_batch_paged([src], 8, [1], forced_gen_lens=[24])
    joiner = np.concatenate([src[:2 * pg], tail])
    batch = [src, joiner, fresh]
    kw = dict(forced_gen_lens=[16, 12, 12],
              already_generated=[first.results[0]["tokens"], [], []])
    want, got = _serve_both(jeng, teng, batch, 8, [1, 2, 3], **kw)
    _assert_same_result(ueng.serve_batch_paged(batch, 8, [1, 2, 3], **kw),
                        got, batch)
    assert got.reprefill_tokens == 0
    assert got.prefix_hit_tokens == 2 * pg and got.shared_blocks == 2
    _release_all(jeng, teng, [1, 2, 3])


@pytest.mark.parametrize("pg", PAGE_SIZES)
def test_fused_engine_multi_slice_at_page_size(models, pg):
    """The fused retention scenario at pages of ``pg`` slots, against the
    JAX fused engine and the port's unfused engine."""
    check_fused_multi_slice(models, page_tokens=pg)


@pytest.mark.parametrize("pg", PAGE_SIZES)
def test_fused_engine_prefix_sharing_tail_join_at_page_size(models, pg):
    """The fused tail-join scenario at pages of ``pg`` slots."""
    check_fused_tail_join(models, pg)
