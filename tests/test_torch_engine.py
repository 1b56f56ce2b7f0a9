"""The port's persistent paged engine (``repro_torch.engine.static_engine``)
against the JAX ``StaticEngine(kv_layout="paged")`` on shared weights, in
the scenarios of ``tests/test_retain.py``: multi-slice retention with zero
re-prefill, EOS-driven rows, evict-on-pressure falling back to re-prefill,
and a prefix-sharing tail join.  Tokens, ``n_valid``, ``finished``,
``steps``, re-prefill and prefix-hit counts must agree, and the allocator
must return to its baseline."""
import numpy as np
import pytest

from torch_port import assert_same_stream, prompts, shared_models


@pytest.fixture(scope="module")
def models():
    return shared_models()


def _engines(models, pool_tokens=512, page_tokens=8, eos_id=1):
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = models
    kw = dict(eos_id=eos_id, len_bucket=8, kv_layout="paged",
              page_tokens=page_tokens, kv_pool_tokens=pool_tokens)
    return JaxEngine(jm, jp, **kw), StaticEngine(tm, tp, device="cpu", **kw)


def _assert_same_result(want, got, prompts_in):
    assert got.steps == want.steps
    assert got.reprefill_tokens == want.reprefill_tokens
    assert got.prefix_hit_tokens == want.prefix_hit_tokens
    assert got.shared_blocks == want.shared_blocks
    assert got.batch_input_len == want.batch_input_len
    assert got.early_return == want.early_return
    for p, a, b in zip(prompts_in, want.results, got.results):
        assert_same_stream(p, a["tokens"], b["tokens"])
        for key in ("n_valid", "finished", "invalid", "pad"):
            assert b[key] == a[key], key


def _serve_both(jeng, teng, batch, slice_len, rids, **kw):
    want = jeng.serve_batch_paged(batch, slice_len, rids, **kw)
    got = teng.serve_batch_paged(batch, slice_len, rids, **kw)
    _assert_same_result(want, got, batch)
    return want, got


def _release_all(jeng, teng, rids):
    for rid in rids:
        assert teng.release_request(rid) == jeng.release_request(rid)
    assert teng.allocator.free_blocks == teng.allocator.n_pages
    assert jeng.allocator.free_blocks == jeng.allocator.n_pages


def test_multi_slice_retention_zero_reprefill(models):
    """>= 3 slices with retained pages: every resumed slice remaps its
    pages (no re-prefill) and the streams match the JAX engine's."""
    jm, jp, tm, tp = models
    jeng, teng = _engines(models)
    ps = prompts(tm.cfg.vocab_size, [7, 12, 4], seed=0)
    totals = [20, 9, 16]
    outs = [[] for _ in ps]
    n_slices = reprefill = 0
    while any(len(o) < t for o, t in zip(outs, totals)):
        idx = [i for i in range(len(ps)) if len(outs[i]) < totals[i]]
        want, got = _serve_both(
            jeng, teng, [ps[i] for i in idx], 8, [100 + i for i in idx],
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
    stage-A prefill and a resumed resident."""
    jm, jp, tm, tp = models
    jeng, teng = _engines(models)
    src, tail, fresh = prompts(tm.cfg.vocab_size, [21, 7, 11], seed=9)
    first, _ = _serve_both(jeng, teng, [src], 8, [1], forced_gen_lens=[24])
    joiner = np.concatenate([src[:16], tail])
    want, got = _serve_both(jeng, teng, [src, joiner, fresh], 8, [1, 2, 3],
                            forced_gen_lens=[16, 12, 12],
                            already_generated=[first.results[0]["tokens"],
                                               [], []])
    assert got.reprefill_tokens == 0
    assert got.prefix_hit_tokens == 16 and got.shared_blocks == 2
    assert teng.allocator.shared_blocks == jeng.allocator.shared_blocks > 0
    _release_all(jeng, teng, [1, 2, 3])
