"""The port's model code (``repro_torch.models``) against the JAX package
on shared weights: the building blocks at 1e-5, the paged serving
functions' logits at 1e-4 (reduced float32 llama3.2-1b), plus the weight
carry-over and the device rules of the entry points."""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kvcache.paged import PagedKVCache as JaxPagedKVCache
from repro.models import common as jcommon
from repro.models import transformer as jtfm
from repro_torch.kvcache import PagedKVCache, init_page_pools
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttfm
from repro_torch.weights import params_from_jax
from torch_port import prompts, shared_models

BLOCK_TOL = 1e-5
LOGIT_TOL = 1e-4


@pytest.fixture(scope="module")
def models():
    return shared_models()


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------
def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    got = tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=BLOCK_TOL)


@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 7)).astype(np.int32)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=BLOCK_TOL)


def test_mlp_matches_jax(models):
    jm, jp, tm, tp = models
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, tm.cfg.d_model)).astype(np.float32)
    layer = jax.tree.map(lambda a: a[0], jp["layers"])
    want = jcommon.mlp_apply(layer["mlp"], jnp.asarray(x), jm.cfg.act)
    got = tp.layers[0].mlp(torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=BLOCK_TOL)


def test_params_from_jax_carries_every_leaf(models):
    jm, jp, tm, tp = models
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    n_jax = sum(np.asarray(leaf).size for _, leaf in flat)
    assert n_jax == sum(p.numel() for p in tp.parameters())
    np.testing.assert_array_equal(_np(tp.layers[1].attn.wk.w),
                                  np.asarray(jp["layers"]["attn"]["wk"]["w"][1]))
    np.testing.assert_array_equal(_np(tp.embed.table),
                                  np.asarray(jp["embed"]["table"]))


def test_params_from_jax_keeps_bfloat16_bits():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((2, 4, 8)).astype(ml_dtypes.bfloat16)
    sd = params_from_jax({"layers": {"attn": {"wq": {"w": w}}},
                          "ln_f": np.zeros(4, ml_dtypes.bfloat16)})
    t = sd["layers.1.attn.wq.w"]
    assert t.dtype == torch.bfloat16 and t.shape == (4, 8)
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  w[1].view(np.int16))


# ---------------------------------------------------------------------------
# dense path (engine profiling) and the paged serving functions
# ---------------------------------------------------------------------------
def _left_pad(vocab, lens, T, seed):
    toks = np.zeros((len(lens), T), np.int32)
    for b, p in enumerate(prompts(vocab, lens, seed)):
        toks[b, T - len(p):] = p
    return toks, np.asarray(lens, np.int32)


def test_dense_prefill_and_decode_match_jax(models):
    jm, jp, tm, tp = models
    toks, lens = _left_pad(tm.cfg.vocab_size, [12, 7], 12, seed=4)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens)}, 16)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "lengths": torch.from_numpy(lens)}, 16)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(3):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur),
                                jnp.asarray(step, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur), step)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def _paged_pair(cfg, bt, pg, n_pages):
    """Empty page pools on both sides for block table ``bt``."""
    B, nb = bt.shape
    kp, vp = init_page_pools(cfg.n_layers, n_pages, pg, cfg.n_kv_heads,
                             cfg.head_dim, cfg.dtype, torch.device("cpu"))
    tcache = PagedKVCache(kp, vp, torch.from_numpy(bt),
                          torch.full((B, nb * pg), -1, dtype=torch.int32),
                          torch.zeros(B, dtype=torch.int32))
    jcache = JaxPagedKVCache(jnp.asarray(_np(kp)), jnp.asarray(_np(vp)),
                             jnp.asarray(bt),
                             jnp.full((B, nb * pg), -1, jnp.int32),
                             jnp.zeros((B,), jnp.int32))
    return jcache, tcache


def _assert_pages_match(jcache, tcache):
    # page 0 is the null page: the JAX oracle parks pad tokens there, the
    # port skips them; no reader ever sees it unmasked
    np.testing.assert_allclose(_np(tcache.k_pages)[:, 1:],
                               np.asarray(jcache.k_pages)[:, 1:],
                               atol=BLOCK_TOL)
    np.testing.assert_allclose(_np(tcache.v_pages)[:, 1:],
                               np.asarray(jcache.v_pages)[:, 1:],
                               atol=BLOCK_TOL)


def test_paged_prefill_and_decode_logits_match_jax(models):
    jm, jp, tm, tp = models
    cfg, jcfg, pg = tm.cfg, jm.cfg, 8
    toks, lens = _left_pad(cfg.vocab_size, [16, 9, 13], 16, seed=5)
    nb = 4
    bt = (np.random.default_rng(5).permutation(3 * nb) + 1) \
        .reshape(3, nb).astype(np.int32)
    jcache, tcache = _paged_pair(cfg, bt, pg, 3 * nb)
    jl, jcache = jtfm.prefill_paged(jp, jcfg, jnp.asarray(toks),
                                    jnp.asarray(lens), jcache)
    with torch.no_grad():
        tl, tcache = ttfm.prefill_paged(tp, cfg, torch.from_numpy(toks),
                                        torch.from_numpy(lens), tcache)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(_np(tcache.slot_pos),
                                  np.asarray(jcache.slot_pos))
    _assert_pages_match(jcache, tcache)
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(4):
        q_pos = (lens + step).astype(np.int32)
        jl, jcache = jtfm.decode_step_paged(jp, jcfg, jcache,
                                            jnp.asarray(cur),
                                            jnp.asarray(q_pos),
                                            jnp.asarray(q_pos))
        with torch.no_grad():
            tl, tcache = ttfm.decode_step_paged(tp, cfg, tcache,
                                                torch.from_numpy(cur),
                                                torch.from_numpy(q_pos),
                                                torch.from_numpy(q_pos))
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    _assert_pages_match(jcache, tcache)


def test_paged_tail_prefill_logits_match_jax(models):
    """A row joins another's first two pages (16 shared tokens) and
    prefills only its tail: logits agree, and the shared pages are read,
    never written."""
    jm, jp, tm, tp = models
    cfg, jcfg, pg = tm.cfg, jm.cfg, 8
    src = prompts(cfg.vocab_size, [21], seed=6)[0]
    tail = prompts(cfg.vocab_size, [7], seed=7)[0]
    joiner = np.concatenate([src[:16], tail])
    # row 0 owns pages 1-3; row 1 shares pages 1-2 and owns 4-5
    bt = np.array([[1, 2, 3, 0], [1, 2, 4, 5]], np.int32)
    jcache, tcache = _paged_pair(cfg, bt, pg, 5)
    toks = np.zeros((2, 24), np.int32)
    toks[0, 3:] = src
    toks[1, 24 - 16:] = joiner[:16]
    lens = np.array([21, 16], np.int32)   # row 1 stands in for the donor
    jl, jcache = jtfm.prefill_paged(jp, jcfg, jnp.asarray(toks),
                                    jnp.asarray(lens), jcache)
    with torch.no_grad():
        tl, tcache = ttfm.prefill_paged(tp, cfg, torch.from_numpy(toks),
                                        torch.from_numpy(lens), tcache)
    shared = _np(tcache.k_pages)[:, 1:3].copy()
    t_toks = np.zeros((1, 8), np.int32)
    t_toks[0, 1:] = tail
    start, total = np.array([16], np.int32), np.array([23], np.int32)
    jcache = jcache._replace(block_table=jnp.asarray(bt[1:]),
                             slot_pos=jcache.slot_pos[1:],
                             lengths=jcache.lengths[1:])
    tcache = tcache._replace(block_table=torch.from_numpy(bt[1:]),
                             slot_pos=tcache.slot_pos[1:],
                             lengths=tcache.lengths[1:])
    jl, jcache = jtfm.prefill_tail_paged(jp, jcfg, jnp.asarray(t_toks),
                                         jnp.asarray(start),
                                         jnp.asarray(total), jcache)
    with torch.no_grad():
        tl, tcache = ttfm.prefill_tail_paged(tp, cfg,
                                             torch.from_numpy(t_toks),
                                             torch.from_numpy(start),
                                             torch.from_numpy(total), tcache)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(_np(tcache.k_pages)[:, 1:3], shared)
    _assert_pages_match(jcache, tcache)


def test_large_prefill_blocks_queries_without_changing_the_maths(monkeypatch):
    """Prefill attention splits its queries into blocks when the scores
    would pass the memory budget; the result is the unblocked one."""
    from repro_torch.models import attention as tattn
    rng = np.random.default_rng(8)
    q = torch.from_numpy(rng.standard_normal((2, 16, 4, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 16, 2, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 16, 2, 8)).astype(np.float32))
    pos = ttfm.make_positions(torch.zeros(2, 16, dtype=torch.int32),
                              torch.tensor([16, 11]))
    mask = tattn.prefill_mask(pos, None)
    whole = tattn.gqa_attend(q, k, v, mask, 8 ** -0.5)
    monkeypatch.setattr(tattn, "_SCORE_BUDGET", 2 * 4 * 16 * 5)
    blocked = tattn.gqa_attend_blocked(q, k, v, mask, 8 ** -0.5)
    np.testing.assert_allclose(_np(blocked), _np(whole), atol=1e-6)


def test_fused_impl_is_not_ported_yet(models):
    jm, jp, tm, tp = models
    bt = np.array([[1, 2]], np.int32)
    _, tcache = _paged_pair(tm.cfg, bt, 8, 2)
    with pytest.raises(NotImplementedError, match="B3/B4"):
        ttfm.prefill_paged(tp, tm.cfg, torch.ones((1, 4), dtype=torch.int32),
                           torch.tensor([4], dtype=torch.int32), tcache,
                           attn_impl="fused")


# ---------------------------------------------------------------------------
# device rules
# ---------------------------------------------------------------------------
def test_entry_points_default_to_cuda_and_raise_without_it(models,
                                                           monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StaticEngine(tm, tp, kv_layout="paged", kv_pool_tokens=64,
                     page_tokens=8)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_init_is_seeded_by_the_generator(models):
    jm, jp, tm, tp = models
    a = tm.init(3, device="cpu")
    b = tm.init(3, device="cpu")
    c = tm.init(4, device="cpu")
    assert torch.equal(a.layers[1].mlp.down.w, b.layers[1].mlp.down.w)
    assert not torch.equal(a.layers[1].mlp.down.w, c.layers[1].mlp.down.w)
    # the JAX recipe's scales: N(0, 0.02) table, N(0, 1/d_in) dense
    assert abs(float(a.embed.table.std()) - 0.02) < 2e-3
    d_ff = tm.cfg.d_ff
    assert abs(float(a.layers[0].mlp.down.w.std()) - d_ff ** -0.5) < 2e-3
