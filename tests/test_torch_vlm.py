"""The prefix-LM VLM family (paligemma-3b) in the port against the JAX
package on shared weights, at its reduced float32 size (2 layers, d 128,
MQA 4/1, head_dim 32, GeGLU, scaled text embeddings, a prefix of 16
patch embeddings), inputs from numpy seeds:

* ``flash_prefill``'s plain version with ``prefix_len`` against JAX's
  ``gqa_attend`` under ``_mask_with_prefix`` (prefix, then pads, then
  text, as the prefill lays them out; with and without a window, which
  the prefix overrides), float32 at 2e-5 and bfloat16 at 2e-2, and the
  port's chunked CPU path with ``prefix_len`` against JAX's at T = 2048
  on one narrow head;
* ``prefill`` and 4 ``decode_step``s at ``LOGIT_TOL`` 1e-4 with a
  left-padded row, and ``forward`` with the prefix;
* ``StaticEngine.serve_batch`` with ``extra_inputs`` over three slices
  with ``already_generated`` (the cache is ``L + P + S`` wide): streams
  equal to JAX's but for recorded near-ties, ``reprefill_tokens`` equal;
* ``kv_bytes_per_token``, and the paged engine refusing ``extra_inputs``.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import transformer as jtfm
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttfm
from repro_torch.testing import stream_tie
from test_torch_models import LOGIT_TOL, _left_pad, _np
from torch_port import (check_config_fields, prompts, serve_slices,
                        shared_models)

ARCH = "paligemma-3b"

#: near-ties met by the engine streams: (prompt length, gap)
near_ties = []


@pytest.fixture(scope="module")
def models():
    return shared_models(ARCH)


def _prefix(d_model, B, P, seed):
    """(B, P, d) float32 patch embeddings from a seed."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, P, d_model)).astype(np.float32)


def _prefix_positions(lens, T, P):
    """The prefill's positions: the prefix at 0..P-1, then the
    left-padded text at its positions + P (pads -1)."""
    text = np.full((len(lens), T), -1, np.int32)
    for b, n in enumerate(lens):
        text[b, T - n:] = P + np.arange(n)
    prefix = np.broadcast_to(np.arange(P, dtype=np.int32), (len(lens), P))
    return np.concatenate([prefix, text], axis=1)


# ---------------------------------------------------------------------------
# config, cache size
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax_field_for_field(reduced):
    check_config_fields(ARCH, reduced)


def test_kv_bytes_per_token_matches_jax():
    """The dense model's count (the prefix's KV is counted per token like
    the text's), full size and reduced."""
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    for reduced in (False, True):
        jm = jax_model(jax_config(ARCH, reduced))
        tm = get_model(get_config(ARCH, reduced))
        for shards in (1, 4):
            assert tm.kv_bytes_per_token(shards) == \
                jm.kv_bytes_per_token(shards)
    assert get_model(get_config(ARCH)).kv_bytes_per_token() == 18 * 1024


def test_paged_engine_refuses_extra_inputs(models):
    """The persistent paged layout serves the dense family only and takes
    no frontend inputs, as in JAX: a dense model with ``extra_inputs`` is
    refused, and so is the VLM."""
    from repro_torch.engine.static_engine import StaticEngine
    _, _, tm, tp = models
    _, _, dm, dp = shared_models()
    kw = dict(kv_layout="paged", kv_pool_tokens=64, page_tokens=8,
              device="cpu")
    with pytest.raises(ValueError, match="extra_inputs"):
        StaticEngine(dm, dp, extra_inputs={
            "prefix_embeds": _prefix(dm.cfg.d_model, 1, 4, 0)}, **kw)
    with pytest.raises(ValueError, match="dense family only"):
        StaticEngine(tm, tp, **kw)


# ---------------------------------------------------------------------------
# the kernels' plain versions with a bidirectional prefix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("dtype, tol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_flash_prefill_plain_with_prefix_matches_jax(dtype, tol, window):
    """B5's plain version with ``prefix_len = P`` on the prefill's layout
    (a prefix of 12, then a left-padded text row and a full one) against
    JAX's ``gqa_attend`` under ``_mask_with_prefix``; without the prefix
    term the two are far apart."""
    rng = np.random.default_rng(31)
    P, T, Hq, Hkv, D = 12, 20, 4, 1, 32
    pos = _prefix_positions([20, 13], T, P)
    B, N = pos.shape
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    q, k, v = (rng.standard_normal((B, N, h, D)).astype(np_dt)
               for h in (Hq, Hkv, Hkv))
    mask = jtfm._mask_with_prefix(jnp.asarray(pos), window, P)
    want = np.asarray(jattn.gqa_attend(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), mask, D ** -0.5)
                      ).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(
        getattr(torch, dtype)) for x in (q, k, v))
    tpos = torch.from_numpy(pos)
    got = ref.flash_prefill_ref(tq, tk, tv, tpos, window=window,
                                prefix_len=P).float().numpy()
    live = pos >= 0  # pad rows: JAX's diagonal rule, the same here
    np.testing.assert_allclose(got[live], want[live], atol=tol)
    causal = ref.flash_prefill_ref(tq, tk, tv, tpos,
                                   window=window).float().numpy()
    assert np.abs(causal[live] - want[live]).max() > 10 * tol
    # the ops dispatch hands the prefix over on the CPU
    ops.reset_counts()
    out = ops.flash_prefill(tq, tk, tv, tpos, window=window, prefix_len=P)
    assert ops.plain_calls["flash_prefill"] == 1
    np.testing.assert_array_equal(out.float().numpy(), got)


def test_chunked_prefill_with_prefix_matches_jax_at_2048():
    """The CPU's q-blocked path (``gqa_attend_chunked``, what
    ``prefill_attend`` takes from ``CHUNK_THRESHOLD`` tokens) with
    ``prefix_len`` against JAX's at T = 2048 on one narrow head: a prefix
    of 256 and a left-padded text row."""
    rng = np.random.default_rng(32)
    P, T, D = 256, 2048 - 256, 8
    pos = _prefix_positions([T - 100], T, P)
    q, k, v = (rng.standard_normal((1, P + T, 1, D)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jattn.gqa_attend_chunked(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), D ** -0.5,
        jnp.asarray(pos), jnp.asarray(pos), None, P))
    got = tattn.gqa_attend_chunked(*(torch.from_numpy(x) for x in (q, k, v)),
                                   D ** -0.5, torch.from_numpy(pos), None, P)
    np.testing.assert_allclose(_np(got), want, atol=2e-5)
    causal = tattn.gqa_attend_chunked(
        *(torch.from_numpy(x) for x in (q, k, v)), D ** -0.5,
        torch.from_numpy(pos), None)
    assert np.abs(_np(causal) - want).max() > 1e-2


# ---------------------------------------------------------------------------
# prefill + decode, forward
# ---------------------------------------------------------------------------
def test_prefill_and_decode_match_jax(models):
    """Prefill of the prefix and two text rows (one left-padded), then 4
    decode steps: logits at ``LOGIT_TOL``; the cache holds the prefix
    (lengths + P) and B5 ran with the prefix once a layer."""
    jm, jp, tm, tp = models
    P = tm.cfg.n_prefix_tokens
    toks, lens = _left_pad(tm.cfg.vocab_size, [9, 5], 9, seed=4)
    pre = _prefix(tm.cfg.d_model, 2, P, seed=5)
    W = toks.shape[1] + P + 4
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens),
                             "prefix_embeds": jnp.asarray(pre)}, W)
    ops.reset_counts()
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "lengths": torch.from_numpy(lens),
                             "prefix_embeds": torch.from_numpy(pre)}, W)
    assert ops.plain_calls["flash_prefill"] == tm.cfg.n_layers
    np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL)
    np.testing.assert_array_equal(_np(tc.lengths), lens + P)
    np.testing.assert_array_equal(_np(tc.slot_pos), np.asarray(jc.slot_pos))
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(4):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur),
                                jnp.asarray(step, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur), step)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL,
                                   err_msg=f"decode {step}")
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_forward_with_prefix_matches_jax(models):
    """The plain ``forward`` with ``prefix_embeds`` (logits over P + T
    tokens; the prefix unscaled, the text scaled by sqrt(d)) at
    ``LOGIT_TOL``."""
    jm, jp, tm, tp = models
    P = tm.cfg.n_prefix_tokens
    rng = np.random.default_rng(6)
    toks = rng.integers(2, tm.cfg.vocab_size, size=(2, 11)).astype(np.int32)
    pre = _prefix(tm.cfg.d_model, 2, P, seed=7)
    want = jtfm.forward(jp, jm.cfg, jnp.asarray(toks),
                        prefix_embeds=jnp.asarray(pre))
    got = ttfm.forward(tp, tm.cfg, torch.from_numpy(toks),
                       prefix_embeds=torch.from_numpy(pre))
    assert tuple(got.shape) == (2, P + 11, tm.cfg.vocab_size)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# the engine: slices with extra_inputs
# ---------------------------------------------------------------------------
def test_serve_batch_with_extra_inputs_matches_jax_over_slices(models):
    """Three requests (bucketed to 4 rows, the pad row repeating the last
    image) over three slices of 4 with ``already_generated``, the cache
    ``L + P + S`` wide: each request's stream equals JAX's but for
    recorded near-ties, and every slice's ``reprefill_tokens`` (text
    tokens: prompt + generated) equals JAX's."""
    jm, jp, tm, tp = models
    P = tm.cfg.n_prefix_tokens
    ps = prompts(tm.cfg.vocab_size, [6, 3, 9], seed=14)
    pre = _prefix(tm.cfg.d_model, 3, P, seed=15)
    forced = [10, 3, 7]
    outs, reprefill = serve_slices(models, ps, {"prefix_embeds": pre},
                                   forced)
    assert reprefill["torch"] == reprefill["jax"]
    assert reprefill["torch"][1] > 0
    for i, p in enumerate(ps):
        assert len(outs["jax"][i]) == forced[i]

        def jax_logits(ctx, i=i):
            logits, _ = jm.prefill(jp, {
                "tokens": ctx[None],
                "lengths": np.array([len(ctx)], np.int32),
                "prefix_embeds": pre[i:i + 1]}, len(ctx) + P + 1)
            return np.asarray(logits[0])

        gap = stream_tie(jax_logits, p, outs["jax"][i], outs["torch"][i])
        if gap is not None:
            near_ties.append((len(p), gap))
