"""The encoder-decoder family (seamless-m4t-large-v2) in the port against
the JAX package on shared weights, at its reduced float32 size (2 + 2
layers, d 128, MHA 4/4, head_dim 32), inputs from numpy seeds:

* the encoder's output on the valid frames and the cross-KV at
  ``BLOCK_TOL`` 1e-5;
* ``prefill`` and 4 ``decode_step``s, and ``forward``, at ``LOGIT_TOL``
  1e-4, with a left-padded decoder row and a source whose last frames are
  invalid;
* ``StaticEngine.serve_batch`` with ``extra_inputs`` over three slices
  with ``already_generated``: token streams equal to JAX's (but for
  recorded near-ties) and ``reprefill_tokens`` equal;
* ``kv_bytes_per_token`` and the weight carry-over, with the norm gains
  drawn apart (``torch_port._perturb_norms``: JAX's are all zero);
* ``flash_prefill``'s plain version with ``prefix_len = S`` (the
  encoder's bidirectional attention) against JAX's ``gqa_attend`` under
  the encoder's mask, and B6's plain version as cross-attention.

The encoder's invalid frames: there the port's served encoder (B5's
``prefix_len`` over masking positions ``where(src_valid, arange, -1)``)
lets a row attend its own frame only, while JAX's mask leaves it fully
masked (a uniform softmax).  No reader sees those rows (cross-attention
masks them by ``src_valid``), so the encoder's output is compared on the
valid frames only and the decoder's logits in full.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import encdec as jencdec
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as tattn
from repro_torch.models import encdec as tencdec
from repro_torch.testing import stream_tie
from test_torch_models import BLOCK_TOL, LOGIT_TOL, _left_pad, _np
from torch_port import (check_config_fields, prompts, serve_slices,
                        shared_models)

ARCH = "seamless-m4t-large-v2"

#: near-ties met by the engine streams: (prompt length, gap)
near_ties = []


@pytest.fixture(scope="module")
def models():
    return shared_models(ARCH)


def _source(d_model, lens, S, seed):
    """(src_embeds (B,S,d) float32, src_valid (B,S) bool): row b's first
    ``lens[b]`` frames valid, the rest invalid (right-padded)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((len(lens), S, d_model)).astype(np.float32)
    valid = np.arange(S)[None] < np.asarray(lens)[:, None]
    return src, valid


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


# ---------------------------------------------------------------------------
# config, weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax_field_for_field(reduced):
    check_config_fields(ARCH, reduced)


def test_params_from_jax_carries_every_leaf_with_drawn_norms(models):
    """Every leaf lands in the port's module (as many values), the
    stacked encoder and decoder blocks at their index, and the norm gains
    drawn apart, so a swapped ``ln_self``/``ln_cross`` would show."""
    jm, jp, tm, tp = models
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert sum(np.asarray(x).size for _, x in flat) == \
        sum(p.numel() for p in tp.parameters())
    dec, enc = jp["dec_layers"], jp["enc_layers"]
    np.testing.assert_array_equal(_np(tp.dec_layers[1].cross_attn.wk.w),
                                  np.asarray(dec["cross_attn"]["wk"]["w"][1]))
    np.testing.assert_array_equal(_np(tp.enc_layers[1].attn.wq.w),
                                  np.asarray(enc["attn"]["wq"]["w"][1]))
    for name in ("ln_self", "ln_cross", "ln_mlp"):
        np.testing.assert_array_equal(_np(getattr(tp.dec_layers[1], name)),
                                      np.asarray(dec[name][1]))
    np.testing.assert_array_equal(_np(tp.ln_enc), np.asarray(jp["ln_enc"]))
    gains = [_np(tp.dec_layers[0].ln_self), _np(tp.dec_layers[0].ln_cross),
             _np(tp.ln_enc), _np(tp.ln_f)]
    assert min(np.abs(a - b).max() for i, a in enumerate(gains)
               for b in gains[i + 1:]) > 0.1


def test_kv_bytes_per_token_matches_jax():
    """The decoder's self-attention cache only, full size and reduced."""
    from repro.configs import get_config as jax_config
    from repro.models.registry import get_model as jax_model
    from repro_torch.configs import get_config
    from repro_torch.models.registry import get_model
    for reduced in (False, True):
        jm = jax_model(jax_config(ARCH, reduced))
        tm = get_model(get_config(ARCH, reduced))
        for shards in (1, 4, 32):
            assert tm.kv_bytes_per_token(shards) == \
                jm.kv_bytes_per_token(shards)
    assert get_model(get_config(ARCH)).kv_bytes_per_token() == 96 * 1024


# ---------------------------------------------------------------------------
# encoder, cross-KV, prefill + decode, forward
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("S, lens", [(24, (24, 17)), (2048, (2048, 1990))])
def test_encoder_matches_jax_on_valid_frames(models, S, lens):
    """The served encoder (B5's plain version with ``prefix_len = S``; at
    2048 frames the CPU's chunked path with the same prefix term) against
    JAX's ``encode`` (its own mask, and its chunked path at 2048), on the
    valid frames, at ``BLOCK_TOL``."""
    jm, jp, tm, tp = models
    src, valid = _source(tm.cfg.d_model, lens, S, seed=1)
    want = np.asarray(jencdec.encode(jp, jm.cfg, jnp.asarray(src),
                                     jnp.asarray(valid)))
    got = _np(tencdec.encode(tp, tm.cfg, *_t(src, valid)))
    np.testing.assert_allclose(got[valid], want[valid], atol=BLOCK_TOL)


def _prefill_pair(models, steps=4, cache_extra=4):
    """Prefill of two decoder rows (one left-padded) over sources of 20
    and 14 valid frames (of 20), then ``steps`` greedy decode steps on
    both sides; yields (label, port logits, JAX logits, port cache, JAX
    cache) after each."""
    jm, jp, tm, tp = models
    toks, lens = _left_pad(tm.cfg.vocab_size, [9, 5], 9, seed=4)
    src, valid = _source(tm.cfg.d_model, (20, 14), 20, seed=2)
    W = toks.shape[1] + cache_extra
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens),
                             "src_embeds": jnp.asarray(src),
                             "src_valid": jnp.asarray(valid)}, W)
    tt, tl_, ts, tv = _t(toks, lens, src, valid)
    tl, tc = tm.prefill(tp, {"tokens": tt, "lengths": tl_,
                             "src_embeds": ts, "src_valid": tv}, W)
    yield "prefill", tl, jl, tc, jc
    cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    for step in range(steps):
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(cur),
                                jnp.asarray(step, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(cur), step)
        yield f"decode {step}", tl, jl, tc, jc
        cur = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)


def test_cross_kv_matches_jax(models):
    """The prefill's cross-KV, every layer, at ``BLOCK_TOL`` (JAX's
    ``EncDecCache.cross_k``/``cross_v``, (L, B, S, Hkv, D)); the cross
    slots of invalid frames differ only where the encoder's invalid rows
    do, and are compared on the valid frames."""
    _, _, _, tc, jc = next(_prefill_pair(models))
    valid = np.asarray(jc.src_valid)
    assert tuple(tc.cross_k.shape) == tuple(jc.cross_k.shape)
    for got, want in ((tc.cross_k, jc.cross_k), (tc.cross_v, jc.cross_v)):
        np.testing.assert_allclose(_np(got)[:, valid],
                                   np.asarray(want)[:, valid],
                                   atol=BLOCK_TOL)
    np.testing.assert_array_equal(_np(tc.src_valid), valid)


def test_prefill_and_decode_match_jax(models):
    """Prefill, then 4 decode steps (B6 for self- and cross-attention):
    logits at ``LOGIT_TOL``, with a left-padded row and invalid frames."""
    for label, tl, jl, _, _ in _prefill_pair(models):
        np.testing.assert_allclose(_np(tl), np.asarray(jl), atol=LOGIT_TOL,
                                   err_msg=label)


def test_decode_runs_b6_for_self_and_cross_attention(models):
    """On the CPU each decode step takes B6's plain version twice a
    layer (self-attention, then cross-attention over the frames) and
    each prefill B5's once a layer of the encoder and of the decoder."""
    jm, jp, tm, tp = models
    ops.reset_counts()
    for label, *_ in _prefill_pair(models, steps=2):
        pass
    L_enc, L_dec = tm.cfg.n_enc_layers, tm.cfg.n_dec_layers
    assert ops.plain_calls["flash_prefill"] == L_enc + L_dec
    assert ops.plain_calls["decode_attention"] == 2 * 2 * L_dec


def test_forward_matches_jax(models):
    """The plain ``forward`` (no kernel, no cache) at ``LOGIT_TOL``."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(6)
    toks = rng.integers(2, tm.cfg.vocab_size, size=(2, 11)).astype(np.int32)
    src, valid = _source(tm.cfg.d_model, (16, 9), 16, seed=3)
    want = jencdec.forward(jp, jm.cfg, jnp.asarray(src), jnp.asarray(toks),
                           jnp.asarray(valid))
    got = tencdec.forward(tp, tm.cfg, *_t(src, toks, valid))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# the engine: slices with extra_inputs
# ---------------------------------------------------------------------------
def _jax_logits(models, src, valid):
    """``stream_tie``'s reference for one request: the JAX prefill of a
    decoder context over its source."""
    jm, jp, _, _ = models

    def logits_of(ctx):
        logits, _ = jm.prefill(jp, {
            "tokens": ctx[None], "lengths": np.array([len(ctx)], np.int32),
            "src_embeds": src[None], "src_valid": valid[None]}, len(ctx) + 1)
        return np.asarray(logits[0])
    return logits_of


def test_serve_batch_with_extra_inputs_matches_jax_over_slices(models):
    """Three requests (a batch of 3 bucketed to 4: the pad row repeats the
    last source) over three slices of 4, with ``already_generated``: each
    request's stream equals JAX's but for recorded near-ties, and every
    slice's ``reprefill_tokens`` (decoder tokens only; the encoder re-runs
    whole) equals JAX's."""
    jm, jp, tm, tp = models
    ps = prompts(tm.cfg.vocab_size, [6, 3, 9], seed=12)
    src, valid = _source(tm.cfg.d_model, (20, 13, 7), 20, seed=13)
    forced = [10, 3, 7]
    outs, reprefill = serve_slices(models, ps,
                                   {"src_embeds": src, "src_valid": valid},
                                   forced)
    assert reprefill["torch"] == reprefill["jax"]
    assert reprefill["torch"][1] > 0
    for i, p in enumerate(ps):
        assert len(outs["jax"][i]) == forced[i]
        gap = stream_tie(_jax_logits(models, src[i], valid[i]), p,
                         outs["jax"][i], outs["torch"][i])
        if gap is not None:
            near_ties.append((len(p), gap))


def test_engine_takes_extra_inputs_of_the_bucketed_batch(models):
    """``extra_inputs`` of the bucketed ``B`` rows are taken as they are:
    a batch of 3 with 4 source rows (the 4th a pad row's) gives the same
    tokens as with 3 rows, whose pad row repeats the last."""
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = models
    ps = prompts(tm.cfg.vocab_size, [6, 3, 9], seed=12)
    src, valid = _source(tm.cfg.d_model, (20, 13, 7, 7), 20, seed=13)
    src[3] = src[2]
    res = [StaticEngine(tm, tp, len_bucket=8, device="cpu",
                        extra_inputs={"src_embeds": src[:n],
                                      "src_valid": valid[:n]}
                        ).serve_batch(ps, 4, forced_gen_lens=[4, 4, 4])
           for n in (3, 4)]
    assert [r["tokens"] for r in res[0].results] == \
        [r["tokens"] for r in res[1].results]


# ---------------------------------------------------------------------------
# the kernels' plain versions on the encoder's and cross-attention's masks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype, tol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_flash_prefill_plain_as_encoder_matches_jax(dtype, tol):
    """B5's plain version with masking positions ``where(valid, arange,
    -1)`` and ``prefix_len = S`` against JAX's ``gqa_attend`` under the
    encoder's mask ``valid_q & valid_k``, on the valid rows (two rows, one
    with its last 9 of 40 frames invalid; 4 query heads over 2 KV
    heads)."""
    rng = np.random.default_rng(21)
    B, S, Hq, Hkv, D = 2, 40, 4, 2, 32
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    q, k, v = (rng.standard_normal((B, S, h, D)).astype(np_dt)
               for h in (Hq, Hkv, Hkv))
    valid = np.arange(S)[None] < np.array([[S], [S - 9]])
    pos = np.where(valid, np.arange(S)[None], -1).astype(np.int32)
    mask = (valid[:, None, :] & valid[:, :, None])[:, None]
    want = np.asarray(jattn.gqa_attend(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(mask),
                                       D ** -0.5)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(
        getattr(torch, dtype)) for x in (q, k, v))
    got = ref.flash_prefill_ref(tq, tk, tv, torch.from_numpy(pos),
                                prefix_len=S).float().numpy()
    np.testing.assert_allclose(got[valid], want[valid], atol=tol)
    # without the prefix term the encoder would be causal: far apart
    causal = ref.flash_prefill_ref(tq, tk, tv,
                                   torch.from_numpy(pos)).float().numpy()
    assert np.abs(causal[valid] - want[valid]).max() > 10 * tol


@pytest.mark.parametrize("dtype, tol", [("float32", 2e-5),
                                        ("bfloat16", 2e-2)])
def test_decode_attention_plain_as_cross_attention_matches_jax(dtype, tol):
    """``attention.cross_decode_attend`` (B6's plain version on the CPU,
    slot_pos 0 on valid frames and -1 on invalid ones, q_pos 0) against
    JAX's cross-attention ``gqa_attend`` under ``src_valid[:, None, None,
    :]``, a row without a valid frame included (uniform over every
    frame, as JAX's)."""
    rng = np.random.default_rng(22)
    B, S, H, D = 3, 33, 4, 32
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    q = rng.standard_normal((B, 1, H, D)).astype(np_dt)
    k, v = (rng.standard_normal((B, S, H, D)).astype(np_dt)
            for _ in range(2))
    valid = np.arange(S)[None] < np.array([[S], [12], [0]])
    mask = np.broadcast_to(valid[:, None, None, :], (B, 1, 1, S))
    want = np.asarray(jattn.gqa_attend(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), jnp.asarray(mask),
                                       D ** -0.5)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(
        getattr(torch, dtype)) for x in (q, k, v))
    ops.reset_counts()
    got = tattn.cross_decode_attend(
        tq, tk, tv, tattn.cross_slot_pos(torch.from_numpy(valid)))
    assert ops.plain_calls["decode_attention"] == 1
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
