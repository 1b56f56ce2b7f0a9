"""The attention kernels' domain, on the CPU: every head dim that is a
multiple of 16 from 16 to 256 and every group of query heads a KV head,
as the Pallas kernels take them.

* ``kernels.split.supports`` admits that domain and nothing else;
* the plain versions of B1 (paged decode), B4 (fused RoPE + append +
  paged decode), B5 (flash prefill) and B6 (dense decode) against the JAX
  oracles and the Pallas kernels in interpret mode at head dims 48 and 80
  and groups 3, 12 and 71 (float32 2e-5, bfloat16 2e-2);
* the port's paged (unfused and fused) and dense engines against JAX's on
  the reduced float32 llama3.2-1b with its heads replaced by (12, 1, 48)
  and (8, 8, 80): the same tokens.

The CUDA kernels themselves take these shapes on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 25)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import \
    decode_attention as pallas_dense_decode
from repro.kernels.flash_prefill import flash_prefill as pallas_prefill
from repro.kernels.fused_rope_decode_append import \
    fused_rope_decode_append as pallas_fused_decode
from repro.kernels.paged_decode_attention import \
    paged_decode_attention as pallas_paged_decode
from repro_torch.kernels import ops, split
from test_torch_kernels import (ATOL, THETA, _cast, _dense_decode_np, _f32,
                                _fused_decode_inputs, _paged_inputs, _pair,
                                _pow2_block, _prefill_np)
from torch_port import prompts, shared_models

DIMS = (48, 80)
GROUPS = (3, 12, 71)
DTYPES = ("float32", "bfloat16")


def _kv(G):
    """KV heads of a case: two (one for the prime group 71)."""
    return 1 if G == 71 else 2


# ---------------------------------------------------------------------------
# the domain
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_supports_admits_the_whole_domain(dtype):
    for D in range(16, 257, 16):
        for G in (1, 2, 3, 7, 8, 9, 12, 16, 24, 64, 65, 71, 128, 200):
            assert split.supports(D, G, dtype), (D, G)
    assert split.instance_dim(80) == 96 and split.instance_dim(240) == 256


@pytest.mark.parametrize("D", [8, 72, 272, 0, 264, 250])
def test_supports_refuses_outside_the_domain(D):
    assert not split.supports(D, 1, torch.bfloat16)
    assert not split.supports(64, 0, torch.bfloat16)
    assert not split.supports(64, 1, torch.float16)


@pytest.mark.parametrize("G", [1, 3, 8, 9, 12, 16, 24, 71, 128, 1000])
def test_head_blocks_cover_a_group_without_an_empty_block(G):
    """ceil(G / 8) blocks of ceil(G / blocks) <= 8 heads, the last one
    holding the rest (at least one head), as the kernels cut a group."""
    rep, gb = split.head_blocks(G), split.block_heads(G)
    assert rep == -(-G // 8) and gb <= split.BLOCK_GROUP
    sizes = [min(gb, G - r * gb) for r in range(rep)]
    assert sum(sizes) == G and min(sizes) >= 1


# ---------------------------------------------------------------------------
# the plain versions against the JAX oracles and the Pallas kernels
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", DIMS)
def test_paged_decode_attention_plain_matches_jax(D, G, dtype):
    """B1 over pages of 8, a window of 6, the last row a pad row; the
    Pallas kernel in float32 (its interpret mode takes float32 pools)."""
    Hkv = _kv(G)
    q, kp, vp, bt, sp, qp = _paged_inputs(3, 4, 8, G * Hkv, Hkv, D,
                                          pad_row=True)
    pairs = [_pair(a, dtype) for a in (q, kp, vp)] + \
        [_pair(a, "int32") for a in (bt, sp, qp)]
    got = _f32(ops.paged_decode_attention(*[p[0] for p in pairs], window=6))
    jargs = [p[1] for p in pairs]
    oracle = jref.paged_decode_attention_ref(*jargs, window=6)
    np.testing.assert_allclose(got, _f32(oracle), atol=ATOL[dtype])
    if dtype == "float32":
        pallas = pallas_paged_decode(*jargs, window=6, interpret=True)
        np.testing.assert_allclose(got, _f32(pallas), atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", DIMS)
def test_fused_rope_decode_append_plain_matches_jax(D, G, dtype):
    """B4's output and pools after the append (RoPE pairs of D / 2 = 24
    and 40: no power of two), against the oracle and, in float32, the
    Pallas kernel (page 0, the pad row's, left out as in
    ``test_torch_kernels``)."""
    Hkv = _kv(G)
    arrays = _fused_decode_inputs(3, 3, 8, G * Hkv, Hkv, D, [20, 9, 0])
    floats = {i: _pair(arrays[i], dtype) for i in (0, 1, 2, 7, 8)}
    ints = {i: _pair(arrays[i], "int32") for i in (3, 4, 5, 6)}
    args = [floats[i] if i in floats else ints[i] for i in range(9)]
    tout = ops.fused_rope_decode_append(*[a[0] for a in args], theta=THETA)
    jargs = [a[1] for a in args]
    jout, jk, jv = jref.fused_rope_decode_append_ref(*jargs, theta=THETA)
    tk, tv = args[7][0], args[8][0]
    tol = ATOL[dtype]
    np.testing.assert_allclose(_f32(tout), _f32(jout), atol=tol)
    np.testing.assert_allclose(_f32(tk), _f32(jk), atol=tol)
    np.testing.assert_array_equal(_f32(tv), _f32(jv))
    if dtype != "float32":
        return
    pout, pk, pv = pallas_fused_decode(*jargs, theta=THETA, interpret=True)
    np.testing.assert_allclose(_f32(tout), _f32(pout), atol=tol)
    np.testing.assert_allclose(_f32(tk)[1:], _f32(pk)[1:], atol=tol)
    np.testing.assert_array_equal(_f32(tv)[1:], _f32(pv)[1:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", DIMS)
def test_flash_prefill_plain_matches_jax(D, G, dtype):
    """B5 over left-padded rows (one all pads) with a window of 5: every
    row against the oracle, the valid rows against the Pallas kernel."""
    Hkv, T = _kv(G), 12
    q, k, v, pos = _prefill_np(3, T, G * Hkv, Hkv, D, [12, 5, 0])
    (jq, tq), (jk, tk), (jv, tv) = (_cast(a, dtype) for a in (q, k, v))
    got = _f32(ops.flash_prefill(tq, tk, tv, torch.from_numpy(pos),
                                 window=5))
    jpos = jnp.asarray(pos)
    oracle = jref.flash_prefill_ref(jq, jk, jv, jpos, window=5)
    np.testing.assert_allclose(got, _f32(oracle), atol=ATOL[dtype])
    blk = _pow2_block(T)
    pallas = pallas_prefill(jq, jk, jv, jpos, window=5, block_q=blk,
                            block_k=blk, interpret=True)
    valid = (pos >= 0)[..., None, None]
    np.testing.assert_allclose(got * valid, _f32(pallas) * valid,
                               atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("G", GROUPS)
@pytest.mark.parametrize("D", DIMS)
def test_decode_attention_plain_matches_jax(D, G, dtype):
    """B6 with a window of 6, the last row empty (the mean of its V),
    against the oracle and the Pallas kernel."""
    Hkv = _kv(G)
    q, kc, vc, sp, qp = _dense_decode_np(3, 24, G * Hkv, Hkv, D)
    (jq, tq), (jk, tk), (jv, tv) = (_cast(a, dtype) for a in (q, kc, vc))
    got = _f32(ops.decode_attention(tq, tk, tv, torch.from_numpy(sp),
                                    torch.from_numpy(qp), window=6))
    jsp, jqp = jnp.asarray(sp), jnp.asarray(qp)
    oracle = jref.decode_attention_ref(jq, jk, jv, jsp, jqp, window=6)
    pallas = pallas_dense_decode(jq, jk, jv, jsp, jqp, window=6,
                                 block_w=_pow2_block(24), interpret=True)
    for want in (oracle, pallas):
        np.testing.assert_allclose(got, _f32(want), atol=ATOL[dtype])
    mean_v = np.repeat(tv[-1].float().mean(dim=0).numpy(), G, 0)
    np.testing.assert_allclose(got[-1], mean_v, atol=ATOL[dtype])


# ---------------------------------------------------------------------------
# the engines at heads outside the old instances
# ---------------------------------------------------------------------------
HEADS = ((12, 1, 48), (8, 8, 80))


def _streams(results):
    return [r["tokens"] for r in results]


@pytest.mark.parametrize("impl", ["unfused", "fused"])
@pytest.mark.parametrize("heads", HEADS)
def test_paged_engines_stream_jax_tokens(heads, impl):
    """``StaticEngine(kv_layout="paged")`` over three retained slices
    (pages of 8): every slice's streams and counts equal the JAX
    engine's, through the plain versions of B5 and B1 (unfused) or B3
    and B4 (fused) at these heads."""
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = shared_models("llama3.2-1b", heads=heads)
    assert (tm.cfg.n_heads, tm.cfg.n_kv_heads, tm.cfg.head_dim) == heads
    kw = dict(eos_id=1, len_bucket=8, kv_layout="paged", page_tokens=8,
              kv_pool_tokens=512, attn_impl=impl)
    jeng = JaxEngine(jm, jp, **kw)
    teng = StaticEngine(tm, tp, device="cpu", **kw)
    ps = prompts(tm.cfg.vocab_size, [7, 12, 4], seed=0)
    totals = [14, 9, 12]
    outs = [[] for _ in ps]
    ops.reset_counts()
    while any(len(o) < t for o, t in zip(outs, totals)):
        idx = [i for i in range(len(ps)) if len(outs[i]) < totals[i]]
        args = ([ps[i] for i in idx], 5, [100 + i for i in idx])
        skw = dict(forced_gen_lens=[totals[i] - len(outs[i]) for i in idx],
                   already_generated=[outs[i] for i in idx])
        want = jeng.serve_batch_paged(*args, **skw)
        got = teng.serve_batch_paged(*args, **skw)
        assert _streams(got.results) == _streams(want.results)
        assert (got.steps, got.reprefill_tokens) == \
            (want.steps, want.reprefill_tokens)
        for s, i in enumerate(idx):
            outs[i].extend(want.results[s]["tokens"])
    assert [len(o) for o in outs] == totals
    decode = ("paged_decode_attention" if impl == "unfused"
              else "fused_rope_decode_append")
    assert ops.plain_calls[decode] > 0


@pytest.mark.parametrize("heads", HEADS)
def test_dense_engine_streams_jax_tokens(heads):
    """The dense ``StaticEngine.serve_batch`` (SCLS re-prefilling prompt +
    generated tokens) over two slices, through the plain versions of B5
    and B6 at these heads."""
    from repro.engine.static_engine import StaticEngine as JaxEngine
    from repro_torch.engine.static_engine import StaticEngine
    jm, jp, tm, tp = shared_models("llama3.2-1b", heads=heads)
    jeng = JaxEngine(jm, jp, eos_id=1, len_bucket=8)
    teng = StaticEngine(tm, tp, eos_id=1, len_bucket=8, device="cpu")
    ps = prompts(tm.cfg.vocab_size, [5, 11, 8], seed=13)
    outs = [[] for _ in ps]
    ops.reset_counts()
    for forced in ([6, 6, 6], [5, 2, 6]):
        skw = dict(forced_gen_lens=forced, already_generated=outs)
        want = jeng.serve_batch(ps, 6, **skw)
        got = teng.serve_batch(ps, 6, **skw)
        assert _streams(got.results) == _streams(want.results)
        assert got.reprefill_tokens == want.reprefill_tokens
        outs = [o + r["tokens"] for o, r in zip(outs, want.results)]
    assert ops.plain_calls["flash_prefill"] > 0
    assert ops.plain_calls["decode_attention"] > 0
